"""The port's random init (utils/init.py:init_random_) against the JAX
modules' Flax initializers, family by family at tiny width.

For every parameter of at least MIN_NUMEL elements, the std of its values
under init_random_ is within STD_RTOL of the std of the JAX `init`'s values
(loaded through convert.load_jax_params), each pooled over N_SEEDS seeds so
that a 64-element bias-sized tensor still holds about a thousand draws.
Parameters the JAX init makes constant (zeros, ones) are equal. The
truncated normals (matrices and conv kernels) stay inside their cut, two
raw standard deviations."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.utils.init import _TRUNC_STD, init_random_
from tests.test_torch_common import (
    jax_dit_flow_cfg, jax_flow_cfg, jax_flow_v1_cfg, jax_hift_cfg, jax_hift_cfg_v3, jax_hift_v1_cfg, jax_lm_cfg,
    jax_lm_cfg_v3, jax_lm_v1_cfg, np_tree, to_port_cfg,
)

MIN_NUMEL = 64
STD_RTOL = 0.10  # pooled over N_SEEDS: sampling error of the ratio ~3 % at 64 elements
N_SEEDS = 16


def _lm(jcfg_fn):
    from cosyvoice_tpu.models.llm import Qwen2LM as J
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule

    jcfg = jcfg_fn()
    jm = J(jcfg)
    return (lambda k: jm.init(k)["params"]), (lambda: Qwen2LMModule(to_port_cfg(jcfg, LMConfig)))


def _lm_v1():
    from cosyvoice_tpu.models.llm_v1 import TransformerLM as J
    from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config, TransformerLMModule

    jcfg = jax_lm_v1_cfg()
    jm = J(jcfg)
    return (lambda k: jm.init(k)["params"]), (lambda: TransformerLMModule(to_port_cfg(jcfg, LMv1Config)))


def _flow(jcfg_fn):
    from cosyvoice_tpu.models.flow import CausalFlow as J
    from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig

    jcfg = jcfg_fn()
    jm = J(jcfg)
    return jm.init, (lambda: CausalFlow(to_port_cfg(jcfg, FlowConfig), device="cpu"))


def _flow_v1():
    from cosyvoice_tpu.models.flow_v1 import MaskedDiffFlow as J
    from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config, MaskedDiffFlow

    jcfg = jax_flow_v1_cfg()
    jm = J(jcfg)
    return jm.init, (lambda: MaskedDiffFlow(to_port_cfg(jcfg, FlowV1Config), device="cpu"))


def _hift(jcfg_fn, frames=8):
    from cosyvoice_tpu.models.hift import HiFTGenerator as J
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator

    jcfg = jcfg_fn()
    jm = J(jcfg)
    return ((lambda k: jm.init(k, jnp.zeros((1, frames, 80)), k)["params"]),
            (lambda: HiFTGenerator(to_port_cfg(jcfg, HiFTConfig), device="cpu")))


def _disc():
    from cosyvoice_tpu.models.discriminator import MultipleDiscriminator as J
    from cosyvoice_tpu_torch.models.discriminator import MultipleDiscriminator

    kw = dict(mpd_channels=(4, 8, 8, 16), mrd_resolutions=((64, 8), (128, 16), (32, 4)))
    jm = J(**kw)
    return (lambda k: jm.init(k, jnp.zeros((1, 2400)))["params"]), (lambda: MultipleDiscriminator(**kw))


def _s3(use_fsq):
    from cosyvoice_tpu.models.speech_tokenizer import S3Tokenizer as J, S3TokenizerConfig as JC
    from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig

    kw = dict(d_model=64, num_heads=4, num_layers=2, use_fsq=use_fsq, codebook_size=64)
    jm = J(JC(**kw))
    return ((lambda k: jm.init(k, jnp.zeros((1, 20, 128)), jnp.asarray([20]))["params"]),
            (lambda: S3Tokenizer(S3TokenizerConfig(**kw))))


def _campplus():
    from cosyvoice_tpu.models.campplus import CamPPConfig as JC, CamPPEmbedding as J
    from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding

    kw = dict(blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2)), seg_len=25)
    jm = J(JC(**kw))
    return (lambda k: jm.init(k, jnp.zeros((1, 20, 80)))["params"]), (lambda: CamPPEmbedding(CamPPConfig(**kw)))


FAMILIES = {
    "lm_v2": lambda: _lm(jax_lm_cfg),
    "lm_v3": lambda: _lm(jax_lm_cfg_v3),
    "lm_v1": _lm_v1,
    "flow_causal": lambda: _flow(jax_flow_cfg),
    "flow_dit": lambda: _flow(jax_dit_flow_cfg),
    "flow_v1": _flow_v1,
    "hift": lambda: _hift(jax_hift_cfg),
    "hift_causal": lambda: _hift(jax_hift_cfg_v3, frames=12),
    "hift_v1": lambda: _hift(jax_hift_v1_cfg),
    "discriminator": _disc,
    "s3_fsq": lambda: _s3(True),
    "s3_vq": lambda: _s3(False),
    "campplus": _campplus,
}


def _values(module):
    return {n: p.detach().double().numpy().copy() for n, p in module.named_parameters() if p.requires_grad}


def _truncated(module):
    """Names of the parameters drawn from lecun_normal: the weights of the
    Linear and conv modules, with their fan_in."""
    out = {}
    for mname, mod in module.named_modules():
        w = getattr(mod, "weight", None)
        if isinstance(mod, torch.nn.Embedding) or not isinstance(w, torch.nn.Parameter) or w.dim() < 2:
            continue
        out[f"{mname}.weight" if mname else "weight"] = w[0].numel()
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_draws_the_jax_initializers_distributions(family):
    jax_init, make = FAMILIES[family]()
    jax_init = jax.jit(jax_init)
    module = make()
    cut = _truncated(module)
    port, ref = {}, {}
    for seed in range(N_SEEDS):
        for dst, fill in ((port, lambda m: init_random_(m, seed)),
                          (ref, lambda m: load_jax_params(m, np_tree(jax_init(jax.random.PRNGKey(seed)))))):
            fill(module)
            for n, v in _values(module).items():
                dst.setdefault(n, []).append(v)
            if dst is port:
                for n, fan_in in cut.items():
                    bound = 2.0 / _TRUNC_STD / math.sqrt(fan_in)
                    v = dict(module.named_parameters())[n].detach()
                    assert float(v.abs().max()) <= bound * (1 + 1e-6), (family, n)
    assert port.keys() == ref.keys()
    checked = 0
    for n in port:
        p, r = np.stack(port[n]), np.stack(ref[n])
        if r.std() == 0.0:
            np.testing.assert_array_equal(p, r, err_msg=f"{family}: {n}")
            continue
        if p[0].size < MIN_NUMEL:
            continue
        ratio = p.std() / r.std()
        assert abs(ratio - 1.0) <= STD_RTOL, (family, n, ratio)
        checked += 1
    assert checked > 0
