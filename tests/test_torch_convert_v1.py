"""The port's CosyVoice-300M converters (tools/convert_checkpoint.py:
convert_llm_v1, convert_flow_v1, and convert_hift at 22.05 kHz) against the
JAX ones on the same synthetic reference-shaped state dicts, bit for bit,
CPU: llm.pt / flow.pt written out from the JAX templates' paths by the
reference's names (the WeNet text encoder, `llm.encoders.<i>` rel-pos
layers, the length regulator's Sequential, the matcha U-Net with plain
ConvTranspose1d upsampling), plus the buffers and loss keys the converters
skip. The trees load into the port's modules; `--version 1` of the CLI
writes what CosyVoice reads. A leftover key raises."""

import json
import re

import jax
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow_v1 import MaskedDiffFlow as JFlow
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.models.llm_v1 import TransformerLM as JTransformerLM
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config, MaskedDiffFlow
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config, TransformerLMModule
from cosyvoice_tpu_torch.tools import convert_checkpoint as pcc
from tests.test_torch_checkpoint import _leaves, assert_same_tree
from tests.test_torch_checkpoint_convert import _HIFT_RULES, _jcc, _state_from_template, _torch_key
from tests.test_torch_common import jax_flow_v1_cfg, jax_hift_v1_cfg, jax_lm_v1_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

_LM_V1_RULES = [
    (r"^(text_embedding|llm_embedding|speech_embedding|text_encoder_affine_layer|spk_embed_affine_layer"
     r"|llm_decoder)$", r"\1"),
    (r"^text_encoder/embed/out_(dense|norm)$", lambda m: "text_encoder.embed.out." + ("0" if m.group(1) == "dense" else "1")),
    (r"^lm_embed/out_(dense|norm)$", lambda m: "llm.embed.out." + ("0" if m.group(1) == "dense" else "1")),
    (r"^text_encoder/encoders_(\d+)/(.+)$", r"text_encoder.encoders.\1.\2"),
    (r"^text_encoder/after_norm$", r"text_encoder.after_norm"),
    (r"^lm_layers_(\d+)/(linear_[qkv]|linear_out|linear_pos)$", r"llm.encoders.\1.self_attn.\2"),
    (r"^lm_layers_(\d+)/ff_w([12])$", r"llm.encoders.\1.feed_forward.w_\2"),
    # the layer's own leaves: the two norms' owners, and pos_bias_u / _v (owned by self_attn)
    (r"^lm_layers_(\d+)/(norm_mha|norm_ff)$", r"llm.encoders.\1.\2"),
    (r"^lm_layers_(\d+)$", r"llm.encoders.\1.self_attn"),
    (r"^lm_after_norm$", r"llm.after_norm"),
]
_FLOW_V1_RULES = [
    (r"^(input_embedding|spk_embed_affine_layer|encoder_proj)$", r"\1"),
    (r"^encoder/embed/out_(dense|norm)$", lambda m: "encoder.embed.out." + ("0" if m.group(1) == "dense" else "1")),
    (r"^encoder/encoders_(\d+)/(.+)$", r"encoder.encoders.\1.\2"),
    (r"^encoder/after_norm$", r"encoder.after_norm"),
    (r"^regulator/conv_(\d+)$", lambda m: f"length_regulator.model.{3 * int(m.group(1))}"),
    (r"^regulator/norm_(\d+)$", lambda m: f"length_regulator.model.{3 * int(m.group(1)) + 1}"),
    (r"^regulator/proj$", lambda m: f"length_regulator.model.{3 * N_REG}"),
    (r"^time_mlp/(linear_\d)$", r"decoder.estimator.time_mlp.\1"),
    (r"^(down|up|mid)_resnet_(\d+)/(block[12])/conv$", r"decoder.estimator.\1_blocks.\2.0.\3.block.0"),
    (r"^(down|up|mid)_resnet_(\d+)/(block[12])/norm$", r"decoder.estimator.\1_blocks.\2.0.\3.block.1"),
    (r"^(down|up|mid)_resnet_(\d+)/mlp$", r"decoder.estimator.\1_blocks.\2.0.mlp.1"),
    (r"^(down|up|mid)_resnet_(\d+)/res_conv$", r"decoder.estimator.\1_blocks.\2.0.res_conv"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/attn1/to_out$", r"decoder.estimator.\1_blocks.\2.1.\3.attn1.to_out.0"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/ff_in$", r"decoder.estimator.\1_blocks.\2.1.\3.ff.net.0.proj"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/ff_out$", r"decoder.estimator.\1_blocks.\2.1.\3.ff.net.2"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/(.+)$", r"decoder.estimator.\1_blocks.\2.1.\3.\4"),
    (r"^downsample_(\d+)/conv$", r"decoder.estimator.down_blocks.\1.2.conv"),
    (r"^upsample_(\d+)/conv$", r"decoder.estimator.up_blocks.\1.2.conv"),
    (r"^(down|up)_post_(\d+)$", r"decoder.estimator.\1_blocks.\2.2"),
    (r"^final_block/(conv|norm)$", lambda m: "decoder.estimator.final_block.block." + ("0" if m.group(1) == "conv" else "1")),
    (r"^final_proj$", r"decoder.estimator.final_proj"),
]
N_REG = 1  # jax_flow_v1_cfg's regulator layers


def _v1_state(tree, rules, rng):
    """A random reference-shaped state dict for a v1 JAX template: Linear
    [out, in], Conv1d [out, in, k], norms and embeddings as they are, the
    U-Net's upsampling a plain ConvTranspose1d weight [in, out, k] (made
    from the template's v; its g is the converter's to fill)."""
    sd = {}
    for path, leaf in _leaves(tree):
        owner = _torch_key(re.sub(r"^(encoder|estimator)/params/|^params/", "", "/".join(path[:-1])), rules)
        val = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        name = path[-1]
        if name == "kernel":
            sd[f"{owner}.weight"] = val.T if val.ndim == 2 else val.transpose(2, 1, 0)
        elif name in ("scale", "embedding"):
            sd[f"{owner}.weight"] = val
        elif name == "v":
            sd[f"{owner}.weight"] = val.transpose(1, 2, 0)
        elif name != "g":
            sd[f"{owner}.{name}"] = val
    return sd


def _templates():
    jlm = JTransformerLM(jax_lm_v1_cfg()).init(jax.random.PRNGKey(0))
    jflow = JFlow(jax_flow_v1_cfg()).init(jax.random.PRNGKey(1))
    jhift = JHiFT(jax_hift_v1_cfg()).init(jax.random.PRNGKey(2), jax.numpy.zeros((1, 8, 80)), jax.random.PRNGKey(3))
    port = {
        "llm": pcc.template(lambda: TransformerLMModule(to_port_cfg(jax_lm_v1_cfg(), LMv1Config))),
        "flow": pcc.template(lambda: MaskedDiffFlow(to_port_cfg(jax_flow_v1_cfg(), FlowV1Config), device="meta")),
        "hift": pcc.template(lambda: HiFTGenerator(to_port_cfg(jax_hift_v1_cfg(), HiFTConfig), device="meta")),
    }
    return {"llm": (jlm, port["llm"]), "flow": (jflow, port["flow"]), "hift": (jhift, port["hift"])}


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(0)
    tmpl = _templates()
    sd_lm = _v1_state(tmpl["llm"][0], _LM_V1_RULES, rng)
    sd_lm["llm.embed.pos_enc.pe"] = rng.standard_normal((1, 9, 32)).astype(np.float32)  # a buffer, skipped
    sd_flow = _v1_state(tmpl["flow"][0], _FLOW_V1_RULES, rng)
    sd_flow["decoder.rand_noise"] = rng.standard_normal((1, 80, 100)).astype(np.float32)  # skipped too
    sd_hift, _ = _state_from_template(tmpl["hift"][0], _HIFT_RULES, rng)
    return tmpl, {"llm": sd_lm, "flow": sd_flow, "hift": sd_hift}


CONVERTERS = {"llm": "convert_llm_v1", "flow": "convert_flow_v1", "hift": "convert_hift"}


@pytest.mark.parametrize("case", ["llm", "flow", "hift"])
def test_v1_converters_match_jax(states, case):
    jcc = _jcc()
    tmpl, sds = states
    jtmpl, ptmpl = tmpl[case]
    sd = sds[case]
    want = getattr(jcc, CONVERTERS[case])(jcc._fold_weight_norm(dict(sd)), jtmpl)
    got = getattr(pcc, CONVERTERS[case])(pcc._fold_weight_norm(dict(sd)), ptmpl)
    assert_same_tree(got, np_tree(want))
    module = {"llm": lambda: TransformerLMModule(to_port_cfg(jax_lm_v1_cfg(), LMv1Config)),
              "flow": lambda: MaskedDiffFlow(to_port_cfg(jax_flow_v1_cfg(), FlowV1Config), device="cpu"),
              "hift": lambda: HiFTGenerator(to_port_cfg(jax_hift_v1_cfg(), HiFTConfig), device="cpu")}[case]()
    load_jax_params(module, got if case == "flow" else got["params"])


def test_upsampling_conv_carries_exactly(states):
    """The plain ConvTranspose1d lands as v = w and g = ||w|| per input
    channel: the weight-normed conv folds back to w."""
    tmpl, sds = states
    got = pcc.convert_flow_v1(dict(sds["flow"]), tmpl["flow"][1])
    flow = load_jax_params(MaskedDiffFlow(to_port_cfg(jax_flow_v1_cfg(), FlowV1Config), device="cpu"), got)
    conv = flow.estimator.upsample_0.conv
    norm = torch.sqrt(conv.v.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
    w = (conv.v * conv.g[:, None, None] / norm).detach().numpy()
    np.testing.assert_allclose(w, sds["flow"]["decoder.estimator.up_blocks.0.2.conv.weight"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["llm", "flow"])
def test_leftover_key_raises(states, case):
    tmpl, sds = states
    sd = dict(sds[case])
    sd["unexpected.weight"] = np.zeros(3, np.float32)
    with pytest.raises(AssertionError, match="unconsumed"):
        getattr(pcc, CONVERTERS[case])(sd, tmpl[case][1])


def test_cli_version_1_writes_what_cosyvoice_reads(states, tmp_path, monkeypatch):
    """`--version 1` on a reference dir (llm.pt, flow.pt, hift.pt; the v1
    configs set to the tiny ones): the files equal the JAX converters'
    trees, and CosyVoice reads them from a dir of version 1."""
    from cosyvoice_tpu_torch.runtime.api import AutoModel, CosyVoice
    from cosyvoice_tpu_torch.utils import msgpack_io

    jcc = _jcc()
    tmpl, sds = states
    ref, out = tmp_path / "ref", tmp_path / "out"
    ref.mkdir()
    for name in ("llm", "flow", "hift"):
        prefix = "generator." if name == "hift" else ""
        torch.save({prefix + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sds[name].items()},
                   ref / f"{name}.pt")
    cfgs = (to_port_cfg(jax_lm_v1_cfg(), LMv1Config), to_port_cfg(jax_flow_v1_cfg(), FlowV1Config),
            to_port_cfg(jax_hift_v1_cfg(), HiFTConfig))
    monkeypatch.setattr(pcc, "LMv1Config", lambda: cfgs[0])
    monkeypatch.setattr(pcc, "FlowV1Config", lambda: cfgs[1])
    monkeypatch.setattr(pcc, "v1_hift_config", lambda: cfgs[2])
    pcc.main(["--model_dir", str(ref), "--out_dir", str(out), "--version", "1"])
    assert sorted(p.name for p in out.iterdir()) == ["flow.msgpack", "hift.msgpack", "lm.msgpack"]
    want = {"lm": jcc.convert_llm_v1(jcc.load_torch_state(str(ref / "llm.pt")), tmpl["llm"][0]),
            "flow": jcc.convert_flow_v1(jcc.load_torch_state(str(ref / "flow.pt")), tmpl["flow"][0]),
            "hift": jcc.convert_hift(jcc.load_torch_state(str(ref / "hift.pt")), tmpl["hift"][0])}
    for name, tree in want.items():
        assert_same_tree(np_tree(msgpack_io.read(str(out / f"{name}.msgpack"))), np_tree(tree))
    (out / "config.json").write_text(json.dumps({"version": 1}))
    api = AutoModel(str(out), device="cpu", lm_cfg=cfgs[0], flow_cfg=cfgs[1], hift_cfg=cfgs[2])
    assert type(api) is CosyVoice
    np.testing.assert_array_equal(api.lm.module.lm_layers[1].pos_bias_u.detach().numpy(),
                                  want["lm"]["params"]["lm_layers_1"]["pos_bias_u"])
