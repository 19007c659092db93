"""The frontend's models against the JAX package's, CPU, float32, with the
JAX params (every leaf perturbed from its init) carried by convert.py:

- S3Tokenizer (d_model 64, 4 heads, 2 layers; FSQ and VQ) on two
  sequences of different lengths: the encoder output and the FSQ
  projection within 1e-4, the token lengths equal and the tokens equal,
  save FSQ frames whose JAX pre-round value lies within 1e-5 of a rounding
  boundary (counted and printed);
- CamPPEmbedding (blocks of 2 layers, 25-frame CAM segments) at 99, 100,
  101 and 250 fbank frames: the x-vector within 1e-4 (the time stride of 2
  gives 50, 50, 51 and 125 frames, so whole and partial segments);
- the converter raises on a missing and on an extra leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.campplus import CamPPConfig as JCamPPConfig
from cosyvoice_tpu.models.campplus import CamPPEmbedding as JCamPPEmbedding
from cosyvoice_tpu.models.speech_tokenizer import S3Tokenizer as JS3Tokenizer
from cosyvoice_tpu.models.speech_tokenizer import S3TokenizerConfig as JS3TokenizerConfig
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig
from tests.test_torch_common import np_tree

torch.set_num_threads(1)

ATOL = 1e-4
BOUNDARY = 1e-5  # FSQ frames this close to a rounding boundary may round either way


def perturbed(params, seed):
    """Every leaf moved by N(0, 0.1), variances kept positive, so that no
    leaf is left at its init's constant."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(np_tree(params))[0]
    out = {}
    for path, leaf in flat:
        name = "/".join(str(k.key) for k in path)
        val = leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k.key, {})
        node[path[-1].key] = np.abs(val) + 0.5 if name.endswith("/var") else val
    return out


def s3_cfgs(use_fsq):
    kw = dict(d_model=64, num_heads=4, num_layers=2, use_fsq=use_fsq, codebook_size=64)
    return JS3TokenizerConfig(**kw), S3TokenizerConfig(**kw)


def s3_init(jcfg):
    return np_tree(jax.jit(JS3Tokenizer(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 20, 128)),
                                                    jnp.asarray([20]))["params"])


@pytest.mark.parametrize("use_fsq", [True, False], ids=["fsq", "vq"])
def test_s3_tokenizer_matches_jax(use_fsq):
    jcfg, cfg = s3_cfgs(use_fsq)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 203, 128)).astype(np.float32)
    mel_len = np.array([203, 150])
    jm = JS3Tokenizer(jcfg)
    params = perturbed(s3_init(jcfg), 1)
    apply = jax.jit(lambda p, mel, ml: jm.apply({"params": p}, mel, ml, capture_intermediates=True))
    (jtok, jlen), inter = apply(params, jnp.asarray(mel), jnp.asarray(mel_len))
    jtok, jlen, inter = np.asarray(jtok), np.asarray(jlen), inter["intermediates"]
    m = load_jax_params(S3Tokenizer(cfg), params)
    with torch.no_grad():
        x, length = m.encode(torch.tensor(mel), torch.tensor(mel_len))
        tok = m.quantize(x).numpy()
    np.testing.assert_array_equal(length.numpy(), jlen)
    want_x = np.asarray(jax.nn.gelu(inter["conv_ds"]["__call__"][0], approximate=False))
    np.testing.assert_allclose(x.numpy(), want_x, rtol=0, atol=ATOL)
    valid = np.arange(tok.shape[1])[None, :] < jlen[:, None]
    exempt = np.zeros_like(valid)
    if use_fsq:
        jproj = np.asarray(inter["fsq_proj"]["__call__"][0])
        with torch.no_grad():
            np.testing.assert_allclose(m.fsq_proj(x).numpy(), jproj, rtol=0, atol=ATOL)
        half = (np.asarray(jcfg.fsq_levels) - 1) / 2.0
        pre = np.tanh(jproj) * half + half
        exempt = (np.abs(pre - np.floor(pre) - 0.5) < BOUNDARY).any(-1)
    differ = (tok != jtok) & valid & ~exempt
    print(f"S3 {'FSQ' if use_fsq else 'VQ'}: {int(exempt[valid].sum())} of {int(valid.sum())} frames within "
          f"{BOUNDARY} of a rounding boundary")
    assert not differ.any(), f"{int(differ.sum())} tokens differ"


def cam_cfgs():
    kw = dict(blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2)), seg_len=25)
    return JCamPPConfig(**kw), CamPPConfig(**kw)


@pytest.fixture(scope="module")
def cam_init():
    jcfg, _ = cam_cfgs()
    return np_tree(jax.jit(JCamPPEmbedding(jcfg).init)(jax.random.PRNGKey(1), jnp.zeros((1, 20, 80)))["params"])


@pytest.fixture(scope="module")
def campplus(cam_init):
    jcfg, cfg = cam_cfgs()
    params = perturbed(cam_init, 2)
    return jax.jit(JCamPPEmbedding(jcfg).apply), params, load_jax_params(CamPPEmbedding(cfg), params)


@pytest.mark.parametrize("frames", [99, 100, 101, 250])
def test_campplus_matches_jax(campplus, frames):
    apply, params, m = campplus
    feats = np.random.default_rng(frames).standard_normal((2, frames, 80)).astype(np.float32)
    want = np.asarray(apply({"params": params}, jnp.asarray(feats)))
    with torch.no_grad():
        got = m(torch.tensor(feats)).numpy()
    assert got.shape == want.shape == (2, 192)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("model", ["s3", "campplus"])
def test_converter_raises_on_missing_and_extra_leaves(model, cam_init):
    if model == "s3":
        jcfg, cfg = s3_cfgs(True)
        params = s3_init(jcfg)
        make, (top, leaf) = (lambda: S3Tokenizer(cfg)), ("blocks_1", "k")
    else:
        params = cam_init
        make, (top, leaf) = (lambda: CamPPEmbedding(cam_cfgs()[1])), ("head", "bn1")
    load_jax_params(make(), params)
    missing = {**params, top: {k: v for k, v in params[top].items() if k != leaf}}
    with pytest.raises(KeyError, match="left unset"):
        load_jax_params(make(), missing)
    extra = {**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="has no port parameter"):
        load_jax_params(make(), extra)
