"""Checkpoints with no download, CPU: the port's flax msgpack reader and
writer (utils/msgpack_io.py) against `flax.serialization`, exactly, both
ways (float32, bfloat16, float16, int8, uint8, int32, bool, 0-d, empty,
nested list-dict trees, chunked leaves, random trees under hypothesis);
`convert.export_params` as the inverse of `load_jax_params` for the five
module families, leaf for leaf (the int4p LM tree from
`quantize_lm_params` too), and on the meta device the JAX templates' paths,
shapes and dtypes (the converters' templates). Also: nothing in the port
imports msgpack, transformers, tokenizers, regex or onnx. The converters
are held in tests/test_torch_checkpoint_convert.py."""

import functools
import os

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig
from cosyvoice_tpu_torch.tools import convert_checkpoint as pcc
from cosyvoice_tpu_torch.utils import msgpack_io
from tests.test_torch_common import (
    REPO,
    _imports,
    jax_flow_cfg,
    jax_hift_cfg,
    jax_lm_cfg,
    jax_lm_cfg_quant,
    np_tree,
    to_port_cfg,
)

torch.set_num_threads(1)

K = jax.random.PRNGKey(0)
CAM = dict(blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2)))
S3 = dict(d_model=64, num_heads=4, num_layers=2)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bits(a):
    """A leaf's dtype name, shape and bytes: equal bits, NaNs included."""
    a = np.asarray(a)
    name = "bfloat16" if a.dtype in (jnp.bfloat16, msgpack_io.BFLOAT16) else a.dtype.name
    return name, a.shape, np.ascontiguousarray(a).tobytes()


def assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:10]
    for path, w in want.items():
        assert _bits(got[path]) == _bits(w), "/".join(path)


# ---------------------------------------------------------------- msgpack


def _dtype_tree(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal(7).astype(np.float16),
        "i8": rng.integers(-128, 127, (4, 2, 3), dtype=np.int8),
        "u8": rng.integers(0, 255, 300, dtype=np.uint8),
        "i32": rng.integers(-(2**31), 2**31 - 1, (2, 2), dtype=np.int32),
        "bool": rng.random(9) > 0.5,
        "zero_d": np.asarray(1.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.float32(-2.25),
        "nested": {"list": [np.arange(3, dtype=np.int32), {"x": np.ones(2, np.float32)}], "n": None, "i": -70000,
                   "big": 2**40, "f": 0.5, "s": "naïve " * 10, "t": True},
    }


def test_port_bytes_equal_flax_bytes_and_restore_in_flax():
    tree = _dtype_tree(np.random.default_rng(0))
    data = msgpack_io.dumps(tree)
    assert data == ser.to_bytes(tree)
    template = jax.tree.map(lambda x: x, tree)
    back = ser.from_bytes(template, data)
    assert back["nested"]["list"][1]["x"].dtype == np.float32 and isinstance(back["nested"]["list"], list)
    for (p, g), (_, w) in zip(sorted(_leaves_any(back)), sorted(_leaves_any(tree))):
        assert _bits_any(g) == _bits_any(w), p


def _leaves_any(tree, prefix=()):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_any(v, prefix + (k,))
    else:
        yield prefix, tree


def _bits_any(x):
    return _bits(x) if isinstance(x, (np.ndarray, np.generic)) else (type(x).__name__, x)


def test_flax_bytes_read_by_the_port():
    tree = _dtype_tree(np.random.default_rng(1))
    back = msgpack_io.loads(ser.to_bytes(tree))
    want = ser.msgpack_restore(ser.to_bytes(tree))
    for (p, g), (q, w) in zip(_leaves_any(back), _leaves_any(want)):
        assert p == q and _bits_any(g) == _bits_any(w), p
    assert isinstance(back["scalar"], np.float32) and back["zero_d"].shape == ()


def test_bfloat16_both_ways():
    w = jnp.asarray(np.random.default_rng(2).standard_normal((4, 6)), jnp.bfloat16)
    got = msgpack_io.loads(ser.to_bytes({"w": w}))["w"]
    assert got.dtype == msgpack_io.BFLOAT16 and got.shape == (4, 6)
    t = msgpack_io.to_torch(got)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(w, np.float32))
    back = ser.from_bytes({"w": w}, msgpack_io.dumps({"w": got}))["w"]
    assert back.dtype == jnp.bfloat16 and _bits(back) == _bits(w)
    # a bf16 leaf loads into a parameter through load_jax_params
    lin = torch.nn.Linear(4, 6, bias=False)
    load_jax_params(lin, {"kernel": got})
    np.testing.assert_array_equal(lin.weight.detach().numpy(), np.asarray(w, np.float32).T)


def test_chunked_leaves_both_ways(monkeypatch):
    """An array over MAX_CHUNK_SIZE bytes is written and read in flat
    chunks (the limit set small in flax and the port alike)."""
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((7, 9)).astype(np.float32), "b": {"c": rng.integers(0, 9, 100, dtype=np.int8)},
            "small": np.ones(4, np.float32)}
    data = msgpack_io.dumps(tree)
    assert data == ser.to_bytes(tree) and b"__msgpack_chunked_array__" in data
    assert_same_tree(msgpack_io.loads(data), tree)
    assert_same_tree(ser.from_bytes(tree, data), tree)


def test_read_views_one_writable_buffer(tmp_path):
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(3, np.int8)}}
    path = str(tmp_path / "x.msgpack")
    assert msgpack_io.write(path, tree) == len(ser.to_bytes(tree))
    back = msgpack_io.read(path)
    w, b = back["params"]["w"], back["params"]["b"]
    # views of one buffer the size of the file
    bounds = [np.lib.array_utils.byte_bounds(a) for a in (w, b)]
    assert w.flags.writeable and not w.flags.owndata and not b.flags.owndata
    assert max(hi for _, hi in bounds) - min(lo for lo, _ in bounds) <= os.path.getsize(path)
    assert_same_tree(back, tree)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.loads(ser.to_bytes(tree)[:-3])
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_io.loads(ser.to_bytes({"c": 1 + 2j}))


DTYPES = st.sampled_from([np.float32, np.float16, np.int8, np.uint8, np.int32, np.bool_])
ARRAYS = DTYPES.flatmap(lambda d: hnp.arrays(d, hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=4)))
KEYS = st.text(st.characters(categories=("L", "N"), max_codepoint=0x3000), min_size=1, max_size=6)
TREES = st.recursive(ARRAYS, lambda kids: st.dictionaries(KEYS, kids, min_size=1, max_size=4), max_leaves=12)


@settings(max_examples=60, deadline=None)
@given(tree=st.dictionaries(KEYS, TREES, min_size=1, max_size=4))
def test_random_trees_round_trip(tree):
    data = msgpack_io.dumps(tree)
    assert data == ser.to_bytes(tree)
    assert_same_tree(msgpack_io.loads(data), tree)


# ---------------------------------------------------------------- export / load


def _families():
    """name -> (the port module, its JAX config), tiny widths."""
    from tests.test_convert_campplus import SMALL_CFG

    cam = CamPPConfig(**{f: getattr(SMALL_CFG, f) for f in CamPPConfig.__dataclass_fields__})
    return {
        "lm": lambda: Qwen2LMModule(to_port_cfg(jax_lm_cfg(), LMConfig)),
        "lm_int4p": lambda: Qwen2LMModule(to_port_cfg(jax_lm_cfg_quant(), LMConfig)),
        "flow": lambda: CausalFlow(to_port_cfg(CASE_CFGS["flow"](), FlowConfig), device="cpu"),
        "hift": lambda: HiFTGenerator(to_port_cfg(jax_hift_cfg(), HiFTConfig), device="cpu"),
        "s3": lambda: S3Tokenizer(S3TokenizerConfig(**S3)),
        "campplus": lambda: CamPPEmbedding(cam),
    }


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    """The JAX param tree (numpy leaves) of one family or converter case,
    made once per session."""
    from cosyvoice_tpu.models.campplus import CamPPEmbedding as JCamPP
    from cosyvoice_tpu.models.flow import CausalFlow as JFlow
    from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
    from cosyvoice_tpu.models.llm import Qwen2LM as JLM
    from cosyvoice_tpu.models.speech_tokenizer import S3Tokenizer as JS3
    from cosyvoice_tpu.models.speech_tokenizer import S3TokenizerConfig as JS3Config
    from cosyvoice_tpu.ops import quant as jquant
    from cosyvoice_tpu.utils.devices import jit_init
    from tests.test_convert_campplus import SMALL_CFG

    if name == "lm_int4p":
        return jquant.quantize_lm_params(np_tree(jit_init(JLM(jax_lm_cfg_quant(False, False)).init, K)), "int4p")
    if name == "s3":
        return np_tree(jit_init(JS3(JS3Config(**S3)).init, K, jnp.zeros((1, 100, 128)), jnp.asarray([100])))
    if name == "campplus":
        return np_tree(jit_init(JCamPP(SMALL_CFG).init, K, jnp.zeros((1, 20, 16))))
    cfg = CASE_CFGS["llm" if name == "lm" else name]()
    if name in ("lm", "llm"):
        return np_tree(jit_init(JLM(cfg).init, K))
    if name == "hift":
        return np_tree(jit_init(JHiFT(cfg).init, K, jnp.zeros((1, 8, 80)), K))
    return np_tree(jit_init(JFlow(cfg).init, K))


@pytest.mark.parametrize("family", ["lm", "lm_int4p", "flow", "hift", "s3", "campplus"])
def test_export_inverts_load_and_meta_gives_the_jax_template(family):
    """export_params(load_jax_params(m, tree)) == tree leaf for leaf and
    dtype for dtype (the JAX init tree with its "params" collections, the
    int4p tree with its int8 leaves); on the meta device the same walk gives
    the tree's paths, shapes and dtypes; a bf16 LM exports bf16-exact
    float32 that loads back bit for bit."""
    make = _families()[family]
    tree = _jax_tree(family)
    module = make()
    load_jax_params(module, tree)
    assert_same_tree(export_params(module), tree)
    spec = pcc.template(make if family not in ("flow", "hift") else (
        lambda: type(module)(module.cfg, device="meta")))
    assert {p: (tuple(v.shape), v.dtype) for p, v in _leaves(spec)} == {
        p: (v.shape, v.dtype) for p, v in _leaves(tree)}
    if family == "lm":
        module.to(torch.bfloat16)
        exported = export_params(module)
        assert all(v.dtype == np.float32 for _, v in _leaves(exported))
        again = make().to(torch.bfloat16)
        load_jax_params(again, exported)
        for (n, a), (_, b) in zip(module.named_parameters(), again.named_parameters()):
            assert torch.equal(a, b), n


def test_export_raises_for_an_unknown_owner():
    class Odd(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = torch.nn.BatchNorm1d(2)  # (GroupNorm has a JAX layout since the v1 flow)

    with pytest.raises(TypeError, match="no JAX layout"):
        export_params(Odd())


def _flow_cfg(n_mid=2, n_tf=1):
    """jax_flow_cfg() with n_mid U-Net mid blocks and n_tf transformer
    blocks per level."""
    import dataclasses

    cfg = jax_flow_cfg()
    return dataclasses.replace(cfg, estimator=dataclasses.replace(cfg.estimator, num_mid_blocks=n_mid, n_blocks=n_tf))


# the configs of the converter cases: the JAX convert_flow_v2 converts only
# a flow with one mid block and one transformer block per level ("flow1");
# "flow" has two of each
CASE_CFGS = {"llm": jax_lm_cfg, "flow1": lambda: _flow_cfg(1, 1), "flow": lambda: _flow_cfg(2, 2),
             "hift": jax_hift_cfg}


# ---------------------------------------------------------------- rules

NOT_ON_THE_CARD = ("msgpack", "transformers", "tokenizers", "regex", "onnx")


@pytest.mark.parametrize("module", NOT_ON_THE_CARD)
def test_port_imports_none_of_the_packages_the_card_lacks(module):
    files = sorted((REPO / "cosyvoice_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{f.relative_to(REPO)}" for f in files for mod in _imports(f) if mod.split(".")[0] == module]
    assert not bad, bad
