"""The decode step's route, as the JAX LM takes it.

The JAX LM sends a decode step to its Pallas kernels only where Hkv * d is a
multiple of 128 and the arena's length divides into the kernel's block
(`flash_decode_wanted`, which COSY_FLASH_DECODE=force lets a CPU run name);
otherwise it writes the new rows with a masked select and attends with the
masked einsum. The port asks one gate, `ops/decode_attention.
decode_kernel_wanted`, in `Qwen2Attention.decode` and in the decode graphs'
keys. Here: the gate against `flash_decode_wanted` over a table of shapes
(the repo's three small configs, full width, float32 and int8 arenas);
the plain route of a tiny Hkv * d = 32 LM against the JAX LM (logits within
ATOL, greedy tokens equal) without a call to any kernel wrapper; the kernel
route of a float32 Hkv * d = 128 LM through the wrappers; and, on a card,
the tiny LM decoding on graphs with no K1/K2 launch and the float32 K1/K2
against their plain versions. JAX is imported inside the CPU tests, so that
the card's test runs without it:
`python -m pytest --noconftest tests/test_torch_decode_route.py -m cuda -q`.
"""

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.models import qwen2 as tq
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
from cosyvoice_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

ATOL = 2e-4  # float32 logits through 2 layers, as tests/test_torch_lm.py


# (label, Hkv, d, arena rows): the hermetic recipe's and the examples' LM
# (Hkv * d = 32) at their arena buckets, full CosyVoice2 width (2 x 64), a
# head of 128, heads of 32 whose lanes make 128, and arenas that do not
# divide into the 512-row block
ROUTES = [
    ("hermetic", 2, 16, 512), ("example", 2, 16, 1024), ("example short", 2, 16, 96),
    ("full width", 2, 64, 512), ("full width long", 2, 64, 4096), ("full width short", 2, 64, 100),
    ("head 128", 1, 128, 1024), ("lanes 4 x 32", 4, 32, 512), ("ragged arena", 2, 64, 768),
    ("ragged long arena", 2, 64, 1000), ("lanes 96", 3, 32, 512), ("lanes 64", 1, 64, 512),
]


@pytest.mark.parametrize("label,hkv,d,T", ROUTES, ids=[r[0] for r in ROUTES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gate_is_the_jax_gate(label, hkv, d, T, dtype, monkeypatch):
    """Kernel or not, per shape: `decode_kernel_wanted` equals
    `flash_decode_wanted` under COSY_FLASH_DECODE=force (the arena's dtype
    moves neither)."""
    from cosyvoice_tpu.ops.decode_attention import flash_decode_wanted

    monkeypatch.setenv("COSY_FLASH_DECODE", "force")
    want = flash_decode_wanted(T, hkv * d) is not None
    assert tda.decode_kernel_wanted(T, hkv * d) == want
    if label in ("hermetic", "example", "example short"):
        assert not want  # the three small configs take the plain route
    if label.startswith("full width") and label != "full width short":
        assert want


TINY = {"hidden_size": 64, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
        "intermediate_size": 128, "vocab_size": 100, "max_cache_len": 512}
LM_KW = {"speech_token_size": 20, "block_size": 8, "top_k": 1, "tau_r": 2.0}  # greedy


def _prompt(rng, n_text=7, n_speech=5):
    """sos, text, task, speech ids and their types (tests/test_torch_lm.py's)."""
    ids = np.concatenate([[0], rng.integers(0, 100, n_text), [1], rng.integers(0, 20, n_speech)]).astype(np.int32)
    types = np.concatenate([[2], np.full(n_text, 0), [2], np.full(n_speech, 1)]).astype(np.int32)
    return ids, types


def _tiny_qwen(**kw):
    """The hermetic recipe's LM (cosyvoice_tpu_torch/examples/hermetic/run.py
    CONFIG): hidden 64, 4 heads, 2 KV heads of 16, float32; as a JAX
    config."""
    import jax.numpy as jnp

    from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config

    return JQwen2Config(**{**TINY, "dtype": jnp.float32, **kw})


def _pair(qwen):
    import jax

    from cosyvoice_tpu.models.llm import LMConfig as JLMConfig, Qwen2LM as JQwen2LM
    from cosyvoice_tpu_torch.convert import load_jax_params
    from tests.test_torch_common import np_tree, to_port_cfg

    jcfg = JLMConfig(**LM_KW, qwen=qwen)
    jlm = JQwen2LM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    lm = Qwen2LM(to_port_cfg(jcfg, LMConfig), device="cpu")
    load_jax_params(lm.module, np_tree(params["params"]))
    return jlm, params, lm


def _no_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain route called a kernel wrapper")

    for name in ("gqa_decode_attention", "gqa_decode_attention_quant", "kv_arena_write_kv"):
        monkeypatch.setattr(tq, name, refuse)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float32 arena", "int8 arena"])
def test_plain_route_matches_jax_and_calls_no_kernel(kv_quant, monkeypatch):
    """Hkv * d = 32: prefill and four decode steps' logits within ATOL of
    the JAX LM's (its einsum path), the arena rows equal, and the greedy
    stream of `generate` equal, with every kernel wrapper refusing."""
    import jax
    import jax.numpy as jnp

    jlm, params, lm = _pair(_tiny_qwen(kv_quant=kv_quant))
    _no_kernels(monkeypatch)
    ids, types = _prompt(np.random.default_rng(0))
    T = len(ids)
    jcache = jlm.init_cache(1, length=64)
    jlogits, jcache = jlm._jit_prefill(params, jnp.asarray(ids[None]), jnp.asarray(types[None]), jnp.asarray([T]),
                                       jcache)
    cache = lm.init_cache(1, 64)
    with torch.inference_mode():
        logits, cache = lm.module.prefill(torch.from_numpy(ids[None]).long(), torch.from_numpy(types[None]).long(),
                                          torch.tensor([T]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
        for step, tok in enumerate([3, 17, 20, 5]):
            cur = T + step
            jlogits, jcache = jlm.module.apply(params, jnp.asarray([tok]), jnp.asarray([cur]), jcache,
                                               method="decode_step")
            logits, cache = lm.module.decode_step(torch.tensor([tok]), torch.tensor([cur], dtype=torch.int32), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    if kv_quant:
        np.testing.assert_array_equal(cache[0][:, :, : T + 4].numpy(), np.asarray(jcache[0])[:, :, : T + 4])
    else:
        np.testing.assert_allclose(cache[0][:, :, : T + 4].numpy(), np.asarray(jcache[0])[:, :, : T + 4], atol=ATOL)
    for seed in (4, 5):  # prompts whose streams run 6 and 10 tokens
        ids, types = _prompt(np.random.default_rng(seed))
        want = np.concatenate(list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), 4, 40))
                              or [np.zeros(0, np.int32)])
        got = np.concatenate(list(lm.generate(ids, types, torch.Generator().manual_seed(0), 4, 40))
                             or [np.zeros(0, np.int32)])
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)


def test_kernel_route_goes_through_the_wrappers(monkeypatch):
    """A float32 LM at Hkv * d = 128 takes K2 and K1 every layer and step
    (their plain versions on CPU), and its decode graphs' key names the
    route; the Hkv * d = 32 LM's key names the plain route."""
    calls = {"k1": 0, "k2": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tq, "gqa_decode_attention", spy("k1", tda.gqa_decode_attention))
    monkeypatch.setattr(tq, "kv_arena_write_kv", spy("k2", tda.kv_arena_write_kv))
    _, _, lm = _pair(_tiny_qwen(hidden_size=128, num_heads=4, num_kv_heads=2, head_dim=64))
    ids, types = _prompt(np.random.default_rng(0))
    toks = np.concatenate(list(lm.generate(ids, types, torch.Generator().manual_seed(0), 4, 12)))
    steps = lm.decode_steps
    assert steps >= len(toks) - 1 > 0
    assert calls == {"k1": 2 * steps, "k2": 2 * steps}
    cache = lm.arenas.get(1, 512)
    assert lm.decoder.route(cache, None) == "per-layer"
    _, _, small = _pair(_tiny_qwen())
    assert small.decoder.route(small.arenas.get(1, 512), None) == "plain attention"


@pytest.mark.cuda
def test_plain_and_float32_kernel_routes_on_the_card():
    """On a card: the tiny Hkv * d = 32 float32 LM decodes on graphs with
    no K1/K2 launch and the host's greedy tokens; the float32 K1 and K2 at
    Hkv * d = 128 equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels and the decode graphs run only on the GPU")
    from cosyvoice_tpu_torch.runtime.engine import random_lm

    qwen = LMConfig(**LM_KW, qwen=Qwen2Config(**TINY, dtype=torch.float32))

    host, _ = random_lm(0, "cpu", qwen)
    card = Qwen2LM(qwen, device="cuda")
    card.module.load_state_dict(host.module.state_dict())
    ids, types = _prompt(np.random.default_rng(0))
    before = {fn: fn.launches for fn in (tda.gqa_decode_attention, tda.kv_arena_write_kv, tda.kv_arena_write)}
    got = np.concatenate(list(card.generate(ids, types, torch.Generator(device="cuda").manual_seed(0), 20, 40)))
    want = np.concatenate(list(host.generate(ids, types, torch.Generator().manual_seed(0), 20, 40)))
    np.testing.assert_array_equal(got, want)
    assert card.graph_replays > 0
    assert all(fn.launches == n for fn, n in before.items())

    gen = torch.Generator().manual_seed(0)
    for B, T, Hkv, d, Hq, pos in ((1, 1024, 2, 64, 14, (700,)), (1, 512, 1, 128, 8, (3,)),
                                   (4, 1024, 2, 64, 14, (0, 63, 511, 1023))):
        k = torch.randn(B, T, Hkv, d, generator=gen)
        v = torch.randn(B, T, Hkv, d, generator=gen)
        q = torch.randn(B, Hq, d, generator=gen)
        kn, vn = torch.randn(B, 1, Hkv, d, generator=gen), torch.randn(B, 1, Hkv, d, generator=gen)
        cur = torch.tensor(pos, dtype=torch.int32)
        kc, vc = k.cuda(), v.cuda()
        tda.kv_arena_write_kv(kc, vc, kn.cuda(), vn.cuda(), cur.cuda())
        tda.kv_arena_write_kv_plain(k, v, kn, vn, cur)
        assert torch.equal(kc.cpu(), k) and torch.equal(vc.cpu(), v)
        out = tda.gqa_decode_attention(q.cuda(), kc, vc, cur.cuda()).cpu()
        np.testing.assert_allclose(out.numpy(), tda.gqa_decode_attention_plain(q, k, v, cur).numpy(), atol=1e-5)
