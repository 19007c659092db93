"""The port's streaming flow against the JAX package at tiny width, float32:
the arena chunk masks, the cached causal conv, chunk attention over a KV
arena (plain and rel-pos), `CausalFlow.inference` with streaming chunk
masks and a lookahead context, the incremental `inference_chunk` over
hop-aligned chunks (padded tails, a finalize cut short) against the JAX
`inference_chunk` and against the port's own recompute rows,
`grow_stream_state`, and HiFT's `cache_source`. Weights cross by
convert.py; the flow noise is the shared fixed buffer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.flow_decoder import _chunk_attn_bias as j_chunk_attn_bias
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.nn import attention as jatt, conv as jconv
from cosyvoice_tpu.nn.conformer import chunk_arena_mask as j_chunk_arena_mask
from cosyvoice_tpu.nn.embedding import EspnetRelPositionalEncoding as JPE
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.nn import attention as tatt, conv as tconv
from cosyvoice_tpu_torch.nn.embedding import EspnetRelPositionalEncoding
from cosyvoice_tpu_torch.ops.masks import chunk_arena_mask, chunk_attn_bias
from tests.test_torch_common import jax_flow_cfg, jax_hift_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 2e-4  # float32 mel after 3 Euler steps, as tests/test_torch_flow.py
ATOL_LEAF = 1e-5  # float32, one small module
ATOL_HIFT = 1e-4  # float32 conv stacks, as tests/test_torch_hift.py
CHUNK = 5  # jax_flow_cfg's chunk_size: the engine's hop unit
LA = 3  # pre_lookahead_len
R = 2  # token_mel_ratio


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_flow_cfg()
    jflow = JCausalFlow(jcfg)
    params = jflow.init(jax.random.PRNGKey(1))
    flow = CausalFlow(to_port_cfg(jcfg, FlowConfig), device="cpu")
    load_jax_params(flow, np_tree(params))
    return jflow, params, flow, jax.jit(jflow.inference_chunk), jax.jit(jflow.grow_stream_state,
                                                                         static_argnames=("new_arena_tok",))


# ---------------------------------------------------------------- leaves


@pytest.mark.parametrize("n,A,pos,real_n,chunk", [(5, 5, 0, 5, 5), (16, 32, 10, 5, 5), (10, 40, 20, 7, 10),
                                                  (4, 12, 8, 2, 3)])
def test_chunk_masks_match_jax(n, A, pos, real_n, chunk):
    got = chunk_arena_mask(2, n, A, pos, real_n, chunk)
    want = j_chunk_arena_mask(2, n, A, pos, real_n, chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(chunk_attn_bias(2, n, A, pos, real_n, chunk).numpy(),
                                  np.asarray(j_chunk_attn_bias(2, n, A, pos, real_n, chunk)))


@pytest.mark.parametrize("real_n", [1, 2, 4])
def test_cached_causal_conv_and_roll_cache_match_jax(real_n):
    rng = np.random.default_rng(real_n)
    cache, x = rng.standard_normal((2, 2, 4)).astype(np.float32), rng.standard_normal((2, 4, 4)).astype(np.float32)
    jmod = jconv.CausalConv1d(6, 3)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), cache=jnp.asarray(cache))
    tmod = tconv.CausalConv1d(4, 6, 3)
    load_jax_params(tmod, np_tree(params["params"]))
    want = jmod.apply(params, jnp.asarray(x), cache=jnp.asarray(cache))
    with torch.inference_mode():
        got = tmod(_t(x), _t(cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_LEAF)
    np.testing.assert_array_equal(tconv.roll_cache(_t(cache), _t(x), real_n).numpy(),
                                  np.asarray(jconv.roll_cache(jnp.asarray(cache), jnp.asarray(x), real_n)))


@pytest.mark.parametrize("rel", [True, False], ids=["rel_pos", "plain"])
@pytest.mark.parametrize("pos,arena,read", [(0, 6, "arena"), (0, 24, "arena"), (7, 24, "arena"), (7, 24, "prefix"),
                                            (18, 24, "prefix")])
def test_attend_chunk_matches_jax(rel, pos, arena, read):
    """Chunk attention over a KV arena against the JAX attend_chunk (which
    reads the whole arena): at pos 0 and past it, with an arena longer than
    the prefix, the port reading the whole arena or only its first pos+n
    rows (the rel-pos table then built for pos+n rows, its row index
    (A-1-pos) + (s-i) moving with it). The arenas hold random rows before
    pos and are written in place at [pos, pos+n)."""
    n, C, H = 6, 16, 2
    rng = np.random.default_rng(pos + arena)
    x = rng.standard_normal((1, n, C)).astype(np.float32)
    ka, va = (rng.standard_normal((1, arena, C)).astype(np.float32) for _ in range(2))
    ka[:, pos:], va[:, pos:] = 0, 0
    real_n = n - 2  # a padded tail
    jmod = (jatt.RelPositionMultiHeadAttention if rel else jatt.MultiHeadAttention)(H, C)
    tmod = (tatt.RelPositionMultiHeadAttention if rel else tatt.MultiHeadAttention)(H, C)
    jx = jnp.asarray(x)
    pe_full = JPE(C).position_encoding(0, arena)
    params = jmod.init(jax.random.PRNGKey(0), jx, jx, jx, pos_emb=JPE(C).position_encoding(0, n))
    load_jax_params(tmod, np_tree(params["params"]))
    jmask = j_chunk_arena_mask(1, n, arena, pos, real_n, 4)
    jargs = (jx, jx, jx, jnp.asarray(ka), jnp.asarray(va), pos, jmask) + ((pe_full,) if rel else ())
    want, jk, jv = jmod.apply(params, *jargs, method="attend_chunk")
    A = arena if read == "arena" else pos + n
    tk, tv = _t(ka), _t(va)
    extra = (EspnetRelPositionalEncoding(C).position_encoding(A),) if rel else ()
    with torch.inference_mode():
        got = tmod.attend_chunk(_t(x), _t(x), _t(x), tk, tv, pos, chunk_arena_mask(1, n, A, pos, real_n, 4), *extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_LEAF)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=ATOL_LEAF)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL_LEAF)


# ---------------------------------------------------------------- flow


def _stream_inputs(seed, n_tok, prompt_tok=4, pm=8):
    """Tokens (prompt first), a prompt mel of pm rows, an x-vector."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 50, n_tok).astype(np.int32)
    feat = rng.standard_normal((1, pm, 80)).astype(np.float32)
    return tokens, feat, rng.standard_normal((1, 192)).astype(np.float32)


def _recompute_args(tokens, feat, body_len, ctx, Lpad):
    tok = np.zeros((1, Lpad), np.int32)
    tok[0, :body_len] = tokens[:body_len]
    conds = np.zeros((1, Lpad * R, 80), np.float32)
    conds[:, : feat.shape[1]] = feat
    c = None if ctx is None else np.asarray(tokens[None, body_len : body_len + LA], np.int32)
    return tok, np.asarray([body_len], np.int32), conds, c


def _port_inference(flow, tok, tl, conds, emb, ctx, streaming=True):
    return flow.inference(_t(tok).long(), _t(tl), _t(conds), _t(emb), None if ctx is None else _t(ctx).long(),
                          streaming=streaming).numpy()


@pytest.mark.parametrize("context", [True, False], ids=["lookahead", "finalize"])
@pytest.mark.parametrize("body_len,Lpad", [(10, 16), (13, 32)])
def test_streaming_inference_matches_jax(pair, context, body_len, Lpad):
    """inference(streaming=True) over a full prefix, with the lookahead
    tokens scattered at the body's end or none (finalize), in a padded
    token bucket (the engine's recompute chunk)."""
    jflow, params, flow, *_ = pair
    tokens, feat, emb = _stream_inputs(body_len, 20)
    tok, tl, conds, ctx = _recompute_args(tokens, feat, body_len, context or None, Lpad)
    want = jflow.inference(params, *map(jnp.asarray, (tok, tl, conds, emb)),
                           context_token=None if ctx is None else jnp.asarray(ctx), streaming=True)
    got = _port_inference(flow, tok, tl, conds, emb, ctx)
    assert got.shape == (1, Lpad * R, 80)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    assert np.all(got[0, body_len * R :] == 0)
    # the chunk masks matter: streaming differs from offline on the same prefix
    assert np.abs(got - _port_inference(flow, tok, tl, conds, emb, ctx, streaming=False)).max() > 1e-3


def _state_pairs(state, jstate):
    """(name, port tensor, JAX array) of every leaf: the JAX estimator
    states are stacked over the Euler steps, the port's a list."""
    for k, v in state["enc"].items():
        for j, a in enumerate(v if isinstance(v, tuple) else (v,)):
            yield f"enc.{k}.{j}", a, np.asarray(jstate["enc"][k] if not isinstance(v, tuple) else jstate["enc"][k][j])
    for step, st in enumerate(state["est"]):
        for k, v in st.items():
            for j, a in enumerate(v if isinstance(v, tuple) else (v,)):
                jv = jstate["est"][k][j] if isinstance(v, tuple) else jstate["est"][k]
                yield f"est[{step}].{k}.{j}", a, np.asarray(jv)[step]


def _chunks(total, hops, final_pad):
    """[(pos, real_n, n_pad, lookahead?)] of hop-aligned chunks then a
    finalize of the rest, each padded to a multiple of 16 or by final_pad."""
    out, pos = [], 0
    for hop in hops:
        out.append((pos, hop, -(-hop // 16) * 16, True))
        pos += hop
    rest = total - pos
    out.append((pos, rest, rest + final_pad, False))
    return out


def _run_chunks(pair, tokens, feat, emb, plan, arena, grow_at=None, grow_to=None):
    """Both frameworks' inference_chunk over `plan`, the state grown before
    chunk `grow_at`. Returns [(port mel rows, JAX mel rows)], the states."""
    jflow, params, flow, jchunk, jgrow = pair
    state, jstate = flow.stream_state(1, arena), jflow.stream_state(1, arena)
    out = []
    for k, (pos, real_n, n_pad, look) in enumerate(plan):
        if k == grow_at:
            state, jstate = flow.grow_stream_state(state, grow_to), jgrow(jstate, new_arena_tok=grow_to)
        chunk = np.zeros((1, n_pad), np.int32)
        chunk[0, :real_n] = tokens[pos : pos + real_n]
        ctx = np.asarray(tokens[None, pos + real_n : pos + real_n + LA], np.int32) if look else None
        conds = np.zeros((1, n_pad * R, 80), np.float32)
        lo = pos * R
        if lo < feat.shape[1]:
            k_rows = min(feat.shape[1] - lo, n_pad * R)
            conds[0, :k_rows] = feat[0, lo : lo + k_rows]
        mel, state = flow.inference_chunk(_t(chunk).long(), None if ctx is None else _t(ctx).long(), _t(conds),
                                          _t(emb), state, pos, real_n)
        jmel, jstate = jchunk(params, jnp.asarray(chunk), None if ctx is None else jnp.asarray(ctx), jnp.asarray(conds),
                              jnp.asarray(emb), jstate, jnp.asarray(pos), jnp.asarray(real_n))
        out.append((mel.numpy()[:, : real_n * R], np.asarray(jmel)[:, : real_n * R]))
    return out, state, jstate


@pytest.mark.parametrize("hops,final_pad", [((10, 5, 10), 0), ((15, 10), 3)], ids=["exact_tail", "padded_tail"])
def test_inference_chunk_matches_jax_and_recompute(pair, hops, final_pad):
    """inference_chunk over hop-aligned chunks (the first one the prompt and
    the first hop together, as the engine's first incremental chunk), each
    padded to a multiple of 16 tokens, then a finalize of the last 4 tokens
    (padded by `final_pad`): each chunk's real rows against the JAX
    inference_chunk on the same inputs, and against the port's own streaming
    recompute of the whole prefix (the rows the engine's recompute chunk
    slices out), and the carried state against the JAX state."""
    flow = pair[2]
    total = sum(hops) + 4
    tokens, feat, emb = _stream_inputs(total, total + LA)
    plan = _chunks(total, hops, final_pad)
    outs, state, jstate = _run_chunks(pair, tokens, feat, emb, plan, 32)
    for k, ((got, want), (pos, real_n, _, look)) in enumerate(zip(outs, plan)):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f"chunk {k} against JAX")
        body = pos + real_n
        tok, tl, conds, ctx = _recompute_args(tokens, feat, body, look or None, -(-(body + LA) // 16) * 16)
        rec = _port_inference(flow, tok, tl, conds, emb, ctx)[:, pos * R : body * R]
        np.testing.assert_allclose(got, rec, rtol=0, atol=ATOL, err_msg=f"chunk {k} against the recompute")
    for name, a, b in _state_pairs(state, jstate):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL, err_msg=name)


def test_grow_stream_state_matches_jax(pair):
    """Arena growth mid-stream (32 -> 64 tokens after two chunks; the engine grows before a chunk
    would pass the arena): the grown
    state equals the JAX grown state leaf for leaf (zeros past the old
    arena), and the chunks after it equal an ungrown run's."""
    tokens, feat, emb = _stream_inputs(5, 24)
    plan = _chunks(20, (5, 5, 5), 0)
    grown, state, jstate = _run_chunks(pair, tokens, feat, emb, plan, 32, grow_at=2, grow_to=64)
    for name, a, b in _state_pairs(state, jstate):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL, err_msg=name)
    assert state["enc"]["enc_0"][0].shape[1] == 64 and state["est"][0]["down_tf_0_0"][0].shape[1] == 128
    flat, _, _ = _run_chunks(pair, tokens, feat, emb, plan, 64)
    for k, ((g, jg), (f, _)) in enumerate(zip(grown, flat)):
        np.testing.assert_allclose(g, jg, rtol=0, atol=ATOL, err_msg=f"chunk {k}")
        np.testing.assert_allclose(g, f, rtol=0, atol=ATOL, err_msg=f"chunk {k} grown vs not")
    assert CausalFlow.stream_state_nbytes(state) == sum(a.nbytes for _, _, a in _state_pairs(state, jstate))


# ---------------------------------------------------------------- HiFT


@pytest.mark.parametrize("lc", [0, 8 * 480])
def test_hift_cache_source_matches_jax(lc):
    """inference(mel, generator, cache_source): the cached source overwrites
    the head of the generated one. The source is pinned by configuration as
    in tests/test_torch_engine.py (all voiced, no noise, the fundamental
    alone), so both frameworks generate the same one."""
    jcfg = jax_hift_cfg(nsf_sigma=0.0, nsf_voiced_threshold=-1.0)
    jh = JHiFT(jcfg)
    hp = np_tree(jh.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 80)), jax.random.PRNGKey(3)))
    w = hp["params"]["m_source"]["l_linear"]["kernel"].copy()
    w[0, 0], w[1:, 0] = 1.5, 0.0
    hp["params"]["m_source"]["l_linear"]["kernel"] = w
    h = HiFTGenerator(to_port_cfg(jcfg, HiFTConfig), device="cpu")
    load_jax_params(h, hp["params"])
    rng = np.random.default_rng(lc)
    mel = (rng.standard_normal((1, 20, 80)) - 4.0).astype(np.float32)
    cache = (0.05 * rng.standard_normal((1, lc))).astype(np.float32)
    jwav, js = jh.apply(jax.tree.map(jnp.asarray, hp), jnp.asarray(mel), jax.random.PRNGKey(0),
                        cache_source=jnp.asarray(cache), method="inference")
    wav, s = h.inference(_t(mel), torch.Generator().manual_seed(0), cache_source=_t(cache))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(s.numpy()[:, :lc], cache)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), rtol=0, atol=ATOL_HIFT)
