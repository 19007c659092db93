"""The port's CosyVoice3 flow against the JAX package at tiny width, float32:
the partial rope, `DiTEstimator` offline, chunk-masked and in its
incremental `stream` form, `DiTFlowEncoder`, and `CausalFlow.inference` /
`inference_chunk` in the DiT layout (chunked == the chunk-masked
recompute). Both sides take one JAX param tree, carried across by
convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.dit import apply_partial_rope as j_rope
from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.dit import apply_partial_rope, dit_stream_state
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from tests.test_torch_common import jax_dit_flow_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 1e-4  # float32 DiT blocks, different summation orders
CHUNK = 5  # tokens; the DiT's chunk mask is 10 mel frames


@pytest.fixture(scope="module")
def flows():
    jcfg = jax_dit_flow_cfg()
    jflow = JCausalFlow(jcfg)
    params = jflow.init(jax.random.PRNGKey(0))
    flow = CausalFlow(to_port_cfg(jcfg, FlowConfig), device="cpu")
    load_jax_params(flow, np_tree(params))
    return jflow, params, flow


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_partial_rope_rotates_only_head_dims_as_jax():
    x = np.random.default_rng(0).standard_normal((2, 7, 32)).astype(np.float32)
    y = apply_partial_rope(_t(x), 8).numpy()
    np.testing.assert_allclose(y, np.asarray(j_rope(jnp.asarray(x), 8)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y[..., 8:], x[..., 8:])
    np.testing.assert_allclose(y[:, 0, :8], x[:, 0, :8], atol=1e-6)  # position 0 unrotated
    # the offset form is the full table's rows
    np.testing.assert_allclose(apply_partial_rope(_t(x[:, 3:]), 8, pos=3).numpy(), y[:, 3:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(j_rope(jnp.asarray(x), 8, pos=0, max_len=16)), rtol=0, atol=1e-6)


def test_dit_flow_names_round_trip(flows):
    _, params, flow = flows
    tree = export_params(flow)
    for part in ("encoder", "estimator"):
        a = dict(jax.tree_util.tree_leaves_with_path(np_tree(params[part])))
        b = dict(jax.tree_util.tree_leaves_with_path(tree[part]))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert "blocks_1" in tree["estimator"]["params"] and "conv_pos" in tree["estimator"]["params"]


def _est_inputs(rng, B, T):
    return dict(
        x=rng.standard_normal((B, T, 80)).astype(np.float32),
        mu=rng.standard_normal((B, T, 80)).astype(np.float32),
        t=rng.random(B).astype(np.float32),
        spks=rng.standard_normal((B, 80)).astype(np.float32),
        cond=rng.standard_normal((B, T, 80)).astype(np.float32),
    )


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "chunk_masked"])
def test_dit_estimator_matches_jax(flows, streaming):
    jflow, params, flow = flows
    rng = np.random.default_rng(1)
    B, T = 2, 23
    inp = _est_inputs(rng, B, T)
    mask = np.ones((B, T), np.float32)
    mask[1, 17:] = 0.0  # a padded row
    want = jflow.estimator.apply(params["estimator"], jnp.asarray(inp["x"]), jnp.asarray(mask),
                                 jnp.asarray(inp["mu"]), jnp.asarray(inp["t"]), jnp.asarray(inp["spks"]),
                                 jnp.asarray(inp["cond"]), streaming)
    with torch.inference_mode():
        got = flow.estimator(_t(inp["x"]), _t(mask), _t(inp["mu"]), _t(inp["t"]), _t(inp["spks"]),
                             _t(inp["cond"]), streaming)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not got[1, 17:].any()


def test_dit_block_fully_masked_rows_match_jax(flows):
    """A query row whose every key is masked: JAX's -1e30 scores give
    uniform weights; the port's additive -1e30 bias gives the same, not NaN."""
    from cosyvoice_tpu.models.dit import DiTBlock as JDiTBlock
    from cosyvoice_tpu_torch.models.dit import _attn_bias, rope_tables

    _, params, flow = flows
    cfg = flow.estimator.cfg
    rng = np.random.default_rng(2)
    B, T = 2, 9
    x = rng.standard_normal((B, T, cfg.dim)).astype(np.float32)
    t_emb = rng.standard_normal((B, cfg.dim)).astype(np.float32)
    mask = rng.random((B, T, T)) > 0.4
    mask[0, 3] = False
    mask[1, :] = False
    bp = {"params": params["estimator"]["params"]["blocks_0"]}
    want = JDiTBlock(jax_dit_flow_cfg().dit).apply(bp, jnp.asarray(x), jnp.asarray(t_emb), jnp.asarray(mask))
    with torch.inference_mode():
        got = flow.estimator.blocks[0](_t(x), _t(t_emb), _attn_bias(torch.from_numpy(mask)),
                                       rope_tables(cfg.dim_head, T))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_dit_estimator_stream_matches_jax_and_recompute(flows):
    """Chunks through the stream form over carried arenas: each equals the
    JAX stream form's chunk and the chunk-masked recompute's rows."""
    jflow, params, flow = flows
    cfg = flow.estimator.cfg
    rng = np.random.default_rng(4)
    B, T, A = 2, 30, 40
    inp = _est_inputs(rng, B, T)
    inp["t"] = np.full(B, 0.3, np.float32)
    with torch.inference_mode():
        full = flow.estimator(_t(inp["x"]), torch.ones(B, T), _t(inp["mu"]), _t(inp["t"]), _t(inp["spks"]),
                              _t(inp["cond"]), True).numpy()
    from cosyvoice_tpu.models.dit import dit_stream_state as j_state

    jst = j_state(jflow.estimator.cfg, B, A)
    st = dit_stream_state(cfg, B, A)
    pos = 0
    for real_n, n_pad in ((10, 16), (10, 10), (7, 16)):  # the last chunk ends mid chunk-mask
        sl = {k: np.zeros((B, n_pad, 80), np.float32) for k in ("x", "mu", "cond")}
        for k in sl:
            sl[k][:, :real_n] = inp[k][:, pos : pos + real_n]
        ones = np.ones((B, n_pad), np.float32)
        jout, jst = jflow.estimator.apply(params["estimator"], jnp.asarray(sl["x"]), jnp.asarray(ones),
                                          jnp.asarray(sl["mu"]), jnp.asarray(inp["t"]), jnp.asarray(inp["spks"]),
                                          jnp.asarray(sl["cond"]), False, (jst, pos, real_n))
        with torch.inference_mode():
            out, st = flow.estimator(_t(sl["x"]), _t(ones), _t(sl["mu"]), _t(inp["t"]), _t(inp["spks"]),
                                     _t(sl["cond"]), stream=(st, pos, real_n))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
        assert not out[:, real_n:].any()
        # the recompute's rows, where the chunk ends on a chunk-mask boundary
        if (pos + real_n) % cfg.static_chunk_size == 0:
            np.testing.assert_allclose(out[:, :real_n].numpy(), full[:, pos : pos + real_n], rtol=0, atol=ATOL)
        pos += real_n
    np.testing.assert_allclose(st["blocks_1"][0].numpy(), np.asarray(jst["blocks_1"][0]), rtol=0, atol=ATOL)


def _body(rng, L, vocab=50):
    return rng.integers(0, vocab, (1, L))


@pytest.mark.parametrize("finalize", [True, False])
def test_dit_flow_encoder_matches_jax(flows, finalize):
    jflow, params, flow = flows
    rng = np.random.default_rng(5)
    tok = np.zeros((2, 16), np.int64)
    tok[0, :12] = _body(rng, 12)
    tok[1, :9] = _body(rng, 9)
    lens = np.asarray([12, 9])
    ctx = None if finalize else _body(rng, 3).repeat(2, 0)
    mu, mask = jflow.encoder.apply(params["encoder"], jnp.asarray(tok, jnp.int32), jnp.asarray(lens),
                                   None if ctx is None else jnp.asarray(ctx, jnp.int32))
    with torch.inference_mode():
        pmu, pmask = flow.encoder(_t(tok, torch.long), _t(lens, torch.long),
                                  None if ctx is None else _t(ctx, torch.long))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), rtol=0, atol=ATOL)


def _prefix(rng, n_prompt=5, n_body=20):
    return dict(prompt_token=_body(rng, n_prompt), token=_body(rng, n_body),
                prompt_feat=rng.random((1, 2 * n_prompt, 80)).astype(np.float32),
                emb=rng.standard_normal((1, 192)).astype(np.float32))


def _run_inference(jflow, params, flow, p, tokens, finalize, streaming=True):
    """Both flows over prompt + tokens (the last 3 the lookahead unless
    finalize), padded; mel past the prompt to the body's end."""
    la = 3
    full = np.concatenate([p["prompt_token"], tokens], axis=1)
    body, ctx = (full, None) if finalize else (full[:, :-la], full[:, -la:])
    body_p = np.concatenate([body, np.zeros((1, 2 * la), body.dtype)], axis=1)
    conds = np.zeros((1, body_p.shape[1] * 2, 80), np.float32)
    conds[:, : p["prompt_feat"].shape[1]] = p["prompt_feat"]
    want = jflow.inference(params, jnp.asarray(body_p, jnp.int32), jnp.asarray([body.shape[1]]), jnp.asarray(conds),
                           jnp.asarray(p["emb"]), None if ctx is None else jnp.asarray(ctx, jnp.int32),
                           streaming=streaming)
    got = flow.inference(_t(body_p, torch.long), torch.tensor([body.shape[1]]), _t(conds), _t(p["emb"]),
                         None if ctx is None else _t(ctx, torch.long), streaming)
    lo, hi = p["prompt_feat"].shape[1], body.shape[1] * 2
    return got.numpy()[:, lo:hi], np.asarray(want)[:, lo:hi]


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
def test_causal_flow_inference_matches_jax(flows, streaming):
    jflow, params, flow = flows
    p = _prefix(np.random.default_rng(6))
    got, want = _run_inference(jflow, params, flow, p, p["token"], finalize=True, streaming=streaming)
    assert got.shape == (1, 40, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_inference_chunk_equals_recompute_and_jax(flows):
    """The incremental DiT flow, chunk by chunk over carried arenas (grown
    once on the way), equals the chunk-masked recompute's new rows and the
    JAX inference_chunk."""
    jflow, params, flow = flows
    p = _prefix(np.random.default_rng(7))
    r, la = 2, 3
    all_tok = np.concatenate([p["prompt_token"], p["token"]], axis=1)[0]
    pm = p["prompt_feat"].shape[1]
    st = flow.stream_state(1, 16)
    jst = jflow.stream_state(1, 16)
    consumed = 0
    bounds = [10, 20, len(all_tok)]  # body tokens through the chunk (lookahead after it)
    for i, end in enumerate(bounds):
        finalize = i == len(bounds) - 1
        n_real = end - consumed
        n_pad = -(-n_real // 16) * 16
        chunk = np.zeros((1, n_pad), np.int64)
        chunk[0, :n_real] = all_tok[consumed:end]
        ctx = None if finalize else all_tok[None, end : end + la]
        conds = np.zeros((1, n_pad * r, 80), np.float32)
        lo = consumed * r
        if lo < pm:
            k = min(pm - lo, n_pad * r)
            conds[0, :k] = p["prompt_feat"][0, lo : lo + k]
        if consumed + n_pad > flow.stream_arena_tok(st):
            st = flow.grow_stream_state(st, 2 * flow.stream_arena_tok(st))
            jst = jflow.grow_stream_state(jst, 2 * jst["est"]["blocks_0"][0].shape[2] // r)
        mel, st = flow.inference_chunk(_t(chunk, torch.long), None if ctx is None else _t(ctx, torch.long),
                                       _t(conds), _t(p["emb"]), st, consumed, n_real)
        jmel, jst = jflow.inference_chunk(params, jnp.asarray(chunk, jnp.int32),
                                          None if ctx is None else jnp.asarray(ctx, jnp.int32), jnp.asarray(conds),
                                          jnp.asarray(p["emb"]), jst, consumed, n_real)
        np.testing.assert_allclose(mel.numpy()[:, : n_real * r], np.asarray(jmel)[:, : n_real * r], rtol=0,
                                   atol=ATOL)
        with torch.inference_mode():
            body_p = np.zeros((1, end + 2 * la), np.int64)
            body_p[0, :end] = all_tok[:end]
            conds_f = np.zeros((1, body_p.shape[1] * r, 80), np.float32)
            conds_f[:, :pm] = p["prompt_feat"]
            rec = flow.inference(_t(body_p, torch.long), torch.tensor([end]), _t(conds_f), _t(p["emb"]),
                                 None if ctx is None else _t(ctx, torch.long), True).numpy()
        np.testing.assert_allclose(mel.numpy()[:, : n_real * r], rec[:, consumed * r : end * r], rtol=0,
                                   atol=2e-3)
        consumed = end
    assert flow.stream_arena_tok(st) == 64  # 16 -> 32 -> 64 tokens
    assert CausalFlow.stream_state_nbytes(st) > 0
