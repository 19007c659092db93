"""Bi-streaming text input of the port's LM against the JAX package at tiny
width, float32: `extend_mixed` segment by segment, and the greedy token
stream of `generate_bistream` with its feed schedule (start, rows and arena
length of every extend) and its per-span routes, for the three LMs: bf16;
int4p weights over an int8 KV arena; int4p weights over a bf16 arena, whose
spans decode through K7 (the JAX LM through its Pallas kernel in interpret
mode, `COSY_INT4_BLOCK=force`). The port's extends of 2..16 rows run the K4
and K5 wrappers' plain versions on CPU, the JAX CPU path runs XLA.

The fill token's head bias is shifted to steer the three regimes of the
schedule: as initialised; raised, so that fills are sampled and the arena
rolls back over them; lowered, so that only the forced cadence ends spans."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm import TYPE_SPEECH, TYPE_TEXT, Qwen2LM as JQwen2LM
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from tests.test_torch_common import jax_lm_cfg, np_tree, to_port_cfg
from tests.test_torch_lm import ATOL, ATOL_K7, ATOL_KV8, _quant_pair, _record_routes, _small_buckets

torch.set_num_threads(1)

LMS = ["bf16", "int4p_kv8", "int4p_bf16"]
# extend logits limits per LM, as tests/test_torch_lm.py states them: float32
# through 2 layers (no extend runs K7); a flipped int8 KV step
EXTEND_ATOL = {"bf16": ATOL, "int4p_kv8": ATOL_KV8, "int4p_bf16": ATOL}


def _bf16_pair():
    jcfg = jax_lm_cfg(top_k=1, tau_r=2.0)
    jlm = JQwen2LM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    lm = Qwen2LM(to_port_cfg(jcfg, LMConfig), device="cpu")
    load_jax_params(lm.module, np_tree(params["params"]))
    return jlm, params, lm


@pytest.fixture(scope="module", params=LMS)
def lm_pair(request):
    kind = request.param
    pair = _bf16_pair() if kind == "bf16" else _quant_pair("int4p", kv_quant=kind == "int4p_kv8")
    return (kind,) + pair


def _with_fill_bias(jlm, params, lm, shift):
    """JAX params with `shift` added to the fill row of the head bias, loaded
    into the port too (the fixture's tree is left as it is)."""
    head = dict(params["params"]["llm_decoder"])
    bias = np.array(head["bias"])
    bias[lm.cfg.fill_token] += shift
    head["bias"] = jnp.asarray(bias)
    shifted = {"params": {**params["params"], "llm_decoder": head}}
    load_jax_params(lm.module, np_tree(shifted["params"]))
    return shifted


@pytest.fixture
def restore(lm_pair):
    """Reload the fixture's weights into the port after a test that shifts them."""
    yield
    _, _, params, lm = lm_pair
    load_jax_params(lm.module, np_tree(params["params"]))


def _segment(rng, n):
    types = rng.integers(0, 3, n)
    ids = np.where(types == TYPE_TEXT, rng.integers(0, 100, n), rng.integers(0, 20, n))
    return ids.astype(np.int32), types.astype(np.int32)


def test_extend_mixed_matches_jax_segment_by_segment(lm_pair, monkeypatch):
    """Segments of 1, 5, 15, 16 and 17 rows appended one after another: the
    one-row segment takes the decode step's route, 5..16 rows K4 and K5 in
    the int4p LMs (plain on CPU), 17 rows the blocked matmuls. The logits
    after each segment and the arena rows written so far match JAX's."""
    kind, jlm, params, lm = lm_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    rng = np.random.default_rng(0)
    A, atol, start = 96, EXTEND_ATOL[kind], 0
    jcache, cache = jlm.init_cache(1, length=A), lm.init_cache(1, A)
    for S in (1, 5, 15, 16, 17):
        ids, types = _segment(rng, S)
        jlogits, jcache = jlm._jit_extend(params, jnp.asarray(ids[None]), jnp.asarray(types[None]),
                                          jnp.asarray([start]), jcache)
        with torch.inference_mode():
            logits, cache = lm.module.extend_mixed(torch.from_numpy(ids[None]).long(),
                                                   torch.from_numpy(types[None]).long(), start, cache)
        start += S
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=atol)
        if kind == "int4p_kv8":
            # equal int8 rows but for steps flipped at a rounding boundary
            dk = cache[0][:, :, :start].int() - torch.from_numpy(np.array(jcache[0])[:, :, :start]).int()
            assert dk.abs().max() <= 1 and (dk != 0).float().mean() < 1e-3
            np.testing.assert_allclose(cache[2][:, :, :start].numpy(), np.asarray(jcache[2])[:, :, :start], rtol=1e-5)
        else:
            np.testing.assert_allclose(cache[0][:, :, :start].numpy(), np.asarray(jcache[0])[:, :, :start],
                                       rtol=0, atol=atol)
        assert not cache[0][:, :, start:].any()


def _chunks(text):
    """Uneven chunks of `text`, sizes cycling 3, 7, 0 (an empty chunk), 1, 11."""
    out, i, k = [], 0, 0
    while i < len(text):
        n = (3, 7, 0, 1, 11)[k % 5]
        out.append(text[i : i + n])
        i, k = i + n, k + 1
    return out


def _request(seed, n_text, n_speech):
    rng = np.random.default_rng(seed)
    return (_chunks(rng.integers(0, 100, n_text).astype(np.int32)), rng.integers(0, 100, 4).astype(np.int32),
            rng.integers(0, 20, n_speech).astype(np.int32))


def _record(monkeypatch, jlm, lm):
    """Both LMs' extends [(start, ids, types, arena rows)] and the port's
    bistream spans [(tokens, sampled a fill?)]."""
    rec = {"jax": [], "port": [], "spans": []}
    jext, text, block = jlm._jit_extend, lm.module.extend_mixed, lm._decode_block

    def jax_extend(p, ids, types, start, cache):
        rec["jax"].append((int(start[0]), np.asarray(ids)[0].tolist(), np.asarray(types)[0].tolist(),
                           cache[0].shape[2]))
        return jext(p, ids, types, start, cache)

    def port_extend(ids, types, start, cache):
        rec["port"].append((start, ids[0].tolist(), types[0].tolist(), cache[0].shape[2]))
        return text(ids, types, start, cache)

    def port_block(*args):
        out = block(*args)
        if args[-1]:  # bistream span
            toks = out[0][0]
            rec["spans"].append((len(toks), bool((toks == lm.cfg.fill_token).any())))
        return out

    monkeypatch.setattr(jlm, "_jit_extend", jax_extend)
    monkeypatch.setattr(lm.module, "extend_mixed", port_extend)
    monkeypatch.setattr(lm, "_decode_block", port_block)
    return rec


def _both(jlm, params, lm, req, max_len):
    chunks, prompt_text, prompt_speech = req
    want = list(jlm.generate_bistream(params, iter(chunks), prompt_text, prompt_speech, jax.random.PRNGKey(0),
                                      max_len=max_len))
    got = list(lm.generate_bistream(iter(chunks), prompt_text, prompt_speech, torch.Generator().manual_seed(0),
                                    max_len=max_len))
    cat = lambda blocks: np.concatenate(blocks) if blocks else np.zeros(0, np.int32)  # noqa: E731
    return cat(want), cat(got)


# (fill bias shift, prompt speech tokens): the plain head; the fill raised so
# that fills are sampled; lowered so that only the cadence forces them; and a
# voice prompt of more speech (150 tokens) than the 44 text tokens can
# interleave (8 pairs take 120), whose rest is never fed, as in the reference
REGIMES = {"plain": (0.0, 20), "sampled_fills": (1.25, 20), "forced_fills": (-100.0, 20), "long_prompt": (0.0, 150)}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_greedy_bistream_matches_jax(lm_pair, restore, monkeypatch, regime):
    """Equal token streams, equal extends (start, ids, types, arena rows) and
    equal per-span routes, with a 32-row arena bucket and MAX_FUSED_ARENA 96
    on both sides, so that the arena grows from 32 rows and the int4p LM over
    a bf16 arena crosses from K7 to the per-layer kernels."""
    kind, jlm, params, lm = lm_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    shift, n_speech = REGIMES[regime]
    params = _with_fill_bias(jlm, params, lm, shift)
    _small_buckets(monkeypatch, jlm, lm, 128)
    for obj in (jlm, lm):
        monkeypatch.setattr(obj, "ARENA_BUCKET", 64)
    routes = _record_routes(monkeypatch, jlm, lm)
    rec = _record(monkeypatch, jlm, lm)
    want, got = _both(jlm, params, lm, _request(2, 40, n_speech), max_len=80)
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0
    assert rec["port"] == rec["jax"] and routes["port"] == routes["jax"]
    arenas = [r[3] for r in rec["port"]]
    assert arenas == sorted(arenas) and arenas[0] == 64 and arenas[-1] > 64
    sampled = sum(f for _, f in rec["spans"])
    if regime == "sampled_fills":
        assert sampled >= 2
    elif regime == "forced_fills":
        assert sampled == 0 and len(rec["spans"]) >= 5
    elif regime == "long_prompt":
        fed_speech = sum(t == TYPE_SPEECH for r in rec["port"] for t in r[2])
        assert fed_speech < n_speech
    if kind == "int4p_bf16":
        fused = [f for _, f in routes["port"]]
        assert fused == sorted(fused, reverse=True)  # K7 while the arena holds <= 128 rows, then per-layer


def _replay(jlm, params, lm, feeds, tokens, A=256):
    """Teacher-forced replay of a recorded bistream run over an arena of A
    rows (K7 on both sides): every extend, then the run's tokens fed one per
    step at the positions up to the next extend's start. Returns the JAX and
    port logits after every extend and step."""
    from cosyvoice_tpu.ops.int4_block import stack_decode_params as jstack

    jstep = jax.jit(lambda p, t, c, cache, st: jlm.module.apply(p, t, c, cache, st, method="decode_step_fused"))
    jstacked = jstack([params["params"]["llm"][f"layers_{i}"] for i in range(lm.cfg.qwen.num_layers)])
    jcache, cache = jlm.init_cache(1, length=A), lm.init_cache(1, A)
    stacked = lm._decode_pack(cache)
    assert stacked is not None
    out, k = [], 0
    for i, (start, ids, types, _) in enumerate(feeds):
        jl, jcache = jlm._jit_extend(params, jnp.asarray([ids]), jnp.asarray([types]), jnp.asarray([start]), jcache)
        with torch.inference_mode():
            tl, cache = lm.module.extend_mixed(torch.tensor([ids]), torch.tensor([types]), start, cache)
        out.append((np.asarray(jl)[0], tl.numpy()[0]))
        pos = start + len(ids)
        end = feeds[i + 1][0] if i + 1 < len(feeds) else pos + len(tokens) - k
        for pos in range(pos, end):
            tok = int(tokens[k])
            k += 1
            jl, jcache = jstep(params, jnp.asarray([tok]), jnp.asarray([pos]), jcache, jstacked)
            with torch.inference_mode():
                tl, cache = lm.module.decode_step_fused(torch.tensor([tok]), torch.tensor([pos], dtype=torch.int32),
                                                        cache, stacked)
            out.append((np.asarray(jl)[0], tl.numpy()[0]))
    assert k == len(tokens)
    return out


@pytest.mark.parametrize("lm_pair", ["int4p_bf16"], indirect=True)
def test_int4p_bistream_near_tie_is_bounded(lm_pair, restore, monkeypatch):
    """The int4p LM over a bf16 arena with the fill raised by 0.25, on a
    request where the two greedy streams part (the JAX Pallas K7 and the
    port's plain K7 differ at bf16 level): JAX's run replayed teacher-forced
    through both LMs' extends and K7 steps. Logits agree within ATOL_K7, and
    the next-token choice (among the speech tokens and the fill, the stop the
    spans allow) agrees except where JAX's top-two margin is below the
    logits' difference: one step of this run."""
    _, jlm, params, lm = lm_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    params = _with_fill_bias(jlm, params, lm, 0.25)
    rec = _record(monkeypatch, jlm, lm)
    chunks, prompt_text, prompt_speech = _request(1, 40, 20)
    want = np.concatenate(list(jlm.generate_bistream(params, iter(chunks), prompt_text, prompt_speech,
                                                     jax.random.PRNGKey(0), max_len=80)))
    allowed = np.arange(lm.cfg.head_size) <= lm.cfg.fill_token
    allowed[lm.cfg.speech_token_size : lm.cfg.fill_token] = False
    flips = 0
    for j, t in _replay(jlm, params, lm, list(rec["jax"]), want):
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL_K7)
        jm, tm = np.where(allowed, j, -np.inf), np.where(allowed, t, -np.inf)
        if jm.argmax() != tm.argmax():
            top2 = np.sort(jm)[-2:]
            assert top2[1] - top2[0] <= np.abs(t - j).max()
            flips += 1
    assert flips <= 1


@pytest.mark.parametrize("lm_pair", ["bf16"], indirect=True)
def test_bistream_stops_at_the_arena_end_like_jax_until_then(lm_pair, caplog):
    """max_cache_len 64: the JAX LM writes past its 64 rope rows (its
    `dynamic_slice` clamps), the port ends the stream at the arena's end
    with a warning. Its tokens are the JAX stream's first ones."""
    import dataclasses

    _, jlm, params, lm = lm_pair
    jcfg = dataclasses.replace(jlm.cfg, qwen=dataclasses.replace(jlm.cfg.qwen, max_cache_len=64))
    small_jlm = JQwen2LM(jcfg)
    small = Qwen2LM(to_port_cfg(jcfg, LMConfig), device="cpu")
    load_jax_params(small.module, np_tree(params["params"]))
    with caplog.at_level(logging.WARNING):
        want, got = _both(small_jlm, params, small, _request(1, 40, 20), max_len=80)
    assert any("passes the KV arena's end" in r.getMessage() for r in caplog.records)
    assert 0 < len(got) < len(want)
    np.testing.assert_array_equal(got, want[: len(got)])
