"""Continuous batching in the port (runtime/batch_scheduler.py) against the
JAX package at tiny width, float32, on the CPU (the kernel wrappers' plain
versions): the ragged decode step at B=2 against the JAX
`decode_step_ragged` and teacher-forced `forward_logits`; greedy session
streams (top_k 1, RAS resample off) against the JAX LMBatchScheduler's,
slot reuse included, for the three LMs (bf16 weights, here float32; int4p
over an int8 arena; int4p over a float arena, whose batched steps never
take K7); the repetition penalty's per-slot presence sets; the capacity
clamp the JAX scheduler lacks (ROADMAP C4); the thread mode (start, stop,
a failing step); a bistream request beside a running scheduler; the engine
and the API with a scheduler (concurrent sessions, streamed and offline,
against the JAX engine's single-session output; concurrent segments in
order); `tts(rng_seed=...)`."""

import dataclasses
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT, Qwen2LM as JQwen2LM
from cosyvoice_tpu.runtime.batch_scheduler import LMBatchScheduler as JScheduler
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.runtime.batch_scheduler import LMBatchScheduler
from tests.test_torch_common import np_tree
from tests.test_torch_lm import ATOL, ATOL_KV8, _quant_pair

torch.set_num_threads(1)

LMS = ["bf16", "int4p_kv8", "int4p_bf16"]
HANG_S = 60.0  # a handle still open after this long has hung


def _pair(kind):
    from tests.test_torch_bistream import _bf16_pair

    if kind == "bf16":
        return _bf16_pair()
    if kind == "kv8":
        return _quant_pair(False)
    return _quant_pair("int4p", kv_quant=kind == "int4p_kv8")


@pytest.fixture(scope="module", params=LMS)
def lm_pair(request):
    return (request.param,) + _pair(request.param)


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair("bf16")


def _prompt(seed, n_text=4, n_speech=3):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([[0], rng.integers(0, 100, n_text), [1], rng.integers(0, 20, n_speech)]).astype(np.int32)
    types = np.concatenate([[TYPE_SPECIAL], np.full(n_text, TYPE_TEXT), [TYPE_SPECIAL],
                            np.full(n_speech, TYPE_SPEECH)]).astype(np.int32)
    return ids, types


def _cat(blocks):
    return np.concatenate(blocks) if blocks else np.zeros(0, np.int32)


def _drive(sched, requests):
    """Submit (ids, types, min_len, max_len) in order and step the scheduler
    until every session ended; each session's tokens."""
    handles = [sched.submit(*r) for r in requests]
    for _ in range(10_000):
        if not (sched.step() or sched.n_active or not sched.pending.empty()):
            break
    return [_cat(list(h)) for h in handles]


def _jax_sessions(jlm, params, requests, max_batch):
    return _drive(JScheduler(jlm, params, max_batch=max_batch, seed=0), requests)


# ---------------------------------------------------------------- the ragged step


@pytest.mark.parametrize("kind", ["fp32", "kv8", "int4p_kv8", "int4p"])
def test_ragged_decode_matches_jax(kind):
    """Rows at lengths 7 and 12 decode 4 teacher-forced steps together: the
    port's one decode step (rope gathered and the arena written at each
    row's own position) gives the JAX decode_step_ragged's logits, and the
    JAX teacher-forced forward's as closely as the JAX step does."""
    jlm, params, lm = _pair({"fp32": "bf16", "int4p": "int4p_bf16"}.get(kind, kind))
    atol = ATOL_KV8 if lm.cfg.qwen.kv_quant else ATOL
    rng = np.random.default_rng(5)
    lens, n_steps = [7, 12], 4
    T_full = max(lens) + n_steps
    full_ids = rng.integers(0, 20, (2, T_full)).astype(np.int32)
    full_types = np.full((2, T_full), TYPE_SPEECH, np.int32)
    lengths = np.array([n + n_steps for n in lens], np.int32)
    fwd = np.asarray(jlm.module.apply(params, jnp.asarray(full_ids), jnp.asarray(full_types), jnp.asarray(lengths),
                                      method="forward_logits"))
    ids = np.zeros((2, 16), np.int32)
    types = np.full((2, 16), TYPE_SPEECH, np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = full_ids[b, :n]
    jcache = jlm.init_cache(2, length=64)
    jlogits, jcache = jlm.module.apply(params, jnp.asarray(ids), jnp.asarray(types), jnp.asarray(lens), jcache,
                                       method="prefill")
    cache = lm.init_cache(2, 64)
    with torch.inference_mode():
        logits, cache = lm.module.prefill(torch.from_numpy(ids).long(), torch.from_numpy(types).long(),
                                          torch.tensor(lens), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=atol)
        for s in range(n_steps):
            tok = np.array([full_ids[b, lens[b] + s] for b in range(2)], np.int32)
            cur = np.array([lens[b] + s for b in range(2)], np.int32)
            jlogits, jcache = jlm.module.apply(params, jnp.asarray(tok), jnp.asarray(cur), jcache,
                                               method="decode_step_ragged")
            logits, cache = lm.module.decode_step(torch.from_numpy(tok), torch.from_numpy(cur), cache)
            got, want = logits.numpy(), np.asarray(jlogits)
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"step {s}")
            for b, n in enumerate(lens):
                teacher = fwd[b, n + s]
                # the int8 arena's quantisation moves both steps off the float forward alike
                limit = atol + np.abs(want[b] - teacher).max() if lm.cfg.qwen.kv_quant else atol
                assert np.abs(got[b] - teacher).max() <= limit, f"row {b} step {s} against the forward"


# ---------------------------------------------------------------- greedy sessions


def test_lone_session_matches_jax_scheduler_and_generate(lm_pair):
    """A lone session in a 4-slot scheduler: the JAX scheduler's tokens and
    the port's own B=1 `generate`'s."""
    kind, jlm, params, lm = lm_pair
    ids, types = _prompt(0)
    want = _jax_sessions(jlm, params, [(ids, types, 8, 40)], 4)[0]
    alone = _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(0), 8, 40)))
    fused = lm.fused_steps
    (got,) = _drive(LMBatchScheduler(lm, max_batch=4), [(ids, types, 8, 40)])
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, alone)
    assert lm.fused_steps == fused  # a batched step never takes K7


def test_three_sessions_on_two_slots_match_jax_scheduler(lm_pair):
    """3 sessions on 2 slots, submitted in one order: the third waits for a
    freed slot; every session's tokens equal the JAX scheduler's. The int4p
    LM over a float arena takes the per-layer kernels at B=2, never K7."""
    kind, jlm, params, lm = lm_pair
    reqs = [_prompt(s, n_text=3 + s) + (4, 20 + 8 * s) for s in range(3)]
    want = _jax_sessions(jlm, params, reqs, 2)
    steps, fused = lm.decode_steps, lm.fused_steps
    sched = LMBatchScheduler(lm, max_batch=2)
    got = _drive(sched, reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert 0 < len(g) <= reqs[i][3]
        np.testing.assert_array_equal(g, w, err_msg=f"session {i}")
    assert lm.decode_steps > steps and lm.fused_steps == fused
    assert sched.n_active == 0 and all(s is None for s in sched.slots)


def test_repetition_penalty_per_slot_matches_jax(bf16_pair):
    """repetition_penalty 1.1 (greedy): each slot's presence set starts with
    its own prompt's speech tokens and marks its own tokens; 3 sessions on
    2 slots give the JAX scheduler's tokens."""
    jlm, params, lm = bf16_pair
    jlm_p = JQwen2LM(dataclasses.replace(jlm.cfg, repetition_penalty=1.1))
    saved = lm.cfg
    lm.cfg = dataclasses.replace(lm.cfg, repetition_penalty=1.1)
    try:
        reqs = [_prompt(10 + s, n_text=3, n_speech=6 + 3 * s) + (4, 32) for s in range(3)]
        want = _jax_sessions(jlm_p, params, reqs, 2)
        sched = LMBatchScheduler(lm, max_batch=2)
        got = _drive(sched, reqs)
    finally:
        lm.cfg = saved
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"session {i}")
    assert sched.decoder.state.seen is not None and sched.decoder.state.seen.shape == (2, lm.cfg.head_size)
    # the penalty changed some stream (the comparison is not vacuous)
    unpenalised = _drive(LMBatchScheduler(lm, max_batch=2), reqs)
    assert any(not np.array_equal(a, b) for a, b in zip(unpenalised, got))


def _no_stops(jlm, params, lm):
    """JAX params with the stop rows' head bias lowered by 100 (loaded into
    the port too), so that greedy streams run to max_len."""
    head = dict(params["params"]["llm_decoder"])
    bias = np.array(head["bias"])
    bias[lm.cfg.speech_token_size:] -= 100.0
    head["bias"] = jnp.asarray(bias)
    shifted = {"params": {**params["params"], "llm_decoder": head}}
    load_jax_params(lm.module, np_tree(shifted["params"]))
    return shifted


def test_capacity_clamp(bf16_pair, caplog):
    """A session whose max_len passes the arena (max_cache_len 256, prompt
    padded to 128 rows: 120 tokens fit in whole blocks of 8) ends there with
    the warning `generate` gives; its tokens are the JAX scheduler's up to
    that point (the JAX one runs on with its writes clamped at the arena's
    end: ROADMAP C4's fourth intended difference)."""
    jlm, params, lm = bf16_pair
    shifted = _no_stops(jlm, params, lm)
    try:
        ids, types = _prompt(3)
        want = _jax_sessions(jlm, shifted, [(ids, types, 0, 300)], 2)[0]
        with caplog.at_level(logging.WARNING):
            (got,) = _drive(LMBatchScheduler(lm, max_batch=2), [(ids, types, 0, 300)])
    finally:
        load_jax_params(lm.module, np_tree(params["params"]))
    assert len(want) == 300
    assert len(got) == 120
    np.testing.assert_array_equal(got, want[:120])
    assert any("exceeds KV arena capacity" in r.message and "clamping to 120" in r.message for r in caplog.records)


# ---------------------------------------------------------------- the thread


def _consume(handles, timeout=HANG_S):
    """Each handle drained on a thread of its own: (tokens or the exception) per handle."""
    out = [None] * len(handles)

    def run(i):
        try:
            out[i] = _cat(list(handles[i]))
        except Exception as e:  # noqa: BLE001 — returned to the test
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(handles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a session handle hung"
    return out


def test_thread_mode_reuses_slots_and_stop_closes_handles(bf16_pair):
    jlm, params, lm = bf16_pair
    reqs = [_prompt(20 + s) + (4, 16 + 8 * s) for s in range(3)]
    want = _drive(LMBatchScheduler(lm, max_batch=2), reqs)
    sched = LMBatchScheduler(lm, max_batch=2)
    sched.start()
    try:
        first = _consume([sched.submit(*r) for r in reqs[:2]])
        late = _consume([sched.submit(*reqs[2])])  # after the first wave: a freed slot
    finally:
        sched.stop()
    for g, w in zip(first + late, want):
        np.testing.assert_array_equal(g, w)
    # stop() closes live and pending handles: one slot, three sessions, one step
    sched = LMBatchScheduler(lm, max_batch=1)
    handles = [sched.submit(*r[:3], 200) for r in reqs]
    sched.step()
    assert sched.n_active == 1 and sched.pending.qsize() == 2
    sched.stop()
    live, *pending = _consume(handles)
    assert 0 < len(live) <= 8 and all(len(p) == 0 for p in pending)


def test_closed_handle_frees_its_slot(bf16_pair):
    """A consumer that closes its handle's iterator after the first block
    (a dropped stream or client) cancels its session: the slot is free at
    the next block, long before max_len, and a waiting session takes it."""
    jlm, params, lm = bf16_pair
    sched = LMBatchScheduler(lm, max_batch=1)
    first = sched.submit(*_prompt(50), 0, 200)
    waiting = sched.submit(*_prompt(51), 4, 16)
    sched.step()
    it = iter(first)
    assert len(next(it)) == 8
    it.close()
    assert first.cancelled and sched.n_active == 1
    sched.step()  # the block that retires the cancelled session
    assert sched.slots[0] is None
    _drive(sched, [])
    assert 0 < len(_cat(list(waiting))) <= 16


def test_failing_step_fails_every_live_handle(bf16_pair, monkeypatch):
    jlm, params, lm = bf16_pair
    sched = LMBatchScheduler(lm, max_batch=2)

    def broken(*args, **kw):
        raise RuntimeError("injected decode failure")

    monkeypatch.setattr(sched.decoder, "run", broken)
    sched.start()
    try:
        out = _consume([sched.submit(*_prompt(s), 4, 40) for s in range(3)])
    finally:
        sched.stop()
    assert all(isinstance(e, RuntimeError) and isinstance(e.__cause__, RuntimeError) for e in out)
    assert "injected" in str(out[0].__cause__)
    assert sched.n_active == 0


def test_bistream_beside_a_running_scheduler(bf16_pair):
    """A B=1 bistream request while the scheduler decodes three sessions on
    its thread: the tokens it gives alone; the sessions give theirs."""
    from tests.test_torch_bistream import _request

    jlm, params, lm = bf16_pair
    chunks, prompt_text, prompt_speech = _request(1, 12, 4)

    def bistream():
        return _cat(list(lm.generate_bistream(iter(chunks), prompt_text, prompt_speech,
                                              torch.Generator().manual_seed(0), max_len=60)))

    alone = bistream()
    reqs = [_prompt(40 + s) + (4, 120) for s in range(3)]
    want = _drive(LMBatchScheduler(lm, max_batch=2), reqs)
    sched = LMBatchScheduler(lm, max_batch=2)
    sched.start()
    try:
        handles = [sched.submit(*r) for r in reqs]
        beside = bistream()
        got = _consume(handles)
    finally:
        sched.stop()
    assert len(alone) > 0
    np.testing.assert_array_equal(beside, alone)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_attached_until_stopped_and_captures_only_when_idle(bf16_pair):
    """A scheduler is attached to its LM (device_turn syncs) from its making
    to stop(); capture_graphs refuses once a session is pending, and with
    the graphs off (the CPU) captures nothing and leaves the slots empty."""
    jlm, params, lm = bf16_pair
    sched = LMBatchScheduler(lm, max_batch=2)
    assert sched in lm._schedulers
    sched.capture_graphs()
    assert lm.graph_captures == 0 and bool(sched.decoder.state.fin.all()) and sched.n_active == 0
    handle = sched.submit(*_prompt(60), 4, 16)
    with pytest.raises(RuntimeError, match="before the scheduler or the LM serves"):
        sched.capture_graphs()
    sched.stop()
    assert sched not in lm._schedulers and len(_cat(list(handle))) == 0


@pytest.mark.cuda
def test_captured_up_front_serving_captures_nothing(monkeypatch):
    """On a card: after capture_graphs (every bucket of the scheduler's
    decoder; every bucket and stop mask of the LM's B=1 decoder), sessions
    on the scheduler's thread and a bistream request beside it capture no
    graph, and the sessions' tokens equal those of a scheduler that
    captured as it went."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs and the kernels run only on the GPU")
    from tests.test_torch_bistream import _request

    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.engine import random_lm

    qwen = Qwen2Config(hidden_size=384, num_layers=2, num_heads=6, num_kv_heads=2, head_dim=64,
                       intermediate_size=448, vocab_size=1000, max_cache_len=1024)
    lm, _ = random_lm(0, "cuda", LMConfig(qwen=qwen))
    monkeypatch.setattr(lm, "ARENA_BUCKET", 256)
    reqs = [_prompt(70 + s) + (4, 300) for s in range(3)]
    want = _drive(LMBatchScheduler(lm, max_batch=2), reqs)
    chunks, prompt_text, prompt_speech = _request(1, 12, 4)
    sched = LMBatchScheduler(lm, max_batch=2)
    before = lm.graph_captures
    sched.capture_graphs()
    assert lm.graph_captures - before == 4 + 4 * 2  # its 4 buckets; the B=1 decoder's 4 buckets x 2 stop masks
    captured = lm.graph_captures
    sched.start()
    try:
        handles = [sched.submit(*r) for r in reqs]
        beside = _cat(list(lm.generate_bistream(iter(chunks), prompt_text, prompt_speech,
                                                torch.Generator(device="cuda").manual_seed(0), max_len=60)))
        got = _consume(handles)
    finally:
        sched.stop()
    assert lm.graph_captures == captured and len(beside) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- the engine and the API


@pytest.fixture(scope="module")
def engines():
    from tests.test_torch_common import jax_lm_cfg
    from tests.test_torch_engine import _engines

    return _engines(jax_lm_cfg(top_k=1, tau_r=2.0))


def _jax_tokens(jeng, eng, req):
    from cosyvoice_tpu_torch.runtime.engine import lm_prompt

    ids, types, min_len, max_len = lm_prompt(eng.lm.cfg, req["text_tokens"], req["prompt_text_tokens"],
                                             req["llm_prompt_speech_token"])
    return _cat(list(jeng.lm.generate(jeng.lm_params, ids, types, jax.random.PRNGKey(0), min_len, max_len)))


@pytest.mark.parametrize("stream", [False, True], ids=["offline", "stream"])
def test_engine_sessions_share_the_scheduler(engines, stream):
    """Two `tts` calls at once on two threads through a 2-slot scheduler:
    each gives the JAX engine's single-session tokens and wav (chunk for
    chunk when streamed), and each streaming session keeps its own chunk
    log."""
    from tests.test_torch_engine import ATOL, _request

    jeng, eng = engines
    reqs = [_request(0), _request(3)]
    want = [[c["tts_speech"] for c in jeng.tts(**r, stream=stream)] for r in reqs]
    want_tokens = [_jax_tokens(jeng, eng, r) for r in reqs]
    eng.scheduler = LMBatchScheduler(eng.lm, max_batch=2)
    eng.scheduler.start()
    got, logs = [None, None], [None, None]
    barrier = threading.Barrier(2)

    def run(i):
        barrier.wait()
        got[i] = list(eng.tts(**reqs[i], stream=stream))
        logs[i] = eng.stream_log

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HANG_S)
    finally:
        eng.scheduler.stop()
        eng.scheduler = None
    for i in range(2):
        assert got[i] is not None, f"session {i} did not finish"
        np.testing.assert_array_equal(np.concatenate([c["speech_tokens"] for c in got[i]]), want_tokens[i])
        assert len(got[i]) == len(want[i])
        for w, g in zip(want[i], got[i]):
            assert g["tts_speech"].shape == w.shape and np.isfinite(g["tts_speech"]).all()
            np.testing.assert_allclose(g["tts_speech"], w, rtol=0, atol=ATOL)
        if stream:
            assert [c["tokens"] for c in logs[i]] == [len(c["speech_tokens"]) for c in got[i]]
    if stream:
        assert logs[0] is not logs[1]


def test_tts_rng_seed_seeds_the_lm():
    """`tts(rng_seed=s)` samples (top_k 25, RAS on) the tokens of `generate`
    with a generator seeded s; the default is SEED."""
    from tests.test_torch_common import jax_flow_cfg, jax_hift_cfg, jax_lm_cfg, to_port_cfg
    from tests.test_torch_engine import _request

    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.runtime.engine import SEED, build_random_engine, lm_prompt

    eng = build_random_engine(0, "cpu", to_port_cfg(jax_lm_cfg(), LMConfig), to_port_cfg(jax_flow_cfg(), FlowConfig),
                              to_port_cfg(jax_hift_cfg(), HiFTConfig))
    req = _request(0)
    ids, types, min_len, max_len = lm_prompt(eng.lm.cfg, req["text_tokens"], req["prompt_text_tokens"],
                                             req["llm_prompt_speech_token"])

    def tokens(**kw):
        return np.concatenate([c["speech_tokens"] for c in eng.tts(**req, **kw)])

    def generate(seed):
        return _cat(list(eng.lm.generate(ids, types, torch.Generator().manual_seed(seed), min_len, max_len)))

    got = {s: tokens(rng_seed=s) for s in (5, 6)}
    np.testing.assert_array_equal(got[5], generate(5))
    np.testing.assert_array_equal(got[6], generate(6))
    np.testing.assert_array_equal(tokens(), generate(SEED))
    assert not np.array_equal(got[5], got[6])


def test_api_concurrent_segments_in_order(tmp_path):
    """`enable_continuous_batching(2)` then a text that splits into two
    segments, offline: both segments decode at once through the scheduler
    and come back in segment order, equal to the serial path's (greedy);
    set_sampling then raises, as does a second enable."""
    from tests.test_torch_api import CAM, EOS_BIAS, TWO_SEGMENTS, _wav, _write_dir

    from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    api = CosyVoice2(_write_dir(tmp_path / "m"), device="cpu", seed=0)
    api.frontend.campplus = CamPPEmbedding(CamPPConfig(**CAM))
    with torch.no_grad():
        api.lm.module.llm_decoder.bias[api.lm.cfg.eos_token] += EOS_BIAS
    wav = _wav(0, 1.0)
    serial = list(api.inference_zero_shot(TWO_SEGMENTS, "A cue.", wav))
    assert len(serial) == 2
    submitted = []
    sched = api.enable_continuous_batching(max_batch=2)
    submit = sched.submit
    sched.submit = lambda *a: submitted.append(len(a[0])) or submit(*a)
    try:
        batched = list(api.inference_zero_shot(TWO_SEGMENTS, "A cue.", wav))
        with pytest.raises(RuntimeError, match="before enable_continuous_batching"):
            api.set_sampling(top_k=5)
        with pytest.raises(RuntimeError, match="already enabled"):
            api.enable_continuous_batching()
    finally:
        sched.stop()
    assert len(submitted) == 2 and len(batched) == 2
    for s, b in zip(serial, batched):
        np.testing.assert_array_equal(b["speech_tokens"], s["speech_tokens"])
        np.testing.assert_allclose(b["tts_speech"], s["tts_speech"], rtol=0, atol=1e-5)
    assert len(serial[0]["speech_tokens"]) != len(serial[1]["speech_tokens"])
