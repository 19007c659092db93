"""The LM's decode step on static buffers (models/decode_graph.py) at tiny
width, float32 on CPU, where it runs without capture: the function a CUDA
graph captures on the card, over the LM's static per-bucket KV arenas
(models/qwen2.py:StaticArenas).

For the bf16 LM, int4p weights over an int8 arena, and int4p weights over a
bf16 arena (K7's plain version while the arena holds at most
MAX_FUSED_ARENA rows): greedy tokens equal to the JAX LM's `generate` and
`generate_bistream` and to the loop of eager calls the step replaced
(`_functional_block`), across several arena growths and the route switch;
sampled tokens (top_k 25, RAS on) equal to that loop's from the same
generator, which ends in the same state; the static arena's growth equal
to the JAX grow_cache's; the idle share's interval union. A `cuda`-marked test holds graph replays against
the eager path on a card; the module imports JAX and the JAX package's
test helpers only inside the CPU tests, so that the card, which has no JAX,
runs it with `python -m pytest tests/test_torch_decode_graph.py -m cuda`."""

import dataclasses

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM

torch.set_num_threads(1)

LMS = ["bf16", "int4p_kv8", "int4p_bf16"]


@pytest.fixture(scope="module", params=LMS)
def lm_pair(request):
    from tests.test_torch_bistream import _bf16_pair
    from tests.test_torch_lm import _quant_pair

    kind = request.param
    pair = _bf16_pair() if kind == "bf16" else _quant_pair("int4p", kv_quant=kind == "int4p_kv8")
    return (kind,) + pair


def _functional_block(lm):
    """Qwen2LM._decode_block as a loop of eager calls that makes new tensors
    every step, as it was before the step moved onto static buffers: the
    reference for models/decode_graph.py:step."""
    c = lm.cfg

    def block(generator, cache, cur, logits, recent, n_dec, min_len, fin, stacked, steps, bistream=False):
        tokens = []
        for _ in range(steps):
            tok = lm._sample(generator, logits, n_dec, recent, min_len, bistream)
            stop_now = tok >= c.speech_token_size
            tok_out = torch.where(fin, torch.full_like(tok, c.eos_token), tok)
            fin_next = fin | stop_now
            recent = torch.where(fin[:, None], recent, torch.cat([recent[:, 1:], tok[:, None]], dim=1))
            n_dec = torch.where(fin, n_dec, n_dec + 1)
            if stacked is not None:
                logits, cache = lm.module.decode_step_fused(tok_out, cur, cache, stacked)
            else:
                logits, cache = lm.module.decode_step(tok_out, cur, cache)
            cur = cur + (~fin).to(cur.dtype)
            fin = fin_next
            tokens.append(tok_out)
        return torch.stack(tokens, dim=1), logits, cur, recent, n_dec, fin

    return block


def _cat(blocks):
    return np.concatenate(blocks) if blocks else np.zeros(0, np.int32)


def _generate(lm, seed, min_len, max_len, generator):
    from tests.test_torch_lm import _prompt

    ids, types = _prompt(np.random.default_rng(seed))
    return _cat(list(lm.generate(ids, types, generator, min_len, max_len)))


def test_greedy_generate_matches_jax_and_the_eager_loop(lm_pair, monkeypatch):
    """150 greedy tokens with a 32-row arena bucket, so that the arena grows
    96 -> 128 -> 160 -> 192 rows, and MAX_FUSED_ARENA 96, so that the int4p
    LM over a bf16 arena takes K7 for the first block and the per-layer
    kernels after: the step on static buffers gives the JAX LM's tokens and
    the eager loop's, with equal arena lengths and routes before every
    block."""
    import jax

    from tests.test_torch_lm import _prompt, _record_routes, _small_buckets

    kind, jlm, params, lm = lm_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    _small_buckets(monkeypatch, jlm, lm, 96)
    routes = _record_routes(monkeypatch, jlm, lm)
    ids, types = _prompt(np.random.default_rng(3))
    want = _cat(list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), 100, 150)))
    got = _generate(lm, 3, 100, 150, torch.Generator().manual_seed(0))
    port_routes = list(routes["port"])
    with monkeypatch.context() as m:
        m.setattr(lm, "_decode_block", _functional_block(lm))
        ref = _generate(lm, 3, 100, 150, torch.Generator().manual_seed(0))
    assert len(got) == 150
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert port_routes == routes["jax"]
    lengths, fused = zip(*port_routes)
    assert list(lengths) == sorted(lengths) and set(lengths) == {96, 128, 160, 192}
    assert fused == tuple(kind == "int4p_bf16" and n <= 96 for n in lengths)
    # the buckets were allocated once each and the decode ran over them
    assert sorted(n for b, n in lm.arenas.buffers if b == 1) == [96, 128, 160, 192]


def test_greedy_bistream_matches_jax_and_the_eager_loop(lm_pair, monkeypatch):
    """generate_bistream with a 32-row bucket and MAX_FUSED_ARENA 96: the
    arena grows from 32 rows past 96 (the int4p LM over a bf16 arena
    switches from K7 to the per-layer kernels); the JAX stream's tokens, and
    the eager loop's."""
    from tests.test_torch_bistream import _both, _request
    from tests.test_torch_lm import _record_routes, _small_buckets

    kind, jlm, params, lm = lm_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    _small_buckets(monkeypatch, jlm, lm, 96)
    routes = _record_routes(monkeypatch, jlm, lm)
    req = _request(2, 40, 20)
    want, got = _both(jlm, params, lm, req, max_len=80)
    port_routes = list(routes["port"])
    with monkeypatch.context() as m:
        m.setattr(lm, "_decode_block", _functional_block(lm))
        chunks, prompt_text, prompt_speech = req
        ref = _cat(list(lm.generate_bistream(iter(chunks), prompt_text, prompt_speech,
                                             torch.Generator().manual_seed(0), max_len=80)))
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert port_routes == routes["jax"]
    lengths, fused = zip(*port_routes)
    assert list(lengths) == sorted(lengths) and lengths[0] < 96 < lengths[-1]
    assert fused == tuple(kind == "int4p_bf16" and n <= 96 for n in lengths)


def test_sampled_tokens_match_the_eager_loop(lm_pair, monkeypatch):
    """top_k 25 and RAS on (tau_r 0.1): generate and generate_bistream draw
    the eager loop's tokens from a CPU generator of the same seed, and leave
    it in the same state."""
    from tests.test_torch_bistream import _request

    kind, _, _, lm = lm_pair
    monkeypatch.setattr(lm, "cfg", dataclasses.replace(lm.cfg, top_k=25, tau_r=0.1))
    chunks, prompt_text, prompt_speech = _request(2, 40, 20)

    def both_entry_points(gen):
        return (_generate(lm, 1, 20, 60, gen),
                _cat(list(lm.generate_bistream(iter(chunks), prompt_text, prompt_speech, gen, max_len=60))))

    gen = torch.Generator().manual_seed(11)
    got = both_entry_points(gen)
    ref_gen = torch.Generator().manual_seed(11)
    with monkeypatch.context() as m:
        m.setattr(lm, "_decode_block", _functional_block(lm))
        ref = both_entry_points(ref_gen)
    for g, r in zip(got, ref):
        assert len(g) > 0
        np.testing.assert_array_equal(g, r)
    assert len(set(got[0].tolist())) > 5  # sampled, not one repeated token
    assert torch.equal(gen.get_state(), ref_gen.get_state())


@pytest.mark.parametrize("lm_pair", ["bf16", "int4p_kv8"], indirect=True)
def test_static_arena_growth_equals_grow_cache(lm_pair):
    """StaticArenas.grow into a bucket that an earlier request left dirty:
    the JAX grow_cache's values and the old new_zeros + copy's (rows
    copied, the rest zero), in buffers that stay the same objects; `first`
    zeroes a dirty bucket."""
    import jax.numpy as jnp

    _, jlm, _, lm = lm_pair
    rng = np.random.default_rng(0)

    def random_cache(length):
        cache = lm.init_cache(1, length)
        for a in cache:
            a.copy_(torch.from_numpy(rng.integers(-100, 100, a.shape)).to(a.dtype))
        return cache

    dirty = lm.grow_cache(random_cache(64), 96)
    bucket = lm.arenas.get(1, 96)
    assert dirty is bucket
    cache = random_cache(32)
    grown = lm.grow_cache(cache, 96)
    assert grown is bucket and all(g.data_ptr() == b.data_ptr() for g, b in zip(grown, bucket))
    want = jlm.grow_cache(tuple(jnp.asarray(a.numpy()) for a in cache), 96)
    for a, g, w in zip(cache, grown, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        padded = a.new_zeros(a.shape[:2] + (96,) + a.shape[3:])
        padded[:, :, :32] = a
        assert torch.equal(g, padded)
    assert lm.grow_cache(grown, 96) is grown and lm.grow_cache(grown, 64) is grown
    first = lm.arenas.first(1, 96)
    assert first is bucket and not any(a.any() for a in first)


def _small_lm():
    cfg = LMConfig()
    small = dataclasses.replace(cfg, qwen=dataclasses.replace(cfg.qwen, hidden_size=64, num_layers=1, num_heads=2,
                                                              intermediate_size=64, vocab_size=10))
    return small


def test_graphs_on_cpu_raise():
    small = _small_lm()
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        Qwen2LM(small, device="cpu", graphs=True)
    lm = Qwen2LM(small, device="cpu")
    assert not lm.graphs and not lm.decoder.enabled
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        lm.graphs = True
    assert not lm.decoder.enabled


def test_one_request_at_a_time():
    """generate and generate_bistream share the LM's static arenas and
    decoder state: a second request while one's generator is open raises,
    and once it is closed the next request runs."""
    torch.manual_seed(0)
    lm = Qwen2LM(_small_lm(), device="cpu")
    ids = np.array([0, 3, 4, 1, 5, 6, 7], np.int32)
    types = np.array([2, 0, 0, 2, 1, 1, 1], np.int32)
    first = lm.generate(ids, types, torch.Generator().manual_seed(0), 56, 60)
    assert len(next(first)) > 0
    for second in (lm.generate(ids, types, torch.Generator().manual_seed(0), 56, 60),
                   lm.generate_bistream(iter([ids[1:3]] * 4), ids[1:3], ids[4:], torch.Generator(), max_len=8)):
        with pytest.raises(RuntimeError, match="one request at a time"):
            next(second)
    first.close()
    assert len(_cat(list(lm.generate(ids, types, torch.Generator().manual_seed(0), 56, 60)))) >= 56
    assert len(_cat(list(lm.generate_bistream(iter([ids[1:3]] * 4), ids[1:3], ids[4:], torch.Generator(),
                                                max_len=8)))) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", LMS)
def test_graph_decode_matches_eager_on_the_card(kind, monkeypatch):
    """On a card: sampled tokens of `generate` (several arena growths, and
    for the int4p LM over a bf16 arena the route switch) and of
    `generate_bistream` replayed from CUDA graphs, equal to the same LM's
    eager path, with the generator left in the same state; every decode step
    after the first at each key replayed."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs and the kernels run only on the GPU")
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.ops import int4_block
    from cosyvoice_tpu_torch.runtime.engine import random_lm

    quant = {"bf16": {}, "int4p_kv8": {"quant": "int4p", "kv_quant": True}, "int4p_bf16": {"quant": "int4p"}}[kind]
    qwen = Qwen2Config(hidden_size=384, num_layers=2, num_heads=6, num_kv_heads=2, head_dim=64,
                       intermediate_size=448, vocab_size=1000, max_cache_len=1024, **quant)
    lm, _ = random_lm(0, "cuda", LMConfig(qwen=qwen))
    monkeypatch.setattr(lm, "ARENA_BUCKET", 128)
    monkeypatch.setattr(int4_block, "MAX_FUSED_ARENA", 256)
    rng = np.random.default_rng(0)
    ids = np.concatenate([[0], rng.integers(0, 1000, 20), [1], rng.integers(0, 6561, 30)]).astype(np.int32)
    types = np.array([2] + [0] * 20 + [2] + [1] * 30, np.int32)
    chunks = [rng.integers(0, 1000, n) for n in (3, 7, 1, 11, 3, 7)]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(3)
        out = (_cat(list(lm.generate(ids, types, gen, 300, 400))),
               _cat(list(lm.generate_bistream(iter(chunks), ids[1:5], ids[-30:], gen, max_len=120))))
        return out, gen.get_state()

    graph_out, graph_state = run()
    assert lm.graph_captures > 0 and lm.graph_replays > 0
    assert lm.decode_steps - lm.graph_replays == lm.graph_warmups > 0
    lm.graphs = False
    eager_out, eager_state = run()
    for g, e in zip(graph_out, eager_out):
        assert len(g) > 0
        np.testing.assert_array_equal(g, e)
    assert torch.equal(graph_state, eager_state)


def test_busy_union_counts_overlaps_once():
    """utils/profiling.py:busy_union, the busy time of a device trace:
    overlapping and nested kernel intervals count once, gaps not at all."""
    from cosyvoice_tpu_torch.utils.profiling import busy_union

    assert busy_union([]) == 0
    assert busy_union([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (5.5, 5.7), (2.5, 2.6)]) == 4.0


def test_device_idle_sums_its_traces(monkeypatch):
    """utils/profiling.py:device_idle over an iterable: a new trace every
    `per_trace` items, every item returned in order, and windows, busy time
    and kernel names summed over the traces (a fake profiler stands in for
    torch.profiler's CUDA activity, which needs a card)."""
    import types

    import torch.profiler
    from torch.autograd import DeviceType

    from cosyvoice_tpu_torch.utils.profiling import device_idle

    def event(name, start, end):
        return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: end - start,
                                     device_type=lambda: DeviceType.CUDA)

    # per trace: the two markers around two kernels, 10 ms of window, 6 ms busy
    trace = [event("mark", 0, 10**6), event("k1", 2 * 10**6, 6 * 10**6), event("k2", 5 * 10**6, 6 * 10**6),
             event("mark", 9 * 10**6, 10**7)]
    started = []

    class Profile:
        def __enter__(self):
            started.append(1)
            return types.SimpleNamespace(profiler=types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: list(reversed(trace)))))

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Profile())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out, stats = device_idle(iter(range(13)), "cpu", per_trace=6)
    assert out == list(range(13)) and len(started) == stats["traces"] == 3
    assert stats["window_ms"] == 30.0 and stats["busy_ms"] == 18.0 and abs(stats["idle_share"] - 0.4) < 1e-12
    assert stats["names"] == {"mark": 6, "k1": 3, "k2": 3} and stats["events"] == 12
    assert [t[0] for t in stats["top"]] == ["k1", "mark", "k2"]
    out, stats = device_idle(lambda: "done", "cpu")
    assert out == "done" and stats["traces"] == 1 and stats["window_ms"] == 10.0
