"""The CosyVoice2 engine's speculative fused first chunk
(runtime/first_chunk.py, `CosyVoice2Engine._first_chunk_admits` and
`_try_first_chunk_fast`,
`Qwen2LM.generate_first` / `generate_continue`) at tiny width, float32 on
the CPU, where the chunk's token->wav body runs eagerly:

(a) the port with the path on against the JAX engine at its defaults
    (path on), greedy, chunk for chunk, on the recompute path and with the
    incremental flow after the first chunk;
(b) the port on against the port off, sampling, seeds 19-26 (as the JAX
    package's test_speculative_first_chunk_matches): the same chunks and
    tokens, wavs within 2e-3 of the chunk's peak;
(c) a forced fallback (a stop id inside the chunk's tokens) and a stop
    past the chunk inside the first blocks, each against the path off;
(d) every request the gate refuses (external tokens, vc, a scheduler,
    bistream text, an odd prompt, max_len below the chunk after the
    arena's capacity clamp, a repetition penalty; CosyVoice3Engine), which
    takes the standard path; streaming with a speed change raises;
(e) `generate_first` + `generate_continue` against `generate`, sampling,
    n1 = 1 and 2, across an arena growth, for the bf16, int4p + int8-arena
    and int4p + bf16-arena LMs: the same tokens, the generator in the same
    state, the request held open in between;
(f) the conformer's and the DiT encoder's lookahead scatters, now indexed
    on the device, against the host-indexed writes they replaced; the
    position table a graph reads outlives its growth.

The engines are tests/test_torch_engine.py's (token hop 5, token bucket
16, mel bucket 8, the HiFT source pinned by configuration). A `cuda`-marked
test holds the graph replay against the eager body on a card; the module
imports JAX and the JAX package only inside the CPU tests, so that the
card, which has no JAX, runs it with `python -m pytest --noconftest
tests/test_torch_first_chunk.py -m cuda`."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.runtime.engine import lm_prompt

torch.set_num_threads(1)

ATOL = 1e-3  # float32 wav in [-1, 1]: tests/test_torch_stream.py's
REL = 2e-3  # on against off, of the chunk's peak: the JAX package's test_speculative_first_chunk_matches


@pytest.fixture(scope="module")
def engines():
    from tests.test_torch_common import jax_lm_cfg
    from tests.test_torch_engine import _engines

    return _engines(jax_lm_cfg(top_k=1, tau_r=2.0))


@pytest.fixture(scope="module")
def sampling_engine():
    from tests.test_torch_common import jax_lm_cfg
    from tests.test_torch_engine import _engines

    return _engines(jax_lm_cfg())[1]


def _request(seed, **kw):
    from tests.test_torch_engine import _request

    return {**_request(seed), **kw}


def _paths(eng):
    return [c["path"] for c in eng.stream_log]


def _stream(eng, req, **kw):
    eng.timer.reset()
    return list(eng.tts(**req, stream=True, **kw))


def _tokens(chunks):
    return np.concatenate([c["speech_tokens"] for c in chunks])


def _off(eng, req, **kw):
    eng.speculative_first_chunk = False
    try:
        return _stream(eng, req, **kw)
    finally:
        eng.speculative_first_chunk = True


def _hold_rel(got, want, label):
    assert len(got) == len(want), f"{label}: {len(got)} chunks against {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["speech_tokens"], w["speech_tokens"], err_msg=f"{label} chunk {i}")
        a, b = g["tts_speech"], w["tts_speech"]
        assert a.shape == b.shape, f"{label} chunk {i}: {a.shape} vs {b.shape}"
        assert np.isfinite(a).all()
        scale = max(np.abs(b).max(initial=0.0), 1e-6)
        assert np.abs(a - b).max(initial=0.0) / scale < REL, f"{label} chunk {i}"


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("min_tok", [10**6, 0], ids=["recompute", "incremental"])
def test_first_chunk_matches_jax_engine(engines, min_tok, monkeypatch):
    """Request seed 0 (a 4-token prompt: this_hop 6, need 9 tokens, 2 blocks
    of 8): the port's fused first chunk, then the standard loop (every
    later chunk recomputed, or a catch-up chunk then incremental ones),
    chunk for chunk against the JAX engine at its defaults; the streamed
    tokens are the JAX LM's."""
    import jax

    jeng, eng = engines
    monkeypatch.setattr(jeng, "flow_incr_min_tok", min_tok)
    monkeypatch.setattr(eng, "flow_incr_min_tok", min_tok)
    req = _request(0)
    assert jeng.speculative_first_chunk and eng.speculative_first_chunk
    want = [c["tts_speech"] for c in jeng.tts(**req, stream=True)]
    got = _stream(eng, req)
    assert _paths(eng)[0] == "fused-first"
    assert _paths(eng)[1] == ("recompute" if min_tok else "catch-up")
    assert len(eng.timer.records["first_chunk_fused"]) == 1
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g["tts_speech"].shape == w.shape, f"chunk {i}"
        np.testing.assert_allclose(g["tts_speech"], w, rtol=0, atol=ATOL, err_msg=f"chunk {i}")
    ids, types, min_len, max_len = lm_prompt(eng.lm.cfg, req["text_tokens"], req["prompt_text_tokens"],
                                             req["llm_prompt_speech_token"])
    jtoks = np.concatenate(list(jeng.lm.generate(jeng.lm_params, ids, types, jax.random.PRNGKey(1986), min_len,
                                                 max_len)))
    np.testing.assert_array_equal(_tokens(got), jtoks)
    assert len(got[0]["speech_tokens"]) == 6


# ---------------------------------------------------------------- (b)


def test_first_chunk_on_matches_off_sampling(sampling_engine):
    """Seeds 19-26, sampling (top_k 25, RAS): the path on and off give the
    same chunks, tokens equal, wavs within REL; at least one seed takes
    the fused chunk (its tokens run past the chunk's 9) and one discards
    it (a stop id inside them)."""
    eng = sampling_engine
    req = _request(21)
    taken = []
    for seed in range(19, 27):
        fast = _stream(eng, req, rng_seed=seed)
        taken.append(_paths(eng)[0] == "fused-first")
        assert len(eng.timer.records["first_chunk_fused"]) == 1
        _hold_rel(fast, _off(eng, req, rng_seed=seed), f"seed {seed}")
    assert any(taken), "no seed took the fused first chunk"
    assert not all(taken), "no seed discarded the fused first chunk"


# ---------------------------------------------------------------- (c)


@pytest.mark.parametrize("n_text,fused", [(4, False), (5, True)], ids=["stop_inside", "stop_after"])
def test_forced_stop_matches_path_off(engines, n_text, fused):
    """The head's eos bias raised after conversion, so that the greedy LM
    stops exactly at min_len = 2 x text ids: at 8 tokens, inside the
    chunk's 9 (the chunk is discarded and the standard path renders the 8
    tokens), or at 10, past the chunk but inside its 2 blocks (the chunk is
    kept, and the LM has no continuation). Each equals the path off."""
    _, eng = engines
    c = eng.lm.cfg
    bias = eng.lm.module.llm_decoder.bias
    saved = bias.detach().clone()
    req = _request(3, text_tokens=np.arange(n_text, dtype=np.int32) + 7)
    try:
        with torch.no_grad():
            bias[c.eos_token] += 100.0
        got = _stream(eng, req)
        paths, attempts = _paths(eng), len(eng.timer.records["first_chunk_fused"])
        want = _off(eng, req)
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    assert attempts == 1
    assert (paths[0] == "fused-first") == fused
    assert len(_tokens(got)) == 2 * n_text
    assert not eng.lm._busy
    _hold_rel(got, want, f"text {n_text}")


# ---------------------------------------------------------------- (d)


def _v3_engine_and_request():
    from tests.test_torch_engine_v3 import _engine, _parts, _request

    return _engine(_parts(0.2)), _request(0)


GATE = {
    "token_generator": lambda eng: dict(token_generator=[np.arange(14, dtype=np.int32) % 20]),
    "vc": lambda eng: dict(source_speech_token=np.arange(14, dtype=np.int32) % 20),
    "bistream": lambda eng: dict(text_tokens=iter([np.arange(3, dtype=np.int32), np.arange(4, dtype=np.int32)])),
    "odd_prompt": lambda eng: dict(prompt_speech_feat=np.zeros((1, 7, 80), np.float32)),
    # a 200-token LM prompt pads to max_cache_len (256): no whole block fits
    "capacity": lambda eng: dict(llm_prompt_speech_token=np.arange(200, dtype=np.int32) % 20),
}


@pytest.mark.parametrize("case", list(GATE) + ["scheduler", "penalty", "v3"])
def test_refused_requests_take_the_standard_path(engines, case, monkeypatch):
    """Each request the gate (`_first_chunk_admits`) refuses streams on
    the standard path: no fused chunk logged, no `first_chunk_fused` stage;
    a v3 engine never takes the path."""
    _, eng = engines
    req = _request(0)
    if case in GATE:
        req.update(GATE[case](eng))
    elif case == "scheduler":
        blocks = [np.arange(12, dtype=np.int32) % 20]
        monkeypatch.setattr(eng, "scheduler", SimpleNamespace(submit=lambda *args: iter(blocks)))
    elif case == "penalty":
        monkeypatch.setattr(eng.lm, "cfg", dataclasses.replace(eng.lm.cfg, repetition_penalty=1.1))
    else:
        eng, req = _v3_engine_and_request()
        assert not eng.speculative_first_chunk
    chunks = _stream(eng, req)
    assert chunks and "fused-first" not in _paths(eng)
    assert "first_chunk_fused" not in eng.timer.records
    assert not eng.lm._busy


def test_streaming_speed_change_raises(engines):
    _, eng = engines
    with pytest.raises(ValueError, match="speed"):
        _stream(eng, _request(0), speed=1.5)


# ---------------------------------------------------------------- (e)


@pytest.fixture(scope="module", params=["bf16", "int4p_kv8", "int4p_bf16"])
def lm(request):
    from tests.test_torch_bistream import _bf16_pair
    from tests.test_torch_lm import _quant_pair

    kind = request.param
    _, _, lm = _bf16_pair() if kind == "bf16" else _quant_pair("int4p", kv_quant=kind == "int4p_kv8")
    return lm


@pytest.mark.parametrize("n1", [1, 2])
def test_generate_first_then_continue_equals_generate(lm, n1, monkeypatch):
    """Sampling (top_k 25, RAS), the non-eos stop ids' head bias lowered so
    that streams run past the first blocks, a 32-row arena bucket (the
    first arena 96 rows; the continuation grows it as the JAX engine's
    does, from pad_T + n1 * block): the first blocks' tokens (on the
    device) and the continuation's blocks are an uninterrupted
    `generate`'s, and the generator ends in the same state. The request
    stays open from generate_first to the continuation's end."""
    from tests.test_torch_lm import _prompt

    c = lm.cfg
    monkeypatch.setattr(lm, "cfg", dataclasses.replace(c, top_k=25, tau_r=0.1))
    monkeypatch.setattr(lm, "ARENA_BUCKET", 32)
    bias = lm.module.llm_decoder.bias
    saved = bias.detach().clone()
    grown = []
    grow = lm.grow_cache
    monkeypatch.setattr(lm, "grow_cache", lambda cache, n: grown.append(n) or grow(cache, n))
    try:
        with torch.no_grad():
            bias[c.eos_token + 1 :] -= 1e4
        for seed in range(3):
            ids, types = _prompt(np.random.default_rng(seed))
            g_ref, g = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
            want = np.concatenate(list(lm.generate(ids, types, g_ref, 80, 150)))
            grown.clear()
            first = lm.generate_first(ids, types, g, 80, 150, n1)
            assert first.tokens.shape == (1, n1 * c.block_size) and lm._busy
            with pytest.raises(RuntimeError, match="one request at a time"):
                next(lm.generate(ids, types, torch.Generator(), 80, 150))
            rest = list(lm.generate_continue(first, g))
            assert not lm._busy
            got = np.concatenate([first.tokens[0].numpy()] + rest)
            np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
            assert torch.equal(g.get_state(), g_ref.get_state())
            assert len(want) >= 80 and max(grown) > 96  # the continuation grew the arena
    finally:
        with torch.no_grad():
            bias.copy_(saved)


def test_closing_first_blocks_frees_the_request(engines):
    """A request whose continuation never runs ends with `first.close()`."""
    from tests.test_torch_lm import _prompt

    _, eng = engines
    ids, types = _prompt(np.random.default_rng(0))
    first = eng.lm.generate_first(ids, types, torch.Generator(), 10, 40, 1)
    assert eng.lm._busy
    first.close()
    first.close()
    assert not eng.lm._busy


# ---------------------------------------------------------------- (f)


@pytest.mark.parametrize("n", [0, 5, 13])
def test_conformer_lookahead_scatter_matches_host_indexed(n):
    """UpsampleConformerEncoder's context rows at xs_lens[0], written with a
    device index: its embedding layer sees exactly what the host-indexed
    write (`xs[:, n0 : n0 + la] = context`, n0 = int(xs_lens[0])) made."""
    from cosyvoice_tpu_torch.nn.conformer import UpsampleConformerEncoder

    torch.manual_seed(0)
    enc = UpsampleConformerEncoder(16, 16, 2, 32, num_blocks=1, num_up_blocks=1, static_chunk_size=5).eval()
    T, la = 16, 3
    xs, ctx = torch.randn(2, T, 16), torch.randn(2, la, 16)
    lens = torch.tensor([n, n])
    seen = []
    enc.embed.register_forward_pre_hook(lambda mod, args: seen.append(args[0].clone()))
    with torch.no_grad():
        out, _ = enc(xs, lens, ctx, streaming=True)
    old = xs.clone()
    n0 = int(lens[0])
    old[:, n0 : n0 + la] = ctx
    assert torch.equal(seen[0], old)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("lens", [(0, 4), (9, 13), (12, 20)])
def test_dit_lookahead_scatter_matches_host_indexed(lens):
    """DiTFlowEncoder's per-row context at each row's length (clamped to
    L - la), written with a device index: its lookahead layer sees exactly
    what the host-indexed loop it replaced made."""
    from cosyvoice_tpu_torch.models.flow import DiTFlowEncoder, FlowConfig
    from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask

    torch.manual_seed(0)
    cfg = FlowConfig(input_size=8, vocab_size=50, dit_lookahead_channels=16, encoder_type="dit_prelookahead")
    enc = DiTFlowEncoder(cfg).eval()
    L, la = 16, 3
    token, ctx_tok = torch.randint(0, 50, (2, L)), torch.randint(0, 50, (2, la))
    token_len = torch.tensor(lens)
    seen = []
    enc.pre_lookahead_layer.register_forward_pre_hook(lambda mod, args: seen.append(args[0].clone()))
    with torch.no_grad():
        enc(token, token_len, ctx_tok)
        old = enc.input_embedding(token) * make_non_pad_mask(token_len, L)[..., None]
        ctx = enc.input_embedding(ctx_tok)
        for b, n in enumerate(token_len.tolist()):
            start = min(max(int(n), 0), L - la)
            old[b, start : start + la] = ctx[b]
    assert torch.equal(seen[0], old)


def test_position_table_growth_keeps_the_table_a_graph_reads():
    """EspnetRelPositionalEncoding's device table, which a captured
    first-chunk graph reads through the rows it was given, outlives the
    growth that replaces it (an offline request past max_len / 2 tokens
    grows it), and the rows after growth are the new table's, equal to the
    old ones where both hold them."""
    import gc
    import weakref

    from cosyvoice_tpu_torch.nn.embedding import EspnetRelPositionalEncoding

    pos = EspnetRelPositionalEncoding(8, max_len=16)
    rows = pos.position_encoding(10)
    table = weakref.ref(rows._base)
    del rows
    grown = pos.position_encoding(40)
    gc.collect()
    assert pos.max_len == 64 and grown.shape == (1, 79, 8)
    assert table() is not None and table()._base is None and table().data_ptr() != grown._base.data_ptr()
    np.testing.assert_array_equal(pos.position_encoding(10).numpy(), table()[:, 6:25].numpy())


def test_chip_smoke_first_chunk_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's first_chunk phase on a tiny random CPU engine (flow
    chunk 25, so that the fallback's 16 tokens fall inside the chunk's 28;
    no launch counted on the CPU, every PER_STEP entry zeroed; 2 timed
    requests each way): on against off, the replay hold (the eager body
    against itself) with its planted faults, the first blocks, the
    fallback."""
    import chip_smoke

    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.flow_decoder import EstimatorConfig
    from cosyvoice_tpu_torch.models.flow_matching import CFMConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine

    zeros = dict.fromkeys(chip_smoke.PER_STEP["bf16"], 0)
    monkeypatch.setitem(chip_smoke.PER_STEP, "fused", zeros)
    monkeypatch.setattr(chip_smoke, "FIRST_CHUNK_TIMED", 2)
    qwen = Qwen2Config(hidden_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=32,
                       intermediate_size=64, vocab_size=1000, max_cache_len=2048, dtype=torch.float32)
    flow = FlowConfig(input_size=32, chunk_size=25, attention_heads=2, linear_units=64, num_blocks=1,
                      num_up_blocks=1, estimator=EstimatorConfig(channels=(32,), attention_head_dim=8, n_blocks=1,
                                                                 num_mid_blocks=1, num_heads=2, static_chunk_size=50),
                      cfm=CFMConfig(n_timesteps=2))
    hift = HiFTConfig(base_channels=32, resblock_kernel_sizes=(3,), resblock_dilations=((1,),),
                      source_resblock_kernel_sizes=(7, 7, 11), source_resblock_dilations=((1,), (1,), (1,)))
    eng = build_random_engine(0, "cpu", LMConfig(qwen=qwen), flow, hift)
    assert chip_smoke.phase_first_chunk(eng, "", zeros) == dict.fromkeys(zeros, 0)
    assert not eng.lm._busy


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_first_chunk_graph_matches_eager_on_the_card():
    """On a card (tiny widths, random weights, a 62-token flow prompt: this
    hop 5 + 3, need 11 tokens): the first chunk's graph replay against its
    eager body on the same inputs (cuDNN deterministic, no TF32), equal; a
    second prompt of the same shape replays the same graph, and so does a
    replay after the flow's position tables grew; a streamed
    request with the path on against the path off: the same tokens, the
    chunks within REL."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs and the kernels run only on the GPU")
    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.flow_decoder import EstimatorConfig
    from cosyvoice_tpu_torch.models.flow_matching import CFMConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine

    qwen = Qwen2Config(hidden_size=384, num_layers=2, num_heads=6, num_kv_heads=2, head_dim=64,
                       intermediate_size=448, vocab_size=1000, max_cache_len=1024)
    flow = FlowConfig(input_size=32, chunk_size=5, attention_heads=2, linear_units=64, num_blocks=2, num_up_blocks=1,
                      estimator=EstimatorConfig(channels=(32,), attention_head_dim=8, n_blocks=1, num_mid_blocks=2,
                                                num_heads=2, static_chunk_size=10), cfm=CFMConfig(n_timesteps=3))
    hift = HiFTConfig(base_channels=32, resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3)),
                      source_resblock_kernel_sizes=(7, 7, 11), source_resblock_dilations=((1,), (1,), (1,)))
    eng = build_random_engine(0, "cuda", LMConfig(qwen=qwen), flow, hift)
    eng.token_bucket, eng.mel_bucket = 16, 8
    rng = np.random.default_rng(0)

    def request():
        return dict(text_tokens=rng.integers(0, 1000, 6), prompt_text_tokens=rng.integers(0, 1000, 3),
                    llm_prompt_speech_token=rng.integers(0, 6561, 60),
                    flow_prompt_speech_token=rng.integers(0, 6561, 62),
                    prompt_speech_feat=rng.standard_normal((1, 124, 80)).astype(np.float32),
                    flow_embedding=rng.standard_normal((1, 192)).astype(np.float32))

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32 = True, False
    fc = eng.first_chunk
    try:
        for i in range(2):
            req = request()
            with eng._on_t2w():
                e = fc.prepare(req["flow_prompt_speech_token"], req["prompt_speech_feat"], req["flow_embedding"])
                tokens = torch.as_tensor(rng.integers(0, 6561, e.tokens.shape), dtype=torch.int32, device="cuda")
                replayed = [t.clone() for t in fc.run(e, tokens)]
                eager = fc._body(e)
            for a, b in zip(replayed, eager):
                assert torch.equal(a, b), f"request {i}: max |diff| {(a - b).abs().max().item()}"
        # a long offline request grows the flow's position tables; the memory
        # the old ones held, were it freed, would go to the NaN fill
        conformer, junk = eng.flow.encoder.encoder, []
        for pos in (conformer.pos_enc, conformer.up_pos_enc):
            shape = pos.position_encoding(1, "cuda")._base.shape
            pos.position_encoding(pos.max_len + 1, "cuda")
            junk.append(torch.full(shape, float("nan"), device="cuda"))
        with eng._on_t2w():
            replayed = [t.clone() for t in fc.run(e, tokens)]
            eager = fc._body(e)
        for a, b in zip(replayed, eager):
            assert torch.equal(a, b), f"after growth: max |diff| {(a - b).abs().max().item()}"
        assert fc.captures == 1 and fc.replays == 3 and fc.pool_bytes > 0
        on = _stream(eng, req, rng_seed=3)
        assert _paths(eng)[0] == "fused-first"
        _hold_rel(on, _off(eng, req, rng_seed=3), "on against off")
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = saved
