"""Temperature and repetition penalty in the LM's decode step (set_sampling),
CPU, float32, against the JAX LM: the pre-draw log-probs of `_sample`
against those the JAX decode block's `sample` hands to RAS (temperature
0.8, penalty 1.1, a presence set seeded from a prompt; the v2 and the
bistream stop masks) within 1e-5; greedy `generate` and
`generate_bistream` with penalty 1.1 (top_k 1, the RAS resample off) give
the JAX LM's tokens, for the bf16 LM and the int4p LM over an int8 arena;
sampled tokens (top_p 0.95, top_k 50, temperature 0.8, penalty 1.1)
through decode_graph.step equal a loop of eager calls that keeps its own
presence set, from the same generator, for those LMs and K7's route; `CosyVoice2.set_sampling`
keeps the LM's weights and static arenas. A `cuda`-marked test holds the
graph replays against the eager path under that config on a card; the
module imports JAX only inside the CPU tests."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.models.llm import LMConfig

torch.set_num_threads(1)

TRITON = dict(top_p=0.95, top_k=50, temperature=0.8, repetition_penalty=1.1)  # the reference's Triton consumer


def _pair(kind):
    from tests.test_torch_bistream import _bf16_pair
    from tests.test_torch_lm import _quant_pair

    return _bf16_pair() if kind == "bf16" else _quant_pair("int4p", kv_quant=kind == "int4p_kv8")


_PAIRS = {}


def _cached_pair(kind):
    if kind not in _PAIRS:
        _PAIRS[kind] = (kind,) + _pair(kind)
    return _PAIRS[kind]


# the JAX LM's K7 (Pallas, interpret mode) rounds at bf16 level unlike the
# port's plain version, so a greedy stream can flip at a near tie
# (tests/test_torch_lm.py bounds that case): the penalty is held against
# the JAX LM on the bf16 LM and the int4p LM over an int8 arena, and on
# K7's route against the port's eager loop
@pytest.fixture(scope="module", params=["bf16", "int4p_kv8"])
def lm_pair(request):
    return _cached_pair(request.param)


@pytest.fixture(scope="module", params=["bf16", "int4p_kv8", "int4p_bf16"])
def any_lm(request):
    return _cached_pair(request.param)


def _penalised(jlm, lm, **kw):
    """The JAX LM and the port's with `kw` replacing the sampling config
    (the JAX LM rebuilt over the same params, as its API's set_sampling
    does; the port's in place)."""
    from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM

    return JQwen2LM(dataclasses.replace(jlm.cfg, **kw)), dataclasses.replace(lm.cfg, **kw)


@pytest.mark.parametrize("bistream", [False, True])
def test_pre_draw_logp_matches_jax_sample(monkeypatch, bistream):
    """One step of the JAX decode block, run without jit so that the
    log-probs its `sample` hands to RAS are concrete, against the port's
    `_sample` on the same logits, presence set, decoded count and min_len."""
    import jax
    import jax.numpy as jnp

    import cosyvoice_tpu.models.llm as jllm
    import cosyvoice_tpu_torch.models.llm as pllm

    jlm0, params, lm = _pair("bf16")
    jlm, cfg = _penalised(jlm0, lm, temperature=0.8, repetition_penalty=1.1)
    monkeypatch.setattr(lm, "cfg", cfg)
    rng = np.random.default_rng(0)
    H = cfg.head_size
    logits = (rng.standard_normal((1, H)) * 3).astype(np.float32)
    seen = np.zeros((1, H), bool)
    seen[0, rng.integers(0, cfg.speech_token_size, 6)] = True
    seen[0, cfg.eos_token] = True  # a seen stop id with a negative logit, too
    logits[0, cfg.eos_token] = -abs(logits[0, cfg.eos_token])
    got, want = [], []

    def record(into, fn):
        def wrapped(*a, **k):
            into.append(np.asarray(a[1] if into is want else a[0], np.float32).copy())
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jllm, "ras_sampling_batch", record(want, jllm.ras_sampling_batch))
    monkeypatch.setattr(pllm, "ras_sampling_batch", record(got, pllm.ras_sampling_batch))
    cache = jlm.init_cache(1, length=32)
    with jax.disable_jit():
        jlm._decode_block_impl(params, jax.random.PRNGKey(0), cache, jnp.asarray([4]), jnp.asarray(logits),
                               jnp.full((1, cfg.win_size), -1, jnp.int32), jnp.asarray([2], jnp.int32),
                               jnp.asarray([5], jnp.int32), jnp.zeros((1,), bool), 1, bistream, seen=jnp.asarray(seen))
    lm._sample(torch.Generator().manual_seed(0), torch.from_numpy(logits), torch.tensor([2], dtype=torch.int32),
               torch.full((1, cfg.win_size), -1, dtype=torch.int32), torch.tensor([5], dtype=torch.int32), bistream,
               torch.from_numpy(seen))
    assert len(want) == len(got) == 1
    finite = want[0] > -1e29
    np.testing.assert_array_equal(got[0] > -1e29, finite)
    np.testing.assert_allclose(got[0][finite], want[0][finite], rtol=0, atol=1e-5)
    # the penalty moved the seen ids: positive logits down, negative further down
    plain = torch.log_softmax(torch.from_numpy(logits / 0.8), -1).numpy()
    assert not np.allclose(plain[finite], got[0][finite], atol=1e-3)


def _greedy_cfg(cfg, **kw):
    return dataclasses.replace(cfg, top_k=1, tau_r=2.0, **kw)


@contextlib.contextmanager
def _no_early_stop(params, lm):
    """The head bias of the stop ids other than eos (which min_len holds
    back) lowered by 30 in both LMs while inside: v2 lets them end a
    request before min_len, and a penalty that pushes the argmax off a
    repeated token lands on one of them in the tiny random LM. Yields the
    JAX params; the port's LM is restored on exit."""
    c = lm.cfg
    rows = [i for i in range(c.speech_token_size, c.head_size) if i != c.eos_token]
    head = dict(params["params"]["llm_decoder"])
    head["bias"] = np.array(head["bias"])
    head["bias"][rows] -= 30.0
    saved = lm.module.llm_decoder.bias.detach().clone()
    with torch.no_grad():
        lm.module.llm_decoder.bias[rows] -= 30.0
    try:
        yield {"params": {**params["params"], "llm_decoder": head}}
    finally:
        with torch.no_grad():
            lm.module.llm_decoder.bias.copy_(saved)


def test_greedy_generate_with_penalty_matches_jax(lm_pair, monkeypatch):
    """150 greedy tokens with penalty 1.1 and temperature 0.8: the presence
    set seeded from the prompt's speech tokens and grown by each token
    changes the argmax, alike in both LMs."""
    import jax

    from tests.test_torch_decode_graph import _cat
    from tests.test_torch_lm import _prompt

    kind, jlm0, params, lm = lm_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    jlm, cfg = _penalised(jlm0, lm, temperature=0.8, repetition_penalty=1.1)
    monkeypatch.setattr(lm, "cfg", cfg)
    ids, types = _prompt(np.random.default_rng(3))
    with _no_early_stop(params, lm) as jparams:
        want = _cat(list(jlm.generate(jparams, ids, types, jax.random.PRNGKey(0), 100, 150)))
        got = _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(0), 100, 150)))
        # without the penalty the stream differs (a check that it acted)
        monkeypatch.setattr(lm, "cfg", _greedy_cfg(lm.cfg, repetition_penalty=1.0))
        plain = _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(0), 100, 150)))
    assert len(got) == 150
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(plain, got)
    assert lm.decoder.state.seen is not None


def test_greedy_bistream_with_penalty_matches_jax(lm_pair, monkeypatch):
    from tests.test_torch_bistream import _both, _request

    kind, jlm0, params, lm = lm_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    jlm, cfg = _penalised(jlm0, lm, repetition_penalty=1.1)
    monkeypatch.setattr(lm, "cfg", cfg)
    want, got = _both(jlm, params, lm, _request(2, 40, 20), max_len=80)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


def _eager_loop(lm, prompt_speech):
    """Qwen2LM._decode_block as a loop of eager calls that make new tensors
    every step and keep their own presence set (seeded from
    `prompt_speech`, grown by each sampled token of a row that has not
    stopped): the reference for decode_graph.step under a penalty."""
    c = lm.cfg
    seen = torch.zeros((1, c.head_size), dtype=torch.bool)
    seen[0, torch.as_tensor(prompt_speech[prompt_speech < c.head_size].astype(np.int64))] = True

    def block(generator, cache, cur, logits, recent, n_dec, min_len, fin, stacked, steps, bistream=False):
        tokens = []
        for _ in range(steps):
            tok = lm._sample(generator, logits, n_dec, recent, min_len, bistream, seen)
            seen[0, tok[0].long()] |= ~fin[0]
            stop_now = tok >= c.speech_token_size
            tok_out = torch.where(fin, torch.full_like(tok, c.eos_token), tok)
            recent = torch.where(fin[:, None], recent, torch.cat([recent[:, 1:], tok[:, None]], dim=1))
            n_dec = torch.where(fin, n_dec, n_dec + 1)
            if stacked is not None:
                logits, cache = lm.module.decode_step_fused(tok_out, cur, cache, stacked)
            else:
                logits, cache = lm.module.decode_step(tok_out, cur, cache)
            cur = cur + (~fin).to(cur.dtype)
            fin = fin | stop_now
            tokens.append(tok_out)
        return torch.stack(tokens, dim=1), logits, cur, recent, n_dec, fin

    return block


def test_sampled_tokens_with_penalty_match_the_eager_loop(any_lm, monkeypatch):
    """The Triton consumer's config: generate and generate_bistream through
    decode_graph.step draw the eager loop's tokens from a CPU generator of
    the same seed, and leave it in the same state."""
    from tests.test_torch_bistream import _request
    from tests.test_torch_decode_graph import _cat
    from tests.test_torch_lm import _prompt

    kind, _, _, lm = any_lm
    monkeypatch.setattr(lm, "cfg", dataclasses.replace(lm.cfg, tau_r=0.1, **TRITON))
    ids, types = _prompt(np.random.default_rng(1))
    chunks, prompt_text, prompt_speech = _request(2, 40, 20)

    def run(gen, patched):
        out = []
        with monkeypatch.context() as m:
            if patched:
                m.setattr(lm, "_decode_block", _eager_loop(lm, ids[types == 1]))
            out.append(_cat(list(lm.generate(ids, types, gen, 20, 60))))
            if patched:
                m.setattr(lm, "_decode_block", _eager_loop(lm, prompt_speech))
            out.append(_cat(list(lm.generate_bistream(iter(chunks), prompt_text, prompt_speech, gen, max_len=60))))
        return out

    gen, ref_gen = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    got, ref = run(gen, False), run(ref_gen, True)
    for g, r in zip(got, ref):
        assert len(g) > 0
        np.testing.assert_array_equal(g, r)
    assert len(set(got[0].tolist())) > 5
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def test_set_sampling_keeps_weights_and_arenas(tmp_path):
    """CosyVoice2.set_sampling replaces the LM's sampling config in place
    (arguments left None keep their values) and returns it; the LM keeps
    its module, static arenas and decoder; a request then runs."""
    from tests.test_torch_api import _write_dir

    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    api = CosyVoice2(_write_dir(tmp_path), device="cpu")
    lm, module, arenas, decoder = api.lm, api.lm.module, api.lm.arenas, api.lm.decoder
    before = api.set_sampling()
    cfg = api.set_sampling(**TRITON)
    assert before.temperature == before.repetition_penalty == 1.0
    assert (cfg.top_p, cfg.top_k, cfg.temperature, cfg.repetition_penalty) == (0.95, 50, 0.8, 1.1)
    assert api.lm is lm and lm.module is module and lm.arenas is arenas and lm.decoder is decoder
    assert api.engine.lm.cfg is cfg and api.set_sampling(top_k=25).top_p == 0.95
    wav = (np.random.default_rng(0).standard_normal((1, 8000)) * 0.1).astype(np.float32)
    out = list(api.inference_cross_lingual("Hi.", wav))
    assert out and np.isfinite(out[0]["tts_speech"]).all() and len(out[0]["speech_tokens"]) > 0
    assert decoder.state.seen is not None


@pytest.mark.cuda
def test_graph_decode_with_penalty_matches_eager_on_the_card():
    """On a card, the Triton consumer's sampling config: generate and
    generate_bistream replayed from CUDA graphs draw the eager path's
    tokens, the generator left in the same state; each graph is keyed by
    the config, so the default config's graphs are not replayed under it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs and the kernels run only on the GPU")
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.engine import random_lm

    qwen = Qwen2Config(hidden_size=384, num_layers=2, num_heads=6, num_kv_heads=2, head_dim=64,
                       intermediate_size=448, vocab_size=1000, max_cache_len=1024)
    lm, _ = random_lm(0, "cuda", LMConfig(qwen=qwen))
    rng = np.random.default_rng(0)
    ids = np.concatenate([[0], rng.integers(0, 1000, 20), [1], rng.integers(0, 6561, 30)]).astype(np.int32)
    types = np.array([2] + [0] * 20 + [2] + [1] * 30, np.int32)
    chunks = [rng.integers(0, 1000, n) for n in (3, 7, 1, 11, 3, 7)]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(3)
        out = (np.concatenate(list(lm.generate(ids, types, gen, 100, 200))),
               np.concatenate(list(lm.generate_bistream(iter(chunks), ids[1:5], ids[-30:], gen, max_len=120))))
        return out, gen.get_state()

    run()  # graphs at the default config
    default_keys = set(lm.decoder.graphs)
    lm.cfg = dataclasses.replace(lm.cfg, **TRITON)
    graph_out, graph_state = run()
    assert set(lm.decoder.graphs) - default_keys and all(k[-1][-1] == 1.1 for k in set(lm.decoder.graphs) - default_keys)
    lm.graphs = False
    eager_out, eager_state = run()
    for g, e in zip(graph_out, eager_out):
        np.testing.assert_array_equal(g, e)
    assert torch.equal(graph_state, eager_state)
