"""The port's LM in the CosyVoice3 layout against the JAX package at tiny
width, float32: sos / task / fill in the speech table, 200 stop rows, a
bias-less head (an nn.Linear, or the int8 QuantDense in int4p mode), for the
three LM configurations: float weights and arena; int4p weights over an int8
KV arena; int4p weights over a float arena, whose B=1 decode steps run K7's
plain version (the JAX LM through its Pallas kernel in interpret mode,
`COSY_INT4_BLOCK=force`). Greedy token streams of `generate` and
`generate_bistream`, and the v3 stop mask: before min_len the whole special
range is suppressed, as the JAX LM does (not eos alone)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT, Qwen2LM as JQwen2LM
from cosyvoice_tpu.ops.quant import quantize_lm_params as j_quantize
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.decode_graph import stop_mask
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from cosyvoice_tpu_torch.ops.quant import quantize_lm_params
from tests.test_torch_common import jax_lm_cfg_quant_v3, jax_lm_cfg_v3, np_tree, to_port_cfg

torch.set_num_threads(1)

LMS = ["fp", "int4p_kv8", "int4p_bf16"]
GREEDY = dict(top_k=1, tau_r=2.0)  # argmax, and RAS never resamples
SPECIAL_SCALE = 0.2  # the special columns of the head scaled down: random streams run long


def _tree(kind):
    """(JAX config, fp param tree) of one LM configuration."""
    if kind == "fp":
        jcfg = jax_lm_cfg_v3(**GREEDY)
        return jcfg, np_tree(JQwen2LM(jcfg).init(jax.random.PRNGKey(0))["params"])
    jcfg = jax_lm_cfg_quant_v3(quant="int4p", kv_quant=kind == "int4p_kv8", **GREEDY)
    fp_cfg = jax_lm_cfg_quant_v3(quant=False, kv_quant=False)
    return jcfg, np_tree(JQwen2LM(fp_cfg).init(jax.random.PRNGKey(1))["params"])


def _damped(tree, cfg):
    """`tree` with the head's special columns scaled by SPECIAL_SCALE."""
    head = dict(tree["llm_decoder"])
    k = np.array(head["kernel"])
    k[:, cfg.speech_token_size :] *= SPECIAL_SCALE
    return {**tree, "llm_decoder": {**head, "kernel": k}}


def _pair(kind, damp=False):
    jcfg, fp = _tree(kind)
    if damp:
        fp = _damped(fp, jcfg)
    tree = fp if kind == "fp" else j_quantize(fp, "int4p")
    lm = Qwen2LM(to_port_cfg(jcfg, LMConfig), device="cpu")
    load_jax_params(lm.module, tree)
    return JQwen2LM(jcfg), {"params": jax.tree.map(jnp.asarray, tree)}, lm


@pytest.fixture(scope="module", params=LMS)
def lms(request):
    return request.param, _pair(request.param), _pair(request.param, damp=True)


def _prompt(cfg, rng, n_text=7, n_speech=5):
    ids = np.concatenate([[cfg.sos_id], rng.integers(0, 100, n_text), [cfg.task_id],
                          rng.integers(0, cfg.speech_token_size, n_speech)]).astype(np.int32)
    types = np.concatenate(
        [[TYPE_SPECIAL], np.full(n_text, TYPE_TEXT), [TYPE_SPECIAL], np.full(n_speech, TYPE_SPEECH)]
    ).astype(np.int32)
    return ids, types


def test_v3_layout_ids_and_tree():
    cfg = to_port_cfg(jax_lm_cfg_v3(), LMConfig)
    assert (cfg.head_size, cfg.sos_id, cfg.eos_token, cfg.task_id, cfg.fill_token) == (220, 20, 20, 22, 23)
    full = LMConfig(speech_token_size=6561, num_special_head=200, special_in_speech_table=True)
    assert (full.head_size, full.sos_id, full.task_id, full.fill_token) == (6761, 6561, 6563, 6564)
    assert stop_mask(cfg, False) == "v3 min_len" and stop_mask(cfg, True) == "bistream"
    assert stop_mask(LMConfig(), False) == "v2 min_len"
    jcfg, fp = _tree("fp")
    assert "llm_embedding" not in fp and set(fp["llm_decoder"]) == {"kernel"}
    lm = Qwen2LM(cfg, device="cpu")
    load_jax_params(lm.module, fp)
    assert lm.module.llm_decoder.bias is None and not hasattr(lm.module, "llm_embedding")
    assert export_params(lm.module)["params"].keys() == fp.keys()


def test_quantize_bias_less_head_matches_jax():
    """ops/quant.quantize_lm_params on the v3 tree: the JAX tree leaf for
    leaf, an int8 head with no bias; the int4p module loads it, and a stray
    leaf still raises."""
    _, fp = _tree("int4p_kv8")
    want = j_quantize(fp, "int4p")
    got = quantize_lm_params(fp, "int4p")
    a = dict(jax.tree_util.tree_leaves_with_path(want))
    b = dict(jax.tree_util.tree_leaves_with_path(got))
    assert a.keys() == b.keys() and set(got["llm_decoder"]) == {"kernel_q", "scale"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    lm = Qwen2LM(to_port_cfg(jax_lm_cfg_quant_v3(kv_quant=False), LMConfig), device="cpu")
    load_jax_params(lm.module, got)
    assert lm.module.llm_decoder.bias is None
    stray = {**got, "llm_decoder": {**got["llm_decoder"], "bias": np.zeros(220, np.float32)}}
    with pytest.raises(KeyError, match="llm_decoder"):
        load_jax_params(lm.module, stray)


def _both(jlm, params, lm, ids, types, min_len, max_len):
    want = np.concatenate(
        list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), min_len, max_len)) or [np.zeros(0, np.int32)])
    got = np.concatenate(list(lm.generate(ids, types, torch.Generator().manual_seed(0), min_len, max_len))
                         or [np.zeros(0, np.int32)])
    return got, want


@pytest.mark.parametrize("damp", [False, True], ids=["as_initialised", "damped_specials"])
@pytest.mark.parametrize("seed,min_len,max_len", [(0, 4, 40), (5, 9, 40)])
def test_greedy_generate_matches_jax(lms, monkeypatch, damp, seed, min_len, max_len):
    kind, plain, damped = lms
    jlm, params, lm = damped if damp else plain
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")  # the JAX int4p + bf16-arena LM through K7
    ids, types = _prompt(lm.cfg, np.random.default_rng(seed))
    steps, fused = lm.decode_steps, lm.fused_steps
    got, want = _both(jlm, params, lm, ids, types, min_len, max_len)
    if kind == "int4p_bf16" and not np.array_equal(got, want):
        _near_tie(jlm, params, lm, ids, types, got, want, min_len)
    else:
        np.testing.assert_array_equal(got, want)
    assert len(got) >= min_len
    if kind == "int4p_bf16":
        assert lm.fused_steps - fused == lm.decode_steps - steps > 0
    if damp:
        assert len(got) > min_len  # the stream runs past the mask


def _near_tie(jlm, params, lm, ids, types, got, want, min_len):
    """The K7 LM's streams part (the JAX Pallas K7 and the port's plain K7
    differ at bf16 level, ROADMAP C4): they agree up to the first
    difference, and there JAX's prefix, teacher-forced through both LMs'
    prefill and fused steps, gives logits within ATOL_K7 whose top two (in
    the rows the stop mask leaves) JAX separates by less than the logits'
    difference."""
    from cosyvoice_tpu.ops.int4_block import stack_decode_params as jstack
    from tests.test_torch_lm import ATOL_K7

    d = next(i for i in range(min(len(got), len(want)) + 1) if i == len(got) or i == len(want) or got[i] != want[i])
    np.testing.assert_array_equal(got[:d], want[:d])
    T, A = len(ids), 64
    jcache = jlm.init_cache(1, length=A)
    jlogits, jcache = jlm._jit_prefill(params, jnp.asarray(ids[None]), jnp.asarray(types[None]), jnp.asarray([T]),
                                       jcache)
    jstacked = jstack([params["params"]["llm"][f"layers_{i}"] for i in range(lm.cfg.qwen.num_layers)])
    cache = lm.init_cache(1, A)
    with torch.inference_mode():
        logits, cache = lm.module.prefill(torch.from_numpy(ids[None]).long(), torch.from_numpy(types[None]).long(),
                                          torch.tensor([T]), cache)
        stacked = lm._decode_pack(cache)
        for step, tok in enumerate(want[:d]):
            jlogits, jcache = jlm.module.apply(params, jnp.asarray([tok]), jnp.asarray([T + step]), jcache, jstacked,
                                               method="decode_step_fused")
            logits, cache = lm.module.decode_step_fused(torch.tensor([int(tok)]),
                                                        torch.tensor([T + step], dtype=torch.int32), cache, stacked)
    j, t = np.asarray(jlogits)[0], logits.numpy()[0]
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL_K7)
    if d < min_len:
        j, t = j[: lm.cfg.speech_token_size], t[: lm.cfg.speech_token_size]
    top2 = np.sort(j)[-2:]
    assert t.argmax() != j.argmax() and top2[1] - top2[0] <= np.abs(t - j).max()


def test_min_len_mask_covers_the_special_range():
    """Logits whose every special row outscores the speech rows: before
    min_len the argmax is a speech token (the v3 mask covers [6561, 6761) at
    full size), from min_len on the top special row (a stop) is taken; the
    v2 layout masks eos alone."""
    for v3 in (True, False):
        cfg = to_port_cfg(jax_lm_cfg_v3(**GREEDY) if v3 else jax_lm_cfg_v3(**GREEDY, num_special_head=3,
                                                                          special_in_speech_table=False), LMConfig)
        lm = Qwen2LM(cfg, device="cpu")
        S = cfg.speech_token_size
        logits = torch.zeros((2, cfg.head_size))
        logits[:, 3] = 1.0
        logits[:, S:] = 5.0
        logits[:, S + 1] = 6.0  # the top special row (v2: the unused stop id)
        n_dec = torch.tensor([2, 6], dtype=torch.int32)
        min_len = torch.tensor([6, 6], dtype=torch.int32)
        recent = torch.full((2, cfg.win_size), -1, dtype=torch.int32)
        tok = lm._sample(torch.Generator().manual_seed(0), logits, n_dec, recent, min_len).tolist()
        assert tok == ([3, S + 1] if v3 else [S + 1, S + 1])


def _chunks(text):
    out, i, n = [], 0, 3
    while i < len(text):
        out.append(text[i : i + n])
        i += n
        n = 7 - n
    return out


@pytest.mark.parametrize("seed", [0, 2])
def test_greedy_bistream_matches_jax(lms, monkeypatch, seed):
    """Bi-streaming text input with the fill token (speech_token_size + 3)
    as the only legal stop in a span: the damped LM's stream against the
    JAX LM's, spans, fills and final drain."""
    from tests.test_torch_bistream import _record, _replay
    from tests.test_torch_lm import ATOL_K7

    kind, _, (jlm, params, lm) = lms
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    rec = _record(monkeypatch, jlm, lm)
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 100, 17).astype(np.int32)
    prompt_text = rng.integers(0, 100, 4).astype(np.int32)
    prompt_speech = rng.integers(0, lm.cfg.speech_token_size, 6).astype(np.int32)
    want = list(jlm.generate_bistream(params, iter(_chunks(text)), prompt_text, prompt_speech,
                                      jax.random.PRNGKey(0), max_len=60))
    got = list(lm.generate_bistream(iter(_chunks(text)), prompt_text, prompt_speech,
                                    torch.Generator().manual_seed(0), max_len=60))
    want = np.concatenate(want) if want else np.zeros(0, np.int32)
    got = np.concatenate(got) if got else np.zeros(0, np.int32)
    assert len(got) > 15 and (got < lm.cfg.speech_token_size).all()
    if kind != "int4p_bf16" or np.array_equal(got, want):
        np.testing.assert_array_equal(got, want)
        return
    # the K7 LM's streams part at a near tie (ROADMAP C4): JAX's run
    # replayed teacher-forced through both LMs' extends and K7 steps gives
    # logits within ATOL_K7, and the choices among the rows a span allows
    # (speech tokens and the fill) differ only where JAX's top two are
    # closer than the logits' difference, once
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


def test_batch_scheduler_sessions_match_jax(lms):
    """Continuous batching of the v3 LM: 3 sessions on 2 slots, each with
    its own min_len under the v3 stop mask in the batched step, equal the
    JAX LMBatchScheduler's (the batched steps never take K7)."""
    from cosyvoice_tpu.runtime.batch_scheduler import LMBatchScheduler as JScheduler
    from cosyvoice_tpu_torch.runtime.batch_scheduler import LMBatchScheduler
    from tests.test_torch_batch_scheduler import _drive

    kind, _, (jlm, params, lm) = lms
    reqs = [_prompt(lm.cfg, np.random.default_rng(s), n_text=3 + s) + (4 + 3 * s, 20 + 8 * s) for s in range(3)]
    want = _drive(JScheduler(jlm, params, max_batch=2, seed=0), reqs)
    fused = lm.fused_steps
    got = _drive(LMBatchScheduler(lm, max_batch=2), reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert reqs[i][2] <= len(g) <= reqs[i][3]
        np.testing.assert_array_equal(g, w, err_msg=f"session {i}")
    assert lm.fused_steps == fused
