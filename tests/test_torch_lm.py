"""The port's Qwen2 speech LM against the JAX package at tiny width, float32:
prefill logits, decode-step logits (the decode step runs the K1/K2 wrappers'
plain versions on CPU), and the greedy token stream of `generate`; the same
for the quantised LM (int4p weights with the int8 KV arena, and the int8 KV
arena alone, whose decode step runs the K4/K2/K3/K6 wrappers' plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT, Qwen2LM as JQwen2LM
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from cosyvoice_tpu_torch.ops.sampling import nucleus_sampling, ras_sampling, ras_sampling_batch
from tests.test_torch_common import jax_lm_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 2e-4  # float32 logits through 2 layers, different summation orders


def _prompt(rng, n_text=7, n_speech=5):
    ids = np.concatenate([[0], rng.integers(0, 100, n_text), [1], rng.integers(0, 20, n_speech)]).astype(np.int32)
    types = np.concatenate(
        [[TYPE_SPECIAL], np.full(n_text, TYPE_TEXT), [TYPE_SPECIAL], np.full(n_speech, TYPE_SPEECH)]
    ).astype(np.int32)
    return ids, types


@pytest.fixture(scope="module")
def pair():
    # greedy: top_k=1, and tau_r so large the RAS resample can never fire
    jcfg = jax_lm_cfg(top_k=1, tau_r=2.0)
    jlm = JQwen2LM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    lm = Qwen2LM(to_port_cfg(jcfg, LMConfig), device="cpu")
    load_jax_params(lm.module, np_tree(params["params"]))
    return jlm, params, lm


def test_prefill_and_decode_logits_match(pair):
    jlm, params, lm = pair
    ids, types = _prompt(np.random.default_rng(0))
    T = len(ids)
    jcache = jlm.init_cache(1, length=64)
    jlogits, jcache = jlm._jit_prefill(params, jnp.asarray(ids[None]), jnp.asarray(types[None]), jnp.asarray([T]), jcache)
    cache = lm.init_cache(1)
    with torch.inference_mode():
        logits, cache = lm.module.prefill(
            torch.from_numpy(ids[None]).long(), torch.from_numpy(types[None]).long(), torch.tensor([T]), cache
        )
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    for step, tok in enumerate([3, 17, 20, 5]):
        cur = T + step
        jlogits, jcache = jlm.module.apply(
            params, jnp.asarray([tok]), jnp.asarray([cur]), jcache, method="decode_step"
        )
        with torch.inference_mode():
            logits, cache = lm.module.decode_step(
                torch.tensor([tok]), torch.tensor([cur], dtype=torch.int32), cache
            )
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    # the arena rows written so far match the JAX arena
    np.testing.assert_allclose(cache[0][:, :, : T + 4].numpy(), np.asarray(jcache[0])[:, :, : T + 4], atol=ATOL)


# prompts chosen so that the streams end at max_len (0), at a stop id (6) and
# at a stop id just past min_len (4)
@pytest.mark.parametrize("seed,min_len,max_len", [(0, 4, 40), (6, 4, 40), (4, 8, 40)])
def test_greedy_generate_matches_jax(pair, seed, min_len, max_len):
    jlm, params, lm = pair
    ids, types = _prompt(np.random.default_rng(seed))
    want = np.concatenate(
        list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), min_len, max_len)) or [np.zeros(0, np.int32)]
    )
    gen = torch.Generator().manual_seed(0)
    got = np.concatenate(list(lm.generate(ids, types, gen, min_len, max_len)) or [np.zeros(0, np.int32)])
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


def test_nucleus_keeps_the_crossing_element_and_samples_its_head():
    """Distribution test: probs [0.5, 0.25, 0.15, 0.1], top_p 0.8 keeps the
    first three (exclusive cumsum 0, 0.5, 0.75 < 0.8), renormalised."""
    logp = torch.log(torch.tensor([[0.1, 0.5, 0.15, 0.25]])).expand(20000, 4)
    gen = torch.Generator().manual_seed(0)
    draws = nucleus_sampling(logp, gen, top_p=0.8, top_k=25)
    freq = torch.bincount(draws, minlength=4).double() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), [0.0, 0.5 / 0.9, 0.15 / 0.9, 0.25 / 0.9], atol=0.015)


def test_ras_resamples_a_repeated_candidate():
    """A candidate repeated >= win*tau_r times in the window is replaced by a
    draw with it banned; with top_k=1 the candidate is the argmax."""
    logp = torch.log_softmax(torch.tensor([[5.0, 0.0, 0.0, 0.0]]).expand(4000, 4), dim=-1)
    recent = torch.zeros((4000, 10), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    out = ras_sampling_batch(logp, recent, torch.full((4000,), 10), gen, top_k=1, tau_r=0.1)
    assert (out != 0).all()
    freq = torch.bincount(out.long(), minlength=4)[1:].double() / 4000
    np.testing.assert_allclose(freq.numpy(), [1 / 3] * 3, atol=0.04)
    out = ras_sampling_batch(logp, recent, torch.zeros(4000, dtype=torch.int32), gen, top_k=1, tau_r=0.1)
    assert (out == 0).all()  # empty window: no repetition
    assert ras_sampling(logp[0], recent[0], 10, gen, top_k=1, tau_r=0.1).item() != 0  # single-row form


# ---------------------------------------------------------------- quantised LM


def _quant_pair(quant):
    """JAX Qwen2LM with an int8 KV arena (and int4p weights when `quant`),
    its params quantised from an fp init by the JAX quantize_lm_params, and
    the port loaded from the same tree through convert.py."""
    from cosyvoice_tpu.ops.quant import quantize_lm_params

    from tests.test_torch_common import jax_lm_cfg_quant

    jcfg = jax_lm_cfg_quant(quant=quant, kv_quant=True, top_k=1, tau_r=2.0)
    fp = JQwen2LM(jax_lm_cfg_quant(quant=False, kv_quant=False)).init(jax.random.PRNGKey(1))
    params = {"params": quantize_lm_params(np_tree(fp["params"]), quant)} if quant else fp
    jlm = JQwen2LM(jcfg)
    lm = Qwen2LM(to_port_cfg(jcfg, LMConfig), device="cpu")
    load_jax_params(lm.module, np_tree(params["params"]))
    return jlm, jax.tree.map(jnp.asarray, params), lm


@pytest.fixture(scope="module", params=["int4p", False], ids=["int4p_kv8", "kv8"])
def quant_pair(request):
    return _quant_pair(request.param)


# Logits of the int8-KV LM, JAX (XLA on CPU) against the port, float32. Both
# quantise the same rope output per token, but float32 sums in another order
# can move a value across a rounding boundary of its int8 grid: one step of
# the row's scale (absmax/127, ~1% of the row's largest |value|) in one K or V
# element. Measured (CPU, these tiny widths, prompts of seeds 1-3): at most
# 3.8e-6 where no step flips, 8.1e-4 with one flipped K step (kv8, prompt
# seed 3; logits up to 3.6 in size). Limit 5e-3, six times the flip's effect.
ATOL_KV8 = 5e-3


# prompt 3 flips one int8 K step in the kv8 LM
@pytest.mark.parametrize("prompt_seed", [1, 3])
def test_quant_prefill_and_decode_logits_match(quant_pair, prompt_seed):
    """Prefill logits, then 8 teacher-forced decode steps: the port's decode
    goes through the kernels' wrappers (plain versions on CPU: K4, K2 int8,
    K3, K6 for int4p), the JAX CPU path through XLA."""
    jlm, params, lm = quant_pair
    ids, types = _prompt(np.random.default_rng(prompt_seed))
    T = len(ids)
    jcache = jlm.init_cache(1, length=64)
    jlogits, jcache = jlm._jit_prefill(params, jnp.asarray(ids[None]), jnp.asarray(types[None]), jnp.asarray([T]), jcache)
    cache = lm.init_cache(1)
    assert [c.dtype for c in cache] == [torch.int8, torch.int8, torch.float32, torch.float32]
    with torch.inference_mode():
        logits, cache = lm.module.prefill(
            torch.from_numpy(ids[None]).long(), torch.from_numpy(types[None]).long(), torch.tensor([T]), cache
        )
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL_KV8)
    for step, tok in enumerate([3, 17, 20, 5, 0, 11, 19, 2]):
        cur = T + step
        jlogits, jcache = jlm.module.apply(params, jnp.asarray([tok]), jnp.asarray([cur]), jcache, method="decode_step")
        with torch.inference_mode():
            logits, cache = lm.module.decode_step(torch.tensor([tok]), torch.tensor([cur], dtype=torch.int32), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL_KV8)
    # the int8 rows and scales written so far: equal but for flipped steps
    n = T + 8
    dk = cache[0][:, :, :n].int() - torch.from_numpy(np.array(jcache[0])[:, :, :n]).int()
    assert dk.abs().max() <= 1 and (dk != 0).float().mean() < 1e-3
    np.testing.assert_allclose(cache[2][:, :, :n].numpy(), np.asarray(jcache[2])[:, :, :n], rtol=1e-5)


@pytest.mark.parametrize("seed,min_len,max_len", [(0, 4, 40), (6, 4, 40)])
def test_quant_greedy_generate_matches_jax(quant_pair, seed, min_len, max_len):
    jlm, params, lm = quant_pair
    ids, types = _prompt(np.random.default_rng(seed))
    want = np.concatenate(
        list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), min_len, max_len)) or [np.zeros(0, np.int32)]
    )
    got = np.concatenate(list(lm.generate(ids, types, torch.Generator().manual_seed(0), min_len, max_len))
                         or [np.zeros(0, np.int32)])
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


def test_int4p_with_bf16_arena_is_refused_naming_k7():
    from tests.test_torch_common import jax_lm_cfg_quant

    with pytest.raises(NotImplementedError, match="K7"):
        Qwen2LM(to_port_cfg(jax_lm_cfg_quant(quant="int4p", kv_quant=False), LMConfig), device="cpu")
