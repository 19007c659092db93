"""The port's Qwen2 speech LM against the JAX package at tiny width, float32:
prefill logits, decode-step logits (the decode step runs the K1/K2 wrappers'
plain versions on CPU), and the greedy token stream of `generate`; the same
for the quantised LM (int4p weights with the int8 KV arena, and the int8 KV
arena alone, whose decode step runs the K4/K2/K3/K6 wrappers' plain versions)
and for int4p weights with a bf16 arena, whose B=1 decode step runs K7's
plain version and K2 (the JAX LM through its Pallas kernel in interpret
mode, `COSY_INT4_BLOCK=force`). The arena grows in ARENA_BUCKET steps on
both sides; with small buckets the streams cross K7's arena limit."""

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


def _quant_pair(quant, kv_quant=True):
    """JAX Qwen2LM with int4p weights (when `quant`) and an int8 KV arena
    (when `kv_quant`), its params quantised from an fp init by the JAX
    quantize_lm_params, and the port loaded from the same tree through
    convert.py."""
    from cosyvoice_tpu.ops.quant import quantize_lm_params

    from tests.test_torch_common import jax_lm_cfg_quant

    jcfg = jax_lm_cfg_quant(quant=quant, kv_quant=kv_quant, top_k=1, tau_r=2.0)
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


# ---------------------------------------------------------------- int4p with a bf16 arena (K7)


@pytest.fixture(scope="module")
def int4p_pair():
    return _quant_pair("int4p", kv_quant=False)


# Logits of the fused step, the JAX Pallas kernel (interpret mode) against
# the port's plain version of K7: the Pallas kernel rounds x, q and the
# softmax weights to bf16 and decodes nibbles by its "fold" scheme, the plain
# version follows the XLA reference (float32 there). Measured: <= 2.8e-2 over
# 22 steps (prompt 1, logits up to ~4). Limit 6e-2, the limit
# tests/test_int4_block.py sets between the JAX fused and unfused steps.
ATOL_K7 = 6e-2


def test_int4p_fused_step_matches_jax(int4p_pair):
    """Teacher-forced fused steps (JAX's greedy stream of prompt 1): logits
    and committed rows within ATOL_K7, every other arena row untouched. The
    greedy choices agree except where JAX's top-two margin is below the
    logits' difference: prompt 1 has one such near tie (margin 1.8e-2 at
    step 19), where the port picks the other token."""
    from cosyvoice_tpu.ops.int4_block import stack_decode_params as jstack

    jlm, params, lm = int4p_pair
    ids, types = _prompt(np.random.default_rng(1))
    T, A = len(ids), 64
    want = np.concatenate(list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), 4, 40)))
    jcache = jlm.init_cache(1, length=A)
    jlogits, jcache = jlm._jit_prefill(params, jnp.asarray(ids[None]), jnp.asarray(types[None]), jnp.asarray([T]), jcache)
    jstacked = jstack([params["params"]["llm"][f"layers_{i}"] for i in range(lm.cfg.qwen.num_layers)])
    cache = lm.init_cache(1, A)
    assert [c.dtype for c in cache] == [torch.float32, torch.float32]
    with torch.inference_mode():
        logits, cache = lm.module.prefill(
            torch.from_numpy(ids[None]).long(), torch.from_numpy(types[None]).long(), torch.tensor([T]), cache
        )
        stacked = lm._decode_pack(cache)
    assert stacked is not None
    flips = 0
    for step, tok in enumerate(want[:22]):
        cur = T + step
        before = [c.clone() for c in cache]
        jlogits, jcache = jlm.module.apply(
            params, jnp.asarray([tok]), jnp.asarray([cur]), jcache, jstacked, method="decode_step_fused"
        )
        with torch.inference_mode():
            logits, cache = lm.module.decode_step_fused(
                torch.tensor([int(tok)]), torch.tensor([cur], dtype=torch.int32), cache, stacked
            )
        j, t = np.asarray(jlogits)[0], logits.numpy()[0]
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL_K7)
        if t.argmax() != j.argmax():
            top2 = np.sort(j)[-2:]
            assert top2[1] - top2[0] <= np.abs(t - j).max()
            flips += 1
        for got, ref, old in zip(cache, jcache, before):
            np.testing.assert_allclose(got[:, 0, cur].numpy(), np.asarray(ref)[:, 0, cur], rtol=0, atol=ATOL_K7)
            keep = torch.arange(A) != cur
            assert torch.equal(got[:, :, keep], old[:, :, keep])
    assert flips <= 1


def test_int4p_pack_is_cached_rebuilt_after_a_load_and_gated():
    """The stacked K7 weights are built once, rebuilt when convert.py loads
    other weights into the module, and refused where the JAX gate refuses
    them: B > 1, an arena over MAX_FUSED_ARENA rows, an int8 arena."""
    from cosyvoice_tpu.ops.quant import quantize_lm_params
    from cosyvoice_tpu_torch.ops import int4_block as tblock

    from tests.test_torch_common import jax_lm_cfg_quant

    fp_cfg = jax_lm_cfg_quant(quant=False, kv_quant=False)
    trees = [quantize_lm_params(np_tree(JQwen2LM(fp_cfg).init(jax.random.PRNGKey(k))["params"]), "int4p")
             for k in (5, 6)]
    lm = Qwen2LM(to_port_cfg(jax_lm_cfg_quant(quant="int4p", kv_quant=False), LMConfig), device="cpu")
    load_jax_params(lm.module, trees[0])
    cache = lm.init_cache(1, 64)
    first = lm._decode_pack(cache)
    assert lm._decode_pack(lm.grow_cache(cache, 96)) is first
    load_jax_params(lm.module, trees[1])
    second = lm._decode_pack(cache)
    assert second is not first
    want = tblock.stack_decode_params(lm.module.llm.layers)
    assert all(torch.equal(second[k], want[k]) for k in want)
    assert not torch.equal(second["qkv_p"], first["qkv_p"])
    assert lm._decode_pack(lm.init_cache(2, 64)) is None
    assert lm._decode_pack(lm.init_cache(1, tblock.MAX_FUSED_ARENA + 1)) is None
    kv8 = Qwen2LM(to_port_cfg(jax_lm_cfg_quant(quant="int4p", kv_quant=True), LMConfig), device="cpu")
    assert kv8._decode_pack(kv8.init_cache(1, 64)) is None


@pytest.mark.parametrize("seed,min_len,max_len", [(0, 4, 40), (3, 4, 40), (7, 4, 40)])
def test_int4p_greedy_generate_matches_jax(int4p_pair, monkeypatch, seed, min_len, max_len):
    """Every decode step of both LMs goes through the fused step: K7 (the
    port: its plain version and K2) and the JAX Pallas kernel in interpret
    mode, which its LM takes off TPU only under COSY_INT4_BLOCK=force."""
    jlm, params, lm = int4p_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    ids, types = _prompt(np.random.default_rng(seed))
    want = np.concatenate(list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), min_len, max_len)))
    steps, fused = lm.decode_steps, lm.fused_steps
    got = np.concatenate(list(lm.generate(ids, types, torch.Generator().manual_seed(0), min_len, max_len)))
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0
    assert lm.fused_steps - fused == lm.decode_steps - steps > 0


def _record_routes(monkeypatch, jlm, lm):
    """Both LMs' per-block route decisions: [(arena rows, fused?)] each."""
    routes = {"jax": [], "port": []}
    jpack, tpack = jlm._decode_pack, lm._decode_pack

    def jax_pack(params, cache):
        pack = jpack(params, cache)
        routes["jax"].append((cache[0].shape[2], pack is not None))
        return pack

    def port_pack(cache):
        pack = tpack(cache)
        routes["port"].append((cache[0].shape[2], pack is not None))
        return pack

    monkeypatch.setattr(jlm, "_decode_pack", jax_pack)
    monkeypatch.setattr(lm, "_decode_pack", port_pack)
    return routes


def _small_buckets(monkeypatch, jlm, lm, max_fused):
    """ARENA_BUCKET 32 on both LMs and MAX_FUSED_ARENA `max_fused` in both
    packages. The tiny configs pad the prompt to 64 rows, so the first arena
    has arena_bucket(64 + 8 + 1) = 96 rows."""
    from cosyvoice_tpu.ops import int4_block as jblock
    from cosyvoice_tpu_torch.ops import int4_block as tblock

    for obj in (jlm, lm):
        monkeypatch.setattr(obj, "ARENA_BUCKET", 32)
    for mod in (jblock, tblock):
        monkeypatch.setattr(mod, "MAX_FUSED_ARENA", max_fused)


def _generate_both(jlm, params, lm, seed, min_len, max_len):
    ids, types = _prompt(np.random.default_rng(seed))
    want = np.concatenate(list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), min_len, max_len)))
    got = np.concatenate(list(lm.generate(ids, types, torch.Generator().manual_seed(0), min_len, max_len)))
    return want, got


def test_int4p_arena_growth_crosses_the_route_switch_like_jax(int4p_pair, monkeypatch):
    """With a 32-row bucket and MAX_FUSED_ARENA 96, both LMs decode the first
    blocks through the fused step over a 96-row arena, then grow it and take
    the per-layer kernels (the port: K4 + K1 + K6, plain on CPU) from the
    block whose arena exceeds 96 rows: equal tokens, equal arena lengths and
    routes before every block."""
    jlm, params, lm = int4p_pair
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    _small_buckets(monkeypatch, jlm, lm, 96)
    routes = _record_routes(monkeypatch, jlm, lm)
    steps, fused = lm.decode_steps, lm.fused_steps
    want, got = _generate_both(jlm, params, lm, 3, 100, 150)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 150
    assert routes["port"] == routes["jax"]
    lengths, fused_blocks = zip(*routes["port"])
    assert list(lengths) == sorted(lengths) and lengths[0] == 96 and lengths[-1] > 128
    n_fused = sum(fused_blocks)
    assert fused_blocks == (True,) * n_fused + (False,) * (len(fused_blocks) - n_fused) and 0 < n_fused < len(lengths)
    assert all(n <= 96 for n in lengths[:n_fused]) and lengths[n_fused] > 96
    assert lm.fused_steps - fused == n_fused * lm.cfg.block_size < lm.decode_steps - steps


def _check_growth(monkeypatch, jlm, params, lm, seed):
    """A 150-token stream with a 32-row bucket: the arena grows from 96 to
    192 rows, as the JAX LM's does; equal tokens and equal arena lengths
    before every block."""
    _small_buckets(monkeypatch, jlm, lm, 96)
    routes = _record_routes(monkeypatch, jlm, lm)
    want, got = _generate_both(jlm, params, lm, seed, 100, 150)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 150
    assert routes["port"] == routes["jax"]
    lengths = [n for n, fused in routes["port"] if not fused]
    assert len(lengths) == len(routes["port"]) and lengths[0] == 96 and lengths[-1] == 192


def test_arena_growth_matches_jax(pair, monkeypatch):
    _check_growth(monkeypatch, *pair, seed=2)


def test_quant_arena_growth_matches_jax(quant_pair, monkeypatch):
    """Both int8-KV LMs (int4p and bf16 weights)."""
    _check_growth(monkeypatch, *quant_pair, seed=3)
