"""The port's CosyVoice-300M (v1) LM (models/llm_v1.py) against the JAX
package at tiny width, float32, CPU: the WeNet text encoder
(`ConformerEncoder`, full and causal-chunk masks, padded rows), the
rel-pos layer's `full` pass, `prepare` (prompt assembly with a speaker and
with the zero speaker row of instruct mode), `lm_step` against the JAX
step (the projected-table window against the JAX slice of q_v . P_full)
and against a longer prefill, and greedy `generate` (eos suppressed before
min_len, stops, max_len)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm_v1 import TransformerLM as JTransformerLM
from cosyvoice_tpu.nn.conformer import ConformerEncoder as JConformerEncoder
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config, TransformerLM
from cosyvoice_tpu_torch.nn.conformer import ConformerEncoder
from tests.test_torch_common import jax_lm_v1_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 2e-4  # float32 through 1 + 2 layers, different summation orders


@pytest.mark.parametrize("streaming,chunk", [(False, 0), (True, 1), (True, 3)])
def test_conformer_encoder_matches_jax(streaming, chunk):
    """Full attention and static chunks of 1 and 3 frames, over a batch whose
    second row is padded."""
    jenc = JConformerEncoder(output_size=32, attention_heads=4, linear_units=48, num_blocks=2, input_layer="linear",
                             static_chunk_size=chunk)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    lens = np.array([11, 7])
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens))
    want, wmask = jenc.apply(params, jnp.asarray(x), jnp.asarray(lens), streaming=streaming)
    enc = load_jax_params(ConformerEncoder(24, 32, 4, 48, 2, static_chunk_size=chunk), np_tree(params["params"]))
    with torch.no_grad():
        got, mask = enc(torch.from_numpy(x), torch.from_numpy(lens), streaming=streaming)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    valid = np.asarray(wmask)[..., None]
    np.testing.assert_allclose(got.numpy() * valid, np.asarray(want) * valid, rtol=0, atol=ATOL)


EOS_BIAS = 1.0  # raised eos logit: the greedy streams below stop at, past and before min_len, or run to max_len


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_lm_v1_cfg(top_k=1, tau_r=2.0)
    jlm = JTransformerLM(jcfg)
    tree = np_tree(jlm.init(jax.random.PRNGKey(0))["params"])
    tree["llm_decoder"]["bias"] = tree["llm_decoder"]["bias"].copy()
    tree["llm_decoder"]["bias"][jcfg.speech_token_size] += EOS_BIAS
    lm = TransformerLM(to_port_cfg(jcfg, LMv1Config), device="cpu")
    load_jax_params(lm.module, tree)
    return jlm, {"params": jax.tree.map(jnp.asarray, tree)}, lm


def _inputs(seed, n_text=6, n_prompt=3, spk=True):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 100, n_text).astype(np.int32)
    pst = rng.integers(0, 30, n_prompt).astype(np.int32)
    emb = rng.standard_normal((1, 192)).astype(np.float32) if spk else np.zeros((1, 192), np.float32)
    return text, emb, pst


def _padded(a, n):
    out = np.zeros((1, n), np.int32)
    out[0, : len(a)] = a
    return out


@pytest.mark.parametrize("spk", [True, False], ids=["speaker", "instruct_zero_speaker"])
def test_prepare_and_steps_match_jax(pair, spk):
    """prepare's logits and arena rows, then 6 teacher-forced lm_steps."""
    jlm, params, lm = pair
    text, emb, pst = _inputs(1, spk=spk)
    tp, pp = _padded(text, 32), _padded(pst, 32)
    jk, jv = jlm.init_cache(1)
    jlogits, jk, jv, jtotal = jlm._jit_prepare(params, jnp.asarray(tp), jnp.asarray([len(text)]), jnp.asarray(emb),
                                               jnp.asarray(pp), jnp.asarray([len(pst)]), jk, jv)
    k, v = lm.init_cache(1)
    with torch.no_grad():
        logits, total = lm.module.prepare(torch.from_numpy(tp).long(), torch.tensor([len(text)]), torch.from_numpy(emb),
                                          torch.from_numpy(pp).long(), torch.tensor([len(pst)]), k, v)
        assert int(total[0]) == int(jtotal[0]) == 3 + len(text) + len(pst)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
        T = int(total[0])
        np.testing.assert_allclose(k[:, :, :T].numpy(), np.asarray(jk)[:, :, :T], rtol=0, atol=ATOL)
        for step, tok in enumerate([3, 17, 29, 0, 5, 11]):
            cur = T + step
            jlogits, jk, jv = jlm.module.apply(params, jnp.asarray([tok]), jnp.asarray([cur]), jk, jv,
                                               method="lm_step")
            logits = lm.module.lm_step(torch.tensor([tok]), cur, k, v)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL, err_msg=f"step {step}")
        np.testing.assert_allclose(v[:, :, : T + 6].numpy(), np.asarray(jv)[:, :, : T + 6], rtol=0, atol=ATOL)


def test_step_equals_a_longer_prefill(pair):
    """The arena step's logits equal a prefill whose prompt holds the token."""
    _, _, lm = pair
    text, emb, pst = _inputs(2)
    args = lambda p: (torch.from_numpy(_padded(text, 32)).long(), torch.tensor([len(text)]), torch.from_numpy(emb),  # noqa: E731
                      torch.from_numpy(_padded(p, 32)).long(), torch.tensor([len(p)]))
    with torch.no_grad():
        k, v = lm.init_cache(1)
        _, total = lm.module.prepare(*args(pst), k, v)
        step = lm.module.lm_step(torch.tensor([7]), int(total[0]), k, v)
        ref, _ = lm.module.prepare(*args(np.append(pst, 7)), *lm.init_cache(1))
    np.testing.assert_allclose(step.numpy(), ref.numpy(), rtol=0, atol=ATOL)


def test_pos_tables_follow_the_weights(pair):
    """The projected tables are built once and again after a load changes
    a linear_pos weight."""
    _, params, lm = pair
    first = lm.module.pos_tables()
    assert lm.module.pos_tables() is first
    assert first[0].shape == (2 * lm.cfg.max_cache_len - 1, lm.cfg.lm_heads, lm.cfg.llm_output_size // lm.cfg.lm_heads)
    load_jax_params(lm.module, np_tree(params["params"]))
    assert lm.module.pos_tables() is not first


# seed 0 stops past min_len, 1 at it, 2 runs to max_len (and is cut at 10),
# 0 with min_len 12 has its early eos suppressed
@pytest.mark.parametrize("seed,min_len,max_len,spk", [(0, 4, 60, True), (1, 4, 60, True), (2, 4, 60, True),
                                                     (2, 4, 10, True), (0, 12, 60, True), (3, 4, 60, False)])
def test_greedy_generate_matches_jax(pair, seed, min_len, max_len, spk):
    jlm, params, lm = pair
    text, emb, pst = _inputs(seed, spk=spk)
    want = np.concatenate(list(jlm.generate(params, text, emb, pst, jax.random.PRNGKey(0), min_len, max_len))
                          or [np.zeros(0, np.int32)])
    got = np.concatenate(list(lm.generate(text, emb, pst, torch.Generator().manual_seed(0), min_len, max_len))
                         or [np.zeros(0, np.int32)])
    np.testing.assert_array_equal(got, want)
    assert min_len <= len(got) <= max_len
