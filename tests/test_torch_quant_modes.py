"""The int8 and int4 weight modes of the port's Qwen2 LM (`Qwen2Config(quant=
True | "int8" | "int4")`) against the JAX package at tiny width, float32,
on the CPU: `quantize_lm_params` bit for bit, `QuantDense4` against the JAX
`int4_matmul`, the converter both ways, and the LM with and without the
int8 KV arena: prefill and teacher-forced decode logits, greedy `generate`
through the decode step on static buffers (the function the decode graphs
capture on the card) against the JAX LM and the eager loop it replaced, the
same for greedy `generate_bistream`, and one batched wave of two sessions
through `LMBatchScheduler` against the JAX scheduler. The decode step of these modes runs the K2 and K1 (bf16 arena)
or K2 and K3 (int8 arena) wrappers, their plain versions here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu.models.qwen2 import QuantDense4 as JQuantDense4
from cosyvoice_tpu.ops import quant as jquant
from cosyvoice_tpu.runtime.batch_scheduler import LMBatchScheduler as JScheduler
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, Qwen2LMModule
from cosyvoice_tpu_torch.models.qwen2 import QuantDense, QuantDense4
from cosyvoice_tpu_torch.ops import quant as tquant
from cosyvoice_tpu_torch.runtime.batch_scheduler import LMBatchScheduler
from tests.test_torch_common import jax_lm_cfg_quant, np_tree, to_port_cfg
from tests.test_torch_quant import _assert_trees_identical

torch.set_num_threads(1)

MODES = [("int8", False), ("int8", True), ("int4", False), ("int4", True)]
IDS = ["int8", "int8_kv8", "int4", "int4_kv8"]
# float32 logits through 2 layers of dequantised products, the two packages
# summing in different orders: measured <= 4e-6 with a float arena; with the
# int8 arena one K/V element may move by one quantisation step at a rounding
# tie (tests/test_torch_lm.py:ATOL_KV8, which this file uses there)
ATOL = 2e-4
ATOL_KV8 = 5e-3


@pytest.fixture(scope="module")
def fp_tree():
    return np_tree(JQwen2LM(jax_lm_cfg_quant(quant=False, kv_quant=False)).init(jax.random.PRNGKey(1))["params"])


@pytest.mark.parametrize("mode", ["int8", True, "int4"])
def test_quantize_lm_params_is_bit_identical(fp_tree, mode):
    got, want = tquant.quantize_lm_params(fp_tree, mode), jquant.quantize_lm_params(fp_tree, mode)
    _assert_trees_identical(got, want)
    layer = got["llm"]["layers_0"]
    kind = {"kernel_q4", "scale4"} if mode == "int4" else {"kernel_q", "scale"}
    assert set(layer["mlp"]["down_proj"]) == kind and set(layer["self_attn"]["qkv_proj"]) == kind | {"bias"}
    assert set(got["llm_decoder"]) == {"kernel_q", "scale", "bias"}  # the head stays int8


def test_unknown_mode_raises(fp_tree):
    with pytest.raises(ValueError, match="int2"):
        tquant.quantize_lm_params(fp_tree, "int2")


@pytest.mark.parametrize("shape", [(64, 48), (384, 1152), (896, 896)])
def test_int4_tensor_and_matmul_match_jax(shape):
    rng = np.random.default_rng(shape[0])
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[:8, 0] = 0.0  # a zero block keeps the 1e-12 scale floor honest
    (gp, gs), (wp, ws) = tquant.quantize_tensor_int4(w), jquant.quantize_tensor_int4(w)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(tquant.unpack_int4(torch.from_numpy(gp), torch.float32).numpy(),
                                  np.asarray(jquant.unpack_int4(jnp.asarray(wp), jnp.float32)))
    x = rng.standard_normal((3, shape[0])).astype(np.float32)
    want = np.asarray(jquant.int4_matmul(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(ws), jnp.float32))
    got = tquant.int4_matmul(torch.from_numpy(x), torch.from_numpy(gp), torch.from_numpy(gs), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_quant_dense4_matches_jax():
    """QuantDense4 over the JAX QuantDense4's params (through convert.py):
    the same output, float32 and bf16 (within one bf16 step of the output)."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 96)).astype(np.float32) * 0.1
    kq, s = jquant.quantize_tensor_int4(w)
    bias = rng.standard_normal(96).astype(np.float32)
    tree = {"kernel_q4": kq, "scale4": s, "bias": bias}
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    for jdt, tdt, atol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 3e-2)):
        want = np.asarray(JQuantDense4(96, dtype=jdt).apply({"params": tree}, jnp.asarray(x)), np.float32)
        m = load_jax_params(QuantDense4(128, 96, tdt), tree)
        got = m(torch.from_numpy(x)).detach().float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_tree_round_trips_through_the_converter(fp_tree, mode):
    """The int8 leaves (kernel_q [in, out] -> [out, in], scale [1, out] ->
    [out]) and the int4 ones (kernel_q4, scale4 as they are) load and export
    back to the same tree; a leaf of the other mode raises."""
    tree = jquant.quantize_lm_params(fp_tree, mode)
    m = Qwen2LMModule(to_port_cfg(jax_lm_cfg_quant(quant=mode, kv_quant=False), LMConfig))
    load_jax_params(m, tree)
    cls = QuantDense4 if mode == "int4" else QuantDense
    assert isinstance(m.llm.layers[0].mlp.gate_up_proj, cls) and isinstance(m.llm_decoder, QuantDense)
    _assert_trees_identical(export_params(m)["params"], tree)
    other = jquant.quantize_lm_params(fp_tree, "int4" if mode == "int8" else "int8")
    with pytest.raises(KeyError, match="no port parameter"):
        load_jax_params(m, other)


def _pair(mode, kv_quant, top_k=1):
    """The JAX LM of `mode` and the port's, loaded from one quantised tree
    (the JAX quantize_lm_params of an fp init), greedy unless top_k > 1."""
    jcfg = jax_lm_cfg_quant(quant=mode, kv_quant=kv_quant, top_k=top_k, tau_r=2.0 if top_k == 1 else 0.1)
    fp = JQwen2LM(jax_lm_cfg_quant(quant=False, kv_quant=False)).init(jax.random.PRNGKey(1))
    params = {"params": jquant.quantize_lm_params(np_tree(fp["params"]), mode)}
    lm = Qwen2LM(to_port_cfg(jcfg, LMConfig), device="cpu")
    load_jax_params(lm.module, params["params"])
    return JQwen2LM(jcfg), jax.tree.map(jnp.asarray, params), lm


@pytest.fixture(scope="module", params=MODES, ids=IDS)
def pair(request):
    return _pair(*request.param)


def _cat(blocks):
    return np.concatenate(blocks) if blocks else np.zeros(0, np.int32)


def test_prefill_and_decode_logits_match_jax(pair):
    from tests.test_torch_lm import _prompt

    jlm, params, lm = pair
    atol = ATOL_KV8 if lm.cfg.qwen.kv_quant else ATOL
    ids, types = _prompt(np.random.default_rng(1))
    T = len(ids)
    jcache = jlm.init_cache(1, length=64)
    jlogits, jcache = jlm._jit_prefill(params, jnp.asarray(ids[None]), jnp.asarray(types[None]), jnp.asarray([T]),
                                       jcache)
    cache = lm.init_cache(1, 64)
    with torch.inference_mode():
        logits, cache = lm.module.prefill(torch.from_numpy(ids[None]).long(), torch.from_numpy(types[None]).long(),
                                          torch.tensor([T]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=atol)
        for step, tok in enumerate([3, 17, 20, 5, 0, 11]):
            cur = T + step
            jlogits, jcache = jlm.module.apply(params, jnp.asarray([tok]), jnp.asarray([cur]), jcache,
                                               method="decode_step")
            logits, cache = lm.module.decode_step(torch.tensor([tok]), torch.tensor([cur], dtype=torch.int32), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=atol, err_msg=f"step {step}")


@pytest.mark.parametrize("seed,min_len,max_len", [(0, 4, 40), (3, 30, 60)])
def test_greedy_generate_matches_jax_and_the_eager_loop(pair, seed, min_len, max_len, monkeypatch):
    """Greedy streams through the decode step on static buffers (what each
    decode graph captures on the card) equal the JAX LM's and the loop of
    eager calls it replaced; the 32-row buckets grow the arena mid-stream."""
    from tests.test_torch_decode_graph import _functional_block
    from tests.test_torch_lm import _prompt, _small_buckets

    jlm, params, lm = pair
    _small_buckets(monkeypatch, jlm, lm, 96)
    ids, types = _prompt(np.random.default_rng(seed))
    want = _cat(list(jlm.generate(params, ids, types, jax.random.PRNGKey(0), min_len, max_len)))
    got = _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(0), min_len, max_len)))
    with monkeypatch.context() as m:
        m.setattr(lm, "_decode_block", _functional_block(lm))
        ref = _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(0), min_len, max_len)))
    assert len(got) >= min_len
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert lm.fused_steps == 0  # K7 is the int4p route only


def test_batched_wave_matches_jax_scheduler(pair):
    """Two sessions in one wave through a 2-slot LMBatchScheduler (the B=2
    decode step over the scheduler's own arenas): each session's tokens
    equal the JAX scheduler's and the port's own B=1 generate's."""
    from tests.test_torch_batch_scheduler import _drive, _prompt

    jlm, params, lm = pair
    reqs = [(*_prompt(0), 8, 40), (*_prompt(1), 8, 40)]
    want = _drive(JScheduler(jlm, params, max_batch=2, seed=0), reqs)
    got = _drive(LMBatchScheduler(lm, max_batch=2), reqs)
    for g, w, (ids, types, lo, hi) in zip(got, want, reqs):
        assert len(g) > 0
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(0), lo, hi))))


def test_sampled_tokens_match_the_eager_loop(monkeypatch):
    """top_k 25 with RAS on (int8, int8 arena): the step on static buffers
    draws the eager loop's tokens from the same generator."""
    from tests.test_torch_decode_graph import _functional_block
    from tests.test_torch_lm import _prompt

    _, _, lm = _pair("int8", True, top_k=25)
    ids, types = _prompt(np.random.default_rng(2))
    got = _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(5), 10, 40)))
    monkeypatch.setattr(lm, "_decode_block", _functional_block(lm))
    ref = _cat(list(lm.generate(ids, types, torch.Generator().manual_seed(5), 10, 40)))
    assert len(got) >= 10
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quant_lm", [True, "int4"])
def test_api_save_pretrained_of_a_quantised_lm(tmp_path, quant_lm):
    """save_pretrained of CosyVoice2(quant_lm=...) writes the quantised LM
    tree, as the JAX API does; an API of the same mode reloads it bit for
    bit (quantisation leaves a quantised tree as it is), and an fp API
    refuses it (ROADMAP C4: the JAX fp template does not restore it
    either)."""
    from tests.test_torch_api import _wav, _write_dir
    from tests.test_torch_checkpoint import assert_same_tree
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    api = CosyVoice2(_write_dir(tmp_path / "src"), quant_lm=quant_lm, kv_quant=True, device="cpu")
    out = tmp_path / "saved"
    api.save_pretrained(str(out))
    _write_dir(out)  # the config.json beside the checkpoints
    again = CosyVoice2(str(out), quant_lm=quant_lm, device="cpu")
    assert_same_tree(export_params(again.lm.module), export_params(api.lm.module))
    assert again.lm.cfg.qwen.quant == api.lm.cfg.qwen.quant and not again.lm.cfg.qwen.kv_quant
    with pytest.raises(KeyError):
        CosyVoice2(str(out), device="cpu")
    (out1,) = again.inference_cross_lingual("Hi.", _wav(1, 1.0), text_frontend=False)
    assert out1["tts_speech"].shape[1] > 0


def test_cosyvoice3_takes_the_weight_modes(tmp_path):
    """CosyVoice3 inherits quant_lm and kv_quant: int4 weights over the int8
    arena, the v3 head int8 without bias."""
    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.runtime.api import CosyVoice3
    from tests.test_torch_common import jax_dit_flow_cfg, jax_hift_cfg_v3, jax_lm_cfg_v3

    api = CosyVoice3(lm_cfg=to_port_cfg(jax_lm_cfg_v3(), LMConfig), flow_cfg=to_port_cfg(jax_dit_flow_cfg(), FlowConfig),
                     hift_cfg=to_port_cfg(jax_hift_cfg_v3(), HiFTConfig), quant_lm="int4", kv_quant=True, device="cpu")
    q = api.lm.cfg.qwen
    assert (q.quant, q.kv_quant) == ("int4", True) and api.lm.module.llm_decoder.bias is None
    none = np.zeros(0, np.int32)
    (out,) = api.engine.tts(np.arange(3, 9, dtype=np.int32), none, none, none, np.zeros((1, 0, 80), np.float32),
                            np.ones((1, 192), np.float32))
    assert out["tts_speech"].shape[1] > 0 and np.isfinite(out["tts_speech"]).all()


def test_greedy_bistream_matches_jax_and_the_eager_loop(pair, monkeypatch):
    """generate_bistream (extends of 2..16 rows through the layers' plain
    products, one-row extends and spans through the decode step) with
    32-row arena buckets: the JAX LM's stream and the eager loop's."""
    from tests.test_torch_bistream import _both, _request
    from tests.test_torch_decode_graph import _functional_block
    from tests.test_torch_lm import _small_buckets

    jlm, params, lm = pair
    _small_buckets(monkeypatch, jlm, lm, 96)
    req = _request(2, 40, 20)
    want, got = _both(jlm, params, lm, req, max_len=80)
    with monkeypatch.context() as m:
        m.setattr(lm, "_decode_block", _functional_block(lm))
        chunks, prompt_text, prompt_speech = req
        ref = _cat(list(lm.generate_bistream(iter(chunks), prompt_text, prompt_speech,
                                             torch.Generator().manual_seed(0), max_len=80)))
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
