"""The port's CosyVoice-300M (v1) training against the JAX package at tiny
width, float32: `v1_lm_targets`, the LM's `forward_logits` and gradients
(to `linear_pos` too), two `make_lm_v1_train_step` steps, the flow's
`MaskedDiffFlow.loss` on the JAX package's draws in value and gradient,
and bin/train.py's v1 LM and flow branches for one epoch on the CPU with
checkpoints the JAX package restores."""

import json

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow_v1 import MaskedDiffFlow as JMaskedDiffFlow
from cosyvoice_tpu.models.llm_v1 import TransformerLM as JTransformerLM
from cosyvoice_tpu.train.trainer import make_lm_v1_train_step as jmake_lm_v1_step
from cosyvoice_tpu.train.trainer import make_optimizer as jmake_optimizer
from cosyvoice_tpu.train.trainer import v1_lm_targets as jv1_lm_targets
from cosyvoice_tpu.utils.config import build_flow_v1_config as jbuild_flow_v1_config
from cosyvoice_tpu.utils.config import build_lm_v1_config as jbuild_lm_v1_config
from cosyvoice_tpu_torch.bin import train
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config, MaskedDiffFlow
from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config, TransformerLMModule
from cosyvoice_tpu_torch.train.trainer import make_lm_v1_train_step, make_optimizer, v1_lm_targets
from cosyvoice_tpu_torch.utils import msgpack_io
from tests.test_torch_common import jax_flow_v1_cfg, jax_lm_v1_cfg, np_tree, to_port_cfg
from tests.test_torch_train_steps import jax_draws

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4  # float32 logits after the text conformer and 2 rel-pos layers
# each gradient leaf within this fraction of the largest gradient element:
# the attention's key biases have a zero gradient in exact arithmetic
# (softmax ignores a shift of every key), so their float32 noise has no
# relative scale of its own
GRAD_RTOL = 1e-4
METRIC_RTOL = 1e-5  # loss, accuracy, gradient norm (tests/test_torch_train_steps.py's)
# Adam moves a weight by about its rate each step whatever its gradient's
# size, so the key biases' noise moves them by up to 2 rates: the update
# over every weight is held by its relative L2 (measured 3.1e-3 after two
# steps), each weight within the sum of the two steps' 2 x rate
UPDATE_RTOL = 1e-2
LOSS_RTOL = 2e-6  # the flow loss on the same draws (tests/test_torch_train_steps.py's)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_diff(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    return max(float(np.max(np.abs(a[k].astype(np.float64) - b[k]))) for k in b)


def _grads_match(module, jgrads):
    """Every gradient leaf of `module` against the JAX tree (GRAD_RTOL)."""
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in module.named_parameters()}
        for _, p in module.named_parameters():
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        got = dict(_leaves(jax.tree.map(np.array, export_params(module))))
        for n, p in module.named_parameters():
            p.copy_(saved[n])
    want = dict(_leaves(np_tree(jgrads)))
    assert got.keys() == want.keys()
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        assert np.abs(got[k].astype(np.float64) - want[k]).max() <= GRAD_RTOL * scale, "/".join(k)
    return got


@pytest.fixture(scope="module")
def lm_pair():
    jlm = JTransformerLM(jax_lm_v1_cfg())
    params = jlm.init(jax.random.PRNGKey(0))
    with torch.device("cpu"):
        module = TransformerLMModule(to_port_cfg(jlm.cfg, LMv1Config))
    load_jax_params(module, np_tree(params["params"]))
    return jlm, params, module


def _lm_batch(seed, B=3):
    rng = np.random.default_rng(seed)
    return {"text": rng.integers(0, 100, (B, 9)).astype(np.int32), "text_len": np.array([9, 5, 7][:B], np.int32),
            "spk": rng.standard_normal((B, 192)).astype(np.float32),
            "speech": rng.integers(0, 30, (B, 14)).astype(np.int32), "speech_len": np.array([14, 6, 11][:B], np.int32)}


def _port(b):
    return {k: torch.from_numpy(v).float() if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in b.items()}


def test_v1_lm_targets_equal_jax():
    b = _lm_batch(0)
    want = jv1_lm_targets(30, 9, jnp.asarray(b["text_len"]), jnp.asarray(b["speech"]), jnp.asarray(b["speech_len"]))
    p = _port(b)
    got = v1_lm_targets(30, 9, p["text_len"], p["speech"], p["speech_len"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 30).sum() == 3  # one stop target a row


def test_forward_logits_and_gradients_match_jax(lm_pair):
    jlm, params, module = lm_pair
    b = _lm_batch(1)
    w = np.random.default_rng(2).standard_normal((3, 26, 31)).astype(np.float32)

    def jloss(p):
        logits, total = jlm.module.apply(p, *(jnp.asarray(b[k]) for k in ("text", "text_len", "spk", "speech",
                                                                          "speech_len")), method="forward_logits")
        return jnp.sum(logits * w), (logits, total)

    (_, (jlogits, jtotal)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    module.zero_grad(set_to_none=True)
    p = _port(b)
    logits, total = module.forward_logits(p["text"], p["text_len"], p["spk"], p["speech"], p["speech_len"])
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=LOGIT_ATOL)
    got = _grads_match(module, jg)
    for i in range(2):  # the rel-pos projection is trained
        assert np.abs(got[("params", f"lm_layers_{i}", "linear_pos", "kernel")]).max() > 0


def test_two_lm_v1_steps_match_jax(lm_pair):
    jlm, params, module = lm_pair
    load_jax_params(module, np_tree(params["params"]))
    jopt = jmake_optimizer(lr=1e-3, warmup_steps=2)
    jstep = jmake_lm_v1_step(jlm.module, jopt, 30)
    own = jax.tree.map(jnp.copy, params)  # the step donates its params; the fixture's stay
    jstate = jopt.init(own)
    opt = make_optimizer(module.parameters(), lr=1e-3, warmup_steps=2)
    step = make_lm_v1_train_step(module, opt, 30)
    tables = module.pos_tables()[0].clone()
    for i in range(2):
        b = _lm_batch(10 + i)
        own, jstate, jm = jstep(own, jstate, {k: jnp.asarray(v) for k, v in b.items()}, i)
        m = step(_port(b), i)
        assert m["step"] == int(jm["step"]) == i + 1
        for k in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, err_msg=f"step {i} {k}")
    got, before, after = (dict(_leaves(t)) for t in (export_params(module), np_tree(params), np_tree(own)))
    d_got = np.concatenate([(got[k].astype(np.float64) - before[k]).ravel() for k in after])
    d_want = np.concatenate([(after[k].astype(np.float64) - before[k]).ravel() for k in after])
    rates = sum(opt.sched(c) for c in range(2))
    assert opt.count == 2 and _rel_l2(d_got, d_want) < UPDATE_RTOL
    assert np.abs(d_got - d_want).max() <= 2 * rates
    # the decode's cached rel-pos tables follow the trained linear_pos
    assert not torch.equal(module.pos_tables()[0], tables)
    load_jax_params(module, np_tree(params["params"]))


@pytest.fixture(scope="module")
def flow_pair():
    jcfg = jax_flow_v1_cfg()
    jflow = JMaskedDiffFlow(jcfg)
    params = jflow.init(jax.random.PRNGKey(1))
    flow = MaskedDiffFlow(to_port_cfg(jcfg, FlowV1Config), device="cpu")
    load_jax_params(flow, np_tree(params))
    return jflow, params, flow


def test_masked_diff_flow_loss_and_gradients_match_jax_on_its_draws(flow_pair):
    jflow, params, flow = flow_pair
    rng = np.random.default_rng(3)
    B, L = 3, 12
    tl = np.array([12, 9, 7], np.int32)
    b = {"token": rng.integers(0, 30, (B, L)).astype(np.int32), "token_len": tl,
         "feat": rng.standard_normal((B, 21, 80)).astype(np.float32), "feat_len": np.array([21, 15, 12], np.int32),
         "embedding": rng.standard_normal((B, 192)).astype(np.float32)}
    keys = ("token", "token_len", "feat", "feat_len", "embedding")
    key = jax.random.PRNGKey(5)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jflow.loss(p, key, *(jnp.asarray(b[k]) for k in keys))))(params)
    d = jax_draws(jflow.cfg, key, B, 21)
    assert d["keep"].any() and d["coin"].lt(0.5).any()  # dropout and a prompt prefix both drawn
    flow.zero_grad(set_to_none=True)
    p = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = flow.loss(*(p[k].long() if k == "token" else p[k] for k in keys), draws=d)
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _grads_match(flow, jg)


# ---------------------------------------------------------------- the CLI

CFG = {
    "version": 1,
    "llm": {"text_encoder_input_size": 16, "llm_input_size": 32, "llm_output_size": 32, "speech_token_size": 30,
            "te_heads": 2, "te_linear_units": 32, "te_blocks": 1, "lm_heads": 2, "lm_linear_units": 32,
            "lm_blocks": 2, "max_cache_len": 256},
    "flow": {"input_size": 16, "vocab_size": 30, "attention_heads": 2, "linear_units": 32, "num_blocks": 1,
             "regulator_ratios": [1], "estimator": {"channels": [16, 16], "attention_head_dim": 8, "n_blocks": 1,
                                                   "num_mid_blocks": 1, "num_heads": 2, "causal": False},
             "cfm": {"n_timesteps": 2}},
    "train": {"max_epoch": 1, "log_interval": 1, "batch_type": "static", "batch_size": 2, "warmup_steps": 2,
              "lr": 1e-3, "sample_rate": 22050, "mel_hop": 256},
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One parquet shard of 4 one-second 22.05 kHz utterances."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    rows = {"utt": [f"u{i}" for i in range(4)], "text": [f"hello world {i}" for i in range(4)],
            "audio": [(rng.standard_normal(22050) * 0.1).astype(np.float32).tolist() for _ in range(4)],
            "sample_rate": [22050] * 4,
            "utt_embedding": [rng.standard_normal(192).astype(np.float32).tolist() for _ in range(4)],
            "speech_token": [rng.integers(0, 30, 25).tolist() for _ in range(4)]}
    pq.write_table(pa.table(rows), str(d / "shard.parquet"))
    (d / "data.list").write_text(str(d / "shard.parquet") + "\n")
    (d / "cfg.json").write_text(json.dumps(CFG))
    return d


def _jax_template(model):
    key = jax.random.PRNGKey(0)
    if model == "llm":
        return JTransformerLM(jbuild_lm_v1_config(CFG["llm"])).init(key)
    return JMaskedDiffFlow(jbuild_flow_v1_config(CFG["flow"])).init(key)


@pytest.mark.parametrize("model", ["llm", "flow"])
def test_v1_cli_branches_train_one_epoch_and_jax_restores_the_checkpoints(data, tmp_path, model):
    executor, branch = train.main(["--model", model, "--config", str(data / "cfg.json"), "--train_data",
                                   str(data / "data.list"), "--cv_data", str(data / "data.list"), "--model_dir",
                                   str(tmp_path), "--device", "cpu"])
    # 4 utterances in batches of 2, one batch a step (accum_grad 2 is not applied)
    assert (executor.epoch, executor.step) == (1, 2) and branch.optimizer.count == 2
    assert branch.optimizer.skip_nonfinite == (model == "llm")
    side = json.loads((tmp_path / f"{model}_epoch1_step2.json").read_text())
    assert np.isfinite(side["cv_loss"])
    template = _jax_template(model)
    for tag in ("epoch0_step0", "epoch1_step2"):
        blob = (tmp_path / f"{model}_{tag}.msgpack").read_bytes()
        restored = ser.from_bytes(template, blob)
        assert _max_diff(msgpack_io.loads(blob), np_tree(restored)) == 0.0
    assert _max_diff(export_params(branch.module), msgpack_io.read(str(tmp_path / f"{model}_epoch1_step2.msgpack"))) == 0
