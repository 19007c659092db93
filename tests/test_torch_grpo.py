"""The port's GRPO (train/grpo.py, bin/rl_grpo.py, serving/reward_server.py)
against the JAX package on the CPU, float32, the tiny LM of
tests/test_grpo.py with the JAX init's weights carried by convert.py:

- advantages, the rollout batch (the immediate-eos rollout included) and
  the per-token log-probs;
- one update from JAX's rollouts with old and reference log-probs moved off
  the policy's (so ratios leave 1, clip and KL are non-zero): loss, KL,
  clipfrac, gradient norm and the weights after clip + AdamW; a non-finite
  step moves nothing;
- the greedy grpo_step driver end to end (the same rollouts, a per-call
  reward sequence so that the group's advantages differ) and the rollout
  copy refreshed to the updated policy;
- the reward server's response bytes against JAX's make_server, the
  http_reward client, make_reward_fn's wav against the JAX engine's;
- rl_grpo.main writing lm_grpo.msgpack, which the JAX package restores."""

import json
import threading
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cosyvoice_tpu.models.llm import TYPE_SPECIAL, TYPE_TEXT, Qwen2LM as JQwen2LM
from cosyvoice_tpu.serving import reward_server as jreward_server
from cosyvoice_tpu.train import grpo as jgrpo
from cosyvoice_tpu_torch.bin import rl_grpo
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.serving import reward_server
from cosyvoice_tpu_torch.train import grpo
from tests.test_torch_common import jax_lm_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

LOGP_ATOL = 1e-5  # float32 log-softmax of the same logits, different summation orders
METRIC_RTOL = 1e-5  # loss / KL / gradient norm
PARAM_ATOL = 2e-5  # weights after one clip + AdamW step at lr 1e-3 (test_torch_train_steps.PARAM_ATOL)
WAV_ATOL = 1e-3  # tests/test_torch_engine.py's ATOL: LM, flow (3 Euler steps) and HiFT in float32
LR = 1e-3
K = jax.random.PRNGKey


def _pair(greedy=False):
    """(JAX LM, its params with the stop rows' bias pinned at -30, the
    port's policy with the same weights, the port's config). Pinned as
    tests/test_grpo.py pins them: random weights may otherwise stop a
    rollout at once."""
    jcfg = jax_lm_cfg(top_k=1, tau_r=2.0) if greedy else jax_lm_cfg()
    jlm = JQwen2LM(jcfg)
    tree = np_tree(jlm.init(K(0)))
    bias = tree["params"]["llm_decoder"]["bias"].copy()
    bias[jcfg.speech_token_size:] = -30.0
    tree["params"]["llm_decoder"]["bias"] = bias
    cfg = to_port_cfg(jcfg, LMConfig)
    policy = load_jax_params(Qwen2LMModule(cfg), tree)
    return jlm, jax.tree.map(jnp.asarray, tree), policy, cfg


def _prompt(cfg, n_text=4):
    rng = np.random.default_rng(0)
    tt = rng.integers(0, 50, n_text).astype(np.int32)
    ids = np.concatenate([[cfg.sos_id], tt, [cfg.task_id]]).astype(np.int32)
    types = np.concatenate([[TYPE_SPECIAL], np.full(n_text, TYPE_TEXT), [TYPE_SPECIAL]]).astype(np.int32)
    return {"ids": ids, "types": types, "n_text": n_text, "ground_truth": "gt"}


def _max_diff(module, params):
    got = np_tree(export_params(module))
    flat = jax.tree_util.tree_flatten_with_path(np_tree(params))[0]
    return max(float(np.abs(np.asarray(v, np.float64) - _at(got, p)).max()) for p, v in flat)


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return np.asarray(tree, np.float64)


def test_advantages_match_jax():
    r = np.array([[1.0, 0.0, 0.5, 0.5], [0.2, 0.2, 0.8, 0.8], [0.7, 0.7, 0.7, 0.7]], np.float32)
    a = grpo.grpo_advantages(r)
    np.testing.assert_array_equal(a, jgrpo.grpo_advantages(r))
    np.testing.assert_allclose(a[:2].mean(axis=1), 0.0, atol=1e-6)
    np.testing.assert_allclose(a[:2].std(axis=1), 1.0, atol=1e-3)
    np.testing.assert_allclose(a[2], 0.0, atol=1e-4)


@pytest.fixture(scope="module")
def rollout_batch():
    """JAX's rollouts of the tiny LM (K = 3) plus an empty one, the JAX
    batch and the port's."""
    jlm, params, policy, cfg = _pair()
    p = _prompt(cfg)
    rollouts = jgrpo.sample_group(jlm, params, p["ids"], p["types"], K(1), jgrpo.GRPOConfig(group_size=3), p["n_text"])
    rollouts = [np.asarray(r, np.int32) for r in rollouts] + [np.zeros(0, np.int32)]
    jb = jgrpo.build_grpo_batch(jlm.cfg, p["ids"], p["types"], rollouts)
    pb = grpo.build_grpo_batch(cfg, p["ids"], p["types"], rollouts)
    return jlm, params, policy, cfg, rollouts, jb, pb


def test_batch_equals_jax_with_immediate_eos(rollout_batch):
    jlm, params, policy, cfg, rollouts, jb, pb = rollout_batch
    assert all(len(r) > 0 for r in rollouts[:3]) and len(rollouts[3]) == 0
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        assert pb[k].dtype == jb[k].dtype
    P = len(_prompt(cfg)["ids"])
    assert pb["targets"][3, P - 1] == cfg.eos_token and pb["lengths"][3] == P


def test_logps_match_jax(rollout_batch):
    jlm, params, policy, cfg, rollouts, jb, pb = rollout_batch
    want = np.asarray(jgrpo.make_logps_fn(jlm.module)(params, {k: jnp.asarray(v) for k, v in jb.items()}))
    got = grpo.make_logps_fn(torch.float32)(policy, grpo.to_device(pb, "cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL)
    assert (got[pb["targets"] == -100] == 0).all()


def _update_batch(jlm, params, jb):
    """JAX's batch with old / ref log-probs moved off the policy's by
    N(0, 0.3) on the valid positions, and mixed-sign advantages."""
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
    lp = np.asarray(jgrpo.make_logps_fn(jlm.module)(params, jbatch))
    valid = jb["targets"] != -100
    rng = np.random.default_rng(3)
    extra = {"old_logps": (lp + rng.normal(0, 0.3, lp.shape) * valid).astype(np.float32),
             "ref_logps": (lp + rng.normal(0, 0.3, lp.shape) * valid).astype(np.float32),
             "advantages": np.array([3.0, -1.5, 0.9, -2.4], np.float32)}
    return extra


def test_one_update_matches_jax_and_a_nonfinite_step_moves_nothing(rollout_batch):
    jlm, params, policy, cfg, rollouts, jb, pb = rollout_batch
    extra = _update_batch(jlm, params, jb)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jstep = jgrpo.make_grpo_train_step(jlm.module, jopt, 0.2, 1e-3)
    jbatch = {**{k: jnp.asarray(v) for k, v in jb.items()}, **{k: jnp.asarray(v) for k, v in extra.items()}}
    jparams, _, jm = jstep(jax.tree.map(jnp.copy, params), jopt.init(params), jbatch, jnp.asarray(0))

    module = load_jax_params(Qwen2LMModule(cfg), np_tree(params))
    opt = grpo.grpo_optimizer(module, LR)
    step = grpo.make_grpo_train_step(module, opt, 0.2, 1e-3, dtype=torch.float32)
    batch = {**grpo.to_device(pb, "cpu"), **{k: torch.from_numpy(v) for k, v in extra.items()}}
    m = step(batch, 0)
    assert m["step"] == 1 and opt.count == 1
    assert 0.0 < float(m["clipfrac"]) < 1.0 and float(m["kl"]) > 0.0 and float(m["grad_norm"]) > 1.0
    for k in ("loss", "kl", "clipfrac", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, err_msg=k)
    assert _max_diff(module, jparams) < PARAM_ATOL

    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    moments = {id(p): {k: v.clone() for k, v in s.items()} for p, s in opt.adam.state.items()}
    m = step({**batch, "advantages": torch.full((4,), float("nan"))}, 1)
    assert not np.isfinite(float(m["grad_norm"])) and opt.count == 1
    for n, p in module.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
    for p, s in opt.adam.state.items():
        for k, v in s.items():
            torch.testing.assert_close(v, moments[id(p)][k], rtol=0, atol=0)


def _sequence_reward(log):
    """A reward of 1, 0, 1, 0, ... by call, recording each call's tokens:
    the same in both packages, and different within a group of identical
    greedy rollouts."""

    def fn(tokens, gt):
        log.append(np.asarray(tokens, np.int32).copy())
        return float(len(log) % 2)

    return fn


def test_greedy_grpo_step_matches_jax_and_refreshes_the_rollout_copy():
    """Greedy rollouts are the same in both packages; a group of identical
    rollouts has zero-mean advantages, so its surrogate's gradient cancels
    to rounding noise: the metrics are compared, not the weights (the next
    test holds the update)."""
    jlm, params, policy, cfg = _pair(greedy=True)
    gcfg = jgrpo.GRPOConfig(group_size=2)
    p = _prompt(cfg)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jstep = jgrpo.make_grpo_train_step(jlm.module, jopt, gcfg.clip_eps, gcfg.kl_coef)
    jlog, plog = [], []
    _, _, jm = jgrpo.grpo_step(jlm, jax.tree.map(jnp.copy, params), jopt.init(params), [p], _sequence_reward(jlog),
                               K(5), gcfg, jstep, jgrpo.make_logps_fn(jlm.module), jax.tree.map(jnp.copy, params), 0)

    lm = grpo.make_rollout_lm(policy, cfg, "cpu")
    ref = grpo.frozen_copy(policy)
    opt = grpo.grpo_optimizer(policy, LR)
    step = grpo.make_grpo_train_step(policy, opt, gcfg.clip_eps, gcfg.kl_coef, dtype=torch.float32)
    m = grpo.grpo_step(lm, policy, [p], _sequence_reward(plog), 5, grpo.GRPOConfig(group_size=2), step,
                       grpo.make_logps_fn(torch.float32), ref, 0)
    assert len(plog) == len(jlog) == 2 and len(plog[0]) > 0
    for a, b in zip(plog, jlog):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(m["rewards"], [1.0, 0.0])
    assert m["step"] == int(jm["step"]) == 1 and opt.count == 1
    for k in ("loss", "kl", "clipfrac"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-6, err_msg=k)
    # the rollout copy holds the updated policy; the reference did not move
    for (n, a), (_, b) in zip(lm.module.named_parameters(), policy.named_parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0, msg=n)
    assert _max_diff(ref, params) == 0.0
    assert _max_diff(policy, params) > 0.0


def test_sampled_grpo_step_update_matches_the_jax_step():
    """The port's driver with sampled rollouts (K = 3): its update equals
    JAX's make_grpo_train_step on the batch JAX builds from the same
    rollouts and rewards, with JAX's log-probs (old = reference = the
    policy: KL and clipfrac 0, ratios 1)."""
    jlm, params, policy, cfg = _pair()
    p = _prompt(cfg)
    log = []
    lm = grpo.make_rollout_lm(policy, cfg, "cpu")
    opt = grpo.grpo_optimizer(policy, LR)
    gcfg = grpo.GRPOConfig(group_size=3)
    step = grpo.make_grpo_train_step(policy, opt, gcfg.clip_eps, gcfg.kl_coef, dtype=torch.float32)
    m = grpo.grpo_step(lm, policy, [p], _sequence_reward(log), 7, gcfg, step, grpo.make_logps_fn(torch.float32),
                       grpo.frozen_copy(policy), 0)
    assert len({tuple(r) for r in log}) > 1  # the rollouts differ

    jb = {k: jnp.asarray(v) for k, v in jgrpo.build_grpo_batch(jlm.cfg, p["ids"], p["types"], log).items()}
    jlogps = jgrpo.make_logps_fn(jlm.module)(params, jb)
    jb.update(old_logps=jlogps, ref_logps=jlogps,
              advantages=jnp.asarray(jgrpo.grpo_advantages(np.asarray([[len(log[:i + 1]) % 2 for i in range(3)]],
                                                                         np.float32))[0]))
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jstep = jgrpo.make_grpo_train_step(jlm.module, jopt, gcfg.clip_eps, gcfg.kl_coef)
    jparams, _, jm = jstep(jax.tree.map(jnp.copy, params), jopt.init(params), jb, jnp.asarray(0))
    np.testing.assert_array_equal(m["rewards"], [1.0, 0.0, 1.0])
    assert float(m["kl"]) == 0.0 and float(m["clipfrac"]) == 0.0
    # rollouts of one length: the zero-mean advantages cancel the loss to
    # rounding, not its gradient
    for k in ("loss", "kl", "clipfrac", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
    assert float(m["grad_norm"]) > 0.1
    assert _max_diff(policy, jparams) < PARAM_ATOL


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}/v2/models/reward/infer"


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read(), resp.headers["Content-Type"]


def test_reward_server_bytes_match_jax_and_http_reward_reads_them():
    def reward_fn(tokens, gt):
        return len(tokens) / 10 + (gt == "ab") + float(np.sum(tokens)) / 1000

    servers = [m.make_server(reward_fn, "127.0.0.1", 0) for m in (reward_server, jreward_server)]
    try:
        urls = [_serve(s) for s in servers]
        payload = {"inputs": [
            {"name": "TOKENS", "shape": [2, 4], "datatype": "INT32", "data": [[1, 2, 3, 0], [7, 8, 0, 0]]},
            {"name": "TOKEN_LENS", "shape": [2, 1], "datatype": "INT32", "data": [[3], [2]]},
            {"name": "GT", "shape": [2], "datatype": "BYTES", "data": ["ab", "cd"]}]}
        got, want = (_post(u, payload) for u in urls)
        assert got == want
        assert json.loads(got[0])["outputs"][0]["data"] == [reward_fn([1, 2, 3], "ab"), reward_fn([7, 8], "cd")]
        toks = np.array([4, 5, 6, 7, 8], np.int32)
        assert grpo.http_reward(urls[0])(toks, "ab") == pytest.approx(reward_fn(toks, "ab"), rel=1e-6)
        assert grpo.http_reward(urls[0])(toks, "ab") == jgrpo.http_reward(urls[1])(toks, "ab")
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_reward_fn_wav_matches_the_jax_engine():
    from tests.test_torch_engine import _engines

    jeng, peng = _engines(jax_lm_cfg(top_k=1, tau_r=2.0))
    heard = {"jax": [], "port": []}

    def asr(key):
        def fn(wav, sr):
            heard[key].append((np.asarray(wav).copy(), sr))
            return "abcd"

        return fn

    jmodel = SimpleNamespace(engine=jeng, flow=SimpleNamespace(cfg=jeng.flow.cfg), sample_rate=24000)
    pmodel = SimpleNamespace(engine=peng, flow=peng.flow, sample_rate=24000)
    jfn = jreward_server.make_reward_fn(jmodel, asr("jax"))
    pfn = reward_server.make_reward_fn(pmodel, asr("port"))
    tokens = np.random.default_rng(4).integers(0, 50, 20).astype(np.int32)
    assert pfn(tokens, "abxd") == jfn(tokens, "abxd") == pytest.approx(0.75)
    (pw, psr), (jw, jsr) = heard["port"][0], heard["jax"][0]
    assert psr == jsr == 24000 and pw.shape == jw.shape and pw.size > 0
    np.testing.assert_allclose(pw, jw, atol=WAV_ATOL)
    assert pfn(np.zeros(0, np.int32), "abcd") == jfn(np.zeros(0, np.int32), "abcd") == 0.0


def low_token_reward(tokens, gt):
    """rl_grpo's --reward_path in test_rl_grpo_main_writes_what_jax_restores."""
    return float((np.asarray(tokens) < 10).mean()) if len(tokens) else 0.0


def test_rl_grpo_main_writes_what_jax_restores(tmp_path):
    from cosyvoice_tpu.runtime.api import _load_msgpack
    from cosyvoice_tpu.utils.config import build_lm_config as jbuild_lm_config

    conf = {"speech_token_size": 20, "block_size": 8,
            "qwen": {"hidden_size": 32, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                     "intermediate_size": 64, "vocab_size": 300, "max_cache_len": 256, "dtype": "float32"}}
    (tmp_path / "lm.json").write_text(json.dumps(conf))
    (tmp_path / "prompts.jsonl").write_text(json.dumps({"text": "hi"}) + "\n" + json.dumps({"text": "yo"}) + "\n")
    policy, metrics = rl_grpo.main([
        "--train_data", str(tmp_path / "prompts.jsonl"), "--model_dir", str(tmp_path / "exp"),
        "--config", str(tmp_path / "lm.json"), "--reward_path", "tests.test_torch_grpo:low_token_reward",
        "--group_size", "2", "--lr", "1e-3", "--save_per_step", "1", "--device", "cpu"])
    assert np.isfinite(float(metrics["loss"])) and metrics["step"] == 2
    assert sorted(p.name for p in (tmp_path / "exp").iterdir()) == [
        "lm_grpo.msgpack", "lm_grpo_step1.msgpack", "lm_grpo_step2.msgpack"]
    template = JQwen2LM(jbuild_lm_config(conf)).init(K(0))
    restored = _load_msgpack(str(tmp_path / "exp" / "lm_grpo.msgpack"), template)
    assert _max_diff(policy, restored) == 0.0


def test_prepare_data_writes_one_prompt_per_utterance(tmp_path):
    """examples/grpo/cosyvoice2/prepare_data.py: kaldi `text` lines to the
    prompt jsonl rl_grpo reads (too long and empty lines skipped), as the
    JAX recipe's script writes it."""
    from cosyvoice_tpu_torch.examples.grpo.cosyvoice2 import prepare_data

    (tmp_path / "text").write_text("u1 hello there\nu2\nu3 " + "x" * 300 + "\nu4 你好 世界\n")
    n = prepare_data.main(["--text", str(tmp_path / "text"), "--out", str(tmp_path / "p.jsonl")])
    rows = [json.loads(line) for line in (tmp_path / "p.jsonl").read_text().splitlines()]
    assert n == 2 and rows == [{"utt": "u1", "text": "hello there"}, {"utt": "u4", "text": "你好 世界"}]
