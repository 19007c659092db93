"""The port's multi-device training (parallel/, the mesh argument of
train/trainer.py) on the CPU over gloo, held against the JAX package:

- the sharding rules (lm_param_spec, fsdp_param_spec) give every parameter
  of the tiny LM the JAX rules' spec of its Flax path, carried to PyTorch's
  layout;
- four processes: the LM step data-parallel (dp 4), dp x tp = 2 x 2, FSDP
  (dp 4, the FSDP rule down to 64-element leaves so that the tiny LM's
  weights are split) and ZeRO-2 (2 x 2) each take two accumulated steps
  (A = 2, B = 4 split over "dp", the ranks holding different valid-token
  counts, the clip at 0.1 so that the global norm decides the update) and
  match JAX's single-device make_lm_train_step: loss, accuracy and
  gradient norm each step, and every rank's weights (its shards under tp)
  after both;
- the flow's accumulated step over dp = 2 against the single-process step
  on the same draws;
- pipeline_forward over pp = 4 stages, n_micro 2, against JAX's
  pipeline_forward on four virtual devices: the output and the gradients
  of mean(y^2) with respect to every stage's layers."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu.parallel import sharding as jsharding
from cosyvoice_tpu.train.trainer import make_lm_train_step as jlm_step
from cosyvoice_tpu.train.trainer import make_optimizer as jmake_optimizer
from cosyvoice_tpu_torch.convert import load_jax_params, port_name
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.parallel import sharding
from tests.test_torch_common import jax_lm_cfg, np_tree, to_port_cfg
from tests.test_torch_train_steps import _lm_batches, _torch_batch
from tests.torch_dist import run_ranks

torch.set_num_threads(1)

METRIC_RTOL = 1e-5  # float32 loss / accuracy / gradient norm; sums over ranks in another order
PARAM_ATOL = 2e-5  # weights after two Adam steps at lr 1e-3 (test_torch_train_steps.PARAM_ATOL)
PIPE_ATOL = 2e-4  # float32 pipeline output and gradients (JAX's own pipeline test: 2e-4 / 3e-3)
FSDP_MIN_SIZE = 64
OPT = {"lr": 1e-3, "warmup_steps": 2, "grad_clip": 0.1}
# (name, dp, tp, placement)
SCENARIOS = [("dp4", 4, 1, "lm"), ("dp2_tp2", 2, 2, "lm"), ("fsdp4", 4, 1, "fsdp"), ("zero2_2x2", 2, 2, "zero2")]


def _jcfg():
    return jax_lm_cfg(speech_token_size=29)  # a head of 32 rows: vocab-parallel over tp 2


@pytest.mark.parametrize("rule", ["lm", "fsdp"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)], ids=["2x2", "4x1", "1x4"])
def test_spec_rules_agree_with_jax_on_every_parameter(rule, shape):
    dp, tp = shape
    jmesh = jsharding.make_mesh(dp * tp, dp=dp, tp=tp)
    jcfg = _jcfg()
    params = JQwen2LM(jcfg).init(jax.random.PRNGKey(0))
    jrule = {"lm": jsharding.lm_param_spec, "fsdp": partial(jsharding.fsdp_param_spec, min_size=FSDP_MIN_SIZE)}[rule]
    prule = {"lm": sharding.lm_param_spec, "fsdp": partial(sharding.fsdp_param_spec, min_size=FSDP_MIN_SIZE)}[rule]
    jspecs = jsharding.param_specs(params, jrule, jmesh)
    module = Qwen2LMModule(to_port_cfg(jcfg, LMConfig))
    specs = sharding.param_specs(module, prule, {"dp": dp, "tp": tp})
    names = dict(module.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    seen, sharded = set(), 0
    for path, jspec in flat:
        keys = tuple(k.key for k in path)
        name = port_name(keys, names)
        ndim = names[name].dim()
        want = list(jspec) + [None] * (ndim - len(jspec))
        if keys[-1] == "kernel" and ndim == 2:
            want = want[::-1]
        want = tuple(want) if any(a is not None for a in want) else ()
        assert specs[name] == want, (name, specs[name], jspec)
        seen.add(name)
        sharded += bool(want)
    assert seen == set(names) and sharded > 0


@pytest.fixture(scope="module")
def lm_spec(tmp_path_factory):
    """The tiny LM's initial weights (the port's layout), two global
    batches [2, 4, T], JAX's two steps' metrics and its weights after them."""
    jcfg = _jcfg()
    jlm = JQwen2LM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    module = Qwen2LMModule(to_port_cfg(jcfg, LMConfig))
    load_jax_params(module, np_tree(params))
    init = {k: v.clone() for k, v in module.state_dict().items()}
    batches = _lm_batches(module.cfg, n_steps=2, A=2, B=4)
    jopt = jmake_optimizer(**OPT)
    jstep = jlm_step(jlm.module, jopt, accum_steps=2)
    state, metrics = jopt.init(params), []
    for i, b in enumerate(batches):
        params, state, m = jstep(params, state, {k: jnp.asarray(v) for k, v in b.items()}, i)
        metrics.append({k: float(m[k]) for k in ("loss", "acc", "grad_norm")})
    load_jax_params(module, np_tree(params))
    q = module.cfg.qwen
    spec = {
        "lm": {"speech_token_size": jcfg.speech_token_size, "block_size": jcfg.block_size},
        "qwen": {f: getattr(q, f) for f in ("hidden_size", "num_layers", "num_heads", "num_kv_heads", "head_dim",
                                            "intermediate_size", "vocab_size", "max_cache_len", "dtype")},
        "init": init, "ref": {k: v.clone() for k, v in module.state_dict().items()},
        "batches": [_torch_batch(b) for b in batches], "opt": OPT, "accum": 2, "fsdp_min_size": FSDP_MIN_SIZE,
        "scenarios": SCENARIOS,
    }
    d = tmp_path_factory.mktemp("lm_steps")
    torch.save(spec, d / "spec.pt")
    # the batches give the ranks different valid-token counts
    counts = [(b["targets"][:, r] != -100).sum() for b in batches for r in range(4)]
    assert len(set(int(c) for c in counts)) > 1
    return d, metrics


@pytest.fixture(scope="module")
def lm_results(lm_spec):
    d, metrics = lm_spec
    return run_ranks("lm_steps", 4, d, str(d / "spec.pt")), metrics


@pytest.mark.parametrize("scenario", [s[0] for s in SCENARIOS])
def test_lm_step_on_a_mesh_matches_jax_single_device(lm_results, scenario):
    results, jmetrics = lm_results
    for rank, res in enumerate(results):
        got = res[scenario]
        for i, jm in enumerate(jmetrics):
            for k in ("loss", "acc", "grad_norm"):
                np.testing.assert_allclose(got[k][i], jm[k], rtol=METRIC_RTOL, err_msg=f"{scenario} r{rank} {i} {k}")
        assert got["max_err"] < PARAM_ATOL, (scenario, rank, got["max_err"])
        assert jmetrics[0]["grad_norm"] > OPT["grad_clip"]  # the clip applied: the norm is the global one
        if scenario != "dp4":
            assert got["sharded"], scenario
    if scenario == "dp2_tp2":
        assert any("qkv_proj" in n for n in results[0][scenario]["sharded"])
        assert any("llm_decoder" in n for n in results[0][scenario]["sharded"])


def test_flow_step_data_parallel_matches_the_single_device_step(tmp_path):
    """The flow's accumulated step (A = 2, B = 4 rows of different valid
    lengths, streaming) over dp = 2 against the same step on one process
    (test_torch_train_steps holds that one against JAX), on the same
    draws: the masked mean taken over every rank's valid mel frames."""
    from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
    from cosyvoice_tpu_torch.models.flow_matching import loss_draws
    from cosyvoice_tpu_torch.train.trainer import make_flow_train_step, make_optimizer
    from tests.test_torch_common import jax_flow_cfg
    from tests.test_torch_train_steps import FLOW_PARAM_ATOL

    cfg = to_port_cfg(jax_flow_cfg(), FlowConfig)
    flow = CausalFlow(cfg, device="cpu")
    torch.manual_seed(0)
    init = {k: v.clone() for k, v in flow.state_dict().items()}
    rng = np.random.default_rng(5)
    A, B, L = 2, 4, 12
    tl = np.array([[L, L - 3, L - 5, L - 7], [L - 1, L - 6, L, L - 2]], np.int64)
    batch = {"token": torch.from_numpy(rng.integers(0, 50, (A, B, L))), "token_len": torch.from_numpy(tl),
             "feat": torch.from_numpy(rng.standard_normal((A, B, 2 * L, 80)).astype(np.float32)),
             "feat_len": torch.from_numpy(2 * tl), "embedding": torch.from_numpy(
                 rng.standard_normal((A, B, 192)).astype(np.float32))}
    gen = torch.Generator().manual_seed(3)
    draws = [loss_draws(gen, B, 2 * L, 80, cfg.cfm, "cpu") for _ in range(A)]
    opt_kw = {"lr": 1e-3, "warmup_steps": 2}
    spec = {"cfg": cfg, "init": init, "batch": batch, "draws": draws, "opt": opt_kw}
    torch.save(spec, tmp_path / "spec.pt")
    m = make_flow_train_step(flow, make_optimizer(flow.parameters(), **opt_kw), accum_steps=A)(batch, None, True,
                                                                                                draws)
    results = run_ranks("flow_steps", 2, tmp_path, str(tmp_path / "spec.pt"))
    want = dict(flow.named_parameters())
    for res in results:
        np.testing.assert_allclose(res["loss"], float(m["loss"]), rtol=METRIC_RTOL)
        np.testing.assert_allclose(res["grad_norm"], float(m["grad_norm"]), rtol=METRIC_RTOL)
        assert max(float((w - want[n].detach()).abs().max()) for n, w in res["weights"].items()) < FLOW_PARAM_ATOL


def test_pipeline_matches_jax_forward_and_gradients(tmp_path):
    from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config, Qwen2Layer as JQwen2Layer
    from cosyvoice_tpu.parallel.pipeline import pipeline_forward as jpipeline
    from cosyvoice_tpu.parallel.pipeline import qwen2_layer_fn as jlayer_fn
    from cosyvoice_tpu.parallel.pipeline import shard_stacked_layers as jshard
    from cosyvoice_tpu.parallel.pipeline import stack_layer_params as jstack
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Layer
    from cosyvoice_tpu_torch.parallel.pipeline import stack_layer_params

    qwen = dict(hidden_size=32, num_layers=4, num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64,
                vocab_size=64, max_cache_len=64)
    jcfg = JQwen2Config(**qwen, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    T = 8
    x = rng.standard_normal((4, T, 32)).astype(np.float32)
    cos = rng.standard_normal((T, 8)).astype(np.float32)
    sin = rng.standard_normal((T, 8)).astype(np.float32)
    keep = np.tril(np.ones((T, T), bool))[None, None]
    bias = np.where(keep, 0.0, -1e30).astype(np.float32)
    bc = tuple(jnp.asarray(a) for a in (cos, sin, bias))
    layer = JQwen2Layer(jcfg)
    lps = [layer.init(jax.random.PRNGKey(i), jnp.asarray(x), *bc)["params"] for i in range(4)]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("pp",))
    fn = jlayer_fn(jcfg)
    stacked = jshard(mesh, jstack(lps))

    def loss(sp):
        return jnp.mean(jnp.square(jpipeline(mesh, fn, sp, jnp.asarray(x), bcast=bc, n_micro=2)))

    y = np.asarray(jax.jit(lambda sp: jpipeline(mesh, fn, sp, jnp.asarray(x), bcast=bc, n_micro=2))(stacked))
    grads = jax.jit(jax.grad(loss))(stacked)

    pcfg = Qwen2Config(**qwen, dtype=torch.float32)

    def port_layers(trees):
        return [load_jax_params(Qwen2Layer(pcfg), np_tree(t)) for t in trees]

    spec = {"qwen": {**qwen, "dtype": torch.float32}, "stacked": stack_layer_params(port_layers(lps)),
            "x": torch.from_numpy(x), "bcast": (torch.from_numpy(cos), torch.from_numpy(sin), torch.from_numpy(keep))}
    torch.save(spec, tmp_path / "spec.pt")
    results = run_ranks("pipeline", 4, tmp_path, str(tmp_path / "spec.pt"))
    want_grads = stack_layer_params(port_layers([jax.tree.map(lambda a, i=i: a[i], grads) for i in range(4)]))
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["y"].numpy(), y, rtol=PIPE_ATOL, atol=PIPE_ATOL)
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g.numpy(), want_grads[k][rank : rank + 1].numpy(), rtol=PIPE_ATOL,
                                       atol=PIPE_ATOL, err_msg=f"stage {rank} {k}")
