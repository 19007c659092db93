"""The port's training steps against the JAX package at tiny width, float32:
three LM steps with accumulation 2 (v2 and v3 layouts), a skipped NaN
step, the flow's CFM loss and gradients on the JAX package's draws
(U-Net and DiT flows, offline and streaming) and one flow step. The
weights are carried by convert.load_jax_params; checked by
convert.export_params."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu.train.trainer import make_flow_train_step as jflow_step
from cosyvoice_tpu.train.trainer import make_lm_train_step as jlm_step
from cosyvoice_tpu.train.trainer import make_optimizer as jmake_optimizer
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.train.lm_data import collate_lm_batch
from cosyvoice_tpu_torch.train.trainer import make_flow_train_step, make_lm_train_step, make_optimizer
from tests.test_torch_common import jax_dit_flow_cfg, jax_flow_cfg, jax_lm_cfg, jax_lm_cfg_v3, np_tree, to_port_cfg

torch.set_num_threads(1)

METRIC_RTOL = 1e-5  # float32 loss / accuracy / gradient norm, sums in different orders
# weights after Adam steps at lr 1e-3: each moves ~1e-3 a step, and the
# update of a near-zero gradient (|g| ~ eps) is sensitive to its last bits
PARAM_ATOL = 2e-5
# the flow's weights after its first Adam update at lr 1e-3 (fresh moments:
# each weight moves lr * g / (|g| + 1e-8), so a gradient near eps moves by
# any fraction of lr): a tenth of one step
FLOW_PARAM_ATOL = 1e-4
GRAD_ATOL = 5e-6  # flow gradients, O(1e-1..1) in size
LOSS_RTOL = 2e-6  # flow loss on the same draws


def _max_diff(a, b):
    if isinstance(a, dict):
        return max(_max_diff(a[k], b[k]) for k in a)
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _lm_pair(jcfg):
    jlm = JQwen2LM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    with torch.device("cpu"):
        module = Qwen2LMModule(to_port_cfg(jcfg, LMConfig))
    load_jax_params(module, np_tree(params))
    return jlm, params, module


def _lm_batches(cfg, n_steps=3, A=2, B=3):
    """n_steps stacked [A, B, T] batches of collated microbatches, one
    random.Random per microbatch (both packages' collates are held equal
    in test_torch_train_losses)."""
    out = []
    for s in range(n_steps):
        mbs = []
        for a in range(A):
            r = np.random.default_rng(10 * s + a)
            batch = {"text_token": r.integers(0, 100, (B, 9)), "text_token_len": r.integers(3, 9, B),
                     "speech_token": r.integers(0, 20, (B, 40)), "speech_token_len": r.integers(5, 40, B)}
            mbs.append(collate_lm_batch(cfg, batch, random.Random(2 * s + a)))
        T = max(m["ids"].shape[1] for m in mbs)
        fill = {"ids": 0, "types": 1, "targets": -100}
        out.append({k: np.stack([np.pad(m[k], [(0, 0), (0, T - m[k].shape[1])], constant_values=fill[k])
                                 if k != "lengths" else m[k] for m in mbs]) for k in mbs[0]})
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if k != "lengths" else torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("jcfg", [jax_lm_cfg, jax_lm_cfg_v3], ids=["v2", "v3"])
def test_three_lm_steps_with_accumulation_match_jax(jcfg):
    jc = jcfg()
    jlm, params, module = _lm_pair(jc)
    jopt = jmake_optimizer(lr=1e-3, warmup_steps=2)
    jstate = jopt.init(params)
    jstep = jlm_step(jlm.module, jopt, accum_steps=2)
    opt = make_optimizer(module.parameters(), lr=1e-3, warmup_steps=2)
    step = make_lm_train_step(module, opt, accum_steps=2)
    for i, b in enumerate(_lm_batches(module.cfg)):
        params, jstate, jm = jstep(params, jstate, {k: jnp.asarray(v) for k, v in b.items()}, i)
        m = step(_torch_batch(b), i)
        assert m["step"] == int(jm["step"]) == i + 1
        for k in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, err_msg=f"step {i} {k}")
    assert opt.count == 3
    assert _max_diff(export_params(module), np_tree(params)) < PARAM_ATOL


def test_nan_step_is_skipped_with_nothing_moved():
    """A NaN in the head's bias makes every gradient NaN: the JAX step
    reverts every optimizer leaf, the port's skips Adam, and neither moves
    a weight (the NaN one included), a moment or the count."""
    jc = jax_lm_cfg()
    jlm, params, module = _lm_pair(jc)
    jopt = jmake_optimizer(lr=1e-3, warmup_steps=2)
    jstep = jlm_step(jlm.module, jopt, accum_steps=2)
    opt = make_optimizer(module.parameters(), lr=1e-3, warmup_steps=2)
    step = make_lm_train_step(module, opt, accum_steps=2)
    good, bad = _lm_batches(module.cfg, n_steps=2)
    params, jstate, _ = jstep(params, jopt.init(params), {k: jnp.asarray(v) for k, v in good.items()}, 0)
    step(_torch_batch(good), 0)
    tree = np_tree(params)
    tree["params"]["llm_decoder"]["bias"] = tree["params"]["llm_decoder"]["bias"].copy()
    tree["params"]["llm_decoder"]["bias"][0] = np.nan
    params = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        module.llm_decoder.bias[0] = float("nan")
    j_before = (np_tree(params), jax.tree.map(np.asarray, jstate))
    before = ({n: p.detach().clone() for n, p in module.named_parameters()},
              {id(p): {k: v.clone() for k, v in st.items()} for p, st in opt.adam.state.items()})
    params, jstate, jm = jstep(params, jstate, {k: jnp.asarray(v) for k, v in bad.items()}, 1)
    m = step(_torch_batch(bad), 1)
    assert np.isnan(float(jm["grad_norm"])) and np.isnan(float(m["grad_norm"]))
    jax.tree.map(np.testing.assert_array_equal, (np_tree(params), jax.tree.map(np.asarray, jstate)), j_before)
    for n, p in module.named_parameters():
        torch.testing.assert_close(p.detach(), before[0][n], rtol=0, atol=0, equal_nan=True)
    for p, st in opt.adam.state.items():
        for k, v in st.items():
            torch.testing.assert_close(v, before[1][id(p)][k], rtol=0, atol=0)
    assert opt.count == 1


FLOWS = {"unet": jax_flow_cfg, "dit": jax_dit_flow_cfg}


@pytest.fixture(scope="module", params=sorted(FLOWS))
def flow_pair(request):
    jcfg = FLOWS[request.param]()
    jflow = JCausalFlow(jcfg)
    params = jflow.init(jax.random.PRNGKey(1))
    flow = CausalFlow(to_port_cfg(jcfg, FlowConfig), device="cpu")
    load_jax_params(flow, np_tree(params))
    return jflow, params, flow


def _flow_batch(seed, B=3, L=12):
    rng = np.random.default_rng(seed)
    tl = np.array([L, L - 3, L - 5][:B], np.int32)
    return {"token": rng.integers(0, 50, (B, L)).astype(np.int32), "token_len": tl,
            "feat": rng.standard_normal((B, 2 * L, 80)).astype(np.float32), "feat_len": 2 * tl,
            "embedding": rng.standard_normal((B, 192)).astype(np.float32)}


def jax_draws(cfg, rng, B, T):
    """The draws JAX CausalFlow.loss / cfm_loss make from `rng`, as the
    port's loss takes them (models/flow_matching.loss_draws)."""
    k_cond, k_cfm = jax.random.split(rng)
    k1, k2 = jax.random.split(k_cond)
    k_t, k_z, k_cfg = jax.random.split(k_cfm, 3)
    d = {"t": jax.random.uniform(k_t, (B, 1, 1), jnp.float32)[:, 0, 0],
         "z": jax.random.normal(k_z, (B, T, 80), jnp.float32),
         "keep": jax.random.uniform(k_cfg, (B,)) > cfg.cfm.training_cfg_rate,
         "coin": jax.random.uniform(k1, (B,)), "frac": jax.random.uniform(k2, (B,))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _port(batch):
    return {k: torch.from_numpy(v).long() if k == "token" else torch.from_numpy(v) for k, v in batch.items()}


def _grad_tree(flow):
    """The flow's .grad as its JAX tree (export_params' leaves view the CPU
    parameters, so the gradients are copied in and the weights back)."""
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in flow.named_parameters()}
        for n, p in flow.named_parameters():
            p.copy_(p.grad)
        tree = _tree_copy(export_params(flow))
        for n, p in flow.named_parameters():
            p.copy_(saved[n])
    return tree


def _tree_copy(tree):
    return {k: _tree_copy(v) for k, v in tree.items()} if isinstance(tree, dict) else np.array(tree)


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
def test_flow_loss_and_gradients_match_jax_on_its_draws(flow_pair, streaming):
    jflow, params, flow = flow_pair
    b = _flow_batch(0)
    rng = jax.random.PRNGKey(5)
    jl, jg = jax.value_and_grad(
        lambda p: jflow.loss(p, rng, *(jnp.asarray(b[k]) for k in ("token", "token_len", "feat", "feat_len",
                                                                     "embedding")), streaming=streaming))(params)
    d = jax_draws(jflow.cfg, rng, 3, b["feat"].shape[1])
    assert d["keep"].any() and d["coin"].lt(0.5).any()  # dropout and a prompt prefix both drawn
    flow.zero_grad(set_to_none=True)
    pb = _port(b)
    loss = flow.loss(pb["token"], pb["token_len"], pb["feat"], pb["feat_len"], pb["embedding"], streaming, draws=d)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert _max_diff(_grad_tree(flow), np_tree(jg)) < GRAD_ATOL


def test_flow_step_with_accumulation_matches_jax(flow_pair):
    jflow, params, flow = flow_pair
    load_jax_params(flow, np_tree(params))
    A = 2
    mbs = [_flow_batch(s) for s in range(A)]
    batch = {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}
    rng = jax.random.PRNGKey(9)
    jopt = jmake_optimizer(lr=1e-3, warmup_steps=2)
    own = jax.tree.map(jnp.copy, params)  # the step donates its params; the fixture's stay
    p2, _, jm = jflow_step(jflow, jopt, accum_steps=A)(own, jopt.init(own),
                                                       {k: jnp.asarray(v) for k, v in batch.items()}, rng, True)
    draws = [jax_draws(jflow.cfg, r, 3, batch["feat"].shape[2]) for r in jax.random.split(rng, A)]
    opt = make_optimizer(flow.parameters(), lr=1e-3, warmup_steps=2)
    m = make_flow_train_step(flow, opt, accum_steps=A)(_port(batch), None, True, draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=METRIC_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=METRIC_RTOL)
    assert _max_diff(export_params(flow), np_tree(p2)) < FLOW_PARAM_ATOL
    load_jax_params(flow, np_tree(params))


def test_flow_step_without_accumulation_matches_jax(flow_pair):
    """A = 1 runs the loop of A = 2 over one stacked microbatch: its loss
    and gradient norm against JAX's step at A = 1 (the batch unstacked,
    the rng unsplit), and the gradient it hands Adam (unclipped, scaled by
    1) against jax.grad on that rng within GRAD_ATOL. The update itself is
    held at A = 2 above; at A = 1 the DiT's key biases, whose gradient is
    zero in exact arithmetic (softmax ignores a shift of every key), move
    by any fraction of lr on either side."""
    jflow, params, flow = flow_pair
    load_jax_params(flow, np_tree(params))
    b = _flow_batch(0)
    rng = jax.random.PRNGKey(9)
    keys = ("token", "token_len", "feat", "feat_len", "embedding")
    jopt = jmake_optimizer(lr=1e-3, warmup_steps=2)
    own = jax.tree.map(jnp.copy, params)  # the step donates its params; the fixture's stay
    _, _, jm = jflow_step(jflow, jopt, accum_steps=1)(own, jopt.init(own), {k: jnp.asarray(v) for k, v in b.items()},
                                                      rng, True)
    jg = jax.grad(lambda p: jflow.loss(p, rng, *(jnp.asarray(b[k]) for k in keys), streaming=True))(params)
    opt = make_optimizer(flow.parameters(), lr=1e-3, warmup_steps=2)
    m = make_flow_train_step(flow, opt, accum_steps=1)(_port({k: v[None] for k, v in b.items()}), None, True,
                                                        [jax_draws(jflow.cfg, rng, 3, b["feat"].shape[1])])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=METRIC_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=METRIC_RTOL)
    assert float(m["grad_norm"]) < opt.grad_clip and opt.count == 1
    assert _max_diff(_grad_tree(flow), np_tree(jg)) < GRAD_ATOL
    load_jax_params(flow, np_tree(params))
