"""The port's training losses, schedules and LM collation against the JAX
package (cosyvoice_tpu/train/losses.py, schedulers.py, lm_data.py), on the
same seed-made inputs, float32."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.train import losses as jlosses
from cosyvoice_tpu.train import lm_data as jlm_data
from cosyvoice_tpu.train.schedulers import SCHEDULERS as JSCHEDULERS
from cosyvoice_tpu.train.schedulers import get_scheduler as jget_scheduler
from cosyvoice_tpu_torch.models.llm import LMConfig
from cosyvoice_tpu_torch.train import losses
from cosyvoice_tpu_torch.train.lm_data import build_lm_sample, collate_lm_batch, dpo_loss, sequence_logps
from cosyvoice_tpu_torch.train.schedulers import SCHEDULERS, get_scheduler
from tests.test_torch_common import jax_lm_cfg, jax_lm_cfg_v3, to_port_cfg

RTOL = 1e-5  # float32 reductions in different orders


def _logits_targets(seed=0, B=3, T=11, V=17):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, (B, T)).astype(np.int32)
    targets[rng.random((B, T)) < 0.3] = losses.IGNORE_ID
    targets[-1] = losses.IGNORE_ID  # a row with no target
    return logits, targets


@pytest.mark.parametrize("smoothing,normalize", [(0.0, True), (0.1, True), (0.1, False)])
def test_lm_ce_loss_matches_jax(smoothing, normalize):
    logits, targets = _logits_targets()
    jl, ja = jlosses.lm_ce_loss(jnp.asarray(logits), jnp.asarray(targets), smoothing, normalize)
    pl, pa = losses.lm_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets), smoothing, normalize)
    assert losses.IGNORE_ID == jlosses.IGNORE_ID
    np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(pa), float(ja), rtol=RTOL)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(1)
    real = [rng.standard_normal(s).astype(np.float32) for s in ((2, 30), (2, 4, 9))]
    fake = [rng.standard_normal(s).astype(np.float32) for s in ((2, 30), (2, 4, 9))]
    odd = [rng.standard_normal((1, 7)).astype(np.float32)], [rng.standard_normal((1, 7)).astype(np.float32)]
    J, T = (lambda xs: [jnp.asarray(x) for x in xs]), (lambda xs: [torch.from_numpy(x) for x in xs])
    pairs = [
        (losses.mel_l1_loss(*T(real[:1] + fake[:1])), jlosses.mel_l1_loss(*J(real[:1] + fake[:1]))),
        (losses.feature_matching_loss(T(real), T(fake)), jlosses.feature_matching_loss(J(real), J(fake))),
        (losses.generator_adv_loss(T(fake)), jlosses.generator_adv_loss(J(fake))),
        (losses.discriminator_adv_loss(T(real), T(fake)), jlosses.discriminator_adv_loss(J(real), J(fake))),
        (losses.tpr_loss(T(real), T(fake), tau=10.0), jlosses.tpr_loss(J(real), J(fake), tau=10.0)),
        (losses.tpr_loss(T(odd[0]), T(odd[1]), tau=10.0), jlosses.tpr_loss(J(odd[0]), J(odd[1]), tau=10.0)),
        (losses.tpr_loss(T(real), T(fake)), jlosses.tpr_loss(J(real), J(fake))),
        (losses.f0_l1_loss(*T(real[:1] + fake[:1])), jlosses.f0_l1_loss(*J(real[:1] + fake[:1]))),
    ]
    for p, j in pairs:
        np.testing.assert_allclose(float(p), float(j), rtol=RTOL)


GRID = [0, 1, 2, 5, 9, 10, 11, 49, 50, 51, 99, 100, 101, 149, 150, 151, 400, 1000, 10**5]
CONF = {"warmup_steps": 10, "hold_steps": 40, "max_steps": 150, "min_lr": 1e-5, "decay_steps": 100,
        "d_model": 64, "constant_steps": 50}


@pytest.mark.parametrize("name", sorted(JSCHEDULERS))
@pytest.mark.parametrize("extra", [{}, {"cycle": True, "power": 2.0}, {"warmup_steps": 0}])
def test_every_scheduler_matches_jax_over_a_grid(name, extra):
    assert sorted(SCHEDULERS) == sorted(JSCHEDULERS)
    conf = {**CONF, **extra}
    if name == "warmuplr" and conf["warmup_steps"] == 0:  # w^-1.5: both raise
        for get in (jget_scheduler, get_scheduler):
            with pytest.raises(ZeroDivisionError):
                get(name, 1e-3, **conf)(1)
        return
    want = [float(jget_scheduler(name, 1e-3, **conf)(s)) for s in GRID]
    got = [get_scheduler(name, 1e-3, **conf)(s) for s in GRID]
    # the JAX package evaluates in float32 (cancellation near a cosine's
    # end costs it ~1e-6 relative), the port in float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_scheduler("nope", 1e-3)


def _processor_batch(seed, B=4, instruct=False):
    r = np.random.default_rng(seed)
    tl, sl = r.integers(1, 12, B), r.integers(0, 60, B)
    tl[0], sl[0] = 0, 5  # no text: always unistream
    out = {"text_token": r.integers(0, 100, (B, 12)), "text_token_len": tl,
           "speech_token": r.integers(0, 20, (B, 60)), "speech_token_len": sl}
    if instruct:
        out["instruct_token"], out["instruct_token_len"] = r.integers(0, 100, (B, 4)), r.integers(0, 5, B)
    return out


@pytest.mark.parametrize("jcfg", [jax_lm_cfg, jax_lm_cfg_v3], ids=["v2", "v3"])
@pytest.mark.parametrize("instruct", [False, True])
def test_build_and_collate_lm_batch_match_jax(jcfg, instruct):
    """Both packages draw the same uni/bistream layouts from the same
    random.Random and lay them out identically, pads included."""
    jc = jcfg()
    cfg = to_port_cfg(jc, LMConfig)
    layouts = set()
    for seed in range(6):
        batch = _processor_batch(seed, instruct=instruct)
        got = collate_lm_batch(cfg, batch, random.Random(seed))
        want = jlm_data.collate_lm_batch(jc, batch, random.Random(seed))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        layouts |= {bool((got["targets"] == cfg.fill_token).any())}
    assert layouts == {False, True}  # both layouts were drawn
    text, speech = np.arange(12) + 3, np.arange(40)
    for seed in range(4):
        a = build_lm_sample(cfg, text, speech, rng=random.Random(seed))
        b = jlm_data.build_lm_sample(jc, text, speech, rng=random.Random(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_dpo_loss_and_sequence_logps_match_jax():
    logits, targets = _logits_targets(2)
    want = jlm_data.sequence_logps(jnp.asarray(logits), jnp.asarray(targets))
    got = sequence_logps(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    rng = np.random.default_rng(3)
    lps = [rng.standard_normal(5).astype(np.float32) * 4 for _ in range(4)]
    for beta in (0.1, 2.0):
        j = jlm_data.dpo_loss(*(jnp.asarray(x) for x in lps), beta=beta)
        p = dpo_loss(*(torch.from_numpy(x) for x in lps), beta=beta)
        np.testing.assert_allclose(float(p), float(j), rtol=RTOL)
