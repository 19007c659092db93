"""The port's HiFT GAN training against the JAX package at tiny width,
float32: the discriminators' outputs and feature maps (odd lengths for
every period, Flax's uneven "SAME" padding under stride 2), the grad-safe
mel in value and gradient, the HiFT training forward on JAX's source draws
(v2, v1 and causal v3; values, and gradients through each straight-through
clip while it clips), one generator step and one discriminator step, one
pretrain step, the warmup-cosine schedule, the pretrain's plateau restart,
and bin/train.py --model hifigan for one epoch on the CPU with checkpoints
the JAX package restores."""

import json

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cosyvoice_tpu.models.discriminator import MultipleDiscriminator as JDisc
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.ops.mel import mel_spectrogram as jmel
from cosyvoice_tpu.train.gan import GanLossConfig as JGanLossConfig
from cosyvoice_tpu.train.gan import make_gan_train_steps as jmake_gan_steps
from cosyvoice_tpu.train.gan import make_generator_pretrain_step as jmake_pretrain_step
from cosyvoice_tpu_torch.bin import train
from cosyvoice_tpu_torch.convert import export_params, load_gan_params, load_jax_params
from cosyvoice_tpu_torch.models.discriminator import MultipleDiscriminator
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.ops.mel import mel_spectrogram
from cosyvoice_tpu_torch.train import gan as gan_mod
from cosyvoice_tpu_torch.train.gan import GanLossConfig, make_gan_train_steps, make_generator_pretrain_step
from cosyvoice_tpu_torch.train.schedulers import warmup_cosine_decay
from cosyvoice_tpu_torch.train.trainer import Optimizer
from cosyvoice_tpu_torch.utils import msgpack_io
from tests.test_torch_common import jax_causal_noise, jax_hift_cfg, jax_hift_cfg_v3, jax_hift_v1_cfg, np_tree
from tests.test_torch_common import to_port_cfg

torch.set_num_threads(2)

MPD_CHANNELS = (4, 8, 8, 16)
MRD = ((64, 8), (128, 16), (32, 4))
FMAP_ATOL = 1e-5  # float32 2-D conv stacks, O(0.1-1) values
MEL_ATOL = 1e-5  # log-mel: the port in float64, JAX in float32
MEL_GRAD_RTOL = 1e-4  # relative L2 of d(mel loss)/d(wav)
SOURCE_ATOL = 1e-5  # the harmonic source on the same draws, float32
# HiFT wav with conv_post's gain 8x (every clip engaged): the iSTFT sums
# magnitudes of up to 100 into samples of at most 0.99, so float32's
# relative error is ~100x the sample's (tests/test_torch_hift.py holds the
# unscaled decode at 1e-4)
WAV_ATOL = 1e-3
GRAD_RTOL = 2e-4  # relative L2 of every gradient leaf of the HiFT forward
METRIC_RTOL = 1e-4  # GAN losses and their terms; the mel, F0 and TPR terms are sums over the batch
LR = 1e-3
# One Adam update from fresh moments moves each weight by lr * g / (|g| +
# 1e-8): a gradient within float32 noise of zero flips sign and moves by up
# to 2 lr the other way. So the update over all weights is held by its
# relative L2, and every weight within the 2 lr a flip can give. Measured
# here 1.2e-4 (generator) and 2.2e-5 (discriminator); with two resblock
# kernels a stage the discriminator step read 1.25e-2 (~0.004 % of its
# weights flipped: two gradients at 1e-7 against a leaf maximum of 0.15).
UPDATE_RTOL = 2e-2


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _grad_tree(module):
    """The module's .grad as its JAX tree (export_params' leaves view the
    CPU parameters, so the gradients are copied in and the weights back)."""
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in module.named_parameters()}
        for _, p in module.named_parameters():
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        tree = jax.tree.map(np.array, export_params(module))
        for n, p in module.named_parameters():
            p.copy_(saved[n])
    return tree


def _assert_update(module, before, after):
    """The module's weights against JAX's `after`, both updated from the
    tree `before` (UPDATE_RTOL)."""
    got, b, a = (dict(_leaves(t)) for t in (export_params(module), np_tree(before), np_tree(after)))
    d_got = np.concatenate([(got[k].astype(np.float64) - b[k]).ravel() for k in a])
    d_want = np.concatenate([(a[k].astype(np.float64) - b[k]).ravel() for k in a])
    assert _rel_l2(d_got, d_want) < UPDATE_RTOL
    assert np.abs(d_got - d_want).max() <= 2 * LR * (1 + 1e-3)


def _disc_pair(seed=0, L=2400):
    jd = JDisc(mpd_channels=MPD_CHANNELS, mrd_resolutions=MRD)
    params = jd.init(jax.random.PRNGKey(seed), jnp.zeros((1, L)))
    with torch.device("cpu"):
        d = MultipleDiscriminator(mpd_channels=MPD_CHANNELS, mrd_resolutions=MRD)
    load_jax_params(d, np_tree(params["params"]))
    return jd, params, d


@pytest.mark.parametrize("L", [2401, 2310], ids=["odd", "even"])
def test_discriminator_outputs_and_feature_maps_match_jax(L):
    """2401 leaves a remainder for every period (2, 3, 5, 7, 11) and odd
    spectrogram sizes under the stride-2 "SAME" convs; 2310 divides by
    every period."""
    jd, params, d = _disc_pair()
    x = (0.3 * np.random.default_rng(L).standard_normal((2, L))).astype(np.float32)
    jo, jf = jax.jit(jd.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        o, f = d(torch.from_numpy(x))
    assert len(o) == len(jo) == 8 and len(f) == len(jf) == 5 * 6 + 3 * 5
    for got, want in zip(o + f, jo + jf):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FMAP_ATOL)
    # the export is the JAX tree, and flax restores it
    _assert_same_tree(export_params(d), np_tree(params))


def _assert_same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))


def test_grad_safe_mel_matches_jax_in_value_and_gradient():
    """Half the wav silent: the clamped mel's floor, where only grad_safe
    carries a gradient. The mel's cached window and filterbank are first
    built under torch.inference_mode (as the frontend builds them), and
    still serve autograd."""
    from cosyvoice_tpu_torch.ops import mel as mel_ops

    rng = np.random.default_rng(0)
    wav = (0.2 * rng.standard_normal((2, 4800))).astype(np.float32)
    wav[:, 2400:] = 0.0
    w = rng.standard_normal((2, 80, 10)).astype(np.float32)
    kw = dict(sr=24000, n_fft=1920, hop=480, win=1920, fmax=None)
    mel_ops._constant.cache_clear()
    with torch.inference_mode():
        mel_spectrogram(torch.from_numpy(wav), **kw)
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(jmel(x, grad_safe=True, **kw) * w))(jnp.asarray(wav))
    x = torch.from_numpy(wav).requires_grad_(True)
    mel = mel_spectrogram(x, grad_safe=True, **kw)
    np.testing.assert_array_equal(mel.detach().numpy(), mel_spectrogram(torch.from_numpy(wav), **kw).numpy())
    np.testing.assert_allclose(mel.detach().numpy(), np.asarray(jmel(jnp.asarray(wav), grad_safe=True, **kw)),
                               rtol=0, atol=MEL_ATOL)
    (mel * torch.from_numpy(w)).sum().backward()
    assert float(x.grad[:, 3000:].abs().max()) > 0  # the silent half has a gradient
    assert _rel_l2(x.grad.numpy(), jg) < MEL_GRAD_RTOL


# one resblock kernel a stage, as the v1 and v3 test configs
CONFIGS = {"v2": lambda **kw: jax_hift_cfg(resblock_kernel_sizes=(3,), resblock_dilations=((1,),), **kw),
           "v1": jax_hift_v1_cfg, "v3 causal": jax_hift_cfg_v3}


def _hift_pair(name, seed=2, **kw):
    jcfg = CONFIGS[name](**kw)
    jh = JHiFT(jcfg)
    params = jh.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 80)), jax.random.PRNGKey(3))
    h = HiFTGenerator(to_port_cfg(jcfg, HiFTConfig), device="cpu").train()
    load_jax_params(h, np_tree(params["params"]))
    if jcfg.causal:
        h.noise_buffer = jax_causal_noise()
    return jh, params, h


def jax_source_draws(cfg, rng, B, L):
    """The draws the JAX source makes from `rng`, as the port's source takes
    them (models/hift.draw_source)."""
    H = cfg.nb_harmonics + 1
    k_ini, k_noise = jax.random.split(rng)
    if cfg.sinegen_type == "1":
        ini = jax.random.uniform(k_ini, (B, 1, H), minval=-np.pi, maxval=np.pi).at[:, :, 0].set(0.0)
    else:
        ini = jax.random.uniform(k_ini, (B, H)).at[:, 0].set(0.0)
    noise = None if cfg.causal else torch.from_numpy(np.array(jax.random.normal(k_noise, (B, L, H))))
    return torch.from_numpy(np.array(ini)), noise


def _loud(params, scale):
    """The tree with conv_post's weight-norm gain scaled: the log-magnitude,
    magnitude and wav clips all engage."""
    p = np_tree(params)
    post = p["params"]["conv_post"]
    post = post.get("conv", post)
    post["g"] = post["g"] * scale
    return jax.tree.map(jnp.asarray, p)


def test_causal_noise_buffer_made_in_inference_mode_trains():
    """The causal source's buffer, first drawn under torch.inference_mode
    (serving), is an ordinary tensor that autograd may save."""
    from cosyvoice_tpu_torch.models import hift as hift_mod

    hift_mod._NOISE.clear()
    with torch.inference_mode():
        buf = hift_mod.causal_noise_buffer(9, "cpu")
    assert not buf.is_inference()
    w = torch.ones(9, requires_grad=True)
    (hift_mod.causal_noise_buffer(9, "cpu")[:4] * w).sum().backward()
    assert torch.equal(w.grad, buf[:4].sum(0))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hift_training_forward_and_straight_through_gradients_match_jax(name):
    jh, params, h = _hift_pair(name)
    params = _loud(params, 8.0)
    load_jax_params(h, np_tree(params["params"]))
    rng = np.random.default_rng(4)
    B, T = 2, 12
    mel = rng.standard_normal((B, T, 80)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    w_wav = rng.standard_normal((B, T * jh.cfg.hop_total)).astype(np.float32)
    w_f0 = rng.standard_normal((B, T)).astype(np.float32)

    def jloss(p):
        wav, f0 = jh.apply(p, jnp.asarray(mel), key)
        return jnp.sum(wav * w_wav) + jnp.sum(f0 * w_f0), (wav, f0)

    (_, (jwav, jf0)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    draws = jax_source_draws(jh.cfg, key, B, T * jh.cfg.hop_total)
    h.zero_grad(set_to_none=True)
    seen = []
    hook = h.conv_post.register_forward_hook(lambda mod, inp, out: seen.append(out.detach()))
    wav, f0 = h(torch.from_numpy(mel), None, draws)
    hook.remove()
    log_mag = seen[0][..., : h.cfg.istft_n_fft // 2 + 1]
    assert float((log_mag > 4.6052).float().mean()) > 0.001, "the magnitude clips do not engage"
    ((wav * torch.from_numpy(w_wav)).sum() + (f0 * torch.from_numpy(w_f0)).sum()).backward()
    assert wav.shape == jwav.shape and f0.shape == jf0.shape
    with torch.no_grad():
        s = h.source_from_f0(f0, None, draws)
    jsource = jax.jit(lambda f: jh.apply(params, key, f, method="source_from_f0"))(jf0)
    np.testing.assert_allclose(s.numpy(), np.asarray(jsource), rtol=0, atol=SOURCE_ATOL)
    np.testing.assert_allclose(f0.detach().numpy(), np.asarray(jf0), rtol=1e-5, atol=WAV_ATOL)
    np.testing.assert_allclose(wav.detach().numpy(), np.asarray(jwav), rtol=0, atol=WAV_ATOL)
    clipped = np.abs(np.asarray(jwav)) >= jh.cfg.audio_limit * (1 - 1e-6)
    assert 0.05 < clipped.mean() < 0.95, f"the wav clip engages on {clipped.mean():.3f} of the samples"
    got = dict(_leaves(_grad_tree(h)))
    for path, want in _leaves(np_tree(jg)):
        assert _rel_l2(got[path], want) < GRAD_RTOL, "/".join(path)


def _gan_batch(cfg, seed=0, B=2, T=10):
    rng = np.random.default_rng(seed)
    L = T * cfg.hop_total
    t = np.arange(L) / cfg.sampling_rate
    f0 = rng.uniform(120, 220, (B, 1))
    wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal((B, L))
    return {"speech": wav.astype(np.float32), "speech_feat": rng.standard_normal((B, T, 80)).astype(np.float32),
            "pitch_feat": np.repeat(f0, T, axis=1).astype(np.float32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_gan_steps_match_optax_clip_adam():
    """One generator step, then one discriminator step (regenerating the wav
    with the updated generator), on one key's draws: the losses and their
    terms, then every weight after each update (v2; v1 in the pretrain
    step)."""
    jh, gparams, h = _hift_pair("v2")
    jd, dparams, d = _disc_pair(seed=1, L=10 * jh.cfg.hop_total)
    jcfg = JGanLossConfig(sample_rate=jh.cfg.sampling_rate, mel_hop=jh.cfg.hop_total)
    g_opt, d_opt = (optax.chain(optax.clip_by_global_norm(5.0), optax.adam(LR)) for _ in range(2))
    jgen, jdisc = jmake_gan_steps(jh, jd, g_opt, d_opt, jcfg)
    batch = _gan_batch(jh.cfg)
    key = jax.random.PRNGKey(21)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g_own, d_own = (jax.tree.map(jnp.copy, p) for p in (gparams, dparams))  # the steps donate their inputs
    g2, _, jgm = jgen(g_own, g_opt.init(g_own), d_own, jb, key)
    d2, _, jdm = jdisc(d_own, d_opt.init(d_own), g2, jb, key)

    cfg = GanLossConfig(sample_rate=h.cfg.sampling_rate, mel_hop=h.cfg.hop_total)
    pg = Optimizer(h.parameters(), lambda _: LR, 5.0, skip_nonfinite=False)
    pd = Optimizer(d.parameters(), lambda _: LR, 5.0, skip_nonfinite=False)
    gen_step, disc_step = make_gan_train_steps(h, d, pg, pd, cfg)
    draws = jax_source_draws(h.cfg, key, 2, 10 * h.cfg.hop_total)
    gm = gen_step(_torch_batch(batch), draws)
    for k in ("loss", "gen_adv", "fm", "mel", "tpr", "f0"):
        np.testing.assert_allclose(float(gm[k]), float(jgm[k]), rtol=METRIC_RTOL, err_msg=k)
    _assert_update(h, gparams, g2)
    assert all(p.grad is None or not p.grad.any() for p in d.parameters())  # the generator step moves no critic
    _assert_same_tree(export_params(d), np_tree(dparams))
    dm = disc_step(_torch_batch(batch), draws)
    np.testing.assert_allclose(float(dm["loss"]), float(jdm["loss"]), rtol=METRIC_RTOL)
    _assert_update(d, dparams, d2)
    assert pg.count == pd.count == 1


def test_pretrain_step_matches_optax():
    jh, gparams, h = _hift_pair("v1")
    jcfg = JGanLossConfig(sample_rate=jh.cfg.sampling_rate, mel_hop=jh.cfg.hop_total)
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 8, LR / 5)
    jopt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(sched))
    jstep = jmake_pretrain_step(jh, jopt, jcfg)
    batch = _gan_batch(jh.cfg, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    own = jax.tree.map(jnp.copy, gparams)
    state = jopt.init(own)
    opt = Optimizer(h.parameters(), warmup_cosine_decay(0.0, LR, 2, 8, LR / 5), 5.0, skip_nonfinite=False)
    step = make_generator_pretrain_step(h, opt, GanLossConfig(sample_rate=jh.cfg.sampling_rate,
                                                              mel_hop=jh.cfg.hop_total))
    for i in range(2):  # the first update is at rate 0
        key = jax.random.PRNGKey(30 + i)
        before = own
        own, state, jm = jstep(jax.tree.map(jnp.copy, own), state, jb, key)
        m = step(_torch_batch(batch), jax_source_draws(h.cfg, key, 2, 10 * h.cfg.hop_total))
        for k in ("loss", "mel", "f0"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, err_msg=f"step {i} {k}")
        if i == 0:
            _assert_same_tree(export_params(h), np_tree(own))  # rate 0 moves nothing
        else:
            _assert_update(h, before, own)


@pytest.mark.parametrize("n", [1000, 8, 2401])
def test_warmup_cosine_schedule_equals_optax(n):
    warm = min(500, max(1, n // 4))
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warm, n, 2e-4)
    got = warmup_cosine_decay(0.0, 1e-3, warm, n, 2e-4)
    steps = np.arange(n + 10)
    # optax evaluates in float32 (a few ulps of its count / warmup quotient), the port in float64
    np.testing.assert_allclose([got(int(s)) for s in steps], np.asarray(jax.vmap(want)(steps)), rtol=2e-5,
                               atol=1e-12)


class _Batches:
    """A dataset stand-in: `per_epoch` batches each epoch, epochs recorded."""

    def __init__(self, batch, per_epoch=40):
        self.batch, self.per_epoch, self.epochs = batch, per_epoch, []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        return iter([self.batch] * self.per_epoch)


def test_pretrain_restarts_from_a_plateau_at_half_the_rate(monkeypatch, tmp_path):
    """The pretrain step stubbed: the first attempt reads mel 5.0 (the
    plateau), the second 1.0. The first attempt stops at the probe step
    (200 for 800 steps), the second restarts from a fresh init at half the
    peak rate and runs all 800; epochs count from 10,000."""
    args = train.parse_args(["--model", "hifigan", "--train_data", "", "--model_dir", str(tmp_path), "--device",
                             "cpu", "--log_interval", "1000"])[0]
    cfg = {"hift": {"base_channels": 8, "resblock_kernel_sizes": [3], "resblock_dilations": [[1]],
                    "source_resblock_dilations": [[1], [1], [1]]},
           "gan": {"mpd_channels": [2, 2, 2, 2], "mrd_resolutions": [[32, 4]], "pretrain_steps": 800,
                   "pretrain_lr": 1e-3}}
    gan = train.build_gan(args, cfg, torch.device("cpu"))
    attempts = []

    def fake_step(hift, opt, loss_cfg):
        attempts.append({"peak": opt.sched(200), "weights": hift.conv_post.v.detach().clone(), "steps": 0})
        mel = 5.0 if len(attempts) == 1 else 1.0

        def step(batch, draws):
            attempts[-1]["steps"] += 1
            return {"loss": torch.tensor(mel), "mel": torch.tensor(mel), "f0": torch.tensor(0.0)}

        return step

    monkeypatch.setattr(gan_mod, "make_generator_pretrain_step", fake_step)
    data = _Batches({"speech": np.zeros((1, 4800), np.float32), "speech_feat": np.zeros((1, 10, 80), np.float32),
                     "pitch_feat": np.zeros((1, 10), np.float32)})
    pm = train.pretrain_generator(args, gan, data)
    assert [a["steps"] for a in attempts] == [200, 800] and pm["steps"] == 800 and pm["attempt"] == 1
    assert attempts[1]["peak"] == pytest.approx(attempts[0]["peak"] / 2, rel=1e-12)
    assert not torch.equal(attempts[0]["weights"], attempts[1]["weights"])  # a fresh init
    assert data.epochs[0] == 10_000 and data.epochs[:6] == [10_000 + i for i in range(5)] + [10_000]


# ---------------------------------------------------------------- the CLI

GAN_CFG = {
    "hift": {"base_channels": 16, "resblock_kernel_sizes": [3], "resblock_dilations": [[1]],
             "source_resblock_kernel_sizes": [7, 7, 11], "source_resblock_dilations": [[1], [1], [1]]},
    "gan": {"truncate_length": 4800, "mpd_channels": [4, 8, 8, 16], "mrd_resolutions": [[64, 8], [128, 16], [32, 4]],
            "batch_size": 2, "pretrain_steps": 2},
    "train": {"max_epoch": 2, "log_interval": 1, "batch_type": "static"},
}


@pytest.fixture(scope="module")
def gan_data(tmp_path_factory):
    """One parquet shard of 4 one-second voiced utterances at 24 kHz."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("gan")
    rng = np.random.default_rng(0)
    t = np.arange(24000) / 24000
    rows = {"utt": [f"u{i}" for i in range(4)], "text": [f"hello {i}" for i in range(4)],
            "audio": [(0.3 * np.sin(2 * np.pi * (150 + 20 * i) * t) + 0.01 * rng.standard_normal(24000))
                      .astype(np.float32).tolist() for i in range(4)],
            "sample_rate": [24000] * 4, "utt_embedding": [rng.standard_normal(192).astype(np.float32).tolist()] * 4}
    pq.write_table(pa.table(rows), str(d / "shard.parquet"))
    (d / "data.list").write_text(str(d / "shard.parquet") + "\n")
    (d / "cfg.json").write_text(json.dumps(GAN_CFG))
    return d


def _jax_gan_template(cfg=GAN_CFG):
    from cosyvoice_tpu.utils.config import build_hift_config as jbuild_hift_config

    key = jax.random.PRNGKey(0)
    g = cfg["gan"]
    jd = JDisc(mpd_channels=tuple(g["mpd_channels"]), mrd_resolutions=tuple(tuple(r) for r in g["mrd_resolutions"]))
    return {"generator": JHiFT(jbuild_hift_config(cfg["hift"])).init(key, jnp.zeros((1, 8, 80)), key),
            "discriminator": jd.init(key, jnp.zeros((1, g["truncate_length"])))}


def test_hifigan_cli_trains_and_jax_restores_its_checkpoints(gan_data, tmp_path):
    out = tmp_path / "exp"
    executor, gan = train.main(["--model", "hifigan", "--config", str(gan_data / "cfg.json"), "--train_data",
                                str(gan_data / "data.list"), "--model_dir", str(out), "--device", "cpu"])
    # 4 utterances in batches of 2: two GAN steps an epoch, two epochs
    assert (executor.epoch, executor.step) == (2, 4) and gan.g_opt.count == gan.d_opt.count == 4
    template = _jax_gan_template()
    for tag, step in (("hifigan_epoch1_step2", 2), ("hifigan_epoch2_step4", 4)):
        side = json.loads((out / f"{tag}.json").read_text())
        assert side["step"] == step and np.isfinite(side["cv_loss"])
        blob = (out / f"{tag}.msgpack").read_bytes()
        restored = ser.from_bytes(template, blob)
        _assert_same_tree(np_tree(restored), msgpack_io.loads(blob))
    final = msgpack_io.read(str(out / "hifigan_epoch2_step4.msgpack"))
    _assert_same_tree(final, {"generator": export_params(gan.hift), "discriminator": export_params(gan.disc)})
    # resume: the GAN checkpoint loads both; a generator-only tree the generator
    args = train.parse_args(["--model", "hifigan", "--config", str(gan_data / "cfg.json"), "--train_data", "",
                             "--model_dir", str(tmp_path / "r"), "--device", "cpu", "--checkpoint",
                             str(out / "hifigan_epoch2_step4.msgpack")])
    again = train.build_gan(*args, torch.device("cpu"))
    _assert_same_tree({"generator": export_params(again.hift), "discriminator": export_params(again.disc)}, final)
    gen_only = tmp_path / "hift.msgpack"
    gen_only.write_bytes(ser.to_bytes(template["generator"]))
    assert not load_gan_params(again.hift, again.disc, msgpack_io.read(str(gen_only)))
    _assert_same_tree(export_params(again.hift), np_tree(template["generator"]))
