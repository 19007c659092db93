"""HiFT GAN training: alternating generator and discriminator steps, and
the generator-only pretrain step.

Counterpart of cosyvoice_tpu/train/gan.py. The generator's loss is
adversarial + 2 x feature matching + 45 x mel L1 + TPR + F0 L1; the
discriminator's least-squares + TPR (train/losses.py). The mel of the
losses is the grad-safe parity mel (`ops/mel.mel_spectrogram(grad_safe=
True)`, full band). Each step is one `Optimizer` update with
skip_nonfinite=False: optax's clip -> Adam chain, which applies a
non-finite gradient like any other.

One step number's generator and discriminator steps take the same source
draws (`models/hift.draw_source`), as the JAX loop hands both the same key;
the discriminator step regenerates the wav with the generator as the
generator step just updated it, detached, and does not reuse that step's
wav. batch: {"speech": [B, L], "speech_feat": [B, T, 80], "pitch_feat":
[B, T]} tensors on the modules' device. Each step returns its metrics as
0-d float32 tensors ("loss" and the loss's terms, "grad_norm").
"""

from dataclasses import dataclass

import torch

from cosyvoice_tpu_torch.ops.mel import mel_spectrogram
from cosyvoice_tpu_torch.train.losses import (
    discriminator_adv_loss,
    f0_l1_loss,
    feature_matching_loss,
    generator_adv_loss,
    mel_l1_loss,
    tpr_loss,
)


@dataclass(frozen=True)
class GanLossConfig:
    mel_weight: float = 45.0
    feat_match_weight: float = 2.0
    tpr_weight: float = 1.0
    f0_weight: float = 1.0
    sample_rate: int = 24000
    mel_hop: int = 480
    mel_fmax: float = 0.0  # 0: the full band


def _gan_mel(wav, cfg: GanLossConfig):
    return mel_spectrogram(wav, sr=cfg.sample_rate, n_fft=cfg.mel_hop * 4, hop=cfg.mel_hop, win=cfg.mel_hop * 4,
                           fmax=None if cfg.mel_fmax == 0.0 else cfg.mel_fmax, grad_safe=True)


def _regression(hift, batch, draws, cfg: GanLossConfig):
    """(wav_hat, real wav cut to its length, mel L1, F0 L1) of one generator
    forward."""
    wav_hat, f0 = hift(batch["speech_feat"], None, draws)
    real = batch["speech"][:, : wav_hat.shape[1]]
    mel = mel_l1_loss(_gan_mel(real, cfg), _gan_mel(wav_hat, cfg))
    return wav_hat, real, mel, f0_l1_loss(batch["pitch_feat"][:, : f0.shape[1]], f0)


def _update(optimizer, loss):
    optimizer.zero_grad()
    loss.backward()
    gnorm, _ = optimizer.step()
    return gnorm


def make_gan_train_steps(hift, disc, gen_opt, disc_opt, cfg: GanLossConfig = GanLossConfig()):
    """Returns (gen_step, disc_step), each (batch, draws) -> metrics: one
    update of the generator (gen_opt) or of the discriminator (disc_opt)."""

    def gen_step(batch, draws):
        wav_hat, real, mel, f0l = _regression(hift, batch, draws, cfg)
        disc.requires_grad_(False)  # the generator's loss moves only the generator
        try:
            d_fake, f_fake = disc(wav_hat)
            with torch.no_grad():
                d_real, f_real = disc(real)
        finally:
            disc.requires_grad_(True)
        adv = generator_adv_loss(d_fake)
        fm = feature_matching_loss(f_real, f_fake)
        tpr = tpr_loss(d_real, d_fake)
        loss = adv + cfg.feat_match_weight * fm + cfg.mel_weight * mel + cfg.tpr_weight * tpr + cfg.f0_weight * f0l
        gnorm = _update(gen_opt, loss)
        return {"loss": loss.detach(), "gen_adv": adv.detach(), "fm": fm.detach(), "mel": mel.detach(),
                "tpr": tpr.detach(), "f0": f0l.detach(), "grad_norm": gnorm}

    def disc_step(batch, draws):
        with torch.no_grad():
            wav_hat, _ = hift(batch["speech_feat"], None, draws)
        real = batch["speech"][:, : wav_hat.shape[1]]
        d_fake, _ = disc(wav_hat)
        d_real, _ = disc(real)
        loss = discriminator_adv_loss(d_real, d_fake) + cfg.tpr_weight * tpr_loss(d_real, d_fake)
        gnorm = _update(disc_opt, loss)
        return {"loss": loss.detach(), "disc_adv": loss.detach(), "grad_norm": gnorm}

    return gen_step, disc_step


def make_generator_pretrain_step(hift, gen_opt, cfg: GanLossConfig = GanLossConfig()):
    """The generator-only warm-up step, (batch, draws) -> metrics: mel L1 +
    F0 L1, no adversarial term. Plain regression takes a far higher rate
    than the adversarial game, and brings the amplitude and pitch into
    range before the discriminator starts (the role of a pretrained
    vocoder in the reference recipe)."""

    def pretrain_step(batch, draws):
        _, _, mel, f0l = _regression(hift, batch, draws, cfg)
        loss = cfg.mel_weight * mel + cfg.f0_weight * f0l
        gnorm = _update(gen_opt, loss)
        return {"loss": loss.detach(), "mel": mel.detach(), "f0": f0l.detach(), "grad_norm": gnorm}

    return pretrain_step
