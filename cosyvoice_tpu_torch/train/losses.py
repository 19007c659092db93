"""Training losses.

Counterpart of cosyvoice_tpu/train/losses.py:

- `lm_ce_loss`: label-smoothing CE over the speech-token head (the
  reference's KL against the smoothed distribution with per-token
  normalisation; lsm_weight 0 in the shipped configs is plain masked CE);
- the GAN losses of HiFT training (mel L1, feature matching, least-squares
  generator and discriminator losses, the truncated pointwise relativistic
  loss, F0 L1).
"""

from typing import Sequence

import torch
from torch.nn import functional as F

IGNORE_ID = -100


def lm_ce_sums(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.0):
    """logits [B, T, V]; targets [B, T] with IGNORE_ID padding. Returns
    (summed smoothed NLL float32, correct argmaxes, valid targets): the
    parts of lm_ce_loss, which a data-parallel step sums over ranks."""
    V = logits.shape[-1]
    valid = targets != IGNORE_ID
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    conf = 1.0 - smoothing
    smooth = smoothing / (V - 1)
    true_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    # KL(smoothed || pred) up to a constant: -(conf * logp_true + smooth * sum(logp_other))
    nll = -(conf * true_lp + smooth * (logp.sum(-1) - true_lp))
    correct = ((logits.argmax(-1) == tgt) & valid).sum()
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), correct, valid.sum()


def lm_ce_loss(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.0, normalize_length: bool = True):
    """logits [B, T, V]; targets [B, T] with IGNORE_ID padding. Returns
    (loss, accuracy), float32 scalars."""
    nll, correct, n_valid = lm_ce_sums(logits, targets, smoothing)
    denom = n_valid.clamp_min(1) if normalize_length else logits.shape[0]
    return nll / denom, (correct / n_valid.clamp_min(1)).float()


def mel_l1_loss(real_mel: torch.Tensor, fake_mel: torch.Tensor) -> torch.Tensor:
    return (real_mel - fake_mel).abs().mean()


def feature_matching_loss(feats_real: Sequence, feats_fake: Sequence) -> torch.Tensor:
    return sum((fr - ff).abs().mean() for fr, ff in zip(feats_real, feats_fake))


def generator_adv_loss(disc_fake_outs: Sequence) -> torch.Tensor:
    return sum((1.0 - d).square().mean() for d in disc_fake_outs)


def discriminator_adv_loss(disc_real_outs: Sequence, disc_fake_outs: Sequence) -> torch.Tensor:
    return sum((1.0 - dr).square().mean() + df.square().mean() for dr, df in zip(disc_real_outs, disc_fake_outs))


def tpr_loss(disc_real_outs: Sequence, disc_fake_outs: Sequence, tau: float = 0.04) -> torch.Tensor:
    """Truncated pointwise relativistic loss: m = median(dr - dg); L_rel =
    mean(((dr - dg) - m)^2 over the elements with dr - dg < m); each
    discriminator adds min(tau, L_rel), written tau - relu(tau - L_rel).
    The median of an even count is the mean of the two middle values, as
    jnp.median takes it (torch.median takes the lower one)."""
    loss = 0.0
    for dr, dg in zip(disc_real_outs, disc_fake_outs):
        diff = (dr - dg).reshape(-1)
        m = torch.quantile(diff, 0.5)
        sel = (diff < m).to(diff.dtype)
        l_rel = ((diff - m).square() * sel).sum() / sel.sum().clamp_min(1.0)
        loss = loss + tau - F.relu(tau - l_rel)
    return loss


def f0_l1_loss(real_f0: torch.Tensor, pred_f0: torch.Tensor) -> torch.Tensor:
    return (real_f0 - pred_f0).abs().mean()
