"""Time-axis resampling.

Counterpart of cosyvoice_tpu/ops/resample.py (torch F.interpolate
semantics; the linear interpolation is written out with the JAX package's
float32 index arithmetic), plus `resample_poly`, a copy of what the JAX
frontend and audio IO take from scipy.signal.resample_poly.
"""

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F


def repeat_interleave_time(x: torch.Tensor, factor: int, axis: int = -1) -> torch.Tensor:
    """Nearest-neighbour integer upsampling (F.interpolate mode='nearest')."""
    return torch.repeat_interleave(x, factor, dim=axis)


def interpolate_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) on the last axis."""
    in_len = x.shape[-1]
    scale = in_len / out_len
    src = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    src = src.clamp(0.0, in_len - 1)
    lo = torch.floor(src).long()
    hi = (lo + 1).clamp_max(in_len - 1)
    w = (src - lo.float()).to(x.dtype)
    return x[..., lo] * (1 - w) + x[..., hi] * w


@functools.lru_cache(maxsize=None)
def _poly_filter(up: int, down: int) -> tuple:
    """scipy's resample_poly filter: firwin(2 * half + 1, 1 / max(up, down),
    window=('kaiser', 5.0)) * up, half = 10 * max(up, down), zero-padded in
    front by `down - half % down`; reversed for a correlation. Returns
    (taps float64, n_pre_remove)."""
    max_rate = max(up, down)
    half = 10 * max_rate
    m = np.arange(2 * half + 1) - half
    h = (1.0 / max_rate) * np.sinc(m / max_rate) * np.kaiser(2 * half + 1, 5.0)
    h = np.concatenate([np.zeros(down - half % down), h / h.sum() * up])
    return h[::-1].copy(), (half + down - half % down) // down


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """scipy.signal.resample_poly(x, up, down) on the last axis (Kaiser
    window, beta 5.0; zero padding): zero-stuff by `up`, low-pass, keep
    every `down`-th sample, aligned and cut to ceil(L * up / down) samples
    as scipy does; one strided convolution in x's dtype on x's device."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x.clone()
    shape, n_in = x.shape[:-1], x.shape[-1]
    n_out = -(-n_in * up // down)
    taps, n_pre_remove = _poly_filter(up, down)
    xu = torch.zeros((*shape, (n_in - 1) * up + 1), dtype=x.dtype, device=x.device)
    xu[..., ::up] = x
    # output j is the filtered zero-stuffed signal at (j + n_pre_remove) * down
    k = len(taps)
    start = n_pre_remove * down
    need = (n_out - 1) * down + 1 + k - 1  # input span of the kept outputs
    xu = F.pad(xu.reshape(-1, 1, xu.shape[-1]), (k - 1, 0))[..., start : start + need]
    xu = F.pad(xu, (0, need - xu.shape[-1]))
    w = torch.as_tensor(taps, dtype=x.dtype, device=x.device).view(1, 1, -1)
    return F.conv1d(xu, w, stride=down).reshape(*shape, n_out)
