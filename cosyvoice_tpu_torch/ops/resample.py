"""Time-axis resampling with torch F.interpolate semantics.

Counterpart of cosyvoice_tpu/ops/resample.py; the linear interpolation is
written out with the JAX package's float32 index arithmetic.
"""

import torch


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
