"""torch.stft/istft-compatible STFT with the JAX package's conventions.

Counterpart of cosyvoice_tpu/ops/stft.py: periodic hann window, reflect
padding when centred, overlap-add with window-square normalisation.
"""

import functools

import numpy as np
import torch
from torch.nn import functional as F


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic hann window (scipy get_window('hann', n, fftbins=True)),
    made once per (n, dtype, device) and kept (never an inference tensor;
    no host-to-device copy per call, which a CUDA graph could not capture).
    Read-only."""
    return _hann_window(n, dtype, None if device is None else torch.device(device))


@functools.lru_cache(maxsize=None)
def _hann_window(n: int, dtype, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n), dtype=dtype, device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor, center: bool = True) -> torch.Tensor:
    """x [..., L] real -> complex [..., n_fft//2+1, T], T = 1 + L//hop when centred."""
    if center:
        shape = x.shape
        x = F.pad(x.reshape(-1, 1, shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect").reshape(*shape[:-1], -1)
    frames = x.unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor, center: bool = True) -> torch.Tensor:
    """complex [..., n_fft//2+1, T] -> real [..., (T-1)*hop] when centred."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window  # [..., T, n_fft]
    batch_shape, n_frames = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    flat = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)  # [N, n_fft, T]

    def overlap_add(cols):
        return F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft), stride=(1, hop))[:, 0, 0]

    sig = overlap_add(flat)
    wsq = overlap_add((window * window)[None, :, None].expand(1, n_fft, n_frames))
    sig = sig / torch.clamp_min(wsq, 1e-11)
    if center:
        sig = sig[:, n_fft // 2 : out_len - n_fft // 2]
    return sig.reshape(*batch_shape, sig.shape[-1])
