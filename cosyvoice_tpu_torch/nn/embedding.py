"""Positional encodings: espnet relative PE, sinusoidal timestep emb, RoPE.

Counterpart of cosyvoice_tpu/nn/embedding.py. The espnet table is built on the
host in float64 numpy exactly as the JAX package builds it, then sliced.
"""

import math
from typing import Tuple

import numpy as np
import torch


def _espnet_pe_table(max_len: int, d_model: int) -> np.ndarray:
    """[1, 2*max_len-1, d] — positive positions reversed then negative from 1."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((max_len, d_model))
    pe_neg = np.zeros((max_len, d_model))
    pe_pos[:, 0::2] = np.sin(position * div_term)
    pe_pos[:, 1::2] = np.cos(position * div_term)
    pe_neg[:, 0::2] = np.sin(-position * div_term)
    pe_neg[:, 1::2] = np.cos(-position * div_term)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return pe[None].astype(np.float32)


class EspnetRelPositionalEncoding:
    """Stateless helper (no trainable params): x -> (x * sqrt(d), pos_emb).

    The table is built on the host, grows on demand (espnet's extend_pe)
    and is kept on each device it is asked for. The rows returned are a
    view of it: read-only. A table that growth replaces stays alive (a
    captured CUDA graph may still read the rows it was given)."""

    def __init__(self, d_model: int, max_len: int = 5000):
        self.d_model = d_model
        self.max_len = max_len
        self.xscale = math.sqrt(d_model)
        self._pe_np = _espnet_pe_table(max_len, d_model)
        self._pe = {}  # device -> the table there (never an inference tensor)
        self._retired = []  # the device tables growth replaced, never freed

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, D] -> (x * sqrt(d), pos_emb [1, 2T-1, D])."""
        return x * self.xscale, self.position_encoding(x.shape[1], x.device)

    def position_encoding(self, size: int, device=None) -> torch.Tensor:
        """Rows for relative positions size-1 .. -(size-1): [1, 2*size-1, D]."""
        if size > self._pe_np.shape[1] // 2 + 1:
            grow = self.max_len
            while size > grow:
                grow *= 2
            self.max_len = grow
            self._pe_np = _espnet_pe_table(grow, self.d_model)
            self._retired.extend(self._pe.values())
            self._pe = {}
        dev = torch.device("cpu") if device is None else torch.device(device)
        if dev not in self._pe:
            # copied to the device once: a slice of it needs no
            # host-to-device copy per call, which a CUDA graph could not capture
            with torch.inference_mode(False):
                self._pe[dev] = torch.from_numpy(self._pe_np).to(dev)
        start = self._pe_np.shape[1] // 2 - size + 1
        return self._pe[dev][:, start : start + 2 * size - 1]


class SinusoidalPosEmb:
    """Matcha SinusoidalPosEmb for CFM timesteps: t [B] -> [B, dim]."""

    def __init__(self, dim: int):
        assert dim % 2 == 0
        self.dim = dim

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        emb = math.log(10000.0) / (half - 1)
        emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
        emb = t[:, None].float() * 1000.0 * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 1e6, device=None):
    """cos/sin tables [max_len, head_dim//2] in float32 (computed in float64)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)
    return (
        torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
        torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device),
    )


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (HF half-split layout): x [B, T, H, D]; cos/sin [T, D/2]
    (one position per step) or [B, T, D/2] (per-row positions). Returns
    float32, as the JAX version promotes bf16 x against the f32 tables."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
