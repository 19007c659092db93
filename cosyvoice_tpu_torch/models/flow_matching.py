"""Conditional flow matching: the 10-step CFG Euler solver.

Counterpart of cosyvoice_tpu/models/flow_matching.py (inference). The noise
comes from the same fixed seeded buffer, np.random.RandomState(0), so the
port's z equals the JAX package's bit for bit.
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


@dataclass(frozen=True)
class CFMConfig:
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10


@lru_cache(maxsize=4)
def fixed_noise_buffer(n_mels: int = 80, max_len: int = 15000) -> np.ndarray:
    """Seeded z buffer [max_len, n_mels] (reference: rand_noise[1,80,50*300])."""
    return np.random.RandomState(0).randn(max_len, n_mels).astype(np.float32)


def t_span_cosine(n_timesteps: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n_timesteps + 1, dtype=np.float32)
    return (1.0 - np.cos(t * 0.5 * np.pi)).astype(np.float32)


def solve_euler(estimator, z, mu, mask, spks, cond, cfg: CFMConfig):
    """CFG Euler ODE from noise z to mel over the cosine time span.
    z/mu/cond [B, T, 80]; mask [B, T]; spks [B, 80]. The conditional and
    unconditional branches run as one batch of 2B per step. Returns [B, T, 80]."""
    B = z.shape[0]
    t_span = t_span_cosine(cfg.n_timesteps)
    mask2 = torch.cat([mask, mask], dim=0)
    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    r = cfg.inference_cfg_rate
    x = z
    for t, t_next in zip(t_span[:-1], t_span[1:]):
        dt = np.float32(t_next - t)
        t2 = torch.full((2 * B,), float(t), dtype=x.dtype, device=x.device)
        out = estimator(torch.cat([x, x], dim=0), mask2, mu2, t2, spks2, cond2)
        x = x + float(dt) * ((1.0 + r) * out[:B] - r * out[B:])
    return x
