"""Conditional flow matching: the 10-step CFG Euler solver.

Counterpart of cosyvoice_tpu/models/flow_matching.py (inference): the
solver over a full sequence (`solve_euler`, offline or with streaming chunk
masks) and over one incremental chunk (`solve_euler_chunk`, one estimator
state per Euler step, where the JAX version scans over them stacked). The
noise comes from the same fixed seeded buffer, np.random.RandomState(0), so
the port's z equals the JAX package's bit for bit.
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


def _steps(n_timesteps: int):
    """(t, dt) of each Euler step over the cosine time span."""
    t_span = t_span_cosine(n_timesteps)
    return [(float(t), float(np.float32(t_next - t))) for t, t_next in zip(t_span[:-1], t_span[1:])]


def _cfg_pair(*xs):
    """The CFG batch of 2B: each input, then zeros (the unconditional branch)."""
    return [torch.cat([x, torch.zeros_like(x)], dim=0) for x in xs]


def solve_euler(estimator, z, mu, mask, spks, cond, cfg: CFMConfig, streaming: bool = False):
    """CFG Euler ODE from noise z to mel over the cosine time span.
    z/mu/cond [B, T, 80]; mask [B, T]; spks [B, 80]; streaming: the
    estimator's chunk masks. The conditional and unconditional branches run
    as one batch of 2B per step. Returns [B, T, 80]."""
    B = z.shape[0]
    mask2 = torch.cat([mask, mask], dim=0)
    mu2, spks2, cond2 = _cfg_pair(mu, spks, cond)
    r = cfg.inference_cfg_rate
    x = z
    for t, dt in _steps(cfg.n_timesteps):
        t2 = torch.full((2 * B,), t, dtype=x.dtype, device=x.device)
        out = estimator(torch.cat([x, x], dim=0), mask2, mu2, t2, spks2, cond2, streaming)
        x = x + dt * ((1.0 + r) * out[:B] - r * out[B:])
    return x


def solve_euler_chunk(estimator, z, mu, spks, cond, cfg: CFMConfig, caches, pos: int, real_n: int):
    """One incremental chunk's CFG Euler trajectory. z/mu/cond [B, n, 80]: the
    new chunk only (z sliced from the fixed noise buffer at the chunk's mel
    offset); caches: one estimator_stream_state per Euler step (each step's
    x_t differs, so each has its own arenas), updated in place; pos the mel
    frames already in them, real_n the chunk's true frames. Returns mel
    [B, n, 80]: O(chunk * prefix) attention instead of the recompute's
    O(prefix^2)."""
    B, n = z.shape[:2]
    mu2, spks2, cond2 = _cfg_pair(mu, spks, cond)
    ones = torch.ones((2 * B, n), dtype=z.dtype, device=z.device)
    r = cfg.inference_cfg_rate
    x = z
    for (t, dt), cache in zip(_steps(cfg.n_timesteps), caches):
        t2 = torch.full((2 * B,), t, dtype=x.dtype, device=x.device)
        out, _ = estimator(torch.cat([x, x], dim=0), ones, mu2, t2, spks2, cond2, stream=(cache, pos, real_n))
        x = x + dt * ((1.0 + r) * out[:B] - r * out[B:])
    return x
