"""Conditional flow matching: the 10-step CFG Euler solver and the loss.

Counterpart of cosyvoice_tpu/models/flow_matching.py: the
solver over a full sequence (`solve_euler`, offline or with streaming chunk
masks) and over one incremental chunk (`solve_euler_chunk`, one estimator
state per Euler step, where the JAX version scans over them stacked). The
noise comes from the same fixed seeded buffer, np.random.RandomState(0), so
the port's z equals the JAX package's bit for bit. `cfm_loss` is the
training loss; its random draws (`loss_draws`) come from a torch.Generator,
or from the caller (the parity tests hand in the JAX package's).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


@dataclass(frozen=True)
class CFMConfig:
    sigma_min: float = 1e-6
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10


@lru_cache(maxsize=4)
def fixed_noise_buffer(n_mels: int = 80, max_len: int = 15000) -> np.ndarray:
    """Seeded z buffer [max_len, n_mels] (reference: rand_noise[1,80,50*300])."""
    return np.random.RandomState(0).randn(max_len, n_mels).astype(np.float32)


_NOISE = {}


def fixed_noise(device) -> torch.Tensor:
    """fixed_noise_buffer() on `device`, copied there once and kept (never
    an inference tensor), so that the solver's z is a slice of a device
    tensor: no host-to-device copy per call, which a CUDA graph could not
    capture."""
    dev = torch.device(device)
    if dev not in _NOISE:
        with torch.inference_mode(False):
            _NOISE[dev] = torch.from_numpy(fixed_noise_buffer()).to(dev)
    return _NOISE[dev]


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


def loss_draws(generator: torch.Generator, B: int, T: int, n_mels: int, cfg: CFMConfig, device) -> dict:
    """The random draws of one flow loss (CausalFlow.loss, cfm_loss), from
    `generator` on `device`: "t" [B] ~ U[0, 1), the flow time; "z" [B, T,
    n_mels] ~ N(0, 1), the noise; "keep" [B] bool, the rows that keep their
    conditioning (U > training_cfg_rate: classifier-free guidance dropout);
    "coin" and "frac" [B] ~ U[0, 1), the conditioning prefix (a prefix of
    frac * 0.3 of the row's frames where coin < 0.5)."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {"t": uniform(B), "z": torch.randn((B, T, n_mels), generator=generator, device=device),
            "keep": uniform(B) > cfg.training_cfg_rate, "coin": uniform(B), "frac": uniform(B)}


def cfm_loss(estimator, x1, mask, mu, spks, cond, cfg: CFMConfig, streaming: bool, draws: dict):
    """The training loss: with t and z from `draws` (loss_draws), the OT path
    y = (1 - (1 - sigma_min) t) z + t x1 and its target u = x1 - (1 -
    sigma_min) z; the conditioning (mu, spks, cond) of the rows not in
    draws["keep"] zeroed where training_cfg_rate > 0; the masked MSE of the
    estimator's field against u. x1/mu/cond [B, T, 80], mask [B, T], spks
    [B, 80]. t is plain uniform: the cosine schedule warps only the
    inference time span."""
    t = draws["t"].to(x1.dtype)[:, None, None]
    z = draws["z"].to(x1.dtype)
    y = (1.0 - (1.0 - cfg.sigma_min) * t) * z + t * x1
    u = x1 - (1.0 - cfg.sigma_min) * z
    if cfg.training_cfg_rate > 0:
        keep = draws["keep"].to(x1.dtype)
        mu, spks, cond = mu * keep[:, None, None], spks * keep[:, None], cond * keep[:, None, None]
    pred = estimator(y, mask, mu, t[:, 0, 0], spks, cond, streaming)
    m = mask[..., None]
    return ((pred - u) * m).square().sum() / (mask.sum() * x1.shape[-1] + 1e-8)
