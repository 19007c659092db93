"""DiT flow estimator of CosyVoice3 (F5-TTS style) in PyTorch.

Counterpart of cosyvoice_tpu/models/dit.py, with the Flax names kept
(`time_embed.mlp1`, `conv_pos.conv1`, `blocks.3.to_q`, `final_adaln`, ...)
so that convert.py carries the JAX weights across. The reference quirks that
the JAX module keeps for checkpoint parity are kept too:

- the interleaved-pair rotary embedding is applied to the first `dim_head`
  dims of the q / k projections before the head split (`apply_partial_rope`);
- AdaLN-Zero: a 6-way chunk of one SiLU + Linear of the timestep embedding
  per block, LayerNorms without affine (eps 1e-6), a tanh-GELU feed-forward,
  and a final 2-way (scale, shift) modulation before `proj_out`;
- attention masks are [B, T, S] bool, chunk-causal when streaming; a masked
  score is -1e30 before the softmax, as in the JAX module, so a row with
  every key masked gives the JAX answer (uniform weights), not NaN.

`DiTEstimator` has the flow estimator's interface (x, mask, mu, t, spks,
cond): offline, chunk-masked (`streaming`), and one incremental chunk
(`stream=(state, pos, real_n)`) over the per-block KV arenas and the
position-conv caches of `dit_stream_state`, written in place.
"""

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.activation import mish
from cosyvoice_tpu_torch.nn.conv import Conv1d, roll_cache
from cosyvoice_tpu_torch.ops.masks import chunk_arena_mask, subsequent_chunk_mask

MASKED = -1.0e30  # the JAX module's masked score


@dataclass(frozen=True)
class DiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 80
    mu_dim: int = 80
    spk_dim: int = 80
    static_chunk_size: int = 50
    freq_embed_dim: int = 256


@lru_cache(maxsize=64)
def _rope_rows(dim_head: int, start: int, n: int, theta: float = 10000.0):
    """Rows [start, start+n) of the interleaved rope tables (each frequency
    twice), float32 numpy, the JAX module's values bit for bit."""
    inv = 1.0 / (theta ** (np.arange(0, dim_head, 2) / dim_head))
    freqs = np.outer(np.arange(start, start + n), inv)
    cos = np.repeat(np.cos(freqs), 2, axis=-1).astype(np.float32)
    sin = np.repeat(np.sin(freqs), 2, axis=-1).astype(np.float32)
    return cos, sin


def rope_tables(dim_head: int, n: int, pos: int = 0, device=None):
    """(cos, sin) [n, dim_head] for absolute positions [pos, pos+n)."""
    cos, sin = _rope_rows(dim_head, pos, n)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate_half_interleaved(x):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_partial_rope(x, dim_head: int, cos=None, sin=None, pos: int = 0):
    """Rotate the first dim_head dims of x [..., T, D] (the reference's
    x-transformers quirk: the rope of one head over the pre-split
    projection). cos/sin [T, dim_head] from `rope_tables`, or made here for
    positions [pos, pos+T) (the offset form of an incremental chunk)."""
    if cos is None:
        cos, sin = rope_tables(dim_head, x.shape[-2], pos, x.device)
    head, rest = x[..., :dim_head], x[..., dim_head:]
    head = head * cos + _rotate_half_interleaved(head) * sin
    return torch.cat([head, rest], dim=-1)


class DiTTimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int = 256):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.mlp1 = nn.Linear(freq_embed_dim, dim)
        self.mlp2 = nn.Linear(dim, dim)

    def forward(self, t):
        half = self.freq_embed_dim // 2
        scale = math.log(10000.0) / (half - 1)
        emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -scale)
        emb = 1000.0 * t[:, None] * emb[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
        return self.mlp2(F.silu(self.mlp1(emb)))


class CausalConvPositionEmbedding(nn.Module):
    """Two left-causal grouped convs (k = 31) with Mish."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.pad = kernel_size - 1
        self.conv1 = Conv1d(dim, dim, kernel_size, groups=groups)
        self.conv2 = Conv1d(dim, dim, kernel_size, groups=groups)

    def forward(self, x, mask=None, caches=None, real_n=None):
        """x [B, T, dim]; mask [B, T] bool. caches=(c1, c2) [B, k-1, dim]:
        incremental-chunk mode, c1 the masked inputs and c2 the post-Mish
        conv1 outputs left of the chunk; returns (h, new caches)."""
        if mask is not None:
            x = x * mask[..., None]
        if caches is not None:
            c1, c2 = caches
            h1 = mish(self.conv1(torch.cat([c1, x], dim=1)))
            h = mish(self.conv2(torch.cat([c2, h1], dim=1)))
            if mask is not None:
                h = h * mask[..., None]
            return h, (roll_cache(c1, x, real_n), roll_cache(c2, h1, real_n))
        h = mish(self.conv1(F.pad(x, (0, 0, self.pad, 0))))
        h = mish(self.conv2(F.pad(h, (0, 0, self.pad, 0))))
        return h * mask[..., None] if mask is not None else h


def _attn_bias(mask):
    """bool [B, T, S] -> additive [B, 1, T, S]: 0 kept, -1e30 masked (a
    score plus -1e30 is -1e30 in float32, as the JAX module's where)."""
    return torch.where(mask[:, None], 0.0, MASKED).to(torch.float32)


def _layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.heads * cfg.dim_head
        self.adaln = nn.Linear(cfg.dim, cfg.dim * 6)
        self.to_q = nn.Linear(cfg.dim, inner)
        self.to_k = nn.Linear(cfg.dim, inner)
        self.to_v = nn.Linear(cfg.dim, inner)
        self.to_out = nn.Linear(inner, cfg.dim)
        self.ff_in = nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult)
        self.ff_out = nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim)

    def forward(self, x, t_emb, bias, rope, arena=None, pos: int = 0):
        """x [B, T, dim]; t_emb [B, dim]; bias [B, 1, T, S] (`_attn_bias`);
        rope (cos, sin) [T, dim_head] at the rows' positions. arena=(k, v)
        [B, A, inner]: incremental-chunk mode, x the new chunk at positions
        [pos, pos+T), whose keys and values are written into the arenas in
        place, and the attention runs over all A rows (S = A)."""
        c = self.cfg
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.adaln(F.silu(t_emb)).chunk(6, dim=-1)
        h = _layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        B, T, _ = h.shape
        q = apply_partial_rope(self.to_q(h), c.dim_head, *rope)
        k = apply_partial_rope(self.to_k(h), c.dim_head, *rope)
        v = self.to_v(h)
        if arena is not None:
            k_arena, v_arena = arena
            if pos + T > k_arena.shape[1]:
                raise ValueError(f"a chunk of {T} rows at {pos} passes the arena's {k_arena.shape[1]}")
            k_arena[:, pos : pos + T] = k.to(k_arena.dtype)
            v_arena[:, pos : pos + T] = v.to(v_arena.dtype)
            k, v = k_arena, v_arena
        S = k.shape[1]

        def heads(a, n):
            return a.reshape(B, n, c.heads, c.dim_head).transpose(1, 2)

        o = F.scaled_dot_product_attention(heads(q, T), heads(k, S), heads(v, S), attn_mask=bias)
        x = x + gate_msa[:, None] * self.to_out(o.transpose(1, 2).reshape(B, T, -1))
        h = _layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        h = self.ff_out(F.gelu(self.ff_in(h), approximate="tanh"))
        return x + gate_mlp[:, None] * h


def dit_stream_state(cfg: DiTConfig, B2: int, arena: int, device=None) -> dict:
    """Zero incremental-chunk state of ONE Euler step of DiTEstimator: the
    position convs' caches ("conv_pos", two [B2, 30, dim]) and per block a
    K and a V arena [B2, arena, inner] float32. B2 = 2*B (the CFG pair); the
    solver keeps one state per Euler step."""
    inner = cfg.heads * cfg.dim_head

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    st = {"conv_pos": (zeros(B2, 30, cfg.dim), zeros(B2, 30, cfg.dim))}
    for i in range(cfg.depth):
        st[f"blocks_{i}"] = (zeros(B2, arena, inner), zeros(B2, arena, inner))
    return st


class DiTEstimator(nn.Module):
    """The flow estimator with the (x, mask, mu, t, spks, cond) interface."""

    def __init__(self, cfg: DiTConfig = DiTConfig()):
        super().__init__()
        self.cfg = cfg
        self.time_embed = DiTTimestepEmbedding(cfg.dim, cfg.freq_embed_dim)
        self.input_proj = nn.Linear(cfg.mel_dim + cfg.mel_dim + cfg.mu_dim + cfg.spk_dim, cfg.dim)
        self.conv_pos = CausalConvPositionEmbedding(cfg.dim)
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final_adaln = nn.Linear(cfg.dim, cfg.dim * 2)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)

    def _out(self, h, t_emb):
        scale, shift = self.final_adaln(F.silu(t_emb)).chunk(2, dim=-1)
        return self.proj_out(_layer_norm(h) * (1 + scale)[:, None] + shift[:, None])

    def forward(self, x, mask, mu, t, spks, cond, streaming: bool = False, stream=None):
        """x/mu/cond [B, T, 80]; mask [B, T] float; t [B]; spks [B, 80].
        Returns the vector field [B, T, 80], zero on padded rows; with
        `streaming` under the chunk masks of static_chunk_size frames.

        stream=(state, pos, real_n): incremental-chunk mode. x/mu/cond are
        the new chunk only (T its padded length, real_n true frames; `mask`
        is not read), `state` one Euler step's dit_stream_state (arenas
        written in place, caches replaced by entry) and `pos` the frames
        already in the arenas. Returns (field, state), equal to the
        chunk-masked recompute's rows."""
        c = self.cfg
        B, T, _ = x.shape
        t_emb = self.time_embed(t)
        h = self.input_proj(torch.cat([x, cond, mu, spks[:, None, :].expand(B, T, spks.shape[-1])], dim=-1))
        if stream is not None:
            st, pos, real_n = stream
            A = st["blocks_0"][0].shape[1]
            m = (torch.arange(T, device=x.device) < real_n)[None].expand(B, T)
            hc, st["conv_pos"] = self.conv_pos(h, m, st["conv_pos"], real_n)
            h = hc + h
            bias = _attn_bias(chunk_arena_mask(B, T, A, pos, real_n, c.static_chunk_size, x.device))
            rope = rope_tables(c.dim_head, T, pos, x.device)
            for i, blk in enumerate(self.blocks):
                h = blk(h, t_emb, bias, rope, st[f"blocks_{i}"], pos)
            return self._out(h, t_emb) * m[..., None], st
        pad = mask > 0.5
        h = self.conv_pos(h, pad) + h
        am = pad[:, None, :]
        if streaming:
            am = am & subsequent_chunk_mask(T, c.static_chunk_size, x.device)[None]
        else:
            am = am.expand(B, T, T)
        bias = _attn_bias(am)
        rope = rope_tables(c.dim_head, T, 0, x.device)
        for blk in self.blocks:
            h = blk(h, t_emb, bias, rope)
        return self._out(h, t_emb) * mask[..., None]
