"""Matcha-style 1D U-Net blocks of the flow estimators.

Counterpart of cosyvoice_tpu/nn/unet.py: the causal blocks of the
CosyVoice2 estimator (CausalBlock1D, causal ResnetBlock1D), with the
incremental-chunk forms of the streaming flow (the conv blocks take
left-context caches, the transformer blocks a KV arena); the non-causal
blocks of the CosyVoice-300M estimator (Block1D: conv, GroupNorm, Mish;
the non-causal ResnetBlock1D; Downsample1D and Upsample1DTranspose of its
multi-level U-Net); TimestepEmbedding and BasicTransformerBlock. x [B, T,
C]; mask [B, T] float; t_emb [B, time_dim]. Block1D's GroupNorm reduces
over every frame of its masked input, padded ones included, as the JAX
block computes it (ROADMAP C4).
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.activation import mish
from cosyvoice_tpu_torch.nn.conv import CausalConv1d, Conv1d, WNConvTranspose1d, roll_cache


class CausalBlock1D(nn.Module):
    """CausalConv k=3 + LayerNorm + Mish, masked in and out.

    cache/real_n: incremental-chunk mode, `cache` [B, 2, C] the two masked
    input frames left of the chunk; returns (y, new_cache)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = CausalConv1d(dim_in, dim_out, 3)
        self.norm = nn.LayerNorm(dim_out, eps=1e-5)

    def forward(self, x, mask, cache=None, real_n=None):
        m = mask[..., None]
        xm = x * m
        y = mish(self.norm(self.conv(xm, cache))) * m
        return y if cache is None else (y, roll_cache(cache, xm, real_n))


class Block1D(nn.Module):
    """Conv k=3 (zero pad 1) of the masked input, GroupNorm of `groups`
    groups, Mish, masked."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.conv = Conv1d(dim_in, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, mask):
        m = mask[..., None]
        h = self.conv(x * m).transpose(1, 2)
        return mish(self.norm(h).transpose(1, 2)) * m


class Downsample1D(nn.Module):
    """Strided conv k=3, stride 2, pad 1: ceil(T / 2) frames."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample1DTranspose(nn.Module):
    """Weight-normed ConvTranspose1d k=4, stride 2, pad 1: 2T frames."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = WNConvTranspose1d(dim, dim, 4, 2, padding=1)

    def forward(self, x):
        return self.conv(x)


class ResnetBlock1D(nn.Module):
    """Resnet block: block1, + mlp(mish(t_emb)), block2, + res_conv(x);
    causal (CausalBlock1D) or not (Block1D)."""

    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int, causal: bool = True):
        super().__init__()
        block = CausalBlock1D if causal else Block1D
        self.block1 = block(dim_in, dim_out)
        self.mlp = nn.Linear(time_emb_dim, dim_out)
        self.block2 = block(dim_out, dim_out)
        self.res_conv = Conv1d(dim_in, dim_out, 1)

    def forward(self, x, mask, t_emb, caches=None, real_n=None):
        """caches: (block1's, block2's) in incremental-chunk mode; returns
        (y, new_caches) when given."""
        if caches is None:
            h = self.block1(x, mask) + self.mlp(mish(t_emb))[:, None, :]
            h = self.block2(h, mask)
            return h + self.res_conv(x * mask[..., None])
        h, c1 = self.block1(x, mask, caches[0], real_n)
        h, c2 = self.block2(h + self.mlp(mish(t_emb))[:, None, :], mask, caches[1], real_n)
        return h + self.res_conv(x * mask[..., None]), (c1, c2)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class UNetAttention(nn.Module):
    """diffusers-style attention: q/k/v without bias, out projection with bias.

    Chunked mode (`arena`=(k, v) [B, A_arena, inner], `pos`): x is the new
    chunk [B, n, C], its K/V rows are written in place at [pos, pos+n), and
    attention reads the arena's first A rows under `attn_bias` [B, n, A]:
    the full recompute's rows under chunk-causal masks."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, attn_bias=None, arena=None, pos=None):
        B, T, _ = x.shape
        q = self.to_q(x).reshape(B, T, self.heads, self.head_dim)
        k, v = self.to_k(x), self.to_v(x)
        if arena is not None:
            A = attn_bias.shape[-1]
            arena[0][:, pos : pos + T] = k
            arena[1][:, pos : pos + T] = v
            k, v = arena[0][:, :A], arena[1][:, :A]
        k = k.reshape(B, -1, self.heads, self.head_dim)
        v = v.reshape(B, -1, self.heads, self.head_dim)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(self.head_dim)
        if attn_bias is not None:
            scores = scores + attn_bias[:, None]
        out = torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)
        return self.to_out(out.reshape(B, T, -1))


class BasicTransformerBlock(nn.Module):
    """Self-attention + GELU FFN; attn_bias additive [B, T, T]."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, ff_mult: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = UNetAttention(dim, num_heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = nn.Linear(dim, dim * ff_mult)
        self.ff_out = nn.Linear(dim * ff_mult, dim)

    def forward(self, x, attn_bias=None, arena=None, pos=None):
        """arena/pos: chunked mode (see UNetAttention), attn_bias [B, n, A]."""
        x = x + self.attn1(self.norm1(x), attn_bias, arena, pos)
        return x + self.ff_out(F.gelu(self.ff_in(self.norm3(x))))
