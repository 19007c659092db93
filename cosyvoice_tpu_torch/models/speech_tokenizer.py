"""Supervised semantic speech tokenizer (S3), whisper-style encoder + quantiser.

Counterpart of cosyvoice_tpu/models/speech_tokenizer.py (which replaces the
reference's speech_tokenizer_v2.onnx): 128-bin whisper log-mel at 100 Hz ->
conv(k3, s1) + GELU, conv(k3, s2) + GELU (50 Hz), sinusoidal positions,
pre-LN blocks whose attention masks padded keys (`k` has no bias),
`ln_post`, a stride-2 conv + GELU to 25 Hz (v2/v3), then FSQ over
`fsq_levels` (round(tanh(x) * h + h), h = (level - 1) / 2, mixed-radix
ids) or, with `use_fsq=False`, the nearest of a VQ codebook. Channel-last
[B, T, C], float32; parameter names follow the JAX tree (convert.py).
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.conv import Conv1d
from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask

LN_EPS = 1e-6  # flax LayerNorm's default


@dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    d_model: int = 1280
    num_heads: int = 20
    num_layers: int = 6
    codebook_size: int = 6561
    use_fsq: bool = True  # v2/v3; v1 uses VQ-4096
    fsq_levels: Tuple[int, ...] = (3,) * 8
    token_rate_div: int = 2  # extra downsample after the 50 Hz conv stack (v2/v3)


def sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class _EncoderBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.attn_ln = nn.LayerNorm(d_model, eps=LN_EPS)
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model, bias=False)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.mlp_ln = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp_in = nn.Linear(d_model, 4 * d_model)
        self.mlp_out = nn.Linear(4 * d_model, d_model)

    def forward(self, x, pad_mask):
        B, T, C = x.shape
        h = self.attn_ln(x)
        q, k, v = (proj(h).reshape(B, T, self.num_heads, -1) for proj in (self.q, self.k, self.v))
        scores = torch.einsum("bthd,bshd->bhts", q, k) / np.sqrt(C // self.num_heads)
        scores = scores.masked_fill(~pad_mask[:, None, None, :], -1e30)
        o = torch.einsum("bhts,bshd->bthd", scores.softmax(dim=-1), v).reshape(B, T, C)
        x = x + self.out(o)
        return x + self.mlp_out(F.gelu(self.mlp_in(self.mlp_ln(x))))


class S3Tokenizer(nn.Module):
    """mel [B, T, n_mels], mel_len [B] -> (tokens [B, T_tok] int64, token_len [B])."""

    def __init__(self, cfg: S3TokenizerConfig = S3TokenizerConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.conv1 = Conv1d(c.n_mels, c.d_model, 3, padding=1)
        self.conv2 = Conv1d(c.d_model, c.d_model, 3, stride=2, padding=1)
        self.blocks = nn.ModuleList(_EncoderBlock(c.d_model, c.num_heads) for _ in range(c.num_layers))
        self.ln_post = nn.LayerNorm(c.d_model, eps=LN_EPS)
        if c.token_rate_div > 1:
            self.conv_ds = Conv1d(c.d_model, c.d_model, 3, stride=c.token_rate_div, padding=1)
        if c.use_fsq:
            self.fsq_proj = nn.Linear(c.d_model, len(c.fsq_levels))
        else:
            self.codebook = nn.Parameter(torch.zeros(c.codebook_size, c.d_model))

    def quantize(self, x):
        """Encoder output [B, T, C] -> ids [B, T]."""
        c = self.cfg
        if c.use_fsq:
            levels = np.asarray(c.fsq_levels)
            half = torch.as_tensor((levels - 1) / 2.0, dtype=torch.float32, device=x.device)
            q = torch.round(torch.tanh(self.fsq_proj(x)) * half + half)
            strides = torch.as_tensor(np.cumprod([1] + list(levels[:-1])), dtype=torch.float32, device=x.device)
            return (q * strides).sum(-1).long()
        d = (x.square().sum(-1, keepdim=True) - 2.0 * torch.einsum("btc,vc->btv", x, self.codebook)
             + self.codebook.square().sum(-1)[None, None, :])
        return d.argmin(dim=-1)

    def encode(self, mel, mel_len):
        """The encoder up to the quantiser: ([B, T_tok, C], token_len [B])."""
        c = self.cfg
        x = F.gelu(self.conv2(F.gelu(self.conv1(mel))))
        T = x.shape[1]
        x = x + torch.as_tensor(sinusoids(T, c.d_model), device=x.device)[None]
        out_len = (mel_len + 1) // 2
        pad_mask = make_non_pad_mask(out_len, T)
        for block in self.blocks:
            x = block(x, pad_mask)
        x = self.ln_post(x)
        if c.token_rate_div > 1:
            x = F.gelu(self.conv_ds(x))
            out_len = (out_len + c.token_rate_div - 1) // c.token_rate_div
        return x, out_len

    def forward(self, mel, mel_len):
        x, out_len = self.encode(mel, mel_len)
        return self.quantize(x), out_len

