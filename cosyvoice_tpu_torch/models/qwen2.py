"""Qwen2 transformer backbone (GQA + RoPE + SwiGLU + RMSNorm) in PyTorch.

Counterpart of cosyvoice_tpu/models/qwen2.py for the bf16/fp32 layouts (the
int8/int4 weight options and the int8 KV arena are not ported yet).

- fused qkv projection with bias, fused gate|up projection;
- a preallocated KV arena [L, B, T, Hkv, d] per K and V, updated in place
  (the JAX version returns updated arrays; here the arena is mutated);
- the decode step writes each new K/V row with kernel K2
  (ops/decode_attention.kv_arena_write) and attends with kernel K1
  (ops/decode_attention.gqa_decode_attention), which reads only the live
  keys; prefill attention is a plain grouped einsum, as in JAX.

Parameters of the matmuls live in `cfg.dtype` (bf16 on the card); norm
weights stay float32 and norms compute in float32, as the JAX module does.
"""

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.embedding import apply_rope, rope_frequencies
from cosyvoice_tpu_torch.ops.decode_attention import gqa_decode_attention, kv_arena_write

NEG_INF = -1e30


@dataclass(frozen=True)
class Qwen2Config:
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    vocab_size: int = 151936
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    max_cache_len: int = 4096
    dtype: torch.dtype = torch.bfloat16


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (x32 * self.weight).to(x.dtype)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        self.qkv_proj = nn.Linear(cfg.hidden_size, nq + 2 * nkv, bias=True, dtype=cfg.dtype)
        self.o_proj = nn.Linear(nq, cfg.hidden_size, bias=False, dtype=cfg.dtype)

    def _qkv(self, x, cos, sin):
        c = self.cfg
        B, S, _ = x.shape
        nq, nkv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        qkv = self.qkv_proj(x)
        q = qkv[..., :nq].reshape(B, S, c.num_heads, c.head_dim)
        k = qkv[..., nq : nq + nkv].reshape(B, S, c.num_kv_heads, c.head_dim)
        v = qkv[..., nq + nkv :].reshape(B, S, c.num_kv_heads, c.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def prefill(self, x, cos, sin, bias, k_arena, v_arena):
        """x [B, S, C]; bias [B, 1, S, S] additive; writes arena rows [0, S)."""
        c = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(x, cos, sin)
        k_arena[:, :S] = k.to(k_arena.dtype)
        v_arena[:, :S] = v.to(v_arena.dtype)
        rep = c.num_heads // c.num_kv_heads
        qg = q.reshape(B, S, c.num_kv_heads, rep, c.head_dim)
        scores = torch.einsum("bsgrd,btgd->bgrst", qg, k_arena[:, :S].float()) / math.sqrt(c.head_dim)
        attn = torch.softmax(scores + bias[:, None], dim=-1).to(v_arena.dtype)
        out = torch.einsum("bgrst,btgd->bsgrd", attn, v_arena[:, :S])
        return self.o_proj(out.reshape(B, S, -1).to(c.dtype))

    def decode(self, x, cos, sin, cur_len, k_arena, v_arena):
        """x [B, 1, C]; cur_len [B] int32 write positions (kernels K2, K1)."""
        B = x.shape[0]
        dt = k_arena.dtype
        q, k, v = self._qkv(x, cos, sin)
        kv_arena_write(k_arena, k.to(dt).contiguous(), cur_len)
        kv_arena_write(v_arena, v.to(dt).contiguous(), cur_len)
        out = gqa_decode_attention(q[:, 0].to(dt).contiguous(), k_arena, v_arena, cur_len)
        return self.o_proj(out.reshape(B, 1, -1).to(self.cfg.dtype))


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.gate_up_proj = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size, bias=False, dtype=cfg.dtype)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False, dtype=cfg.dtype)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = Qwen2MLP(cfg)

    def _tail(self, x, attn_out):
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x))

    def prefill(self, x, cos, sin, bias, k_arena, v_arena):
        return self._tail(x, self.self_attn.prefill(self.input_layernorm(x), cos, sin, bias, k_arena, v_arena))

    def decode(self, x, cos, sin, cur_len, k_arena, v_arena):
        return self._tail(x, self.self_attn.decode(self.input_layernorm(x), cos, sin, cur_len, k_arena, v_arena))


class Qwen2Model(nn.Module):
    """Backbone: embeddings in, final hidden out; text embedding table in
    `embed_tokens`."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype)
        self.layers = nn.ModuleList(Qwen2Layer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_cache_len, cfg.rope_theta, device=self.norm.weight.device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def init_cache(self, batch: int):
        """Zero KV arenas (k, v), each [L, B, max_cache_len, Hkv, d] in cfg.dtype."""
        c = self.cfg
        shape = (c.num_layers, batch, c.max_cache_len, c.num_kv_heads, c.head_dim)
        dev = self.norm.weight.device
        return (torch.zeros(shape, dtype=c.dtype, device=dev), torch.zeros(shape, dtype=c.dtype, device=dev))

    def prefill(self, embeds, true_len, cache):
        """Write the prompt into the arena. embeds [B, S, C] (tail-padded ok),
        true_len [B]. Returns (hidden at true_len-1 [B, C], cache)."""
        B, S, _ = embeds.shape
        pos = torch.arange(S, device=embeds.device)
        keep = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] < true_len[:, None, None])
        bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)[:, None]
        cos, sin = self.rope_cos[:S], self.rope_sin[:S]
        x = embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.prefill(x, cos, sin, bias, cache[0][i], cache[1][i])
        x = self.norm(x)
        idx = (true_len.long() - 1).clamp_min(0)
        return x[torch.arange(B, device=x.device), idx], cache

    def decode_step(self, emb, cur_len, cache):
        """One token per row. emb [B, 1, C]; cur_len [B] int32 positions
        (the KV write position; keys 0..cur_len are attended).
        Returns (hidden [B, C], cache)."""
        pos = cur_len.long()
        cos, sin = self.rope_cos[pos][:, None], self.rope_sin[pos][:, None]
        x = emb.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cos, sin, cur_len, cache[0][i], cache[1][i])
        return self.norm(x)[:, 0], cache
