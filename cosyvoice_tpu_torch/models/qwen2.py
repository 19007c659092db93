"""Qwen2 transformer backbone (GQA + RoPE + SwiGLU + RMSNorm) in PyTorch.

Counterpart of cosyvoice_tpu/models/qwen2.py for bf16/fp32 weights and for
the three weight-only modes, each with a bf16 or an int8 KV arena
(`kv_quant`): `Qwen2Config(quant=True | "int8")`, int8 kernels with
per-output-channel scales (`QuantDense`); `quant="int4"`, half-split
nibble-packed int4 with 8 input-blockwise scales (`QuantDense4`); and
`quant="int4p"`, the blocked int4 layouts of the fused decode kernels. The
int8 and int4 products are plain dequantise-then-matmul, as the JAX package
computes them in XLA; their decode step is the bf16 LM's (K2, then K1 or K3):

- fused qkv projection with bias, fused gate|up projection;
- a KV arena [L, B, T, Hkv, d] per K and V, updated in place
  (the JAX version returns updated arrays; here the arena is mutated); with
  kv_quant the arena is int8 with per-token f32 scales [L, B, T] per K and V
  (`ops/decode_attention.quantize_kv_rows`);
- `decode_step` (one token per row) routes each layer's attention as the
  JAX LM does (`ops/decode_attention.decode_kernel_wanted`, from Hkv * d
  and the arena's length): on the kernel route it writes the new K and V
  rows (and over the int8 arena their scales) with one launch of kernel K2
  (kv_arena_write_kv) and attends with K1 (gqa_decode_attention, bf16 or
  float32) or, over the int8 arena, K3 (gqa_decode_attention_quant); on the
  plain route (Hkv * d not a multiple of 128: every small config of the
  repo) an indexed row write and the masked einsum over the whole arena,
  dequantised first when it is int8, as the JAX einsum path; with int4p its qkv
  projection is K4 (ops/int4_fused.int4_gemv) and its whole post-attention
  tail, o_proj + residual + RMSNorm + MLP + residual, is K6 (int4_o_mlp).
  With a bf16 arena at B=1 and at most ops/int4_block.MAX_FUSED_ARENA rows,
  the LM (models/llm.py) decodes through the whole-step kernel K7 instead;
- `prefill` and `extend` (an exact-shape segment at arena rows
  [start, start+S), the bi-streaming feeds) write their rows with a slice
  and attend with a plain grouped einsum over the arena rows up to the
  segment's end, dequantised first when they are int8, as in JAX. A
  one-row `extend` takes the decode step's route instead. Their int4p
  products route by shape, as the JAX layers do on the TPU
  (`_int4p_use_pallas`): at most 16 rows with 128-multiple widths take K4
  for qkv and o_proj and K5 (int4_mlp) for the MLP, more rows the plain
  blocked matmuls (int4_matmul_blocked, int4_mlp_reference), where the JAX
  package runs XLA;
- `forward(embeds, valid, dtype)` is the teacher-forced forward of
  training (JAX `Qwen2Model.__call__`): the causal & valid mask, rope from
  position 0, no arena, attention through scaled_dot_product_attention
  (the JAX package computes it in XLA); each product casts its weight to
  `dtype`, so float32 master weights train with bf16 products, as the JAX
  module's float32 params with dtype bf16. Quantised layouts do not train;
- the arena's length is the caller's (`init_cache(batch, length)`);
  `StaticArenas` keeps one arena per length bucket for the LM's decode
  graphs, grown with zeros by `grow_cache` as the JAX LM grows it.

The kernel wrappers run the kernels on CUDA tensors and their plain versions
on CPU tensors.

Parameters of the matmuls live in `cfg.dtype` (bf16 on the card); norm
weights stay float32 and norms compute in float32, as the JAX module does.
Packed int4/int8 weights are frozen int8 parameters under the JAX names
(`kernel_q4b`, `scale4`, `kernel_q`, `scale`).
"""

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.embedding import apply_rope, rope_frequencies
from cosyvoice_tpu_torch.ops.decode_attention import (
    dequantize_kv_arena,
    gqa_decode_attention,
    gqa_decode_attention_quant,
    decode_kernel_wanted,
    kv_arena_write_kv,
    kv_arena_write_kv_plain,
    quantize_kv_rows,
)
from cosyvoice_tpu_torch.ops.int4_fused import (
    GEMV_IN_ALIGN,
    MAX_ROWS,
    MLP_INTER_ALIGN,
    _pad_to,
    int4_gemv,
    int4_matmul_blocked,
    int4_mlp,
    int4_mlp_reference,
    int4_o_mlp,
)
from cosyvoice_tpu_torch.ops.quant import INT4_BLOCKS, int4_matmul, quant_mode

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
    quant: object = False  # weight-only quantisation: False | True / "int8" | "int4" | "int4p"
    kv_quant: bool = False  # int8 KV arena with per-token f32 scales


def _int4p_kernel(cfg, rows: int, n_in: int, n_out: int = 0) -> bool:
    """Whether an int4p product of `rows` rows takes its kernel (K4, K5): the
    JAX package's `_int4p_use_pallas` without its backend test. At most 16
    rows, input and output widths multiples of 128."""
    return cfg.quant == "int4p" and rows <= MAX_ROWS and n_in % 128 == 0 and n_out % 128 == 0


def _linear(layer: nn.Module, x, dtype=None):
    """`layer(x)`, or with `dtype` an nn.Linear's product in `dtype`: input,
    weight and bias cast to it (the training forward's float32 master
    weights, bf16 products)."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def grow_cache(cache, out):
    """`cache` grown into `out`, buffers of more rows on axis 2 of every leaf
    ([L, B, T, Hkv, d] K/V and [L, B, T] scale planes): its rows copied, the
    rest zero, as the JAX LM's grow_cache pads. Returns `out`."""
    T = cache[0].shape[2]
    for a, g in zip(cache, out):
        g[:, :, :T] = a
        g[:, :, T:] = 0
    return out


class StaticArenas:
    """KV arenas that never move: one set of buffers per (batch, length),
    allocated on first use and kept for the owner's life. A CUDA graph bakes
    in the arena's pointers (and K7 its tensor maps), so the LM decodes over
    these and its graphs stay valid for every later request. `first` zeroes
    a bucket's buffers (a request's first arena); `grow` copies an arena
    into the next bucket's buffers and zeroes the rest (grow_cache)."""

    def __init__(self, model: "Qwen2Model"):
        self.model = model
        self.buffers = {}  # (batch, length) -> cache tuple

    def get(self, batch: int, length: int):
        key = (batch, length)
        if key not in self.buffers:
            with torch.inference_mode(False):
                self.buffers[key] = self.model.init_cache(batch, length)
        return self.buffers[key]

    def first(self, batch: int, length: int):
        cache = self.get(batch, length)
        for a in cache:
            a.zero_()
        return cache

    def grow(self, cache, new_len: int):
        if new_len <= cache[0].shape[2]:
            return cache
        return grow_cache(cache, self.get(cache[0].shape[1], new_len))

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for cache in self.buffers.values() for a in cache)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (x32 * self.weight).to(x.dtype)


def _frozen(shape, dtype, fill=0):
    return nn.Parameter(torch.full(shape, fill, dtype=dtype), requires_grad=False)


class QuantDense(nn.Module):
    """int8 weight-only Dense (the head in int4p mode): kernel_q [out, in]
    int8, per-output-channel scale [out] f32, bias [out] (none with
    bias=False: the v3 head). Computes in `dtype`, as the JAX QuantDense:
    (x @ Wq) * scale + bias."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel_q = _frozen((out_features, in_features), torch.int8)
        self.scale = _frozen((out_features,), torch.float32, 1)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=torch.float32)) if bias else None

    def forward(self, x):
        dt = self.dtype
        y = (x.to(dt) @ self.kernel_q.to(dt).T) * self.scale.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class QuantDense4(nn.Module):
    """int4 weight-only Dense in the JAX layout: kernel_q4 [in/2, out] int8
    (two half-split nibbles a byte, ops/quant.quantize_tensor_int4), scale4
    [8, out] f32, bias [out] (none with bias=False). Computes in `dtype` the
    dot summed per scale block, as the JAX QuantDense4 (ops/quant.int4_matmul)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel_q4 = _frozen((in_features // 2, out_features), torch.int8)
        self.scale4 = _frozen((INT4_BLOCKS, out_features), torch.float32, 1)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=torch.float32)) if bias else None

    def forward(self, x):
        y = int4_matmul(x, self.kernel_q4, self.scale4, self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def dense(cfg: "Qwen2Config", in_features: int, out_features: int, bias: bool) -> nn.Module:
    """A decode-path matmul of the unfused layouts by cfg.quant (the JAX
    dense_cls): nn.Linear in cfg.dtype unquantised, QuantDense for True /
    "int8", QuantDense4 for "int4"."""
    if not cfg.quant:
        return nn.Linear(in_features, out_features, bias=bias, dtype=cfg.dtype)
    if quant_mode(cfg.quant) == "int4":
        return QuantDense4(in_features, out_features, cfg.dtype, bias=bias)
    return QuantDense(in_features, out_features, cfg.dtype, bias=bias)


class Int4PWeights(nn.Module):
    """Holder of one weight in a blocked half-split int4 layout
    (ops/int4_fused.py): kernel_q4b int8 and scale4 f32, handed to the
    kernels and plain functions as they are."""

    def __init__(self, wshape, sshape):
        super().__init__()
        self.kernel_q4b = _frozen(tuple(wshape), torch.int8)
        self.scale4 = _frozen(tuple(sshape), torch.float32, 1)


class QuantDense4P(Int4PWeights):
    """int4p Dense with bias: kernel_q4b [nb, 128, out], scale4 [nb, out],
    bias [out]. `forward` is the plain blocked matmul, `gemv` the call
    through K4 for at most 16 rows."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        nb = _pad_to(in_features, GEMV_IN_ALIGN) // GEMV_IN_ALIGN
        super().__init__((nb, GEMV_IN_ALIGN // 2, out_features), (nb, out_features))
        self.dtype = dtype
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=torch.float32))

    def forward(self, x):
        return int4_matmul_blocked(x, self.kernel_q4b, self.scale4, self.dtype) + self.bias.to(self.dtype)

    def gemv(self, x):
        """x [rows <= 16, in] -> [rows, out] through K4."""
        return int4_gemv(x.to(self.dtype), self.kernel_q4b, self.scale4) + self.bias.to(self.dtype)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        if cfg.quant == "int4p":
            nb_o = _pad_to(nq, GEMV_IN_ALIGN) // GEMV_IN_ALIGN
            self.qkv_proj = QuantDense4P(cfg.hidden_size, nq + 2 * nkv, cfg.dtype)
            self.o_proj = Int4PWeights((nb_o, GEMV_IN_ALIGN // 2, cfg.hidden_size), (nb_o, cfg.hidden_size))
        else:
            self.qkv_proj = dense(cfg, cfg.hidden_size, nq + 2 * nkv, bias=True)
            self.o_proj = dense(cfg, nq, cfg.hidden_size, bias=False)

    def _qkv(self, x, cos, sin):
        """q, k rope'd (float32, as apply_rope returns) and v in cfg.dtype."""
        c = self.cfg
        B, S, _ = x.shape
        nq, nkv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        if _int4p_kernel(c, B * S, c.hidden_size, nq + 2 * nkv):
            qkv = self.qkv_proj.gemv(x.reshape(B * S, -1)).reshape(B, S, -1)
        else:
            qkv = self.qkv_proj(x)
        q = qkv[..., :nq].reshape(B, S, c.num_heads, c.head_dim)
        k = qkv[..., nq : nq + nkv].reshape(B, S, c.num_kv_heads, c.head_dim)
        v = qkv[..., nq + nkv :].reshape(B, S, c.num_kv_heads, c.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def out(self, attn):
        """o_proj of the pre-o attention output [B, S, nq] (prefill, extends,
        and the decode step of the unfused layouts): K4 for at most 16 rows
        of int4p, the plain blocked matmul for more."""
        c = self.cfg
        B, S, nq = attn.shape
        o = self.o_proj
        if _int4p_kernel(c, B * S, nq, c.hidden_size):
            return int4_gemv(attn.reshape(B * S, nq).to(c.dtype), o.kernel_q4b, o.scale4).reshape(B, S, -1)
        if c.quant == "int4p":
            return int4_matmul_blocked(attn, o.kernel_q4b, o.scale4, c.dtype)
        return o(attn.to(c.dtype))

    def extend(self, x, cos, sin, bias, start: int, cache):
        """x [B, S, C] at positions start..start+S-1; bias [B, 1, S, start+S]
        additive. Writes arena rows [start, start+S) of the layer's cache and
        attends over rows [0, start+S) (prefill: start 0). Returns the pre-o
        attention output [B, S, nq]."""
        c = self.cfg
        B, S, _ = x.shape
        end = start + S
        q, k, v = self._qkv(x, cos, sin)
        if c.kv_quant:
            ck, cv, cks, cvs = cache
            (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            ck[:, start:end], cks[:, start:end], cv[:, start:end], cvs[:, start:end] = kq, ks, vq, vs
            # attention reads the dequantised arena rows, as the JAX path does
            k_all = dequantize_kv_arena(ck[:, :end], cks[:, :end], c.dtype)
            v_all = dequantize_kv_arena(cv[:, :end], cvs[:, :end], c.dtype)
        else:
            ck, cv = cache
            ck[:, start:end] = k.to(ck.dtype)
            cv[:, start:end] = v.to(cv.dtype)
            k_all, v_all = ck[:, :end], cv[:, :end]
        return self._attend(q, k_all, v_all, bias)

    def _attend(self, q, k_all, v_all, bias):
        """The grouped einsum over arena rows k_all / v_all [B, T, Hkv, d]:
        float32 scores plus the additive `bias` [B, 1, S, T], the softmax's
        weights in the arena's dtype. Returns [B, S, nq]."""
        c = self.cfg
        B, S = q.shape[:2]
        rep = c.num_heads // c.num_kv_heads
        qg = q.reshape(B, S, c.num_kv_heads, rep, c.head_dim)
        scores = torch.einsum("bsgrd,btgd->bgrst", qg, k_all.float()) / math.sqrt(c.head_dim)
        attn = torch.softmax(scores + bias[:, None], dim=-1).to(v_all.dtype)
        return torch.einsum("bgrst,btgd->bsgrd", attn, v_all).reshape(B, S, -1)

    def forward(self, x, cos, sin, keep, dtype):
        """The teacher-forced attention: x [B, T, C]; cos/sin [T, d/2];
        keep [B, 1, T, T] bool (query, key). Products in `dtype`. Returns
        the attention output after o_proj, [B, T, C] in `dtype`."""
        c = self.cfg
        B, T, _ = x.shape
        nq, nkv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        qkv = _linear(self.qkv_proj, x, dtype)
        q = apply_rope(qkv[..., :nq].reshape(B, T, c.num_heads, c.head_dim), cos, sin)
        k = apply_rope(qkv[..., nq : nq + nkv].reshape(B, T, c.num_kv_heads, c.head_dim), cos, sin)
        v = qkv[..., nq + nkv :].reshape(B, T, c.num_kv_heads, c.head_dim)
        rep = c.num_heads // c.num_kv_heads
        q, k, v = (a.to(dtype).transpose(1, 2) for a in (q, k, v))
        out = F.scaled_dot_product_attention(q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1), keep)
        return _linear(self.o_proj, out.transpose(1, 2).reshape(B, T, nq), dtype)

    def decode(self, x, cos, sin, cur_len, cache):
        """x [B, 1, C]; cur_len [B] int32 write positions. On the kernel route
        (`decode_kernel_wanted`) writes the K and V rows (and their int8
        scales) with one K2 launch and attends with K1 (bf16 or float32
        arena) or K3 (int8 arena); on the plain route writes them by index
        and attends with the masked einsum over the arena (`_attend`).
        Returns the pre-o attention output [B, 1, nq]: float32 from K3 (it
        keeps the float32 rope output's precision), cfg.dtype otherwise."""
        c = self.cfg
        B, T = x.shape[0], cache[0].shape[1]
        q, k, v = self._qkv(x, cos, sin)
        kernel = decode_kernel_wanted(T, c.num_kv_heads * c.head_dim)
        write = kv_arena_write_kv if kernel else kv_arena_write_kv_plain
        if c.kv_quant:
            ck, cv, cks, cvs = cache
            (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            write(ck, cv, kq, vq, cur_len, cks, cvs, ks, vs)
            if kernel:
                return gqa_decode_attention_quant(q[:, 0].contiguous(), ck, cv, cks, cvs, cur_len).reshape(B, 1, -1)
            k_all, v_all = dequantize_kv_arena(ck, cks, c.dtype), dequantize_kv_arena(cv, cvs, c.dtype)
        else:
            ck, cv = cache
            dt = ck.dtype
            write(ck, cv, k.to(dt).contiguous(), v.to(dt).contiguous(), cur_len)
            if kernel:
                return gqa_decode_attention(q[:, 0].to(dt).contiguous(), ck, cv, cur_len).reshape(B, 1, -1)
            k_all, v_all = ck, cv
        live = torch.arange(T, device=x.device)[None, :] <= cur_len.long()[:, None]
        bias = torch.where(live, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
        return self._attend(q, k_all, v_all, bias)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        if cfg.quant == "int4p":
            nb_in = _pad_to(cfg.hidden_size, GEMV_IN_ALIGN) // GEMV_IN_ALIGN
            half_in = GEMV_IN_ALIGN // 2
            inter_p = _pad_to(cfg.intermediate_size, MLP_INTER_ALIGN)
            n_down = inter_p // MLP_INTER_ALIGN
            self.gate_up_proj = Int4PWeights((2, nb_in, half_in, inter_p), (2, nb_in, inter_p))
            self.down_proj = Int4PWeights((n_down, MLP_INTER_ALIGN // 2, cfg.hidden_size), (n_down, cfg.hidden_size))
        else:
            self.gate_up_proj = dense(cfg, cfg.hidden_size, 2 * cfg.intermediate_size, bias=False)
            self.down_proj = dense(cfg, cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x, dtype=None):
        """The MLP of x [..., H]: int4p through K5 for at most 16 rows, the
        plain blocked matmuls for more; unquantised with the products in
        `dtype` where given (the training forward)."""
        c = self.cfg
        if c.quant == "int4p":
            gu, d = self.gate_up_proj, self.down_proj
            w = (gu.kernel_q4b, gu.scale4, d.kernel_q4b, d.scale4)
            rows = x.numel() // c.hidden_size
            if _int4p_kernel(c, rows, c.hidden_size):
                return int4_mlp(x.reshape(rows, -1).to(c.dtype), *w).reshape(x.shape)
            return int4_mlp_reference(x, *w, c.dtype)
        gate, up = _linear(self.gate_up_proj, x, dtype).chunk(2, dim=-1)
        return _linear(self.down_proj, F.silu(gate) * up, dtype)


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = Qwen2MLP(cfg)

    def _tail(self, x, attn_out):
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, cos, sin, keep, dtype):
        """The teacher-forced layer (Qwen2Attention.forward's arguments)."""
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, keep, dtype)
        return x + self.mlp(self.post_attention_layernorm(x), dtype)

    def extend(self, x, cos, sin, bias, start: int, cache):
        attn = self.self_attn.extend(self.input_layernorm(x), cos, sin, bias, start, cache)
        return self._tail(x, self.self_attn.out(attn))

    def decode(self, x, cos, sin, cur_len, cache):
        attn = self.self_attn.decode(self.input_layernorm(x), cos, sin, cur_len, cache)
        if self.cfg.quant != "int4p":
            return self._tail(x, self.self_attn.out(attn))
        # the whole post-attention tail in one kernel (K6)
        o, gu, d = self.self_attn.o_proj, self.mlp.gate_up_proj, self.mlp.down_proj
        y = int4_o_mlp(
            attn[:, 0], x[:, 0], self.post_attention_layernorm.weight, o.kernel_q4b, o.scale4,
            gu.kernel_q4b, gu.scale4, d.kernel_q4b, d.scale4, eps=self.cfg.rms_norm_eps,
        )
        return y[:, None]


class Qwen2Model(nn.Module):
    """Backbone: embeddings in, final hidden out; text embedding table in
    `embed_tokens`."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        if cfg.quant:
            quant_mode(cfg.quant)  # raises on an unknown mode
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype)
        self.layers = nn.ModuleList(Qwen2Layer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_cache_len, cfg.rope_theta, device=self.norm.weight.device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def init_cache(self, batch: int, length: int = None):
        """Zero KV arenas of `length` rows (default max_cache_len): (k, v),
        each [L, B, length, Hkv, d] in cfg.dtype; with kv_quant (k, v) in int8
        plus (k_scale, v_scale), each [L, B, length] float32."""
        c = self.cfg
        shape = (c.num_layers, batch, length or c.max_cache_len, c.num_kv_heads, c.head_dim)
        dev = self.norm.weight.device
        if c.kv_quant:
            sshape = shape[:3]
            return (
                torch.zeros(shape, dtype=torch.int8, device=dev), torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(sshape, dtype=torch.float32, device=dev), torch.zeros(sshape, dtype=torch.float32, device=dev),
            )
        return (torch.zeros(shape, dtype=c.dtype, device=dev), torch.zeros(shape, dtype=c.dtype, device=dev))

    def forward(self, embeds, valid, dtype=None):
        """The teacher-forced forward of training. embeds [B, T, C]; valid
        [B, T] bool, each row's first position valid (no query row is then
        fully masked: scaled_dot_product_attention returns NaN on one).
        Position q attends to the valid keys <= q; rope from position 0.
        The products compute in `dtype` (default cfg.dtype) with each
        weight cast to it; norms and softmax in float32. Returns the final
        hidden [B, T, C] in `dtype`."""
        if self.cfg.quant:
            raise NotImplementedError("the teacher-forced forward trains unquantised weights only")
        dt = dtype or self.cfg.dtype
        T = embeds.shape[1]
        pos = torch.arange(T, device=embeds.device)
        keep = ((pos[None, :] <= pos[:, None])[None] & valid[:, None, :])[:, None]
        cos, sin = self.rope_cos[:T], self.rope_sin[:T]  # made at construction, outside inference mode
        x = embeds.to(dt)
        for layer in self.layers:
            x = layer(x, cos, sin, keep, dt)
        return self.norm(x)

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
            x = layer.extend(x, cos, sin, bias, 0, [part[i] for part in cache])
        x = self.norm(x)
        idx = (true_len.long() - 1).clamp_min(0)
        return x[torch.arange(B, device=x.device), idx], cache

    def extend(self, embeds, start: int, cache):
        """Append an exact-shape segment at arena rows [start, start+S) (the
        bi-streaming feeds). embeds [B, S, C], every row valid; position
        start+s attends to arena rows 0..start+s. One row per batch row takes
        the decode step's route (K4, K2, K1 or K3, K6); more rows run the
        layers' `extend`, whose products route by shape (K4 and K5 for at
        most 16 rows of int4p). Returns (hidden of the last row [B, C], cache)."""
        B, S, _ = embeds.shape
        if S == 1:
            return self.decode_step(embeds, torch.full((B,), start, dtype=torch.int32, device=embeds.device), cache)
        end = start + S
        qpos = torch.arange(start, end, device=embeds.device)
        keep = torch.arange(end, device=embeds.device)[None, :] <= qpos[:, None]
        bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32).expand(B, 1, S, end)
        cos, sin = self.rope_cos[start:end], self.rope_sin[start:end]
        x = embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.extend(x, cos, sin, bias, start, [part[i] for part in cache])
        return self.norm(x[:, -1]), cache

    def decode_step(self, emb, cur_len, cache):
        """One token per row. emb [B, 1, C]; cur_len [B] int32 positions
        (the KV write position; keys 0..cur_len are attended).
        Returns (hidden [B, C], cache)."""
        pos = cur_len.long()
        cos, sin = self.rope_cos[pos][:, None], self.rope_sin[pos][:, None]
        x = emb.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cos, sin, cur_len, [part[i] for part in cache])
        return self.norm(x)[:, 0], cache
