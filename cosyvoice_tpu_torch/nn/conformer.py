"""Conformer encoders: the WeNet encoder of CosyVoice-300M and the
upsample-conformer encoder of the CosyVoice2 flow.

Counterpart of the parts of cosyvoice_tpu/nn/conformer.py that the shipped
configs use: PositionwiseFeedForward, ConformerEncoderLayer (rel-pos
attention, no macaron, no conv module), LinearInputLayer, ConformerEncoder
(the v1 LM's text encoder and the v1 flow's encoder: linear input layer,
espnet rel-pos encoding, full or static-chunk masks), PreLookaheadLayer,
Upsample1DConv and UpsampleConformerEncoder. Channel-last [B, T, C]. The
upsample encoder has three
modes: offline (full attention); streaming recompute (the lookahead tokens
scattered at the body's end, static chunk masks at `static_chunk_size`
tokens and `static_chunk_size * up_stride` mel frames); and the incremental
chunk (`forward_chunk` over the KV arenas and conv caches of
`upsample_encoder_stream_state`).
"""

import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.attention import RelPositionMultiHeadAttention
from cosyvoice_tpu_torch.nn.conv import Conv1d, roll_cache
from cosyvoice_tpu_torch.nn.embedding import EspnetRelPositionalEncoding
from cosyvoice_tpu_torch.ops.masks import add_optional_chunk_mask, chunk_arena_mask, make_non_pad_mask


class PositionwiseFeedForward(nn.Module):
    """Linear, swish, linear."""

    def __init__(self, dim: int, hidden_units: int):
        super().__init__()
        self.w_1 = nn.Linear(dim, hidden_units)
        self.w_2 = nn.Linear(hidden_units, dim)

    def forward(self, x):
        return self.w_2(F.silu(self.w_1(x)))


class ConformerEncoderLayer(nn.Module):
    """Pre-norm block: rel-pos self-attention then FFN, each residual."""

    def __init__(self, size: int, attention_heads: int, linear_units: int):
        super().__init__()
        self.norm_mha = nn.LayerNorm(size, eps=1e-12)
        self.self_attn = RelPositionMultiHeadAttention(attention_heads, size)
        self.norm_ff = nn.LayerNorm(size, eps=1e-12)
        self.feed_forward = PositionwiseFeedForward(size, linear_units)

    def forward(self, x, att_mask, pos_emb, arena=None, pos=None):
        """arena=(k_arena, v_arena), pos: incremental-chunk mode, x the new
        chunk and att_mask a bool [B, n, A] arena mask; the arenas are
        written in place."""
        xn = self.norm_mha(x)
        if arena is None:
            x = x + self.self_attn(xn, xn, xn, mask=att_mask, pos_emb=pos_emb)
        else:
            x = x + self.self_attn.attend_chunk(xn, xn, xn, arena[0], arena[1], pos, att_mask, pos_emb)
        return x + self.feed_forward(self.norm_ff(x))


class LinearInputLayer(nn.Module):
    """'linear' input layer: Linear + LayerNorm (dropout is inference-off)."""

    def __init__(self, in_dim: int, output_size: int):
        super().__init__()
        self.out_dense = nn.Linear(in_dim, output_size)
        self.out_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, x):
        return self.out_norm(self.out_dense(x))


class ConformerEncoder(nn.Module):
    """WeNet encoder over full sequences: LinearInputLayer, the espnet
    rel-pos encoding (x * sqrt(d)), `num_blocks` rel-pos layers, LayerNorm.
    With `streaming` the attention mask is the static chunk mask of
    `static_chunk_size` frames (1: causal, the v1 LM's text encoder)."""

    def __init__(self, input_size: int, output_size: int = 512, attention_heads: int = 8, linear_units: int = 2048,
                 num_blocks: int = 6, static_chunk_size: int = 0):
        super().__init__()
        self.static_chunk_size = static_chunk_size
        self.embed = LinearInputLayer(input_size, output_size)
        self.pos_enc = EspnetRelPositionalEncoding(output_size)
        self.encoders = nn.ModuleList(
            ConformerEncoderLayer(output_size, attention_heads, linear_units) for _ in range(num_blocks)
        )
        self.after_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, xs, xs_lens, streaming: bool = False):
        """xs [B, T, input_size], xs_lens [B] -> ([B, T, output_size], non-pad mask [B, T])."""
        pad_mask = make_non_pad_mask(xs_lens, xs.shape[1])
        xs, pos_emb = self.pos_enc(self.embed(xs))
        att_mask = add_optional_chunk_mask(pad_mask[:, None, :], self.static_chunk_size if streaming else 0)
        for layer in self.encoders:
            xs = layer(xs, att_mask, pos_emb)
        return self.after_norm(xs), pad_mask


class PreLookaheadLayer(nn.Module):
    """Lookahead conv (k = la+1 over the next la frames) + leaky ReLU + causal
    conv k=3 + residual. x [B, T, C]; context [B, la, C], the lookahead
    tokens' frames, or None (zeros past the end).

    cache/real_n: incremental-chunk mode. x is the new chunk (embedded and
    scaled, zero beyond real_n), context goes at row real_n, and `cache`
    [B, 2, C_mid] holds the last two conv1 outputs left of the chunk (conv2's
    left context). Returns (y, new_cache). The lookahead tokens are the next
    chunk's first tokens, so the chunks equal the full recompute."""

    def __init__(self, in_channels: int, channels: int, pre_lookahead_len: int = 3):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = Conv1d(in_channels, channels, pre_lookahead_len + 1)
        self.conv2 = Conv1d(channels, in_channels, 3)

    def forward(self, x, context=None, cache=None, real_n=None):
        la = self.pre_lookahead_len
        if cache is not None:
            buf = F.pad(x, (0, 0, 0, la))
            if context is not None:
                buf[:, real_n : real_n + la] = context.to(buf.dtype)
            h = F.leaky_relu(self.conv1(buf), negative_slope=0.01)
            y = self.conv2(torch.cat([cache, h], dim=1))
            return y + x, roll_cache(cache, h, real_n)
        h = F.pad(x, (0, 0, 0, la)) if context is None else torch.cat([x, context], dim=1)
        h = F.leaky_relu(self.conv1(h), negative_slope=0.01)
        h = self.conv2(F.pad(h, (0, 0, 2, 0)))
        return h + x


class Upsample1DConv(nn.Module):
    """x stride nearest upsample + left-padded conv (k = 2*stride+1)."""

    def __init__(self, channels: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(channels, channels, stride * 2 + 1)

    def forward(self, x, cache=None, real_n=None):
        """cache/real_n: incremental-chunk mode, `cache` [B, 2*stride, C] the
        last repeated frames left of the chunk, real_n the chunk's real
        (pre-upsample) frames. Returns (y, new_cache)."""
        x = torch.repeat_interleave(x, self.stride, dim=1)
        if cache is not None:
            return self.conv(torch.cat([cache, x], dim=1)), roll_cache(cache, x, real_n * self.stride)
        return self.conv(F.pad(x, (0, 0, self.stride * 2, 0)))


def upsample_encoder_stream_state(enc: "UpsampleConformerEncoder", B: int, arena_tok: int, arena_mel: int,
                                  device=None) -> dict:
    """Zero incremental-chunk state of an UpsampleConformerEncoder: float32 KV
    arenas of the token-rate and mel-rate conformer layers, and the lookahead
    conv2 and upsample conv caches."""
    C = enc.output_size

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    st = {"pre_conv2": zeros(B, 2, C), "up_conv": zeros(B, enc.up_stride * 2, C)}
    for i in range(len(enc.encoders)):
        st[f"enc_{i}"] = (zeros(B, arena_tok, C), zeros(B, arena_tok, C))
    for i in range(len(enc.up_encoders)):
        st[f"up_enc_{i}"] = (zeros(B, arena_mel, C), zeros(B, arena_mel, C))
    return st


class UpsampleConformerEncoder(nn.Module):
    """Flow-v2 encoder: lookahead + 6 conformer blocks + 2x upsample + 4 blocks."""

    def __init__(
        self,
        input_size: int = 512,
        output_size: int = 512,
        attention_heads: int = 8,
        linear_units: int = 2048,
        num_blocks: int = 6,
        num_up_blocks: int = 4,
        pre_lookahead_len: int = 3,
        up_stride: int = 2,
        static_chunk_size: int = 25,
    ):
        super().__init__()
        self.output_size, self.up_stride, self.static_chunk_size = output_size, up_stride, static_chunk_size
        self.embed = LinearInputLayer(input_size, output_size)
        self.pos_enc = EspnetRelPositionalEncoding(output_size)
        self.pre_lookahead_layer = PreLookaheadLayer(output_size, output_size, pre_lookahead_len)
        self.encoders = nn.ModuleList(
            ConformerEncoderLayer(output_size, attention_heads, linear_units) for _ in range(num_blocks)
        )
        self.up_layer = Upsample1DConv(output_size, up_stride)
        self.up_embed = LinearInputLayer(output_size, output_size)
        self.up_pos_enc = EspnetRelPositionalEncoding(output_size)
        self.up_encoders = nn.ModuleList(
            ConformerEncoderLayer(output_size, attention_heads, linear_units) for _ in range(num_up_blocks)
        )
        self.after_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, xs, xs_lens, context=None, streaming=False):
        """xs [B, T, C] raw token embeddings, zero beyond xs_lens; context
        [B, la, C] the lookahead tokens' raw embeddings or None (finalize),
        scattered at row xs_lens (T >= xs_lens + la; one length for the
        batch); streaming: chunk masks. Returns ([B, 2T, C], up-sampled
        non-pad mask [B, 2T])."""
        T = xs.shape[1]
        pad_mask = make_non_pad_mask(xs_lens, T)
        valid_len = xs_lens
        if context is not None:
            # rows xs_lens[0] .. + la, indexed on the device (no host read:
            # the engine's first-chunk CUDA graph runs this)
            at = xs_lens[:1].long() + torch.arange(context.shape[1], device=xs.device)
            xs = xs.index_copy(1, at, context.to(xs.dtype))
            valid_len = xs_lens + context.shape[1]
        xs, pos_emb = self.pos_enc(self.embed(xs))
        # zero beyond the valid (+ context) region: the lookahead conv sees zeros at the boundary
        xs = xs * make_non_pad_mask(valid_len, T)[..., None]
        att_mask = add_optional_chunk_mask(pad_mask[:, None, :], self.static_chunk_size if streaming else 0)
        xs = self.pre_lookahead_layer(xs)
        for layer in self.encoders:
            xs = layer(xs, att_mask, pos_emb)

        xs = self.up_layer(xs)
        T2 = xs.shape[1]
        pad_mask2 = make_non_pad_mask(xs_lens * self.up_stride, T2)
        xs, pos_emb2 = self.up_pos_enc(self.up_embed(xs))
        att_mask2 = add_optional_chunk_mask(pad_mask2[:, None, :],
                                            self.static_chunk_size * self.up_stride if streaming else 0)
        for layer in self.up_encoders:
            xs = layer(xs, att_mask2, pos_emb2)
        return self.after_norm(xs), pad_mask2

    def forward_chunk(self, xs, context, st: dict, pos: int, real_n: int):
        """Incremental streaming chunk over carried KV arenas instead of the
        full-prefix recompute. xs [B, n, C] raw token embeddings of the new
        chunk (zero beyond real_n); context [B, la, C] the lookahead tokens'
        raw embeddings or None (finalize); st from
        upsample_encoder_stream_state, updated in place (arenas) and by
        entry (conv caches); pos the tokens already consumed. Chunk
        boundaries must be multiples of static_chunk_size (the engine's hops
        are). Attention reads the arena rows up to pos + n. Returns
        (h [B, n*up_stride, C], st), equal to forward's rows [pos, pos+real_n)
        in streaming mode."""
        B, n, _ = xs.shape
        dev = xs.device
        xs = self.embed(xs) * self.pos_enc.xscale
        xs = xs * (torch.arange(n, device=dev) < real_n)[None, :, None]
        ctx = None if context is None else self.embed(context) * self.pos_enc.xscale
        xs, st["pre_conv2"] = self.pre_lookahead_layer(xs, ctx, st["pre_conv2"], real_n)
        A = pos + n
        pe = self.pos_enc.position_encoding(A, dev)
        mask = chunk_arena_mask(B, n, A, pos, real_n, self.static_chunk_size, dev)
        for i, layer in enumerate(self.encoders):
            xs = layer(xs, mask, pe, arena=st[f"enc_{i}"], pos=pos)
        xs, st["up_conv"] = self.up_layer(xs, st["up_conv"], real_n)
        xs = self.up_embed(xs) * self.up_pos_enc.xscale
        r = self.up_stride
        A2 = (pos + n) * r
        pe2 = self.up_pos_enc.position_encoding(A2, dev)
        mask2 = chunk_arena_mask(B, n * r, A2, pos * r, real_n * r, self.static_chunk_size * r, dev)
        for i, layer in enumerate(self.up_encoders):
            xs = layer(xs, mask2, pe2, arena=st[f"up_enc_{i}"], pos=pos * r)
        return self.after_norm(xs), st
