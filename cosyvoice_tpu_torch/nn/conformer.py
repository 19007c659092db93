"""Upsample-conformer encoder of the CosyVoice2 flow (offline mode).

Counterpart of the parts of cosyvoice_tpu/nn/conformer.py that the flow-v2
encoder uses: PositionwiseFeedForward, ConformerEncoderLayer (rel-pos
attention, no macaron, no conv module), LinearInputLayer, PreLookaheadLayer,
Upsample1DConv and UpsampleConformerEncoder. Channel-last [B, T, C],
offline (full attention); the streaming chunk masks, lookahead context and
chunk arenas are not ported yet.
"""

import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.attention import RelPositionMultiHeadAttention
from cosyvoice_tpu_torch.nn.conv import Conv1d
from cosyvoice_tpu_torch.nn.embedding import EspnetRelPositionalEncoding
from cosyvoice_tpu_torch.ops.masks import add_optional_chunk_mask, make_non_pad_mask


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

    def forward(self, x, att_mask, pos_emb):
        xn = self.norm_mha(x)
        x = x + self.self_attn(xn, xn, xn, mask=att_mask, pos_emb=pos_emb)
        return x + self.feed_forward(self.norm_ff(x))


class LinearInputLayer(nn.Module):
    """'linear' input layer: Linear + LayerNorm (dropout is inference-off)."""

    def __init__(self, in_dim: int, output_size: int):
        super().__init__()
        self.out_dense = nn.Linear(in_dim, output_size)
        self.out_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, x):
        return self.out_norm(self.out_dense(x))


class PreLookaheadLayer(nn.Module):
    """Lookahead conv (k = la+1 over the next la frames) + leaky ReLU + causal
    conv k=3 + residual. x [B, T, C]; the lookahead past the end is zeros."""

    def __init__(self, in_channels: int, channels: int, pre_lookahead_len: int = 3):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = Conv1d(in_channels, channels, pre_lookahead_len + 1)
        self.conv2 = Conv1d(channels, in_channels, 3)

    def forward(self, x):
        h = F.leaky_relu(self.conv1(F.pad(x, (0, 0, 0, self.pre_lookahead_len))), negative_slope=0.01)
        h = self.conv2(F.pad(h, (0, 0, 2, 0)))
        return h + x


class Upsample1DConv(nn.Module):
    """x stride nearest upsample + left-padded conv (k = 2*stride+1)."""

    def __init__(self, channels: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(channels, channels, stride * 2 + 1)

    def forward(self, x):
        x = torch.repeat_interleave(x, self.stride, dim=1)
        return self.conv(F.pad(x, (0, 0, self.stride * 2, 0)))


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
    ):
        super().__init__()
        self.up_stride = up_stride
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

    def forward(self, xs, xs_lens):
        """xs [B, T, C] raw token embeddings, zero beyond xs_lens. Returns
        ([B, 2T, C], up-sampled non-pad mask [B, 2T])."""
        pad_mask = make_non_pad_mask(xs_lens, xs.shape[1])
        xs, pos_emb = self.pos_enc(self.embed(xs))
        xs = xs * pad_mask[..., None]
        att_mask = add_optional_chunk_mask(pad_mask[:, None, :], 0)
        xs = self.pre_lookahead_layer(xs)
        for layer in self.encoders:
            xs = layer(xs, att_mask, pos_emb)

        xs = self.up_layer(xs)
        T2 = xs.shape[1]
        pad_mask2 = make_non_pad_mask(xs_lens * self.up_stride, T2)
        xs, pos_emb2 = self.up_pos_enc(self.up_embed(xs))
        att_mask2 = add_optional_chunk_mask(pad_mask2[:, None, :], 0)
        for layer in self.up_encoders:
            xs = layer(xs, att_mask2, pos_emb2)
        return self.after_norm(xs), pad_mask2
