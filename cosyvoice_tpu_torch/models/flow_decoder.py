"""Flow-matching estimator: the causal Matcha-style 1D U-Net of CosyVoice2.

Counterpart of cosyvoice_tpu/models/flow_decoder.py:ConditionalDecoder for
the shipped causal single-level config (channels=(256,)), full-sequence mode
with the offline attention masks. Maps (x_t, mu, spks, cond, t) to the
vector field. The streaming chunk masks, the incremental chunk-arena mode
and non-causal multi-level configs are not ported yet.
"""

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from cosyvoice_tpu_torch.nn.conv import CausalConv1d, Conv1d
from cosyvoice_tpu_torch.nn.embedding import SinusoidalPosEmb
from cosyvoice_tpu_torch.nn.unet import BasicTransformerBlock, CausalBlock1D, ResnetBlock1D, TimestepEmbedding
from cosyvoice_tpu_torch.ops.masks import add_optional_chunk_mask, mask_to_bias


@dataclass(frozen=True)
class EstimatorConfig:
    in_channels: int = 320  # pack(x, mu, spks, cond) = 80*3 + 80
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8


def _attn_bias(mask: torch.Tensor) -> torch.Tensor:
    """mask [B, T] float -> additive offline attention bias [B, T, T]."""
    return mask_to_bias(add_optional_chunk_mask((mask > 0.5)[:, None, :], 0))


class ConditionalDecoder(nn.Module):
    def __init__(self, cfg: EstimatorConfig = EstimatorConfig()):
        super().__init__()
        if len(cfg.channels) != 1:
            raise NotImplementedError("only the causal single-level estimator (CosyVoice2) is ported")
        self.cfg = cfg
        ch = cfg.channels[0]
        t_dim = ch * 4

        def tblocks():
            return nn.ModuleList(
                BasicTransformerBlock(ch, cfg.num_heads, cfg.attention_head_dim) for _ in range(cfg.n_blocks)
            )

        self.time_emb = SinusoidalPosEmb(cfg.in_channels)
        self.time_mlp = TimestepEmbedding(cfg.in_channels, t_dim)
        self.down_resnet = nn.ModuleList([ResnetBlock1D(cfg.in_channels, ch, t_dim)])
        self.down_tf = nn.ModuleList([tblocks()])
        self.down_post = nn.ModuleList([CausalConv1d(ch, ch, 3)])
        self.mid_resnet = nn.ModuleList(ResnetBlock1D(ch, ch, t_dim) for _ in range(cfg.num_mid_blocks))
        self.mid_tf = nn.ModuleList(tblocks() for _ in range(cfg.num_mid_blocks))
        self.up_resnet = nn.ModuleList([ResnetBlock1D(2 * ch, ch, t_dim)])
        self.up_tf = nn.ModuleList([tblocks()])
        self.up_post = nn.ModuleList([CausalConv1d(ch, ch, 3)])
        self.final_block = CausalBlock1D(ch, ch)
        self.final_proj = Conv1d(ch, cfg.out_channels, 1)

    def forward(self, x, mask, mu, t, spks, cond):
        """x/mu/cond [B, T, 80]; mask [B, T] float; t [B]; spks [B, 80].
        Returns the vector field [B, T, 80]."""
        t_emb = self.time_mlp(self.time_emb(t))
        h = torch.cat([x, mu, spks[:, None, :].expand(-1, x.shape[1], -1), cond], dim=-1)
        m = mask
        mm = m[..., None]
        bias = _attn_bias(m)

        h = self.down_resnet[0](h, m, t_emb)
        for blk in self.down_tf[0]:
            h = blk(h, bias)
        skip = h
        h = self.down_post[0](h * mm)
        for resnet, tblk in zip(self.mid_resnet, self.mid_tf):
            h = resnet(h, m, t_emb)
            for blk in tblk:
                h = blk(h, bias)
        h = torch.cat([h[:, : skip.shape[1]], skip], dim=-1)
        h = self.up_resnet[0](h, m, t_emb)
        for blk in self.up_tf[0]:
            h = blk(h, bias)
        h = self.up_post[0](h * mm)
        h = self.final_block(h, m)
        return self.final_proj(h * mm) * mm
