"""Flow-matching estimator: the Matcha-style 1D U-Net, causal and not.

Counterpart of cosyvoice_tpu/models/flow_decoder.py:ConditionalDecoder. Maps
(x_t, mu, spks, cond, t) to the vector field over a full sequence (offline
masks, or with `streaming` the chunk masks of `static_chunk_size` mel
frames). The CosyVoice2 config is causal and single-level (channels (256,));
with `stream=(state, pos, real_n)` it also runs one incremental chunk over
the per-step KV arenas and conv caches of `estimator_stream_state`. The
CosyVoice-300M config is non-causal and multi-level (channels (256, 256)):
Block1D / GroupNorm resnets, a strided-conv Downsample1D after every level
but the last, an Upsample1DTranspose on the way up, the skip of each level
concatenated (cut to its length), the mask halved per level; it has no
incremental-chunk form (v1 streams token windows).
"""

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from cosyvoice_tpu_torch.nn.conv import CausalConv1d, Conv1d
from cosyvoice_tpu_torch.nn.embedding import SinusoidalPosEmb
from cosyvoice_tpu_torch.nn.unet import (
    BasicTransformerBlock,
    Block1D,
    CausalBlock1D,
    Downsample1D,
    ResnetBlock1D,
    TimestepEmbedding,
    Upsample1DTranspose,
)
from cosyvoice_tpu_torch.nn.conv import roll_cache
from cosyvoice_tpu_torch.ops.masks import add_optional_chunk_mask, chunk_attn_bias, mask_to_bias


@dataclass(frozen=True)
class EstimatorConfig:
    in_channels: int = 320  # pack(x, mu, spks, cond) = 80*3 + 80
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    static_chunk_size: int = 50  # mel frames (= chunk_size * token_mel_ratio)
    causal: bool = True


def _attn_bias(mask: torch.Tensor, streaming: bool = False, chunk: int = 0) -> torch.Tensor:
    """mask [B, T] float -> additive attention bias [B, T, T]: the pad mask,
    and with `streaming` the static chunk mask of `chunk` frames."""
    return mask_to_bias(add_optional_chunk_mask((mask > 0.5)[:, None, :], chunk if streaming else 0))


def estimator_stream_state(cfg: EstimatorConfig, B2: int, arena: int, device=None) -> dict:
    """Zero incremental-chunk state for ONE Euler step of ConditionalDecoder:
    float32 KV arenas [B2, arena, inner] per transformer block and 2-frame
    causal-conv caches. B2 = 2*B (the CFG cond/uncond pair); the solver keeps
    one such state per Euler step."""
    if not cfg.causal or len(cfg.channels) != 1:
        raise NotImplementedError("the chunked estimator is the shipped causal single-level config only")
    inner = cfg.num_heads * cfg.attention_head_dim
    ch = cfg.channels[0]

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    st = {"down_resnet_0": (zeros(B2, 2, cfg.in_channels), zeros(B2, 2, ch)), "down_post_0": zeros(B2, 2, ch)}
    names = ["down_tf_0"]
    for i in range(cfg.num_mid_blocks):
        st[f"mid_resnet_{i}"] = (zeros(B2, 2, ch), zeros(B2, 2, ch))
        names.append(f"mid_tf_{i}")
    st["up_resnet_0"] = (zeros(B2, 2, 2 * ch), zeros(B2, 2, ch))
    st["up_post_0"] = zeros(B2, 2, ch)
    st["final_block"] = zeros(B2, 2, ch)
    for name in names + ["up_tf_0"]:
        for j in range(cfg.n_blocks):
            st[f"{name}_{j}"] = (zeros(B2, arena, inner), zeros(B2, arena, inner))
    return st


class ConditionalDecoder(nn.Module):
    def __init__(self, cfg: EstimatorConfig = EstimatorConfig()):
        super().__init__()
        self.cfg = cfg
        chans, causal = cfg.channels, cfg.causal
        t_dim = chans[0] * 4
        last = len(chans) - 1

        def tblocks(ch):
            return nn.ModuleList(
                BasicTransformerBlock(ch, cfg.num_heads, cfg.attention_head_dim) for _ in range(cfg.n_blocks)
            )

        def post(ch):
            return CausalConv1d(ch, ch, 3) if causal else Conv1d(ch, ch, 3, padding=1)

        self.time_emb = SinusoidalPosEmb(cfg.in_channels)
        self.time_mlp = TimestepEmbedding(cfg.in_channels, t_dim)
        ins = (cfg.in_channels,) + tuple(chans[:-1])
        self.down_resnet = nn.ModuleList(ResnetBlock1D(i, o, t_dim, causal) for i, o in zip(ins, chans))
        self.down_tf = nn.ModuleList(tblocks(ch) for ch in chans)
        for i, ch in enumerate(chans[:-1]):
            self.add_module(f"downsample_{i}", Downsample1D(ch))
        self.down_post = nn.ModuleDict({str(last): post(chans[-1])})  # JAX down_post_<last level>
        ch = chans[-1]
        self.mid_resnet = nn.ModuleList(ResnetBlock1D(ch, ch, t_dim, causal) for _ in range(cfg.num_mid_blocks))
        self.mid_tf = nn.ModuleList(tblocks(ch) for _ in range(cfg.num_mid_blocks))
        up = tuple(chans[::-1]) + (chans[0],)
        self.up_resnet = nn.ModuleList(ResnetBlock1D(2 * up[i], up[i + 1], t_dim, causal) for i in range(len(chans)))
        self.up_tf = nn.ModuleList(tblocks(up[i + 1]) for i in range(len(chans)))
        for i in range(last):
            self.add_module(f"upsample_{i}", Upsample1DTranspose(up[i + 1]))
        self.up_post = nn.ModuleDict({str(last): post(up[-1])})
        self.final_block = CausalBlock1D(up[-1], up[-1]) if causal else Block1D(up[-1], up[-1])
        self.final_proj = Conv1d(up[-1], cfg.out_channels, 1)

    def forward(self, x, mask, mu, t, spks, cond, streaming: bool = False, stream=None):
        """x/mu/cond [B, T, 80]; mask [B, T] float; t [B]; spks [B, 80].
        Returns the vector field [B, T, 80].

        stream=(state, pos, real_n): incremental-chunk mode (the causal
        single-level config). x/mu/cond are the new chunk only (T its padded
        length, real_n true frames; `mask` is not read), `state` one Euler
        step's estimator_stream_state (arenas written in place, caches
        replaced by entry) and `pos` the mel frames already in the arenas.
        Returns (field, state), equal to the streaming recompute's rows
        under chunk-causal masks."""
        t_emb = self.time_mlp(self.time_emb(t))
        h = torch.cat([x, mu, spks[:, None, :].expand(-1, x.shape[1], -1), cond], dim=-1)
        if stream is not None:
            if not self.cfg.causal or len(self.cfg.channels) != 1:
                raise NotImplementedError("the chunked estimator is the causal single-level config only")
            return self._forward_chunk(h, t_emb, *stream)
        chunk = self.cfg.static_chunk_size
        last = len(self.cfg.channels) - 1
        skips, masks = [], [mask]
        for i, (resnet, tblk) in enumerate(zip(self.down_resnet, self.down_tf)):
            m = masks[-1]
            bias = _attn_bias(m, streaming, chunk)
            h = resnet(h, m, t_emb)
            for blk in tblk:
                h = blk(h, bias)
            skips.append(h)
            hm = h * m[..., None]
            h = self.down_post[str(last)](hm) if i == last else getattr(self, f"downsample_{i}")(hm)
            masks.append(m if i == last else m[:, ::2])
        m = masks[-2]
        bias = _attn_bias(m, streaming, chunk)
        for resnet, tblk in zip(self.mid_resnet, self.mid_tf):
            h = resnet(h, m, t_emb)
            for blk in tblk:
                h = blk(h, bias)
        for i, (resnet, tblk) in enumerate(zip(self.up_resnet, self.up_tf)):
            m = masks[last - i]
            bias = _attn_bias(m, streaming, chunk)
            skip = skips[last - i]
            h = resnet(torch.cat([h[:, : skip.shape[1]], skip], dim=-1), m, t_emb)
            for blk in tblk:
                h = blk(h, bias)
            hm = h * m[..., None]
            h = self.up_post[str(last)](hm) if i == last else getattr(self, f"upsample_{i}")(hm)
        h = self.final_block(h, m)
        mm = m[..., None]
        return self.final_proj(h * mm) * mask[..., None]

    def _forward_chunk(self, h, t_emb, st: dict, pos: int, real_n: int):
        B, n, _ = h.shape
        dev = h.device
        m = (torch.arange(n, device=dev) < real_n).to(h.dtype)[None].expand(B, n)
        mm = m[..., None]
        bias = chunk_attn_bias(B, n, pos + n, pos, real_n, self.cfg.static_chunk_size, dev)

        def tblocks(blocks, name):
            nonlocal h
            for j, blk in enumerate(blocks):
                h = blk(h, bias, st[f"{name}_{j}"], pos)

        def causal3(conv, name):
            hm = h * mm
            y = conv(hm, st[name])
            st[name] = roll_cache(st[name], hm, real_n)
            return y

        h, st["down_resnet_0"] = self.down_resnet[0](h, m, t_emb, st["down_resnet_0"], real_n)
        tblocks(self.down_tf[0], "down_tf_0")
        skip = h
        h = causal3(self.down_post["0"], "down_post_0")
        for i, (resnet, tblk) in enumerate(zip(self.mid_resnet, self.mid_tf)):
            h, st[f"mid_resnet_{i}"] = resnet(h, m, t_emb, st[f"mid_resnet_{i}"], real_n)
            tblocks(tblk, f"mid_tf_{i}")
        h = torch.cat([h, skip], dim=-1)
        h, st["up_resnet_0"] = self.up_resnet[0](h, m, t_emb, st["up_resnet_0"], real_n)
        tblocks(self.up_tf[0], "up_tf_0")
        h = causal3(self.up_post["0"], "up_post_0")
        h, st["final_block"] = self.final_block(h, m, st["final_block"], real_n)
        return self.final_proj(h * mm) * mm, st
