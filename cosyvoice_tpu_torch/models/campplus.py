"""CAM++ (D-TDNN) speaker embedding: CMN'd 80-dim kaldi fbank -> 192-d x-vector.

Counterpart of cosyvoice_tpu/models/campplus.py (which replaces the
reference's campplus.onnx, the 3D-Speaker CAMPPlus graph):

  head (FCM): 2-D convs over (freq, time), conv1 + BN, two stages of two
    residual blocks (the first of each with freq stride 2), conv2 + BN with
    freq stride 2; (C, F') flattened to C * F' channels, index c * F' + f.
  xvector: TDNN (k 5, time stride 2) + BN + ReLU, three CAM dense blocks
    (each layer BN-ReLU-1x1-BN-ReLU then a context-aware masked conv whose
    context is the global mean plus a ceil-mode segment mean over
    `seg_len` frames, re-expanded), each followed by a transit layer
    (BN + ReLU + 1x1 conv halving the channels), BN + ReLU, mean and
    unbiased std over time, a 1x1 linear to 192 and an affine-less BN.

Every BatchNorm is in eval mode with its running statistics as parameters
(`mean`, `var`, `scale`, `bias`, the JAX tree's names). The 1-D parts are
channel-last [B, T, C]; the head runs NCHW over [B, C, F, T].
"""

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.conv import Conv1d


@dataclass(frozen=True)
class CamPPConfig:
    feat_dim: int = 80
    embed_dim: int = 192
    m_channels: int = 32
    init_channels: int = 128
    growth_rate: int = 32
    bn_size: int = 4  # bottleneck = bn_size * growth_rate
    # (num_layers, kernel_size, dilation) per dense block
    blocks: Tuple[Tuple[int, int, int], ...] = ((12, 3, 1), (24, 3, 2), (16, 3, 2))
    seg_len: int = 100  # CAM segment pooling window (frames)


class _BN(nn.Module):
    """Eval-mode BatchNorm over dimension `dim` (torch eps 1e-5)."""

    def __init__(self, channels: int, affine: bool = True, dim: int = -1):
        super().__init__()
        self.dim = dim
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))
        if affine:
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        self.affine = affine

    def forward(self, x):
        shape = [1] * x.ndim
        shape[self.dim] = -1
        y = (x - self.mean.view(shape)) * torch.rsqrt(self.var.view(shape) + 1e-5)
        if self.affine:
            y = y * self.scale.view(shape) + self.bias.view(shape)
        return y


def _conv2d(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=(stride, 1), padding=k // 2, bias=False)


class _FCMResBlock(nn.Module):
    """BasicResBlock: 3x3 convs, the stride on the freq axis only."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv2d(cin, planes, 3, stride)
        self.bn1 = _BN(planes, dim=1)
        self.conv2 = _conv2d(planes, planes, 3)
        self.bn2 = _BN(planes, dim=1)
        self.has_shortcut = stride != 1 or cin != planes
        if self.has_shortcut:
            self.shortcut_conv = _conv2d(cin, planes, 1, stride)
            self.shortcut_bn = _BN(planes, dim=1)

    def forward(self, x):  # [B, C, F, T]
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.has_shortcut:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(h + x)


class _FCM(nn.Module):
    def __init__(self, m: int):
        super().__init__()
        self.conv1 = _conv2d(1, m, 3)
        self.bn1 = _BN(m, dim=1)
        self.layer1_0 = _FCMResBlock(m, m, 2)
        self.layer1_1 = _FCMResBlock(m, m, 1)
        self.layer2_0 = _FCMResBlock(m, m, 2)
        self.layer2_1 = _FCMResBlock(m, m, 1)
        self.conv2 = _conv2d(m, m, 3, 2)
        self.bn2 = _BN(m, dim=1)

    def forward(self, feats):  # [B, T, F] -> [B, T, C * F/8]
        x = F.relu(self.bn1(self.conv1(feats.transpose(1, 2)[:, None])))
        for layer in (self.layer1_0, self.layer1_1, self.layer2_0, self.layer2_1):
            x = layer(x)
        x = F.relu(self.bn2(self.conv2(x)))  # [B, C, F', T]
        B, C, Fq, T = x.shape
        return x.permute(0, 3, 1, 2).reshape(B, T, C * Fq)


def _seg_pooling(x, seg_len: int):
    """torch avg_pool1d(kernel=stride=seg_len, ceil_mode=True) over time,
    re-expanded to T: the last, partial segment averages its own frames."""
    B, T, C = x.shape
    n_seg = -(-T // seg_len)
    sums = F.pad(x, (0, 0, 0, n_seg * seg_len - T)).reshape(B, n_seg, seg_len, C).sum(dim=2)
    counts = (T - torch.arange(n_seg, device=x.device) * seg_len).clamp(max=seg_len).to(x.dtype)
    return torch.repeat_interleave(sums / counts[None, :, None], seg_len, dim=1)[:, :T]


class _CAMLayer(nn.Module):
    """The local conv's output gated by sigmoid(an MLP of the context)."""

    def __init__(self, cin: int, out_ch: int, kernel: int, dilation: int, seg_len: int, reduction: int = 2):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = Conv1d(cin, out_ch, kernel, padding=(kernel - 1) // 2 * dilation, dilation=dilation,
                                   bias=False)
        self.linear1 = Conv1d(cin, cin // reduction, 1)
        self.linear2 = Conv1d(cin // reduction, out_ch, 1)

    def forward(self, x):  # [B, T, Cbn]
        y = self.linear_local(x)
        context = x.mean(dim=1, keepdim=True) + _seg_pooling(x, self.seg_len)
        return y * torch.sigmoid(self.linear2(F.relu(self.linear1(context))))


class _CAMDenseTDNNLayer(nn.Module):
    def __init__(self, cin: int, growth: int, bn_channels: int, kernel: int, dilation: int, seg_len: int):
        super().__init__()
        self.nonlinear1_bn = _BN(cin)
        self.linear1 = Conv1d(cin, bn_channels, 1, bias=False)
        self.nonlinear2_bn = _BN(bn_channels)
        self.cam_layer = _CAMLayer(bn_channels, growth, kernel, dilation, seg_len)

    def forward(self, x):
        h = F.relu(self.nonlinear2_bn(self.linear1(F.relu(self.nonlinear1_bn(x)))))
        return self.cam_layer(h)


class CamPPEmbedding(nn.Module):
    """feats [B, T, 80] (CMN'd kaldi fbank) -> x-vector [B, embed_dim]."""

    def __init__(self, cfg: CamPPConfig = CamPPConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.head = _FCM(c.m_channels)
        channels = c.m_channels * -(-c.feat_dim // 8)  # three freq strides of 2, each rounding up
        self.tdnn_linear = Conv1d(channels, c.init_channels, 5, stride=2, padding=2, bias=False)
        self.tdnn_bn = _BN(c.init_channels)
        channels = c.init_channels
        for i, (num_layers, kernel, dilation) in enumerate(c.blocks):
            block = nn.Module()
            for j in range(num_layers):
                block.add_module(f"tdnnd{j + 1}", _CAMDenseTDNNLayer(
                    channels + j * c.growth_rate, c.growth_rate, c.bn_size * c.growth_rate, kernel, dilation,
                    c.seg_len))
            self.add_module(f"block{i + 1}", block)
            channels += num_layers * c.growth_rate
            self.add_module(f"transit{i + 1}_bn", _BN(channels))
            self.add_module(f"transit{i + 1}_linear", Conv1d(channels, channels // 2, 1, bias=False))
            channels //= 2
        self.out_bn = _BN(channels)
        self.dense_linear = Conv1d(2 * channels, c.embed_dim, 1, bias=False)
        self.dense_bn = _BN(c.embed_dim, affine=False)

    def forward(self, feats):
        x = F.relu(self.tdnn_bn(self.tdnn_linear(self.head(feats))))
        for i in range(len(self.cfg.blocks)):
            for layer in getattr(self, f"block{i + 1}").children():
                x = torch.cat([x, layer(x)], dim=-1)
            x = getattr(self, f"transit{i + 1}_linear")(F.relu(getattr(self, f"transit{i + 1}_bn")(x)))
        x = F.relu(self.out_bn(x))
        # statistics pooling: mean and unbiased std over time (ddof 1)
        mean = x.mean(dim=1)
        var = (x - mean[:, None]).square().sum(dim=1) / max(x.shape[1] - 1, 1)
        stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
        return self.dense_bn(self.dense_linear(stats[:, None]))[:, 0]
