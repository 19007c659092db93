"""1D convolutions with the JAX package's channel-last layout [B, T, C].

Counterpart of cosyvoice_tpu/nn/conv.py. Weights use PyTorch's layout
([out, in/groups, k]; ConvTranspose [in, out, k]); each call transposes to
[B, C, T] for torch's conv and back. Weight-normalized convs keep v and g and
fold them on every call, as the JAX modules do. The causal family (left- or
right-causal, strided down, nearest-upsampled) is causal HiFT's and the
flow's.
"""

import torch
from torch import nn
from torch.nn import functional as F


def _cl(fn, x):
    """Run a [B, C, T] op on channel-last x [B, T, C]."""
    return fn(x.transpose(1, 2)).transpose(1, 2)


class Conv1d(nn.Module):
    """torch-Conv1d semantics with symmetric zero pad `padding`."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, groups=1, dilation=1, bias=True):
        super().__init__()
        self.stride, self.padding, self.groups, self.dilation = stride, padding, groups, dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5**0.5)

    def forward(self, x):
        return _cl(lambda t: F.conv1d(t, self.weight, self.bias, self.stride, self.padding, self.dilation,
                                      self.groups), x)


class WNConv1d(nn.Module):
    """Weight-normalized conv (torch weight_norm dim=0): w = g * v / ||v||_(in,k)."""

    def __init__(self, in_channels, out_channels, kernel_size, padding=0, dilation=1, stride=1):
        super().__init__()
        self.padding, self.dilation, self.stride = padding, dilation, stride
        self.v = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size) * 0.01)
        self.g = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def folded_weight(self):
        norm = torch.sqrt(self.v.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
        return self.v * (self.g[:, None, None] / norm)

    def forward(self, x):
        w = self.folded_weight()
        return _cl(lambda t: F.conv1d(t, w, self.bias, self.stride, self.padding, self.dilation), x)


class WNConvTranspose1d(nn.Module):
    """Weight-normalized ConvTranspose1d: weight [in, out, k], one g per
    input channel, norm over (out, k). out_len = (T-1)*stride - 2*padding + k."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.v = nn.Parameter(torch.randn(in_channels, out_channels, kernel_size) * 0.01)
        self.g = nn.Parameter(torch.ones(in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        norm = torch.sqrt(self.v.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
        w = self.v * (self.g[:, None, None] / norm)
        return _cl(lambda t: F.conv_transpose1d(t, w, self.bias, self.stride, self.padding), x)


def roll_cache(cache: torch.Tensor, x: torch.Tensor, real_n: int) -> torch.Tensor:
    """Advance a causal conv's left-context cache past a chunk: cache
    [B, P, C] frames left of the chunk, x [B, n, C] the chunk's input (the
    tail beyond real_n may be padding). Returns the P frames that end at the
    real boundary, concat(cache, x)[:, real_n : real_n + P]."""
    P = cache.shape[1]
    return torch.cat([cache, x.to(cache.dtype)], dim=1)[:, real_n : real_n + P]


class CausalConv1d(nn.Module):
    """One-sided conv: (k-1)*d frames of zeros on the left (causal_type
    "left") or on the right ("right"), or, in a streaming chunk or at the
    right-causal lookahead, `cache` [B, (k-1)*d, C], the frames on that side.
    weight_norm: the inner conv is a WNConv1d (causal HiFT). The inner conv
    is `conv`, as the JAX module's."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1, causal_type="left", weight_norm=False):
        super().__init__()
        if causal_type not in ("left", "right"):
            raise ValueError(f"causal_type {causal_type!r}: left or right")
        cls = WNConv1d if weight_norm else Conv1d
        self.conv = cls(in_channels, out_channels, kernel_size, dilation=dilation)
        self.causal_padding = (kernel_size - 1) * dilation
        self.causal_type = causal_type

    def forward(self, x, cache=None):
        pad = self.causal_padding
        if cache is None:
            return self.conv(F.pad(x, (0, 0, pad, 0) if self.causal_type == "left" else (0, 0, 0, pad)))
        if cache.shape[1] != pad:
            raise ValueError(f"cache must hold {pad} frames, not {cache.shape[1]}")
        return self.conv(torch.cat([cache, x] if self.causal_type == "left" else [x, cache], dim=1))


class CausalConv1dDownSample(nn.Module):
    """Strided causal conv: stride-1 frames of zeros on the left;
    kernel_size % stride == 0, so out_len = in_len // stride."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, weight_norm=True):
        super().__init__()
        if kernel_size % stride:
            raise ValueError(f"kernel_size {kernel_size} is not a multiple of stride {stride}")
        cls = WNConv1d if weight_norm else Conv1d
        self.conv = cls(in_channels, out_channels, kernel_size, stride=stride)
        self.causal_padding = stride - 1

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, self.causal_padding, 0)))


class CausalConv1dUpsample(nn.Module):
    """Nearest upsampling by `stride`, then a left-causal conv (k-1 frames of
    zeros on the left): causal HiFT's replacement for the transposed conv."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, weight_norm=True):
        super().__init__()
        cls = WNConv1d if weight_norm else Conv1d
        self.conv = cls(in_channels, out_channels, kernel_size)
        self.stride = stride
        self.causal_padding = kernel_size - 1

    def forward(self, x):
        return self.conv(F.pad(torch.repeat_interleave(x, self.stride, dim=1), (0, 0, self.causal_padding, 0)))


class ConvolutionModule(nn.Module):
    """Conformer convolution module: pointwise-GLU, depthwise, LayerNorm,
    Swish, pointwise. x [B, T, C]; pad_mask [B, T] bool (True = valid).
    Returns (y, new_cache); the causal mode's left context starts at zeros."""

    def __init__(self, channels: int, kernel_size: int = 15, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.lorder = kernel_size - 1 if causal else 0
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        pad = 0 if causal else (kernel_size - 1) // 2
        self.depthwise_conv = Conv1d(channels, channels, kernel_size, padding=pad, groups=channels)
        self.norm = nn.LayerNorm(channels, eps=1e-5)
        self.pointwise_conv2 = Conv1d(channels, channels, 1)

    def forward(self, x, pad_mask=None):
        if pad_mask is not None:
            x = x * pad_mask[..., None]
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        x = a * torch.sigmoid(b)
        new_cache = None
        if self.causal:
            x = F.pad(x, (0, 0, self.lorder, 0))
            new_cache = x[:, -self.lorder :]
        x = self.norm(self.depthwise_conv(x))
        x = self.pointwise_conv2(x * torch.sigmoid(x))
        if pad_mask is not None:
            x = x * pad_mask[..., None]
        return x, new_cache
