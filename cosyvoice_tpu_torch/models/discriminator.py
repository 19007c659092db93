"""The HiFT GAN's discriminators: multi-period (MPD) and multi-resolution
magnitude-spectrogram (MRD).

Counterpart of cosyvoice_tpu/models/discriminator.py. Each module returns
(outputs, feature maps) in the JAX module's order, the feature maps
channel-last as Flax computes them ([B, H, W, C]), and keeps the Flax
module names as attribute names (`mpd.mpd_2.conv_0`, `mrd.mrd_1024.conv_post`),
so `convert.load_jax_params` / `export_params` carry the JAX tree across
(the 2-D kernels HWIO there, OIHW here).

- `PeriodDiscriminator`: the wav padded to a multiple of the period (reflect
  where it has more than one sample), folded to [B, 1, L/p, p], four
  (5, 1) convs of stride (3, 1), one more, then a (3, 1) conv to one
  channel.
- `SpecDiscriminator`: |STFT| (periodic hann, centred) as [B, 1, T, F],
  three (3, 9) convs and one (3, 3) conv of stride (1, 1) / (2, 2) / (1, 1)
  / (2, 2), then a (3, 3) conv to one channel. Flax's padding "SAME" pads
  a dimension of n by total = max((ceil(n / s) - 1) s + k - n, 0), total // 2
  of it on the low side: uneven under stride 2, which nn.Conv2d cannot
  express, so each conv pads explicitly with F.pad first.
"""

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.ops.stft import hann_window, stft

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = (32, 128, 512, 1024)
MRD_RESOLUTIONS = ((1024, 120), (2048, 240), (512, 50))


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of Flax "SAME" for one dimension of size n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with Flax's "SAME" padding on channel-first input."""

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph, pw = _same_pads(x.shape[-2], kh, sh), _same_pads(x.shape[-1], kw, sw)
        return super().forward(F.pad(x, (*pw, *ph)))


def _channel_last(x):
    return x.permute(0, 2, 3, 1)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, channels: Sequence[int] = MPD_CHANNELS):
        super().__init__()
        self.period = period
        widths = (1, *channels)
        # the Flax names: conv_<i> for the strided convs, conv_4 for the last
        self.names = [f"conv_{i}" for i in range(len(channels))] + ["conv_4"]
        for i, name in enumerate(self.names[:-1]):
            self.add_module(name, nn.Conv2d(widths[i], widths[i + 1], (5, 1), (3, 1), padding=(2, 0)))
        self.conv_4 = nn.Conv2d(channels[-1], channels[-1], (5, 1), padding=(2, 0))
        self.conv_post = nn.Conv2d(channels[-1], 1, (3, 1), padding=(1, 0))

    def forward(self, x):
        """x [B, L] -> (score [B, n], feature maps [B, L/p/3^i, p, C])."""
        B, L = x.shape
        pad = (self.period - L % self.period) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect" if L > 1 else "constant")[:, 0]
        x = x.reshape(B, 1, -1, self.period)
        fmaps = []
        for name in self.names:
            x = F.leaky_relu(getattr(self, name)(x), 0.1)
            fmaps.append(_channel_last(x))
        x = self.conv_post(x)
        fmaps.append(_channel_last(x))
        return x.reshape(B, -1), fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = MPD_PERIODS, channels: Sequence[int] = MPD_CHANNELS):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"mpd_{p}", PeriodDiscriminator(p, channels))

    def forward(self, x):
        outs, fmaps = [], []
        for p in self.periods:
            o, f = getattr(self, f"mpd_{p}")(x)
            outs.append(o)
            fmaps.extend(f)
        return outs, fmaps


class SpecDiscriminator(nn.Module):
    def __init__(self, n_fft: int, hop: int):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.conv_0 = SameConv2d(1, 32, (3, 9))
        self.conv_1 = SameConv2d(32, 32, (3, 9), stride=(2, 2))
        self.conv_2 = SameConv2d(32, 32, (3, 9))
        self.conv_3 = SameConv2d(32, 32, (3, 3), stride=(2, 2))
        self.conv_post = SameConv2d(32, 1, (3, 3))

    def forward(self, x):
        """x [B, L] -> (score [B, n], feature maps [B, T', F', C])."""
        spec = stft(x, self.n_fft, self.hop, hann_window(self.n_fft, x.dtype, x.device))
        h = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9).transpose(1, 2)[:, None]  # [B, 1, T, F]
        fmaps = []
        for conv in (self.conv_0, self.conv_1, self.conv_2, self.conv_3):
            h = F.leaky_relu(conv(h), 0.1)
            fmaps.append(_channel_last(h))
        h = self.conv_post(h)
        fmaps.append(_channel_last(h))
        return h.reshape(x.shape[0], -1), fmaps


class MultiResSpecDiscriminator(nn.Module):
    def __init__(self, resolutions: Sequence[Tuple[int, int]] = MRD_RESOLUTIONS):
        super().__init__()
        self.resolutions = tuple(tuple(r) for r in resolutions)
        for n_fft, hop in self.resolutions:
            self.add_module(f"mrd_{n_fft}", SpecDiscriminator(n_fft, hop))

    def forward(self, x):
        outs, fmaps = [], []
        for n_fft, _ in self.resolutions:
            o, f = getattr(self, f"mrd_{n_fft}")(x)
            outs.append(o)
            fmaps.extend(f)
        return outs, fmaps


class MultipleDiscriminator(nn.Module):
    """MPD + MRD: (MPD outputs + MRD outputs, MPD maps + MRD maps)."""

    def __init__(self, mpd_periods: Sequence[int] = MPD_PERIODS, mpd_channels: Sequence[int] = MPD_CHANNELS,
                 mrd_resolutions: Sequence[Tuple[int, int]] = MRD_RESOLUTIONS):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(mpd_periods, mpd_channels)
        self.mrd = MultiResSpecDiscriminator(mrd_resolutions)

    def forward(self, x):
        o1, f1 = self.mpd(x)
        o2, f2 = self.mrd(x)
        return o1 + o2, f1 + f2
