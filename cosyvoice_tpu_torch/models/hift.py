"""HiFT vocoder (NSF source + iSTFT HiFi-GAN): 24 kHz non-causal (v2) and
causal (v3), and 22.05 kHz non-causal (v1).

Counterpart of cosyvoice_tpu/models/hift.py:HiFTGenerator:

  mel [B, T, 80] --f0 predictor--> f0 [B, T]
      --x480 upsample + SineGen2 harmonic source--> s [B, T*480]
      --STFT(16/4)--> 18-ch source spectrum, added into the
      upsampling/ResBlock(Snake) stack (8, 5, 3)
      --conv_post--> magnitude/phase --iSTFT--> wav [B, T*480]

`HiFTConfig(causal=True)` (CosyVoice3) makes every conv one-sided: the f0
predictor's first conv and `conv_pre` are right-causal (k = 4 and
conv_pre_look_right + 1: they read lookahead frames), the upsampling convs
are nearest-upsampled left-causal convs, and the ResBlocks, source convs
and conv_post are left-causal. `inference(mel, finalize=False)` treats the
last frames as lookahead: the f0 predictor consumes 3 and drops them, then
conv_pre consumes conv_pre_look_right more, and the last 480 samples are
cut; finalize=True pads with zeros instead. The causal source draws its
phase by nearest-neighbour upsampling and its noise from a fixed uniform
buffer indexed by sample position (`causal_noise_buffer`), so the
re-vocode of a growing mel emits the same prefix. The buffer is the port's
own, drawn once per device from a seeded torch.Generator: the JAX
package's is a threefry draw (ROADMAP C4). The causal f0 predictor stays in
float32, as in the JAX package.

At 22.05 kHz (CosyVoice-300M: upsampling (8, 8), hop 256) the source is
SineGen1 (`sine_source_v1`, chosen by `HiFTConfig.sinegen_type`): each
harmonic's phase accumulates at the sample rate, modulo 1, in float64 (the
JAX package takes the sum modulo 1 inside an associative scan; a plain
float32 cumulative sum would detune the high harmonics over long audio),
plus a uniform(-pi, pi) initial phase per harmonic, 0 for the fundamental.

Randomness of the sources (harmonic initial phases; the non-causal noise)
comes from an explicit torch.Generator; a source's `draws` (initial phases,
noise), or `HiFTGenerator.source_draws` when set, hand it fixed draws
instead (the tests hand it JAX's).

Training (`forward(mel, generator, draws)` -> (wav, f0), the counterpart of
the JAX generator's `__call__`): the source's sines are detached, so f0
learns from the F0 loss alone, and the three clips (the log-magnitude at
ln 100, the magnitude at 100, the wav at audio_limit) are straight-through:
`ste_clip`, x + (clip(x) - x) detached, whose forward is the clip up to an
ulp and whose gradient is the identity. The JAX package uses this exact
form: its GAN pretrain is bistable at its working rate, and a one-ulp
change of the forward flips a seed into its loud-noise plateau.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.activation import Snake
from cosyvoice_tpu_torch.nn.conv import (
    CausalConv1d,
    CausalConv1dDownSample,
    CausalConv1dUpsample,
    Conv1d,
    WNConv1d,
    WNConvTranspose1d,
)
from cosyvoice_tpu_torch.ops.resample import interpolate_linear, repeat_interleave_time
from cosyvoice_tpu_torch.ops.stft import hann_window, istft, stft
from cosyvoice_tpu_torch.utils.devices import resolve_device


def ste_clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """Straight-through clip: forward x + (clip(x) - x), the clip up to an
    ulp; backward the identity."""
    return x + (x.clamp(lo, hi) - x).detach()


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    causal: bool = False
    conv_pre_look_right: int = 4  # causal variant only

    @property
    def hop_total(self) -> int:
        return int(np.prod(self.upsample_rates)) * self.istft_hop  # 480 at 24 kHz, 256 at 22.05 kHz

    @property
    def sinegen_type(self) -> str:
        """'1' (SineGen1) at 22.05 kHz, the v1 vocoder; '2' otherwise."""
        return "1" if self.sampling_rate == 22050 else "2"


def v1_hift_config(**kw) -> "HiFTConfig":
    """The CosyVoice-300M vocoder: 22.05 kHz, upsampling (8, 8) with kernels
    (16, 16), source resblocks (7, 11), hop 256 (the JAX API's v1 config)."""
    return HiFTConfig(**{
        "sampling_rate": 22050, "upsample_rates": (8, 8), "upsample_kernel_sizes": (16, 16),
        "source_resblock_kernel_sizes": (7, 11), "source_resblock_dilations": ((1, 3, 5), (1, 3, 5)), **kw,
    })


class ConvRNNF0Predictor(nn.Module):
    """5x (WN conv k=3 pad=1 + ELU) + linear head, |.|."""

    def __init__(self, in_channels: int = 80, cond_channels: int = 512):
        super().__init__()
        self.condnet = nn.ModuleList(
            WNConv1d(in_channels if i == 0 else cond_channels, cond_channels, 3, padding=1) for i in range(5)
        )
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, mel):
        x = mel
        for conv in self.condnet:
            x = F.elu(conv(x))
        return torch.abs(self.classifier(x)[..., 0])


class CausalConvRNNF0Predictor(nn.Module):
    """Causal variant: a right-causal k=4 first conv, then 4 left-causal
    k=3, all weight-normed. finalize=False takes the last 3 frames as the
    first conv's lookahead, so f0 has 3 frames fewer."""

    def __init__(self, in_channels: int = 80, cond_channels: int = 512):
        super().__init__()
        self.condnet = nn.ModuleList(
            [CausalConv1d(in_channels, cond_channels, 4, causal_type="right", weight_norm=True)]
            + [CausalConv1d(cond_channels, cond_channels, 3, weight_norm=True) for _ in range(4)]
        )
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, mel, finalize: bool = True):
        first = self.condnet[0]
        if finalize:
            x = first(mel)
        else:
            pad = first.causal_padding
            x = first(mel[:, :-pad], cache=mel[:, -pad:])
        x = F.elu(x)
        for conv in self.condnet[1:]:
            x = F.elu(conv(x))
        return torch.abs(self.classifier(x)[..., 0])


# the causal source's noise buffer: 80 s at 24 kHz covers the longest
# segment (<= 80 text tokens x 20 tokens each); positions wrap beyond
CAUSAL_NOISE_SAMPLES = 80 * 24000
CAUSAL_NOISE_SEED = 7
_NOISE = {}


def causal_noise_buffer(n_harmonics: int, device) -> torch.Tensor:
    """The causal source's fixed uniform [0, 1) buffer [CAUSAL_NOISE_SAMPLES,
    n_harmonics] float32: drawn once on the host from a torch.Generator
    seeded with CAUSAL_NOISE_SEED and kept once per device, so that every
    device holds the same values; never an inference tensor, so that the
    causal vocoder trains after it has served."""
    dev = torch.device(device)
    key = (n_harmonics, dev)
    if key not in _NOISE:
        gen = torch.Generator().manual_seed(CAUSAL_NOISE_SEED)
        with torch.inference_mode(False):
            _NOISE[key] = torch.rand((CAUSAL_NOISE_SAMPLES, n_harmonics), generator=gen).to(dev)
    return _NOISE[key]


def draw_source(cfg: HiFTConfig, B: int, L: int, generator: torch.Generator, device, dtype=torch.float32):
    """The random draws of one source of B rows and L samples, as
    SourceModuleHnNSF takes them: SineGen1's initial phases [B, 1, H+1]
    (U(-pi, pi), the fundamental's 0) or SineGen2's [B, H+1] (U[0, 1)
    cycles, the fundamental's 0), then the noise [B, L, H+1] ~ N(0, 1)
    (None for the causal source, whose noise is its fixed buffer)."""
    H = cfg.nb_harmonics + 1
    if cfg.sinegen_type == "1":
        ini = (torch.rand((B, 1, H), generator=generator, device=device, dtype=dtype) * 2.0 - 1.0) * np.pi
        ini[..., 0] = 0.0
    else:
        ini = torch.rand((B, H), generator=generator, device=device, dtype=dtype)
        ini[:, 0] = 0.0
    noise = None if cfg.causal else torch.randn((B, L, H), generator=generator, device=device, dtype=dtype)
    return ini, noise


def sine_source_v1(f0_up: torch.Tensor, cfg: HiFTConfig, generator: torch.Generator, phase=None, noise=None):
    """SineGen1 harmonic source. f0_up [B, L] at the sample rate. Returns
    (sine_waves [B, L, H+1], uv [B, L, 1]). The phases accumulate modulo 1
    in float64; `phase` [B, 1, H+1] (initial phases, the fundamental's 0)
    and `noise` [B, L, H+1] (standard normal) are drawn from `generator`
    unless given."""
    H = cfg.nb_harmonics + 1
    B, L = f0_up.shape
    dev, dt = f0_up.device, f0_up.dtype
    fn = f0_up[..., None] * torch.arange(1, H + 1, dtype=dt, device=dev) / cfg.sampling_rate  # [B, L, H]
    cum = torch.remainder(torch.cumsum(torch.remainder(fn, 1.0).double(), dim=1), 1.0).to(dt)
    if phase is None:
        phase, noise = draw_source(cfg, B, L, generator, dev, dt)
    sines = cfg.nsf_alpha * torch.sin(2.0 * np.pi * cum + phase.to(dev, dt))
    uv = (f0_up > cfg.nsf_voiced_threshold).to(dt)[..., None]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    return sines * uv + noise_amp * noise.to(dev, dt), uv


def sine_source(f0_up: torch.Tensor, cfg: HiFTConfig, generator: torch.Generator, noise_buffer=None,
                rand_ini=None, noise=None):
    """SineGen2 harmonic source. f0_up [B, L] at the sample rate (L = T*480).
    Returns (sine_waves [B, L, H+1], uv [B, L, 1]). Causal: the phase is
    upsampled nearest-neighbour and the noise is `noise_buffer` [N, H+1]
    (default causal_noise_buffer) at the samples' positions mod N.
    `rand_ini` [B, H+1] (initial phases in cycles, the fundamental's 0) and,
    non-causal, `noise` [B, L, H+1] (standard normal) are drawn from
    `generator` unless given."""
    H = cfg.nb_harmonics + 1
    B, L = f0_up.shape
    dev = f0_up.device
    fn = f0_up[..., None] * torch.arange(1, H + 1, dtype=f0_up.dtype, device=dev)
    rad = torch.remainder(fn / cfg.sampling_rate, 1.0)
    if rand_ini is None:
        rand_ini, noise = draw_source(cfg, B, L, generator, dev, f0_up.dtype)
    rand_ini = rand_ini.to(dev, f0_up.dtype)
    rad = torch.cat([rad[:, :1] + rand_ini[:, None], rad[:, 1:]], dim=1)
    # downsample rad to the frame rate (linear), integrate, upsample the phase back
    scale = cfg.hop_total
    rad_lo = interpolate_linear(rad.transpose(1, 2), L // scale)  # [B, H, L/480]
    phase_lo = torch.cumsum(rad_lo, dim=-1) * (2.0 * np.pi)
    if cfg.causal:
        phase = repeat_interleave_time(phase_lo * scale, scale, axis=-1)
    else:
        phase = interpolate_linear(phase_lo * scale, L)  # [B, H, L]
    sines = torch.sin(phase.transpose(1, 2))
    uv = (f0_up > cfg.nsf_voiced_threshold).to(f0_up.dtype)[..., None]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    if cfg.causal:
        buf = causal_noise_buffer(H, dev) if noise_buffer is None else noise_buffer.to(dev)
        idx = torch.arange(L, device=dev) % buf.shape[0]
        noise = noise_amp * buf[idx].to(sines.dtype)[None]
    else:
        noise = noise_amp * noise.to(dev, sines.dtype)
    return cfg.nsf_alpha * sines * uv + noise, uv


class SourceModuleHnNSF(nn.Module):
    """Merge the harmonics into one excitation: tanh(linear(sines))."""

    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.cfg = cfg
        self.l_linear = nn.Linear(cfg.nb_harmonics + 1, 1)

    def forward(self, f0_up, generator, noise_buffer=None, draws=None):
        """draws: the source's (initial phases, noise) (sine_source_v1's
        phase and noise, or sine_source's rand_ini and noise), or None (from
        `generator`). The sines are detached: no gradient reaches f0
        through the source."""
        if self.cfg.sinegen_type == "1":
            sine_waves, _ = sine_source_v1(f0_up, self.cfg, generator, *(draws or (None, None)))
        else:
            sine_waves, _ = sine_source(f0_up, self.cfg, generator, noise_buffer, *(draws or (None, None)))
        return torch.tanh(self.l_linear(sine_waves.detach()))[..., 0]


class ResBlock(nn.Module):
    """HiFi-GAN residual block with Snake activations; `causal`: left-causal
    convs."""

    def __init__(self, channels: int, kernel_size: int, dilations, causal: bool = False):
        super().__init__()
        self.act1 = nn.ModuleList(Snake(channels) for _ in dilations)
        self.act2 = nn.ModuleList(Snake(channels) for _ in dilations)
        if causal:
            self.convs1 = nn.ModuleList(
                CausalConv1d(channels, channels, kernel_size, dilation=d, weight_norm=True) for d in dilations
            )
            self.convs2 = nn.ModuleList(
                CausalConv1d(channels, channels, kernel_size, weight_norm=True) for _ in dilations
            )
            return
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=(kernel_size * d - d) // 2, dilation=d) for d in dilations
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2) for _ in dilations
        )

    def forward(self, x):
        for a1, c1, a2, c2 in zip(self.act1, self.convs1, self.act2, self.convs2):
            x = x + c2(a2(c1(a1(x))))
        return x


class HiFTGenerator(nn.Module):
    def __init__(self, cfg: HiFTConfig = HiFTConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        # the causal source's noise [N, H+1]; None: causal_noise_buffer (tests hand in another)
        self.noise_buffer = None
        # the source's draws: None, or a function of the source length L
        # giving SourceModuleHnNSF's draws (tests hand in JAX's)
        self.source_draws = None
        with torch.device(resolve_device(device)):
            self._build(cfg)
        self.eval()

    def _build(self, cfg: HiFTConfig):
        base = cfg.base_channels
        n_src = cfg.istft_n_fft + 2
        causal = cfg.causal
        self.f0_predictor = (CausalConvRNNF0Predictor if causal else ConvRNNF0Predictor)(cfg.in_channels, base)
        self.m_source = SourceModuleHnNSF(cfg)
        if causal:
            self.conv_pre = CausalConv1d(cfg.in_channels, base, cfg.conv_pre_look_right + 1, causal_type="right",
                                         weight_norm=True)
            self.ups = nn.ModuleList(
                CausalConv1dUpsample(base // 2**i, base // 2 ** (i + 1), k, u)
                for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))
            )
        else:
            self.conv_pre = WNConv1d(cfg.in_channels, base, 7, padding=3)
            self.ups = nn.ModuleList(
                WNConvTranspose1d(base // 2**i, base // 2 ** (i + 1), k, u, padding=(k - u) // 2)
                for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))
            )
        downsample_cum = np.cumprod([1] + list(cfg.upsample_rates[::-1][:-1]))[::-1]
        self.source_downs = nn.ModuleList()
        self.source_resblocks = nn.ModuleList()
        for i, (u, k, d) in enumerate(
            zip(downsample_cum, cfg.source_resblock_kernel_sizes, cfg.source_resblock_dilations)
        ):
            ch, u = base // 2 ** (i + 1), int(u)
            if causal:
                down = (CausalConv1d(n_src, ch, 1) if u == 1
                        else CausalConv1dDownSample(n_src, ch, u * 2, u, weight_norm=False))
            else:
                down = Conv1d(n_src, ch, 1) if u == 1 else Conv1d(n_src, ch, u * 2, stride=u, padding=u // 2)
            self.source_downs.append(down)
            self.source_resblocks.append(ResBlock(ch, k, d, causal))
        self.resblocks = nn.ModuleList(
            ResBlock(base // 2 ** (i + 1), k, d, causal)
            for i in range(len(cfg.upsample_rates))
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)
        )
        last = base // 2 ** len(cfg.upsample_rates)
        self.conv_post = (CausalConv1d(last, n_src, 7, weight_norm=True) if causal
                          else WNConv1d(last, n_src, 7, padding=3))

    def decode(self, mel, s, finalize: bool = True):
        """mel [B, T, 80]; s [B, T*480] source. Returns wav [B, T*480].
        Causal with finalize=False: the last conv_pre_look_right frames are
        conv_pre's lookahead, and the wav is (T - look_right - 1) * 480
        samples."""
        cfg = self.cfg
        window = hann_window(cfg.istft_n_fft, device=mel.device)
        spec = stft(s, cfg.istft_n_fft, cfg.istft_hop, window)
        sr, si = spec.real, spec.imag
        if cfg.causal and not finalize:
            la = cfg.conv_pre_look_right
            x = self.conv_pre(mel[:, :-la], cache=mel[:, -la:])
            trim = int(np.prod(cfg.upsample_rates)) * la
            sr, si = sr[:, :, :-trim], si[:, :, :-trim]
        else:
            x = self.conv_pre(mel)
        s_stft = torch.cat([sr, si], dim=1).transpose(1, 2)  # [B, Ts, 18]
        nk = len(cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, cfg.lrelu_slope))
            if i == len(self.ups) - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # reflection pad (1, 0) on time
            x = x + self.source_resblocks[i](self.source_downs[i](s_stft))
            xs = self.resblocks[i * nk](x)
            for j in range(1, nk):
                xs = xs + self.resblocks[i * nk + j](x)
            x = xs / nk
        x = self.conv_post(F.leaky_relu(x, 0.01)).transpose(1, 2)  # [B, 18, Tt]
        n_half = cfg.istft_n_fft // 2 + 1
        # clip before exp: min(e^x, 100) == e^min(x, ln 100), and exp's
        # gradient stays bounded
        magnitude = ste_clip(torch.exp(ste_clip(x[:, :n_half], hi=4.6052)), hi=1e2)
        phase = torch.sin(x[:, n_half:])
        spec = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
        wav = istft(spec, cfg.istft_n_fft, cfg.istft_hop, window)
        if cfg.causal and not finalize:
            wav = wav[:, : -int(np.prod(cfg.upsample_rates)) * cfg.istft_hop]
        return ste_clip(wav, -cfg.audio_limit, cfg.audio_limit)

    def predict_f0(self, mel, finalize: bool = True):
        if self.cfg.causal:
            return self.f0_predictor(mel, finalize)
        return self.f0_predictor(mel)

    def source_from_f0(self, f0, generator, draws=None):
        """f0 [B, T] at the mel rate -> source [B, T*480]; `draws` as
        SourceModuleHnNSF's, else from source_draws where it is set."""
        f0_up = repeat_interleave_time(f0, self.cfg.hop_total, axis=-1)
        if draws is None and self.source_draws is not None:
            draws = self.source_draws(f0_up.shape[1])
        return self.m_source(f0_up, generator, self.noise_buffer, draws)

    def forward(self, mel, generator: torch.Generator, draws=None):
        """Training forward: mel [B, T, 80] -> (wav [B, T*480], f0 [B, T]),
        with gradients (the source detached, the clips straight-through)."""
        f0 = self.predict_f0(mel)
        return self.decode(mel, self.source_from_f0(f0, generator, draws)), f0

    @torch.inference_mode()
    def inference(self, mel, generator: torch.Generator, cache_source: Optional[torch.Tensor] = None,
                  source: Optional[torch.Tensor] = None, finalize: bool = True):
        """mel [B, T, 80] -> (wav [B, T*480], source [B, T*480]).
        cache_source [B, Lc], a streaming chunk's source cache, overwrites
        the head of the generated source (no phase glitch across chunks).
        `source`, when given, replaces the generated excitation (for tests).
        Causal with finalize=False: the last 3 frames are the f0
        predictor's lookahead (source (T-3)*480) and decode sees the mel
        without them."""
        s = self.source_from_f0(self.predict_f0(mel, finalize), generator) if source is None else source
        if cache_source is not None and cache_source.shape[1] > 0:
            s = torch.cat([cache_source.to(s.dtype), s[:, cache_source.shape[1] :]], dim=1)
        if self.cfg.causal and not finalize:
            mel = mel[:, :-3]
        return self.decode(mel, s, finalize), s
