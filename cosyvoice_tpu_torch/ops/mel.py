"""Mel and fbank feature extractors on the tensor's device.

Counterpart of cosyvoice_tpu/ops/mel.py, which computes them with XLA
outside any Pallas kernel; here `torch.fft.rfft` does the FFT. The
filterbanks and windows are built in numpy (float64, rounded to float32 as
the JAX package's are) once per (shape, device). Each extractor computes in
float64 and returns the input's dtype: in float32, the FFT's rounding moves
the log of a band 100 dB below its frame's peak by up to ~1e-2 (and the
fbank's pre-emphasised lowest band by ~1e-4), so two float32 libraries (the
card's and the host's, or the port's and XLA's) disagree there; in float64
they agree to ~1e-9.

1. `mel_spectrogram`: the Matcha/HiFi-GAN 80-mel of the flow's prompt
   features (n_fft 1920, hop 480 at 24 kHz; slaney mel; reflect pad
   (n_fft - hop) / 2, magnitude sqrt(power + 1e-9), ln(clamp(., 1e-5))).
2. `whisper_log_mel`: the 128-mel whisper frontend of the S3 speech
   tokenizer (n_fft 400, hop 160 at 16 kHz, centred, power, log10 clamp
   1e-10, max - 8 floor, (x + 4) / 4, last frame dropped).
3. `kaldi_fbank`: torchaudio.compliance.kaldi.fbank(dither=0) of the CAM++
   x-vector (snip-edges framing, DC removal, pre-emphasis 0.97, povey
   window, 512-point power FFT, HTK mel from 20 Hz, ln(max(., eps)),
   optional mean normalisation over time).
"""

import functools

import numpy as np
import torch
from torch.nn import functional as F

from cosyvoice_tpu_torch.ops.stft import hann_window


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank_slaney(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney'): [n_mels, n_fft//2+1]."""
    if fmax is None:
        fmax = sr / 2
    fftfreqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def mel_filterbank_htk(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Kaldi/HTK mel bank (1127 ln(1 + f/700), unnormalised): [n_mels, n_fft//2+1]."""

    def h2m(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    fftfreqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    centers = np.linspace(h2m(fmin), h2m(fmax), n_mels + 2)
    mel_bins = h2m(fftfreqs)
    lower = (mel_bins[None, :] - centers[:-2, None]) / (centers[1:-1] - centers[:-2])[:, None]
    upper = (centers[2:, None] - mel_bins[None, :]) / (centers[2:] - centers[1:-1])[:, None]
    return np.maximum(0, np.minimum(lower, upper)).astype(np.float32)


def _povey_window(n: int) -> np.ndarray:
    return ((0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _constant(kind: str, device: torch.device, *args) -> torch.Tensor:
    """A filterbank or window (float32 values) as a float64 tensor on
    `device`, built once, never as an inference tensor (a first call under
    torch.inference_mode would otherwise keep one that autograd, as in the
    GAN's mel loss, refuses to save)."""
    build = {"slaney": mel_filterbank_slaney, "htk": mel_filterbank_htk, "povey": _povey_window,
             "hann": lambda n: hann_window(n).numpy()}[kind]
    with torch.inference_mode(False):
        return torch.as_tensor(build(*args), device=device).double()


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    shape = x.shape
    return F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect").reshape(*shape[:-1], -1)


def _power(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.real.square() + spec.imag.square()


def mel_spectrogram(x: torch.Tensor, sr: int = 24000, n_fft: int = 1920, hop: int = 480, win: int = 1920,
                    n_mels: int = 80, fmin: float = 0.0, fmax: float = 8000.0, grad_safe: bool = False) -> torch.Tensor:
    """Matcha/HiFi-GAN mel: [..., L] -> [..., n_mels, T], T = 1 + (L - hop) // hop.

    grad_safe=True (the GAN losses) keeps the forward value exactly but
    takes the backward pass through ln(mel + 1e-5): below the 1e-5 floor
    the clamp has no gradient, and a randomly initialised vocoder trained
    on the clamped mel stays at silence."""
    dtype, x = x.dtype, x.double()
    fb = _constant("slaney", x.device, sr, n_fft, n_mels, fmin, fmax)
    frames = _reflect_pad(x, (n_fft - hop) // 2).unfold(-1, win, hop) * _constant("hann", x.device, win)
    mag = torch.sqrt(_power(frames, n_fft) + 1e-9)
    mel = torch.einsum("...tf,mf->...mt", mag, fb)
    hard = torch.log(torch.clamp(mel, min=1e-5))
    if grad_safe:
        smooth = torch.log(mel + 1e-5)
        hard = hard.detach() + (smooth - smooth.detach())
    return hard.to(dtype)


def whisper_log_mel(x: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """Whisper log-mel: 16 kHz [..., L] -> [..., n_mels, T], T = L // 160."""
    dtype, x = x.dtype, x.double()
    fb = _constant("slaney", x.device, 16000, 400, n_mels, 0.0, 8000.0)
    frames = _reflect_pad(x, 200).unfold(-1, 400, 160) * _constant("hann", x.device, 400)
    power = _power(frames, 400)[..., :-1, :]  # drop the last frame
    mel = torch.einsum("...tf,mf->...mt", power, fb)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    return ((torch.maximum(log_spec, floor) + 4.0) / 4.0).to(dtype)


def kaldi_fbank(x: torch.Tensor, sr: int = 16000, n_mels: int = 80, frame_len: int = 400, frame_shift: int = 160,
                cmn: bool = False) -> torch.Tensor:
    """torchaudio.compliance.kaldi.fbank(dither=0): [L] -> [T, n_mels],
    T = 1 + (L - frame_len) // frame_shift; with `cmn`, minus its mean over T."""
    n_fft = 512
    dtype, x = x.dtype, x.double()
    fb = _constant("htk", x.device, sr, n_fft, n_mels, 20.0, sr / 2.0)
    frames = x.unfold(-1, frame_len, frame_shift)
    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove the DC offset
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames * _constant("povey", x.device, frame_len)
    mel = torch.einsum("...tf,mf->...tm", _power(frames, n_fft), fb)
    feats = torch.log(torch.clamp(mel, min=1.1920928955078125e-07))
    if cmn:
        feats = feats - feats.mean(dim=-2, keepdim=True)
    return feats.to(dtype)
