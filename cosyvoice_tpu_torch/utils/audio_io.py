"""Host-side wav IO over the standard library's `wave`.

Counterpart of cosyvoice_tpu/utils/audio_io.py, with the port's
`ops/resample.resample_poly` (a copy of scipy's) in place of scipy.
"""

import wave
from fractions import Fraction

import numpy as np
import torch

from cosyvoice_tpu_torch.ops.resample import resample_poly


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """A wav file mixed to mono and resampled to target_sr: [1, L] float32 in [-1, 1]."""
    with wave.open(path, "rb") as f:
        sr, n, ch, width = f.getframerate(), f.getnframes(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        frac = Fraction(target_sr, sr).limit_denominator(1000)
        x = resample_poly(torch.from_numpy(x), frac.numerator, frac.denominator).numpy()
    return x[None, :]


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """wav: [1, L] or [L] float in [-1, 1], written as 16-bit mono PCM."""
    pcm = np.clip(np.asarray(wav).reshape(-1) * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
