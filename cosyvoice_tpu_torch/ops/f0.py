"""F0 extraction for HiFT GAN training: YIN in native C++ on the host.

Counterpart of cosyvoice_tpu/ops/f0.py. `csrc/f0_yin.cc` (YIN: the
cumulative-mean-normalised difference function, the first dip under the
threshold or a convincing global minimum, parabolic refinement) is a host
helper, not a CUDA kernel: the data pipeline runs it per utterance on the
CPU. It is built at first use with g++ into `build/cosyvoice_tpu_torch/`
(named by a hash of the source and flags, written under a pid-unique name
and renamed into place, so concurrent first uses never load a partial
file) and loaded with ctypes. It stays apart from ops/_build.py's nvcc
library, which compiles the `*.cu` sources only.

`yin_f0_numpy` is the same algorithm in numpy, the plain version the tests
hold the native one against. Unlike the JAX package, `extract_f0` does not
fall back to it when the build fails: it raises, naming g++ (ROADMAP C4).
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "f0_yin.cc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cosyvoice_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 120


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libf0_yin_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/f0_yin.cc unless its library exists; raises RuntimeError
    (naming g++) if g++ is missing, fails or times out."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the native YIN helper needs g++: {' '.join(cmd)} did not run ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}) building the native YIN helper: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.yin_f0.restype = ctypes.c_int
    lib.yin_f0.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    return lib


def yin_f0(wav: np.ndarray, sample_rate: int, hop: int, frame: Optional[int] = None, fmin: float = 60.0,
           fmax: float = 500.0, threshold: float = 0.15) -> np.ndarray:
    """F0 in Hz per hop (0 where unvoiced), float32 [len(wav) // hop], from
    the native helper."""
    wav = np.ascontiguousarray(np.asarray(wav, np.float32).reshape(-1))
    n_frames = len(wav) // hop
    out = np.zeros(n_frames, np.float32)
    if n_frames == 0:
        return out
    load_library().yin_f0(wav.ctypes.data, len(wav), sample_rate, hop, frame or 4 * hop, fmin, fmax, threshold,
                          out.ctypes.data, n_frames)
    return out


def yin_f0_numpy(wav: np.ndarray, sample_rate: int, hop: int, frame: Optional[int] = None, fmin: float = 60.0,
                 fmax: float = 500.0, threshold: float = 0.15) -> np.ndarray:
    """The same YIN in numpy (the plain version of `yin_f0`)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    frame = frame or 4 * hop
    tau_min = int(sample_rate / fmax)
    tau_max = min(int(sample_rate / fmin), frame - 1)
    n_frames = len(wav) // hop
    f0 = np.zeros(n_frames, np.float32)
    taus = np.arange(1, tau_max + 1)
    for fidx in range(n_frames):
        start = fidx * hop
        w = frame if start + frame + tau_max < len(wav) else len(wav) - start - tau_max - 1
        if w < tau_max:
            continue
        x = wav[start : start + w + tau_max]
        if np.mean(x[:w] ** 2) < 1e-8:
            continue
        d = np.asarray([np.sum((x[:w] - x[t : t + w]) ** 2) for t in taus])
        dn = np.concatenate([[1.0], d * taus / np.maximum(np.cumsum(d), 1e-12)])
        tau_est = -1
        below = np.nonzero(dn[tau_min:tau_max] < threshold)[0]
        if len(below):
            tau = tau_min + below[0]
            while tau + 1 <= tau_max - 1 and dn[tau + 1] < dn[tau]:
                tau += 1
            tau_est = tau
        else:
            tau = tau_min + int(np.argmin(dn[tau_min : tau_max + 1]))
            if dn[tau] < 2.0 * threshold:
                tau_est = tau
        if tau_est < 0:
            continue
        tau_ref = float(tau_est)
        if tau_min < tau_est < tau_max:
            a, b, c = dn[tau_est - 1], dn[tau_est], dn[tau_est + 1]
            denom = a - 2 * b + c
            if abs(denom) > 1e-12:
                shift = 0.5 * (a - c) / denom
                if -1 < shift < 1:
                    tau_ref += shift
        f0[fidx] = sample_rate / tau_ref
    return f0


def extract_f0(wav: np.ndarray, sample_rate: int, hop: int, n_frames: int) -> np.ndarray:
    """The native YIN track linearly interpolated to n_frames (the mel's
    length), float32."""
    f0 = yin_f0(wav, sample_rate, hop)
    if len(f0) == 0:
        return np.zeros(n_frames, np.float32)
    if len(f0) == n_frames:
        return f0
    return np.interp(np.linspace(0.0, 1.0, n_frames), np.linspace(0.0, 1.0, len(f0)), f0).astype(np.float32)
