"""Build and load the port's CUDA kernels.

Every `.cu` file under `cosyvoice_tpu_torch/csrc/` is compiled by ONE `nvcc`
call into one shared library with a plain C interface, which is loaded with
`ctypes`. No source includes PyTorch's headers, so the build takes seconds
rather than the minutes of `torch.utils.cpp_extension.load`, and there is no
lock file that a cut-off build could leave behind: the library is written
under a temporary name and renamed into place.

The library lands in `<repo>/build/cosyvoice_tpu_torch/`, named by a hash of
the sources and flags, so an edited source is never served by a stale build.
The build runs at first use (never at import) and raises on any failure.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cosyvoice_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float

# argtypes of every C entry point; pointers and the stream are c_void_p so
# ctypes never truncates them to 32 bits
_SIGNATURES = {
    "cvt_gqa_decode_attention": [_c_void_p] * 8 + [_c_int] * 7 + [_c_float, _c_void_p],
    "cvt_gqa_decode_attention_quant": [_c_void_p] * 10 + [_c_int] * 7 + [_c_float, _c_void_p],
    "cvt_kv_arena_write": [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p],
    "cvt_int4_gemv": [_c_void_p] * 4 + [_c_int] * 5 + [_c_void_p],
    "cvt_int4_o_mlp": [_c_void_p, _c_int] + [_c_void_p] * 13 + [_c_int] * 10 + [_c_float, _c_void_p],
}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcosyvoice_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels if their library is missing. Returns
    {"path", "seconds", "built", "log"}; raises if nvcc fails or times out."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s: {' '.join(cmd)}") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True, "log": log}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _c_int
    return lib
