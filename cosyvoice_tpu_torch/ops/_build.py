"""Build and load the port's CUDA kernels.

Every `.cu` file under `cosyvoice_tpu_torch/csrc/` is compiled by its own
`nvcc -c` process, all started together (the build takes as long as the
slowest source, not their sum), and the objects are linked by one more `nvcc`
call into one shared library with a plain C interface, which is
loaded with `ctypes`. No source includes PyTorch's headers, so the build takes
seconds rather than the minutes of `torch.utils.cpp_extension.load`, and there
is no lock file that a cut-off build could leave behind: the library is
written under a temporary name and renamed into place.

The library lands in `<repo>/build/cosyvoice_tpu_torch/`, named by a hash of
the sources, headers and flags, so an edited source is never served by a stale
build. The build runs at first use (never at import) and raises on any failure.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cosyvoice_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")
BUILD_TIMEOUT_S = 300

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float

# argtypes of every C entry point; pointers and the stream are c_void_p so
# ctypes never truncates them to 32 bits
_SIGNATURES = {
    "cvt_gqa_decode_attention": [_c_void_p] * 7 + [_c_int] * 6 + [_c_float, _c_void_p],
    "cvt_gqa_decode_attention_f32": [_c_void_p] * 7 + [_c_int] * 6 + [_c_float, _c_void_p],
    "cvt_gqa_decode_attention_quant": [_c_void_p] * 9 + [_c_int] * 6 + [_c_float, _c_void_p],
    "cvt_kv_arena_write_kv": [_c_void_p] * 5 + [_c_int] + [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p],
    "cvt_empty_kernel": [_c_void_p],
    "cvt_int4_gemv": [_c_void_p] * 4 + [_c_int] * 7 + [_c_void_p],
    "cvt_int4_mlp": [_c_void_p] * 9 + [_c_int] * 16 + [_c_void_p],
    "cvt_int4_o_mlp_rows": [_c_void_p, _c_int] + [_c_void_p] * 12 + [_c_int] * 20 + [_c_float, _c_void_p],
    "cvt_int4_o_mlp_resident": [_c_void_p, _c_int] + [_c_void_p] * 12 + [_c_int] * 18 + [_c_float, _c_void_p],
    "cvt_int4_decode_layers": [_c_void_p] * 23 + [_c_int] * 28 + [_c_float, _c_void_p],
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcosyvoice_kernels_{h.hexdigest()[:16]}.so"


def run_nvcc(args) -> tuple:
    """One nvcc call; returns (log, seconds) or raises on failure or timeout."""
    cmd = [find_nvcc(), *args]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s: {' '.join(cmd)}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    return log, time.perf_counter() - t0


def build() -> dict:
    """Compile the kernels if their library is missing. Returns {"path",
    "seconds", "built", "log", "compile_s": {source name: seconds}}; raises if
    nvcc fails or times out."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": "", "compile_s": {}}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = _sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            compiled = list(pool.map(run_nvcc, [[*COMPILE_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]))
        link_log, _ = run_nvcc([*LINK_FLAGS, "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "built": True,
            "log": "".join(log for log, _ in compiled) + link_log,
            "compile_s": {src.name: secs for src, (_, secs) in zip(srcs, compiled)}}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _c_int
    return lib
