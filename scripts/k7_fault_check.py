"""Fault check of chip_smoke.py's K7 comparison; needs one CUDA card.

Builds `cosyvoice_tpu_torch/csrc/int4_block.cu` as it is and once per
planted fault (MUTANTS), each into a library of its own under
`build/k7_faults/`, and runs chip_smoke's K7 cases (`k7_cases`, held by
`_hold_k7`) through each library in turn. It passes when the source as it is
passes every case and every mutant fails at least one. For each mutant and
case it prints the worst error over its limit, so the margin by which a
fault is caught can be read off.

    python3 scripts/k7_fault_check.py
"""

import ctypes
import json
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# name -> [(text in int4_block.cu, replacement)]; each text must be present
MUTANTS = {
    # every query head reads the keys and values of the next KV head
    "wrong_kv_head": [
        ("p.ka + layer_kv + g * kD", "p.ka + layer_kv + ((g + 1) % p.n_kv) * kD"),
        ("p.va + layer_kv + g * kD", "p.va + layer_kv + ((g + 1) % p.n_kv) * kD"),
    ],
    # every layer attends over layer 0's arena
    "layer_0_arena": [("const size_t layer_kv = (size_t)l * p.A * lanes;", "const size_t layer_kv = 0;")],
    # the head merge leaves out the last key chunk
    "drop_last_chunk": [(
        "              const size_t o = base + (size_t)c * kMaxRep;\n",
        "              if (c > 0 && c == n_chunks - 1) continue;\n"
        "              const size_t o = base + (size_t)c * kMaxRep;\n",
    )],
    # the keys of the middle chunk are skipped
    "skip_middle_chunk_keys": [(
        "const int key0 = c * p.chunk, key1 = min(key0 + p.chunk, pos);",
        "const int key0 = c * p.chunk, key1 = (c > 0 && c == n_chunks / 2) ? key0 : min(key0 + p.chunk, pos);",
    )],
    # the chunks' partials are summed without their exp(m_c - M) weights
    "unscaled_merge": [("const float f = expf(p.part_m[o] - M);", "const float f = 1.f;")],
    # the attention row is zero once more than 1024 keys are live
    "zero_attention_past_1024": [("v = As / Ls;", "v = pos > 1024 ? 0.f : As / Ls;")],
}


def build_variants(workdir, source="int4_block.cu", mutants=None):
    """{variant: library path} of csrc/<source> as it is ("as_is") and with
    each planted fault of `mutants` (default MUTANTS), compiled in parallel."""
    from cosyvoice_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / source).read_text()
    jobs = {}
    for name, subs in {"as_is": [], **(MUTANTS if mutants is None else mutants)}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"mutant {name}: text not found in {source}: {old!r}")
            text = text.replace(old, new)
        d = workdir / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d)
        (d / source).write_text(text)
        jobs[name] = [*_build.COMPILE_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / source)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(_build.run_nvcc, jobs.values()))
    print(f"{len(jobs)} variants of {source} built in {time.perf_counter() - t0:.1f} s")
    return {name: workdir / name / "lib.so" for name in jobs}


def main():
    import torch

    import chip_smoke
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.ops import _build, int4_block as tb, int4_fused as int4

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    workdir = REPO / "build" / "k7_faults"
    libs = build_variants(workdir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, cases = chip_smoke.k7_cases(torch, int4, Qwen2Config(), gen)
    real_load = _build.load_library
    results = {}
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.cvt_int4_decode_layers.argtypes = _build._SIGNATURES["cvt_int4_decode_layers"]
            lib.cvt_int4_decode_layers.restype = ctypes.c_int
            _build.load_library = lambda lib=lib: lib
            caught = {}
            for label, inputs, W in cases:
                try:
                    chip_smoke._hold_k7(tb, label, inputs, W)
                except AssertionError as e:
                    caught[label] = str(e)
            results[name] = caught
            print(f"== {name}: fails {len(caught)} of {len(cases)} cases")
            for label, msg in caught.items():
                print(f"   {msg}")
    finally:
        _build.load_library = real_load
    ok = not results["as_is"] and all(results[m] for m in MUTANTS)
    print(json.dumps({"as_is_passes": not results["as_is"],
                      "mutants_caught": {m: len(results[m]) for m in MUTANTS}, "cases": len(cases), "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
