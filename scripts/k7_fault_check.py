"""Fault check of chip_smoke.py's K7 comparison; needs one CUDA card.

Builds `cosyvoice_tpu_torch/csrc/int4_block.cu` as it is and once per
planted fault (MUTANTS: the attention faults of the first design and those
of the resident design's ring, plan and counters), each into a library of its own under
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
        ("tma_box(d, &p.mk, g * kD,", "tma_box(d, &p.mk, ((g + 1) % p.n_kv) * kD,"),
        ("tma_box(d + kChunk * kD * 2, &p.mv, g * kD,", "tma_box(d + kChunk * kD * 2, &p.mv, ((g + 1) % p.n_kv) * kD,"),
        ("* lanes + g * kD;", "* lanes + ((g + 1) % p.n_kv) * kD;"),
    ],
    # every layer attends over layer 0's arena
    "layer_0_arena": [("&p.mk, g * kD, l * p.A + key0", "&p.mk, g * kD, 0 * p.A + key0"),
                      ("&p.mv, g * kD, l * p.A + key0", "&p.mv, g * kD, 0 * p.A + key0"),
                      ("const size_t row = ((size_t)l * p.A + key0 + j)", "const size_t row = ((size_t)0 * p.A + key0 + j)")],
    # the head merge leaves out the last key chunk
    "drop_last_chunk": [("  const float w = lane < cnt ? expf(mv - M) : 0.f;",
                         "  const float w = lane < cnt && !(c0 + lane > 0 && c0 + lane == n_chunks - 1) ? expf(mv - M) : 0.f;")],
    # the keys of the middle chunk are skipped
    "skip_middle_chunk_keys": [(
        "key0 = c * kChunk, n = min(kChunk, pos - key0);",
        "key0 = c * kChunk, n = (c > 0 && c == n_chunks / 2) ? 0 : min(kChunk, pos - key0);",
    )],
    # the chunks' partials are summed without their exp(m_c - M) weights
    "unscaled_merge": [("  const float w = lane < cnt ? expf(mv - M) : 0.f;", "  const float w = lane < cnt ? 1.f : 0.f;")],
    # the attention row is zero once more than 1024 keys are live
    "zero_attention_past_1024": [("h < p.n_heads ? __floats2bfloat162_rn", "h < p.n_heads && n_chunks <= 32 ? __floats2bfloat162_rn")],
    # every stage is read without waiting for its copies, which go out only when the phase begins (nothing is
    # fetched ahead); the copies of the last layer are waited for before the blocks exit
    "stage_read_before_landing": [
        ("    for (int s = 0; s < kStages; ++s) issue_stage(p, t, ring, 0, s, pos, n_chunks, mbar + s);\n", ""),
        *((f"mbar_wait(mbar + {s}, l & 1);", f"if (threadIdx.x == 0) issue_stage(p, t, ring, l, {s}, pos, n_chunks, mbar + {s});")
          for s in range(5)),
        *((f"if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, {s}, pos, n_chunks, mbar + {s});", "") for s in range(5)),
        ("  grid_exit(p.bar);\n}", "  for (int s = 0; s < kStages; ++s) mbar_wait(mbar + s, (p.L - 1) & 1);\n  grid_exit(p.bar);\n}"),
    ],
    # the gate|up stage is refilled with the next layer's weights while this layer still reads it
    "ring_refilled_too_early": [
        ("    mbar_wait(mbar + 3, l & 1);\n",
         "    mbar_wait(mbar + 3, l & 1);\n    __syncthreads();\n"
         "    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, 3, pos, n_chunks, mbar + 3);\n"),
        ("    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, 3, pos, n_chunks, mbar + 3);\n    grid_wait", "    grid_wait"),
    ],
    # the qkv units of column tile 0 copy the weights of tile 1 in place of their own
    "plan_unit_off_by_one": [(
        "  const int id = t.ids[w][k], c0",
        "  const int id = t.ids[w][k] + (w == 0 && t.ids[w][k] % t.tiles[0] == 0), c0",
    )],
    # the grid barrier's counters are not returned to 0 at the end of a launch
    "barrier_not_reset": [("  grid_exit(p.bar);\n}", "  __syncthreads();\n}")],
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
        logs = dict(zip(jobs, pool.map(_build.run_nvcc, jobs.values())))
    print(f"{len(jobs)} variants of {source} built in {time.perf_counter() - t0:.1f} s")
    for ln in logs["as_is"][0].splitlines():
        if any(w in ln for w in ("registers", "spill", "Compiling entry")):
            print(f"  ptxas ({source} as is): {ln.strip()}")
    return {name: workdir / name / "lib.so" for name in jobs}


def main():
    import torch

    import chip_smoke
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.ops import _build, decode_attention as da, int4_block as tb, int4_fused as int4

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
            da._COUNTERS.clear()  # a mutant may leave its counters set
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
