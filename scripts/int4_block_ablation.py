"""Where the time of K7 (whole int4p decode step), K6 (fused int4 layer tail, B=1 and the batched steps' B > 1) and
K5 (fused int4 MLP of the bistream extends) goes, by ablation; needs one CUDA card.

Builds `csrc/int4_block.cu` and `csrc/int4_fused.cu` as they are and cut short at successive points (CUTS, per
kernel), each into a library of its own under `build/int4_block_ablation/`, and times each through the real wrappers
at chip_smoke.py's phase-3 shapes: K7 over a 2048-row arena at pos 0 (no arena key read) and at pos 1023, K6 at B=1
and ("K6 rows", int4_o_mlp_rows_kernel) at 4 and 16 rows, K5 at 5 and 16 rows (CUDA events around a replayed graph over rotating input sets that exceed twice the L2). The
difference between two successive cuts is the time of the stage between them; "as is without copies" is the kernel
with no weight or arena copy issued (it computes on whatever shared memory holds), K5's "as is without k-steps" the
kernel with its tensor-core loop left out. The cut kernels compute nothing useful: only their times are read.

For the resident designs it also prints a timeline of one call: %globaltimer stamps (0.26 us steps on an H100) at
each phase's end and after each grid barrier (K7 at layer 12), min / median / max over the blocks that pass them.

The cuts are written for the sources of this checkout. The table holds those of each kernel's design before its
redesign too ("grid barriers", chosen when that design's marker text is in the source), so the same script run from
a checkout of an earlier commit (copied into its `scripts/`) times that design:

    python3 scripts/int4_block_ablation.py
"""

import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

RETURN = "if (threadIdx.x < 100000) return;\n"  # a return the compiler cannot prove always taken


def _skip(stmt):
    """`stmt` on a branch the compiler cannot prove always taken."""
    return f"if (threadIdx.x < 100000) {{ {stmt} }}\n"


SYNCS = ["grid.sync();"] * 5


def _old_k7_cut(after_phase):
    """The layer loop of the grid-barrier K7 cut after its phase `after_phase` (0: before phase A): the
    remaining grid barriers of the layer, then the next layer."""
    return " ".join(SYNCS[after_phase:]) + " continue;"


def _copies_from(s0):
    """The rest of a layer of the resident K7 with no work: each remaining stage waited for, its barrier, its
    refill."""
    return (f"for (int s = {s0}; s < kStages; ++s) {{ mbar_wait(mbar + s, l & 1); grid_arrive(p.bar); "
            "if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, s, pos, n_chunks, mbar + s); "
            "grid_wait(p.bar, ++barriers * G); } continue;")


def _k7_after(stage):
    return (f"    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, {stage}, pos, n_chunks, mbar + {stage});\n"
            "    grid_wait(p.bar, ++barriers * G);\n")


K6_BARRIERS = "grid_arrive(p.bar); grid_wait(p.bar, gridDim.x); grid_arrive(p.bar); grid_wait(p.bar, 2 * gridDim.x);"
# the copies of K6's three stages, and the no-copy stand-ins that keep its mbarriers' accounting
K6_COPIES = [("    mbar_expect(mbar, n_o * uo.bytes());\n    for (int k = 0; k < n_o; ++k)\n",
              "    mbar_expect(mbar, 0);\n    if (threadIdx.x >= 100000)\n    for (int k = 0; k < n_o; ++k)\n"),
             ("    mbar_expect(mbar + 1, H * 4 + n_g * ug.bytes());\n    bulk_copy(img_g - H * 4, p.norm_w, H * 4, mbar + 1);\n"
              "    for (int k = 0; k < n_g; ++k)\n",
              "    mbar_expect(mbar + 1, 0);\n    if (threadIdx.x >= 100000)\n    for (int k = 0; k < n_g; ++k)\n"),
             ("    mbar_expect(mbar + 2, n_d * ud.bytes());\n    for (int k = 0; k < n_d; ++k)\n",
              "    mbar_expect(mbar + 2, 0);\n    if (threadIdx.x >= 100000)\n    for (int k = 0; k < n_d; ++k)\n")]

# points of K6 at B > 1 (int4_o_mlp_rows_kernel) that its cuts start from
K6R_COPIES_OUT = "  // every copy of the launch goes out first: o, then the norm weight and gate|up, then down\n"
K6R_PHASE_1 = "  // phase 1: each o unit's split of attn staged in bf16"
K6R_H2 = "    const float* nw = reinterpret_cast<const float*>(img_g) - H;\n"
K6R_PHASE_2 = "  // phase 2 (blocks with gate|up units)"
K6R_GATE_UP = "    __syncthreads();\n    run_mma_units<NH>(img_g, ug,"
K6R_PHASE_3 = "  // phase 3: down units over their split of act -> f32 partials"

# K5's copies, and the no-copy stand-ins that keep its mbarriers' accounting
K5_COPIES = [("    mbar_expect(mbar, n_g * ug.bytes());\n    for (int k = 0; k < n_g; ++k)\n",
              "    mbar_expect(mbar, 0);\n    if (threadIdx.x >= 100000)\n    for (int k = 0; k < n_g; ++k)\n"),
             ("    mbar_expect(mbar + 1, n_d * ud.bytes());\n    for (int k = 0; k < n_d; ++k)\n",
              "    mbar_expect(mbar + 1, 0);\n    if (threadIdx.x >= 100000)\n    for (int k = 0; k < n_d; ++k)\n")]
K5_BARRIER = "grid_arrive(p.bar); grid_wait(p.bar, gridDim.x);"

# kernel -> (source, {design: (marker text, {cut: [(text, replacement)]})}), the cuts in the order the stages run
CUTS = {
    "K7": ("int4_block.cu", {
        "resident": ("issue_stage(", {
            "launch only": [("  // the first layer's stages go out before anything else\n", "  " + RETURN)],
            "barriers alone": [("  // the first layer's stages go out before anything else\n", "  " + _skip(
                "for (int l = 0; l < p.L; ++l) for (int s = 0; s < kStages; ++s) { grid_arrive(p.bar); "
                "grid_wait(p.bar, ++barriers * G); } grid_exit(p.bar); return;"))],
            "+ weight and arena copies": [("  for (int l = 0; l < p.L; ++l) {\n",
                                           "  for (int l = 0; l < p.L; ++l) {\n    " + _skip(_copies_from(0)))],
            "+ A (norm, qkv)": [(_k7_after(0), _k7_after(0) + "    " + _skip(_copies_from(1)))],
            "+ B (attention)": [(_k7_after(1), _k7_after(1) + "    " + _skip(_copies_from(2)))],
            "+ C (merge, o_proj)": [(_k7_after(2), _k7_after(2) + "    " + _skip(_copies_from(3)))],
            "+ D (x2, norm, gate|up)": [(_k7_after(3), _k7_after(3) + "    " + _skip(_copies_from(4)))],
            "as is without copies": [("  if (l >= p.L) return;\n", "  if (l >= p.L) return;\n  mbar_expect(bar, 0);\n  "
                                      + RETURN)],
        }),
        "grid barriers": ("cg::grid_group grid = cg::this_grid();", {
            "launch only": [("  const int H = p.H, I = p.I;\n", "  " + RETURN + "  const int H = p.H, I = p.I;\n")],
            "barriers alone": [("  for (int l = 0; l < p.L; ++l) {\n",
                                "  for (int l = 0; l < p.L; ++l) {\n    " + _skip(_old_k7_cut(0)))],
            "+ A (norm, qkv)": [("    grid.sync();\n\n    // ---- B:", "    grid.sync();\n    " + _skip(_old_k7_cut(1))
                                 + "\n    // ---- B:")],
            "+ B (attention)": [("    grid.sync();\n\n    // ---- C:", "    grid.sync();\n    " + _skip(_old_k7_cut(2))
                                 + "\n    // ---- C:")],
            "+ C (merge, o_proj)": [("    grid.sync();\n\n    // ---- D:", "    grid.sync();\n    "
                                     + _skip(_old_k7_cut(3)) + "\n    // ---- D:")],
            "+ D (x2, norm, gate|up)": [("    grid.sync();\n\n    // ---- E:", "    grid.sync();\n    "
                                         + _skip(_old_k7_cut(4)) + "\n    // ---- E:")],
            "+ E (down)": [("    grid.sync();\n\n    // layer boundary", "    grid.sync();\n    " + _skip("continue;")
                            + "\n    // layer boundary")],
        }),
    }),
    "K6": ("int4_fused.cu", {
        "resident": ("int4_o_mlp_resident_kernel", {
            "launch only": [("  // attn is read first, then every copy", "  " + RETURN + "  // attn is read first, then every copy")],
            "barriers alone": [("  // attn is read first, then every copy",
                                "  " + _skip(K6_BARRIERS + " grid_exit(p.bar); return;") + "  // attn is read first, then every copy")],
            "+ weight copies": [("  // phase 1: o_proj units over bf16(attn) -> f32 partials per split of the input\n",
                                 "  " + _skip("mbar_wait(mbar, 0); mbar_wait(mbar + 1, 0); mbar_wait(mbar + 2, 0); "
                                              "__syncthreads(); " + K6_BARRIERS + " grid_exit(p.bar); return;"))],
            "+ 1 (o_proj)": [("  grid_wait(p.bar, gridDim.x);\n", "  grid_wait(p.bar, gridDim.x);\n  " + _skip(
                "mbar_wait(mbar + 1, 0); mbar_wait(mbar + 2, 0); grid_arrive(p.bar); grid_wait(p.bar, 2 * gridDim.x); "
                "grid_exit(p.bar); return;"))],
            "+ 2 (x2, norm, gate|up)": [("  grid_wait(p.bar, 2 * gridDim.x);\n", "  grid_wait(p.bar, 2 * gridDim.x);\n  "
                                         + _skip("mbar_wait(mbar + 2, 0); grid_exit(p.bar); return;"))],
            "as is without copies": K6_COPIES,
        }),
        "grid barriers": ("launch_o_mlp<1>(", {
            "launch only": [("  // phase 1: o_proj partials, one item per (column tile, scale block)\n",
                             "  " + RETURN)],
            "barriers alone": [("  // phase 1: o_proj partials, one item per (column tile, scale block)\n",
                                "  " + _skip("grid.sync(); grid.sync(); grid.sync(); return;"))],
            "+ 1 (o_proj)": [("  grid.sync();\n\n  // phase 2: x2, the norm and h2",
                              "  grid.sync();\n  " + _skip("grid.sync(); grid.sync(); return;")
                              + "\n  // phase 2: x2, the norm and h2")],
            "+ 2 (x2, norm, gate|up)": [("  grid.sync();\n\n  // phase 3: down partials",
                                         "  grid.sync();\n  " + _skip("grid.sync(); return;")
                                         + "\n  // phase 3: down partials")],
            "+ 3 (down)": [("  grid.sync();\n\n  // phase 4: out = x2", "  grid.sync();\n  " + _skip("return;")
                            + "\n  // phase 4: out = x2")],
        }),
    }),
    "K6 rows": ("int4_fused.cu", {
        "resident": ("int4_o_mlp_rows_kernel", {
            "launch only": [(K6R_COPIES_OUT, "  " + RETURN + K6R_COPIES_OUT)],
            "barriers alone": [(K6R_COPIES_OUT, "  " + _skip(K6_BARRIERS + " grid_exit(p.bar); return;") + K6R_COPIES_OUT)],
            "+ weight copies": [(K6R_PHASE_1, "  " + _skip("__syncthreads(); mbar_wait(mbar, 0); mbar_wait(mbar + 1, 0); "
                                                          "mbar_wait(mbar + 2, 0); " + K6_BARRIERS
                                                          + " grid_exit(p.bar); return;") + K6R_PHASE_1)],
            "+ 1 (attn staging, o_proj)": [(K6R_PHASE_2, "  " + _skip(
                "mbar_wait(mbar + 1, 0); mbar_wait(mbar + 2, 0); grid_arrive(p.bar); grid_wait(p.bar, 2 * gridDim.x); "
                "grid_exit(p.bar); return;") + K6R_PHASE_2)],
            "+ x2, norm, h2": [(K6R_GATE_UP, "    __syncthreads();\n    if (threadIdx.x >= 100000) run_mma_units<NH>(img_g, ug,"),
                               (K6R_PHASE_3, "  " + _skip("mbar_wait(mbar + 2, 0); grid_exit(p.bar); return;") + K6R_PHASE_3)],
            "+ 2 (gate|up)": [(K6R_PHASE_3, "  " + _skip("mbar_wait(mbar + 2, 0); grid_exit(p.bar); return;")
                               + K6R_PHASE_3)],
            "as is without copies": K6_COPIES,
        }),
    }),
    "K5": ("int4_fused.cu", {
        "resident": ("int4_mlp_kernel<1>", {
            "launch only": [("  // every copy of the launch goes out first: gate|up, then down\n",
                             "  " + RETURN + "  // every copy of the launch goes out first: gate|up, then down\n")],
            "barrier alone": [("  // every copy of the launch goes out first: gate|up, then down\n",
                               "  " + _skip(K5_BARRIER + " grid_exit(p.bar); return;")
                               + "  // every copy of the launch goes out first: gate|up, then down\n")],
            "+ weight copies": [("  // phase 1: x staged (zero past n_in and past B); gate|up units -> act\n", "  " + _skip(
                "__syncthreads(); mbar_wait(mbar, 0); mbar_wait(mbar + 1, 0); " + K5_BARRIER + " grid_exit(p.bar); return;")
                                 + "  // phase 1: x staged (zero past n_in and past B); gate|up units -> act\n")],
            "+ 1 (x staging, gate|up)": [("  grid_wait(p.bar, gridDim.x);\n\n  // phase 2: down units", "  grid_wait(p.bar, "
                                          "gridDim.x);\n  " + _skip("mbar_wait(mbar + 1, 0); grid_exit(p.bar); return;")
                                          + "\n  // phase 2: down units")],
            "+ act staging": [("    mbar_wait(mbar + 1, 0);\n    __syncthreads();\n    run_mma_units<NH>(img_d",
                               "    mbar_wait(mbar + 1, 0);\n    __syncthreads();\n    " + _skip("grid_exit(p.bar); return;")
                               + "    run_mma_units<NH>(img_d")],
            "+ down units": [("    for (int k = 0; k < n_d; ++k) {\n      const int tile = ids_d[k] % tiles;\n      if (threadIdx.x"
                              " == 0) last_flag = ticket_add(p.bar + 2 + tile) == (unsigned)(p.kd - 1);",
                              "    " + _skip("grid_exit(p.bar); return;") + "    for (int k = 0; k < n_d; ++k) {\n      const int "
                              "tile = ids_d[k] % tiles;\n      if (threadIdx.x == 0) last_flag = ticket_add(p.bar + 2 + tile) == "
                              "(unsigned)(p.kd - 1);")],
            "as is without copies": K5_COPIES,
            "as is without k-steps": [("    for (int s = 0; s < steps; ++s) {\n      const uint2 wa",
                                       "    for (int s = 0; s < steps * 0; ++s) {\n      const uint2 wa")],
        }),
        "grid barriers": ("launch_mlp<4>(", {
            "launch only": [("  // phase 1: x staged in every block (zero past n_in); gate|up -> act\n", "  " + RETURN)],
            "barrier alone": [("  // phase 1: x staged in every block (zero past n_in); gate|up -> act\n",
                               "  " + _skip("grid.sync(); grid.sync(); return;"))],
            "+ 1 (x staging, gate|up)": [("  grid.sync();\n\n  // phase 2: down partials, one item per (column tile, scale block)\n"
                                          "  down_items", "  grid.sync();\n  " + _skip("grid.sync(); return;") + "\n  // phase 2:"
                                          " down partials, one item per (column tile, scale block)\n  down_items")],
            "+ down units": [("  grid.sync();\n\n  // phase 3: out = the down partials summed in order",
                              "  grid.sync();\n  " + _skip("return;") + "\n  // phase 3: out = the down partials summed in order")],
        }),
    }),
}
# A timeline of the resident design: %globaltimer stamps (every block, after a __syncthreads()) at the points
# below, K7 at layer 12, read back through cvt_trace. source -> ([(text, text with stamps)], point labels).
_TRACE_HDR = ('#include "int4_resident.cuh"\n', '#include "int4_resident.cuh"\n'
              '__device__ unsigned long long g_trace[1024][32];\n'
              '#define TR(n) do { __syncthreads(); if (threadIdx.x == 0) { unsigned long long t_; '
              'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_trace[blockIdx.x][n] = t_; } } while (0)\n'
              'extern "C" int cvt_trace(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)); }\n')
_K7_STAMPS = [("  for (int l = 0; l < p.L; ++l) {\n", "  for (int l = 0; l < p.L; ++l) {\n    if (l == 12) TR(0);\n")]
for _s in range(5):
    _a = (f"    grid_arrive(p.bar);\n    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, {_s}, pos, n_chunks, mbar + {_s});\n"
          "    grid_wait(p.bar, ++barriers * G);\n")
    _K7_STAMPS.append((_a, f"    if (l == 12) TR({2 * _s + 1});\n" + _a + f"    if (l == 12) TR({2 * _s + 2});\n"))
TIMELINE = {
    "K7": ([_TRACE_HDR, *_K7_STAMPS], ["layer start", "A (x, norm, qkv) done", "A barrier passed",
                                                  "B (attention) done", "B barrier passed", "C (merge, o_proj) done",
                                                  "C barrier passed", "D (x2, norm, gate|up) done", "D barrier passed",
                                                  "E (down) done", "E barrier passed"]),
    "K6": ([_TRACE_HDR,
                       ("  uint8_t* img_d = img_g + n_g * ug.bytes();\n", "  uint8_t* img_d = img_g + n_g * ug.bytes();\n  TR(0);\n"),
                       ("  // phase 1: o_proj units over bf16(attn)", "  TR(1);\n  // phase 1: o_proj units over bf16(attn)"),
                       ("  mbar_wait(mbar, 0);\n  __syncthreads();\n", "  mbar_wait(mbar, 0);\n  __syncthreads();\n  TR(2);\n"),
                       ("  grid_arrive(p.bar);\n  grid_wait(p.bar, gridDim.x);\n",
                        "  TR(3);\n  grid_arrive(p.bar);\n  grid_wait(p.bar, gridDim.x);\n  TR(4);\n"),
                       ("  mbar_wait(mbar + 1, 0);\n  __syncthreads();\n", "  TR(5);\n  mbar_wait(mbar + 1, 0);\n  __syncthreads();\n"),
                       ("  grid_arrive(p.bar);\n  grid_wait(p.bar, 2 * gridDim.x);\n",
                        "  TR(6);\n  grid_arrive(p.bar);\n  grid_wait(p.bar, 2 * gridDim.x);\n  TR(7);\n"),
                       ("  grid_exit(p.bar);\n}\n\n", "  TR(8);\n  grid_exit(p.bar);\n}\n\n")],
                      ["start", "copies issued", "o landed", "o units done", "barrier 1 passed", "x2 summed",
                       "gate|up units done", "barrier 2 passed", "down units and tickets done"]),
    "K6 rows": ([_TRACE_HDR,
                 ("  uint8_t* img_d = img_g + n_g * ug.bytes();\n", "  uint8_t* img_d = img_g + n_g * ug.bytes();\n  TR(0);\n"),
                 (K6R_PHASE_1, "  TR(1);\n" + K6R_PHASE_1),
                 ("  mbar_wait(mbar, 0);\n  run_mma_units<NH>(img, uo,", "  mbar_wait(mbar, 0);\n  TR(2);\n  run_mma_units<NH>(img, uo,"),
                 ("  grid_arrive(p.bar);\n  grid_wait(p.bar, gridDim.x);\n",
                  "  TR(3);\n  grid_arrive(p.bar);\n  grid_wait(p.bar, gridDim.x);\n  TR(4);\n"),
                 (K6R_H2, "    TR(5);\n" + K6R_H2),
                 (K6R_GATE_UP, "    TR(6);\n    run_mma_units<NH>(img_g, ug,"),
                 ("  grid_arrive(p.bar);\n  grid_wait(p.bar, 2 * gridDim.x);\n",
                  "  TR(7);\n  grid_arrive(p.bar);\n  grid_wait(p.bar, 2 * gridDim.x);\n  TR(8);\n"),
                 ("    __syncthreads();\n    run_mma_units<NH>(img_d, ud, n_d, xs, (size_t)kRows * sd, sd, red, [&](int k, int r, "
                  "int j, float s, float) {\n      if (r < p.B) p.part_d[",
                  "    TR(9);\n    run_mma_units<NH>(img_d, ud, n_d, xs, (size_t)kRows * sd, sd, red, [&](int k, int r, "
                  "int j, float s, float) {\n      if (r < p.B) p.part_d["),
                 ("  grid_exit(p.bar);\n}\n\n}  // namespace", "  TR(10);\n  grid_exit(p.bar);\n}\n\n}  // namespace")],
                ["start", "copies issued", "attn staged, o landed", "o units done", "barrier 1 passed",
                 "gate|up landed, x2 and norm done", "h2 staged", "gate|up units done", "barrier 2 passed", "act staged, down landed",
                 "down units and tile sums done"]),
    "K5": ([_TRACE_HDR,
            ("  uint8_t* img_d = img + n_g * ug.bytes();\n", "  uint8_t* img_d = img + n_g * ug.bytes();\n  TR(0);\n"),
            ("  // phase 1: x staged (zero past n_in and past B)", "  TR(1);\n  // phase 1: x staged (zero past n_in and past B)"),
            ("  mbar_wait(mbar, 0);\n  run_mma_units<NH>(img, ug", "  mbar_wait(mbar, 0);\n  TR(2);\n  run_mma_units<NH>(img, ug"),
            ("  grid_arrive(p.bar);\n  grid_wait(p.bar, gridDim.x);\n\n  // phase 2: down units",
             "  TR(3);\n  grid_arrive(p.bar);\n  grid_wait(p.bar, gridDim.x);\n  TR(4);\n\n  // phase 2: down units"),
            ("    __syncthreads();\n    run_mma_units<NH>(img_d", "    __syncthreads();\n    TR(5);\n    run_mma_units<NH>(img_d"),
            ("                      });\n    for (int k = 0; k < n_d; ++k) {\n      const int tile = ids_d[k] % tiles;",
             "                      });\n    TR(6);\n    for (int k = 0; k < n_d; ++k) {\n      const int tile = ids_d[k] % tiles;"),
            ("  grid_exit(p.bar);\n}\n\n// ---- K6 at B = 2..16",
             "  TR(7);\n  grid_exit(p.bar);\n}\n\n// ---- K6 at B = 2..16")],
           ["start", "copies issued", "x staged, gate|up landed", "gate|up units done", "barrier passed",
            "act staged, down landed", "down units done", "tile sums done"]),
}

ENTRIES = {"int4_block.cu": ("cvt_int4_decode_layers",),
           "int4_fused.cu": ("cvt_int4_mlp", "cvt_int4_o_mlp", "cvt_int4_o_mlp_rows", "cvt_int4_o_mlp_resident")}


def design_of(kernel, text):
    """(design name, cuts) of the kernel's design whose marker is in its source text."""
    for name, (marker, cuts) in CUTS[kernel][1].items():
        if marker in text:
            return name, cuts
    raise RuntimeError(f"{kernel}: no design of CUTS matches {CUTS[kernel][0]}")


def main():
    import torch

    import chip_smoke as cs
    from k7_fault_check import build_variants

    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.ops import _build, int4_block as tb, int4_fused as int4

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    qc = Qwen2Config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    libs, order = {}, {}
    for kernel, (source, _) in CUTS.items():
        if kernel == "K6 rows" and "int4_o_mlp_rows_kernel" not in (_build.CSRC_DIR / source).read_text():
            continue  # a checkout from before K6's B > 1 redesign
        design, cuts = design_of(kernel, (_build.CSRC_DIR / source).read_text())
        variants = {**cuts, "timeline": TIMELINE[kernel][0]} if design == "resident" and kernel in TIMELINE else cuts
        paths = build_variants(REPO / "build" / "int4_block_ablation" / kernel, source, variants)
        order[kernel] = (design, [*cuts, "as is"])
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for entry in (e for e in ENTRIES[source] if hasattr(lib, e)):
                getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
            if hasattr(lib, "cvt_trace"):
                lib.cvt_trace.argtypes = [ctypes.c_void_p]
            libs[kernel, "as is" if name == "as_is" else name] = lib
    real_load = _build.load_library

    def timeline(kernel, label, fn, args):
        """One traced call after three untraced ones: per stamp, us from the earliest first stamp, min / median /
        max over the blocks."""
        import numpy as np

        _build.load_library = lambda: libs[kernel, "timeline"]
        for _ in range(4):
            fn(*args[0], **args[1])
        torch.cuda.synchronize()
        buf = np.zeros((1024, 32), np.uint64)
        if libs[kernel, "timeline"].cvt_trace(buf.ctypes.data) != 0:
            raise RuntimeError("cvt_trace failed")
        labels = TIMELINE[kernel][1]
        rel = buf[: int4.grid_of(torch.device("cuda")), : len(labels)].astype(np.float64)
        rel[rel == 0] = np.nan  # a stamp on a path a block does not take (K5: the blocks without down units)
        rel = (rel - np.nanmin(rel[:, 0])) / 1e3
        print(f"{label} timeline, us (min / median / max over blocks): " + "; ".join(
            f"{name} {np.nanmin(rel[:, i]):.2f} / {np.nanmedian(rel[:, i]):.2f} / {np.nanmax(rel[:, i]):.2f}"
            for i, name in enumerate(labels)))

    def timed(kernel, name, sets, fn, calls):
        _build.load_library = lambda: libs[kernel, name]
        return cs.graph_ms(cs.rotate(sets, fn), calls=calls) * 1e3

    try:
        W = cs._k7_weights(torch, int4, qc, gen)
        design, names = order["K7"]
        for pos in (0, cs.CUR_T):
            sets = [cs._k7_inputs(torch, qc, 2048, pos, gen, 0.0) + tuple(W.values())]
            cuts = ", ".join(f"{name} {timed('K7', name, sets, tb.int4_decode_layers, 4):.2f}" for name in names)
            print(f"K7 ({design}) A=2048 pos {pos}, us per step: {cuts}")
            if design == "resident":
                timeline("K7", f"K7 layer 12, A=2048 pos {pos}", tb.int4_decode_layers,
                         (sets[0][:6], dict(zip(cs.K7_KEYS, sets[0][6:]))))
        del W, sets
        torch.cuda.empty_cache()
        H, inter = qc.hidden_size, qc.intermediate_size
        n = cs.n_sets(8.2e6)
        sets = []
        for _ in range(n):
            attn = torch.randn((1, H), generator=gen, device="cuda")
            x = torch.randn((1, H), generator=gen, device="cuda").to(torch.bfloat16)
            nw = 1.0 + 0.1 * torch.randn((H,), generator=gen, device="cuda")
            sets.append((attn, x, nw) + cs._tail_weights(torch, int4, H, inter, gen))
        design, names = order["K6"]
        cuts = ", ".join(f"{name} {timed('K6', name, sets, int4.int4_o_mlp, n):.2f}" for name in names)
        print(f"K6 ({design}) B=1, us per call: {cuts}")
        if design == "resident":
            timeline("K6", "K6 B=1", int4.int4_o_mlp, (sets[0], {}))
        weights = [s[3:] for s in sets]
        if "K6 rows" in order:
            design, names = order["K6 rows"]
            for B in (4, 16):
                sets = [(torch.randn((B, H), generator=gen, device="cuda"),
                         torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16), nw) + w for w in weights]
                cuts = ", ".join(f"{name} {timed('K6 rows', name, sets, int4.int4_o_mlp, n):.2f}" for name in names)
                print(f"K6 ({design}) B={B}, us per call: {cuts}")
                timeline("K6 rows", f"K6 B={B}", int4.int4_o_mlp, (sets[0], {}))
        del sets, weights
        torch.cuda.empty_cache()
        design, names = order["K5"]
        n = cs.n_sets(7.74e6)
        weights = [cs._mlp_weights(torch, int4, H, inter, gen) for _ in range(n)]
        for B in (5, 16):
            sets = [(torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16),) + w for w in weights]
            cuts = ", ".join(f"{name} {timed('K5', name, sets, int4.int4_mlp, n):.2f}" for name in names)
            print(f"K5 ({design}) {B} rows, us per call: {cuts}")
            if design == "resident":
                timeline("K5", f"K5 {B} rows", int4.int4_mlp, (sets[0], {}))
    finally:
        _build.load_library = real_load
    return 0


if __name__ == "__main__":
    sys.exit(main())
