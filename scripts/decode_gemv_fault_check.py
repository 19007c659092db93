"""Fault check of chip_smoke.py's K1, K3, K4, K5 and K6 comparisons; needs one CUDA card.

Builds `cosyvoice_tpu_torch/csrc/decode_attention.cu` (K1, K3) and
`int4_fused.cu` (K4, K5, and K6 at B=1 and B > 1) as they are and once per planted
fault (MUTANTS), each into a library of its own under
`build/decode_gemv_faults/`, and runs chip_smoke's holding checks (`hold_k1`,
`hold_k3` for the attention source, `hold_k4`, `hold_k5` and `hold_k6` for the
int4 source) through each library in turn. It passes when
the sources as they are pass every check and every mutant fails at least one;
for each failure it prints the first case that failed, with its error and
limit.

    python3 scripts/decode_gemv_fault_check.py
"""

import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

# source -> {name: [(text in the source, replacement)]}; each text must be present
MUTANTS = {
    "decode_attention.cu": {
        # the merge leaves out the last split
        "merge_drops_last_split": [("const float w = t < splits ? __expf(mv[u] - mx) : 0.f;",
                                    "const float w = t < splits - 1 ? __expf(mv[u] - mx) : 0.f;")],
        # the first split's partial counts twice in the sum, once in l
        "merge_doubles_split_0": [("if (warp < rep && t < splits) wgt[r * kMaxSplits + t] = w;",
                                   "if (warp < rep && t < splits) wgt[r * kMaxSplits + t] = t == 0 ? 2.f * w : w;")],
        # each split's acc takes the next split's weight
        "merge_weight_of_next_split": [("const float w = wr[t0 + u];", "const float w = wr[(t0 + u + 1) % splits];")],
        # the middle split leaves out its last key
        "split_drops_its_last_key": [(
            "key1 = split_begin(s + 1, n_live, splits);",
            "key1 = split_begin(s + 1, n_live, splits) - (s == splits / 2 && key0 + 1 < split_begin(s + 1, n_live, "
            "splits));",
        )],
        # every query head reads the values of KV head 0
        "values_of_kv_head_0": [("const kv_t* vb = v + (size_t)b * T * row + (size_t)g * D;",
                                 "const kv_t* vb = v + (size_t)b * T * row;")],
        # K3 drops the v scale from the softmax weight
        "k3_without_v_scale": [("if constexpr (kQuant) w *= vsc[j];", "")],
        # the merging block leaves its ticket counter set, so the next call never merges
        "counter_not_reset": [("if (tid == 0) counters[b * Hkv + g] = 0;", "")],
    },
    "int4_fused.cu": {
        # rank 0 leaves out the last rank's tile
        "sum_drops_last_rank": [("for (int q = 0; q < csize; ++q) t += gather[q * BT * cols + idx];",
                                 "for (int q = 0; q < csize - 1; ++q) t += gather[q * BT * cols + idx];")],
        # every scale block takes the scales of block 0
        "scales_of_block_0": [("sc = __ldg(scale + (size_t)blk * O + col0 + tid);", "sc = __ldg(scale + col0 + tid);")],
        # rank 1's tile counts twice
        "rank_1_doubled": [("slot[idx] = blk == rank ? t : res[idx] + t;",
                            "slot[idx] = (blk == rank ? t : res[idx] + t) * (rank == 1 ? 2.f : 1.f);")],
        # the high nibbles at <= 2 rows take the next input row
        "high_inputs_shifted": [("__ldg(xr + half + i)", "__ldg(xr + half + (i + 1) % half)")],
        # every staged row (> 2 rows) reads row 0's low inputs
        "staged_rows_of_row_0": [("xl[r] = __bfloat162float(xs[r * K + i]);", "xl[r] = __bfloat162float(xs[i]);")],
        # K6 at B=1: the o_proj stage is read before its copies have landed (its wait dropped)
        "k6_o_read_before_landing": [("  mbar_wait(mbar, 0);\n  __syncthreads();\n", "  __syncthreads();\n")],
        # K6 at B=1: the o_proj units of column tile 0 copy the weights of tile 1 in place of their own
        "k6_plan_unit_off_by_one": [("(ids_o[k] % tiles) * kUnitCols,\n                mbar);",
                                     "(ids_o[k] % tiles + (ids_o[k] % tiles == 0)) * kUnitCols,\n                mbar);")],
        # K6 at B=1: the last unit of a tile leaves out the last split of the down partials
        "k6_tile_sum_drops_last_split": [("d[s] = s < p.kd ? ld_cg(p.part_d + (size_t)s * H + c)",
                                          "d[s] = s < p.kd - 1 ? ld_cg(p.part_d + (size_t)s * H + c)")],
        # K6 at B=1: the down tickets are not returned to 0, so the next launch never writes out
        "k6_ticket_not_reset": [("x2s[c] + sum);\n        }\n        if (threadIdx.x == 0) p.bar[2 + tile] = 0;\n",
                                 "x2s[c] + sum);\n        }\n")],
        # K6 at B=1: the grid barrier's counters are not returned to 0 at the end of a launch
        "k6_barrier_not_reset": [("  grid_exit(p.bar);\n}\n\n// ---- K5", "  __syncthreads();\n}\n\n// ---- K5")],
        # K5: block 0 drops its gate|up unit from the plan (neither copied nor computed)
        "k5_unit_dropped_from_plan": [("const int n_g = mine[0], n_d = mine[1 + p.maxu];",
                                       "const int n_g = mine[0] - (blockIdx.x == 0 && mine[0] > 0), n_d = mine[1 + p.maxu];")],
        # K5: the gate|up stage is read before its copies have landed (its wait dropped)
        "k5_gate_up_read_before_landing": [("  __syncthreads();\n  mbar_wait(mbar, 0);\n  run_mma_units", "  __syncthreads();\n  run_mma_units")],
        # K5: the last down unit of a tile leaves out the last split of the partials
        "k5_tile_sum_drops_last_split": [("d[s] = s < p.kd ? ld_cg(p.part_d + (size_t)s * p.B * H + o)",
                                          "d[s] = s < p.kd - 1 ? ld_cg(p.part_d + (size_t)s * p.B * H + o)")],
        # K5: the down tickets are not returned to 0, so the next launch never writes out
        "k5_ticket_not_reset": [("p.out[o] = __float2bfloat16(sum);\n        }\n        if (threadIdx.x == 0) p.bar[2 + tile] = 0;\n",
                                 "p.out[o] = __float2bfloat16(sum);\n        }\n")],
        # K5: the rows past the first 8 get no tensor-core product (their sums stay 0)
        "k5_rows_past_8_skipped": [("for (int h = 0; h < NH; ++h) mma_bf16(", "for (int h = 0; h < 1; ++h) mma_bf16(")],
        # K5: every item takes the scales of its plane's first scale block
        "k5_scales_of_block_0": [("(pl * u.nb + b) * kUnitCols + 8 * g;", "(pl * u.nb) * kUnitCols + 8 * g;")],
        # K5: the high nibbles are decoded without their sign flip (offset by 8)
        "k5_high_nibbles_unsigned": [("nib_pair(ax4, bx4, sel, 0x43084308u), nib_pair(ay4, by4, sel, 0x43084308u)",
                                      "nib_pair(ax4, bx4, sel, 0x43004300u), nib_pair(ay4, by4, sel, 0x43004300u)")],
        # K5: the grid barrier's counters are not returned to 0, so the next launch passes its barrier early
        "k5_barrier_not_reset": [("  grid_exit(p.bar);\n}\n\n// ---- K6 at B = 2..16",
                                  "  __syncthreads();\n}\n\n// ---- K6 at B = 2..16")],
        # K6 at B > 1: x2 leaves out the last split of the o_proj partials
        "k6rows_x2_drops_last_o_split": [("v[s] = s < p.ko ? __ldcg(", "v[s] = s < p.ko - 1 ? __ldcg(")],
        # K6 at B > 1: the last unit of a tile leaves out the last split of the down partials
        "k6rows_tile_sum_drops_last_split": [("d[s] = s < p.kd ? __ldcg(", "d[s] = s < p.kd - 1 ? __ldcg(")],
        # K6 at B > 1: every row's h2 takes row 0's norm
        "k6rows_norm_of_row_0": [("a = x2s[(size_t)r * H + k] * inv[r] * nw[k];",
                                  "a = x2s[(size_t)r * H + k] * inv[0] * nw[k];")],
        # K6 at B > 1: f32 attention rows past the first 8 are not staged (two products a fragment)
        "k6rows_attn_rows_past_8_unstaged": [("static_cast<const float*>(p.attn) + c0, p.B, kRows,",
                                              "static_cast<const float*>(p.attn) + c0, p.B, 8,")],
        # K6 at B > 1: the down tickets are not returned to 0, so the next launch never writes out
        "k6rows_ticket_not_reset": [(
            "*reinterpret_cast<const uint32_t*>(&hi));\n        }\n        if (threadIdx.x == 0) p.bar[2 + tile] = 0;\n",
            "*reinterpret_cast<const uint32_t*>(&hi));\n        }\n")],
    },
}
HOLDS = {"decode_attention.cu": ("hold_k1", "hold_k3"), "int4_fused.cu": ("hold_k4", "hold_k5", "hold_k6")}
ENTRIES = {"decode_attention.cu": ("cvt_gqa_decode_attention", "cvt_gqa_decode_attention_quant"),
           "int4_fused.cu": ("cvt_int4_gemv", "cvt_int4_mlp", "cvt_int4_o_mlp_rows", "cvt_int4_o_mlp_resident")}


def main():
    import torch

    import chip_smoke
    from k7_fault_check import build_variants

    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.ops import _build, decode_attention as da, int4_fused as int4

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    qc = Qwen2Config()
    modules = {"hold_k1": da, "hold_k3": da, "hold_k4": int4, "hold_k5": int4, "hold_k6": int4}
    real_load = _build.load_library
    results = {}
    try:
        for source, mutants in MUTANTS.items():
            libs = build_variants(REPO / "build" / "decode_gemv_faults" / source.split(".")[0], source, mutants)
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                for entry in ENTRIES[source]:
                    getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
                    getattr(lib, entry).restype = ctypes.c_int
                _build.load_library = lambda lib=lib: lib
                caught = {}
                for hold in HOLDS[source]:
                    da._COUNTERS.clear()  # a mutant may leave the ticket or barrier counters set
                    gen = torch.Generator(device="cuda").manual_seed(0)
                    try:
                        getattr(chip_smoke, hold)(modules[hold], qc, gen)
                    except AssertionError as e:
                        caught[hold] = str(e)
                    torch.cuda.synchronize()
                results[f"{source}:{name}"] = caught
                print(f"== {source} {name}: fails {len(caught)} of {len(HOLDS[source])} checks")
                for hold, msg in caught.items():
                    print(f"   {hold}: {msg}")
    finally:
        _build.load_library = real_load
        da._COUNTERS.clear()
    as_is = [k for k in results if k.endswith(":as_is")]
    mutants = [k for k in results if k not in as_is]
    ok = not any(results[k] for k in as_is) and all(results[k] for k in mutants)
    print(json.dumps({"as_is_pass": {k: not results[k] for k in as_is},
                      "mutants_caught": {k: len(results[k]) for k in mutants}, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
