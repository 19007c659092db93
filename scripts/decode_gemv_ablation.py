"""Where the time of K1 / K3 and K4 goes, by ablation; needs one CUDA card.

Builds `csrc/decode_attention.cu` and `csrc/int4_fused.cu` as they are and
cut short at successive points (ABLATIONS), each into a library of its own
under `build/decode_gemv_ablation/`, and times each through the real
wrappers at chip_smoke.py's phase-3 shapes (CUDA events around a replayed
graph over rotating input sets that exceed twice the L2). The difference
between two successive cuts is the time of the stage between them. It also
times K1 / K3 as they are at other split counts (decode_plan fixes 66 at
B=1) and K4 with 16-column tiles (gemv_plan fixes 32). The cut kernels compute nothing useful: only
their times are read.

    python3 scripts/decode_gemv_ablation.py
"""

import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

RETURN = "if (threadIdx.x < 100000) return;\n"  # a return the compiler cannot prove always taken
# source -> {cut: [(text, replacement)]}, in the order the stages run
ABLATIONS = {
    "decode_attention.cu": {
        "launch only": [("  const int n_live = live_keys(cur_len, b, T);\n",
                         "  " + RETURN + "  const int n_live = live_keys(cur_len, b, T);\n")],
        "+ cur_len and K/V copies": [("    cp_async_wait_all();\n    __syncthreads();\n",
                                      "    cp_async_wait_all();\n    __syncthreads();\n    " + RETURN)],
        "+ scores, softmax, P.V, partial": [("  // the last of the S blocks of this (row, KV head) merges all partials\n",
                                             "  " + RETURN)],
        "+ fence and ticket": [("  if (!is_last) return;\n",
                                "  if (!is_last) return;\n  if (tid == 0) counters[b * Hkv + g] = 0;\n  " + RETURN)],
    },
    "int4_fused.cu": {
        "launch only": [("  cg::cluster_group cluster = cg::this_cluster();\n",
                         "  " + RETURN + "  cg::cluster_group cluster = cg::this_cluster();\n")],
        "+ loads and FMAs": [("    for (int off = G; off < 32; off <<= 1) {\n",
                              "    if (part[0][0] == 12345.f) y[0] = __float2bfloat16(part[BT - 1][CPT - 1]);\n"
                              "    " + RETURN + "    for (int off = G; off < 32; off <<= 1) {\n")],
        # before the push into rank 0's shared memory: a rank must not write
        # there once rank 0 may have exited
        "+ shuffles and shared-memory partials": [("    // the block's partial: the warps summed in order, times the block's\n",
                                                   "    " + RETURN)],
    },
}
ENTRIES = {"decode_attention.cu": ("cvt_gqa_decode_attention", "cvt_gqa_decode_attention_quant"),
           "int4_fused.cu": ("cvt_int4_gemv",)}
SPLITS = (16, 33, 66, 132)
# K4 with 16-column tiles (64 would need more static shared memory at 16 rows)
NARROW = {"16-column tiles": [("constexpr int kGemvCols = 32;", "constexpr int kGemvCols = 16;")]}


def main():
    import torch

    import chip_smoke as cs
    from k7_fault_check import build_variants

    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.ops import _build, decode_attention as da, int4_fused as int4

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    qc = Qwen2Config()
    Hq, Hkv, d = qc.num_heads, qc.num_kv_heads, qc.head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    libs = {}
    for source, cuts in ABLATIONS.items():
        extra = NARROW if source == "int4_fused.cu" else {}
        paths = build_variants(REPO / "build" / "decode_gemv_ablation" / source.split(".")[0], source,
                               {**cuts, **extra})
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for entry in ENTRIES[source]:
                getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
            libs[source, "as is" if name == "as_is" else name] = lib
    real_load, real_plan, real_gplan = _build.load_library, da.decode_plan, int4.gemv_plan

    def timed(source, name, sets, fn):
        _build.load_library = lambda: libs[source, name]
        da._COUNTERS.clear()
        return cs.graph_ms(cs.rotate(sets, fn), calls=len(sets)) * 1e3

    try:
        for kernel, T, cur_t in (("K1", 4096, 1023), ("K1", 512, 127), ("K1", 4096, 4095), ("K3", 4096, 1023)):
            cur = torch.tensor([cur_t], device="cuda", dtype=torch.int32)
            n = cs.n_sets(2 * (cur_t + 1) * Hkv * d * 2)
            case = cs._quant_arena_case if kernel == "K3" else cs._arena_case
            sets = [case(torch, 1, T, Hq, Hkv, d, cur, gen, 0.0) + (cur,) for _ in range(n)]
            fn = da.gqa_decode_attention_quant if kernel == "K3" else da.gqa_decode_attention
            cuts = ", ".join(f"{name} {timed('decode_attention.cu', name, sets, fn):.2f}"
                             for name in (*ABLATIONS["decode_attention.cu"], "as is"))
            sweep = []
            for S in SPLITS:
                da.decode_plan = lambda B, Hkv, T, S=S: min(S, T)
                sweep.append(f"S={S} {timed('decode_attention.cu', 'as is', sets, fn):.2f}")
            da.decode_plan = real_plan
            print(f"{kernel} cur_len {cur_t}, {T}-row arena, S={real_plan(1, Hkv, T)}, us: {cuts}; as is at "
                  f"{', '.join(sweep)}")
            del sets
            torch.cuda.empty_cache()
        for proj, n_out in (("qkv", (Hq + 2 * Hkv) * d), ("o_proj", Hq * d)):
            for B in (1, 2, 5, 16):
                n = cs.n_sets(qc.hidden_size * n_out // 2)
                sets = [(torch.randn((B, qc.hidden_size), generator=gen, device="cuda").to(torch.bfloat16),)
                        + cs._gemv_weights(torch, int4, qc.hidden_size, n_out, gen) for _ in range(n)]
                cuts = ", ".join(f"{name} {timed('int4_fused.cu', name, sets, int4.int4_gemv):.2f}"
                                 for name in (*ABLATIONS["int4_fused.cu"], "as is"))
                int4.gemv_plan = lambda nb, O: (-(-O // 16), min(nb, int4.K4_MAX_CLUSTER))
                narrow = timed("int4_fused.cu", "16-column tiles", sets, int4.int4_gemv)
                int4.gemv_plan = real_gplan
                print(f"K4 {proj} B={B}, {int4.K4_COLS}-column tiles, us: {cuts}; with 16-column tiles {narrow:.2f}")
            del sets
            torch.cuda.empty_cache()
    finally:
        _build.load_library, da.decode_plan, int4.gemv_plan = real_load, real_plan, real_gplan
        da._COUNTERS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
