#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cosyvoice_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each under a hard time budget (the process exits non-zero if one is
exceeded, a kernel disagrees with its plain version, or anything raises):

1. device: the card's name and power limit; TF32 off for matmuls and convs.
2. build: both CUDA kernels, one nvcc call, timed.
3. kernels: K1 (flash-decode GQA) and K2 (KV-arena row write) against their
   plain PyTorch versions on the card, at the LM's decode shapes (B=1 and a
   ragged B=4, cur_len 0/27/511/512/513/4095), in bf16; kernel, plain and
   library device times (CUDA events around a replayed CUDA graph of 50
   calls) and eager host rates, and the bound from the bytes and
   operations of each call.
4. slice: the full-width CosyVoice2-0.5B offline engine, random weights from
   seed 0, serves 3 `tts(stream=False)` requests; wavs must be finite and
   n_tokens * 2 * 480 long, and the launch counters must show that every
   decode step went through K1 (24 per step) and K2 (48 per step).
5. check: the LM's kernel decode path against the same decode with the
   plain versions and against a full-prefix recompute of the same tokens
   (plain attention), logits within twice the floor that plain decode
   against the recompute shows.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a card it exits 2 and prints no result.
"""

import faulthandler
import json
import subprocess
import sys
import time

# K1 limit per case: two bf16 ulps at the case's largest |reference|. Kernel
# and plain version each round one fp32 result to bf16, and one bf16 ulp at
# |x| is at most 2**-7 * |x|.
K1_TOL_REL = 2**-6
# Relative L2 of LM logits, kernel decode against the same decode with the
# plain versions and against one prefill over the sequence: twice the floor,
# plain decode against that prefill, which is 9.6e-3 to 1.0e-2 on an H100 at
# full width (bf16 matmuls of M=1 and M=T round differently).
LOGIT_TOL = 0.02
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16

PHASE_BUDGET_S = {"device": 60, "build": 360, "kernels": 180, "slice": 420, "check": 120}


class Phase:
    """Hard time budget for one phase: faulthandler's watchdog thread dumps
    the stacks and exits the process if the phase overruns, even inside a
    CUDA call that never returns to the interpreter."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        faulthandler.dump_traceback_later(PHASE_BUDGET_S[self.name], exit=True)
        print(f"== phase {self.name} (budget {PHASE_BUDGET_S[self.name]} s)", flush=True)
        return self

    def __exit__(self, *exc):
        faulthandler.cancel_dump_traceback_later()
        print(f"== phase {self.name} done in {time.perf_counter() - self.t0:.1f} s", flush=True)
        return False


def cuda_ms(fn, iters=100, warmup=5):
    """Mean time per call of fn() in ms between CUDA events around `iters`
    eager calls: the rate at which the host launches the work (it includes
    the wrapper's Python and launch cost, as the decode loop pays it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=50, replays=20):
    """Device time per call of fn() in ms: `calls` calls captured in one CUDA
    graph and replayed `replays` times between CUDA events, so the host's
    launch cost is excluded."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32 set to False for cuda.matmul and cudnn (fp32 flow and vocoder run in full fp32)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")


def phase_build():
    from cosyvoice_tpu_torch.ops import _build

    info = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    print(f"kernels built in {info['seconds']:.1f} s -> {info['path']}")
    for ln in regs:
        print(f"  ptxas: {ln}")


def _arena_case(torch, B, T, Hq, Hkv, d, cur, gen, dead):
    """Random q and arenas with the dead region (positions > cur_len) set to
    `dead`, so any read of dead arena shows in the result."""
    dev = "cuda"
    q = torch.randn((B, Hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, T, Hkv, d), generator=gen, device=dev)
    v = torch.randn((B, T, Hkv, d), generator=gen, device=dev)
    live = torch.arange(T, device=dev)[None, :] <= cur[:, None]
    k = torch.where(live[..., None, None], k, torch.full_like(k, dead)).to(torch.bfloat16)
    v = torch.where(live[..., None, None], v, torch.full_like(v, dead)).to(torch.bfloat16)
    return q, k.contiguous(), v.contiguous()


def phase_kernels(cfg):
    """Hold K1 and K2 against their plain versions; time all three ways."""
    import torch

    from cosyvoice_tpu_torch.ops import decode_attention as da

    qc = cfg.qwen
    Hq, Hkv, d, T = qc.num_heads, qc.num_kv_heads, qc.head_dim, qc.max_cache_len
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = [0, 27, 511, 512, 513, 4095]
    cases = [[c] for c in lens] + [[0, 27, 513, 4095], [511, 512, 4095, 27]]

    k1_err = 0.0
    for cl in cases:
        cur = torch.tensor(cl, device="cuda", dtype=torch.int32)
        q, k, v = _arena_case(torch, len(cl), T, Hq, Hkv, d, cur, gen, dead=100.0)
        out = da.gqa_decode_attention(q, k, v, cur)
        ref = da.gqa_decode_attention_plain(q, k, v, cur)
        err = (out.float() - ref.float()).abs().max().item()
        tol = K1_TOL_REL * ref.float().abs().max().item()
        # NaN in the dead arena must not reach the output: the kernel never reads it
        kn = torch.where(k == 100.0, torch.full_like(k, float("nan")), k)
        vn = torch.where(v == 100.0, torch.full_like(v, float("nan")), v)
        out_nan = da.gqa_decode_attention(q, kn, vn, cur)
        torch.cuda.synchronize()
        if not torch.equal(out_nan, out):
            raise AssertionError(f"K1 read dead arena at cur_len={cl}")
        k1_err = max(k1_err, err)
        print(f"K1 B={len(cl)} cur_len={cl}: max_abs_err {err:.3e} (tol {tol:.3e} = 2 bf16 ulps at max |ref|)")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at cur_len={cl}: {err}")

    k2_err = 0.0
    for cl in cases:
        B = len(cl)
        pos = torch.tensor(cl, device="cuda", dtype=torch.int32)
        arena = torch.randn((B, T, Hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        new = torch.randn((B, 1, Hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        ref = da.kv_arena_write_plain(arena.clone(), new, pos)
        out = da.kv_arena_write(arena.clone(), new, pos)
        err = (out.float() - ref.float()).abs().max().item()
        k2_err = max(k2_err, err)
        if err != 0.0:
            raise AssertionError(f"K2 disagrees with its plain version at pos={cl}: {err}")
    print(f"K2 {len(cases)} cases (B=1 and ragged B=4): max_abs_err {k2_err} (tol 0, exact copy)")

    # timing at the decode shape: B=1, T=max_cache_len, a mid-utterance
    # cur_len, rotating over one arena pair per layer as a decode step does
    n_layers, cur_t = qc.num_layers, 1023
    cur = torch.tensor([cur_t], device="cuda", dtype=torch.int32)
    arenas = [_arena_case(torch, 1, T, Hq, Hkv, d, cur, gen, dead=0.0) for _ in range(n_layers)]
    it = {"i": 0}

    def rot(fn):
        def call():
            q, k, v = arenas[it["i"] % n_layers]
            it["i"] += 1
            return fn(q, k, v, cur)
        return call

    mask = (torch.arange(T, device="cuda") <= cur_t)[None, None, None, :]

    def sdpa(q, k, v, c):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    k1_fns = {"kernel": rot(da.gqa_decode_attention), "plain": rot(da.gqa_decode_attention_plain),
              "library": rot(sdpa)}
    live = cur_t + 1
    k1_bytes = 2 * Hq * d * 2 + 2 * live * Hkv * d * 2 + 4
    k1_bound, k1_by = bound(k1_bytes, 4 * live * Hq * d)

    F = Hkv * d
    arena = torch.randn((1, T, Hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    new = torch.randn((1, 1, Hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    flat_idx = cur.long()  # row b*T + pos[b] of the [B*T, F] view, B=1
    k2_fns = {
        "kernel": lambda: da.kv_arena_write(arena, new, cur),
        "plain": lambda: da.kv_arena_write_plain(arena, new, cur),
        "library": lambda: arena.view(T, F).index_copy_(0, flat_idx, new.view(1, F)),
    }
    k2_bound, k2_by = bound(2 * F * 2 + 4, 0)

    dev_ms, host_ms = {}, {}
    for key, fns in (("K1", k1_fns), ("K2", k2_fns)):
        dev_ms[key] = {name: graph_ms(fn) for name, fn in fns.items()}
        host_ms[key] = {name: cuda_ms(fn) for name, fn in fns.items()}
    k1_ms, k1_plain, k1_lib = (dev_ms["K1"][n] for n in ("kernel", "plain", "library"))
    k2_ms, k2_plain, k2_lib = (dev_ms["K2"][n] for n in ("kernel", "plain", "library"))

    kernels = {
        "K1": {
            "name": "gqa_decode_attention", "route": "cuda",
            "source": "cosyvoice_tpu_torch/csrc/decode_attention.cu",
            "replaces": "cosyvoice_tpu/ops/decode_attention.py:290",
            "launches": None, "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
        },
        "K2": {
            "name": "kv_arena_write", "route": "cuda",
            "source": "cosyvoice_tpu_torch/csrc/decode_attention.cu",
            "replaces": "cosyvoice_tpu/ops/decode_attention.py:447",
            "launches": None, "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
        },
    }
    for key, k in kernels.items():
        eager = ", ".join(f"{n} {v * 1e3:.2f} us" for n, v in host_ms[key].items())
        print(
            f"{key} {k['name']} device time per call: {k['ms'] * 1e3:.2f} us, plain {k['plain_ms'] * 1e3:.2f} us, "
            f"library {k['library_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.4f} us ({k['bound_by']}); eager host rate: {eager}"
        )
    return kernels


def build_engine():
    import torch

    from cosyvoice_tpu_torch.runtime.engine import build_random_engine

    t0 = time.perf_counter()
    eng = build_random_engine(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_lm = sum(p.numel() for p in eng.lm.module.parameters())
    n_fh = sum(p.numel() for m in (eng.flow, eng.hift) for p in m.parameters())
    print(f"full-width engine from seed 0 in {time.perf_counter() - t0:.1f} s: LM {n_lm / 1e6:.1f}M params, "
          f"flow+HiFT {n_fh / 1e6:.1f}M params")
    return eng


def phase_slice(eng, text_lens=(16, 32, 48), n_prompt_speech=50, n_prompt_mel=100):
    """Serve offline requests through CosyVoice2Engine.tts; check each wav and
    that every decode step went through K1 and K2. Returns (prompt, requests,
    launches)."""
    import numpy as np

    from cosyvoice_tpu_torch.ops import decode_attention as da

    c = eng.lm.cfg
    rng = np.random.default_rng(0)
    prompt_text = rng.integers(0, c.qwen.vocab_size, 10)
    prompt_speech = rng.integers(0, min(c.speech_token_size, eng.flow.cfg.vocab_size), n_prompt_speech)
    prompt_mel = (rng.standard_normal((1, n_prompt_mel, 80)) - 5.0).astype(np.float32)
    emb = rng.standard_normal((1, 192)).astype(np.float32)

    def request(n_text):
        text = rng.integers(0, c.qwen.vocab_size, n_text)
        (out,) = list(eng.tts(text, prompt_text, prompt_speech, prompt_speech, prompt_mel, emb, stream=False))
        return text, out

    request(4)  # warm-up: first launches, cuDNN algorithm choice; not counted
    da.gqa_decode_attention.launches = 0
    da.kv_arena_write.launches = 0
    eng.lm.decode_steps = 0
    reqs = []
    for n_text in text_lens:
        eng.timer.reset()
        t = time.perf_counter()
        text, out = request(n_text)
        wall = time.perf_counter() - t
        wav, toks = out["tts_speech"], out["speech_tokens"]
        if not np.isfinite(wav).all():
            raise AssertionError(f"request text={n_text}: non-finite wav")
        if wav.shape != (1, len(toks) * 2 * 480):
            raise AssertionError(f"request text={n_text}: wav {wav.shape} for {len(toks)} tokens")
        lm_s, t2w_s = eng.timer.records["lm"][-1], sum(eng.timer.records["t2w"])
        audio_s = wav.shape[1] / 24000
        rtf = f"{wall / audio_s:.4f}" if audio_s else "n/a (no audio)"
        print(f"request text={n_text}: {len(toks)} tokens, LM {len(toks) / lm_s:.1f} tok/s ({lm_s * 1e3:.0f} ms), "
              f"flow+HiFT {t2w_s * 1e3:.1f} ms, audio {audio_s:.2f} s, wall {wall * 1e3:.0f} ms, RTF {rtf}")
        reqs.append((text, toks))
    launches = {"K1": da.gqa_decode_attention.launches, "K2": da.kv_arena_write.launches}
    steps, L = eng.lm.decode_steps, c.qwen.num_layers
    print(f"decode steps {steps}: K1 launches {launches['K1']} (want {L * steps}), "
          f"K2 launches {launches['K2']} (want {2 * L * steps})")
    if eng.device.type == "cuda" and (steps == 0 or launches["K1"] != L * steps or launches["K2"] != 2 * L * steps):
        raise AssertionError("the decode steps did not all go through K1 and K2")
    return (prompt_text, prompt_speech), reqs, launches


def phase_check(eng, prompt, reqs, n_tokens=96):
    """LM logits after decoding generated tokens through the kernels, against
    the same decode with the plain versions swapped in, and against one
    prefill over the whole sequence (plain attention): relative L2 error
    after the first and after the last step. Plain decode against the
    prefill is the floor: the bf16 drift of two paths with exact attention."""
    import numpy as np
    import torch

    from cosyvoice_tpu_torch.models import qwen2
    from cosyvoice_tpu_torch.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT
    from cosyvoice_tpu_torch.ops import decode_attention as da

    c, m, dev = eng.lm.cfg, eng.lm.module, eng.device
    prompt_text, prompt_speech = prompt
    text, toks = max(reqs, key=lambda r: len(r[1]))
    toks = np.asarray(toks[:n_tokens], np.int64)
    if len(toks) == 0:
        raise AssertionError("no request generated a token to check")
    ids = np.concatenate([[c.sos_id], prompt_text, text, [c.task_id], prompt_speech]).astype(np.int64)
    types = np.concatenate([[TYPE_SPECIAL], np.full(len(prompt_text) + len(text), TYPE_TEXT), [TYPE_SPECIAL],
                            np.full(len(prompt_speech), TYPE_SPEECH)]).astype(np.int64)
    T, n = len(ids), len(toks)

    def prefill(i, t):
        return m.prefill(torch.as_tensor(i[None], device=dev), torch.as_tensor(t[None], device=dev),
                         torch.tensor([len(i)], device=dev), eng.lm.init_cache(1))

    def decode_logits():
        """Logits after the first and after the last decode step."""
        logits, cache = prefill(ids, types)
        seen = []
        for i, t in enumerate(toks):
            logits, cache = m.decode_step(torch.tensor([int(t)], device=dev),
                                          torch.tensor([T + i], dtype=torch.int32, device=dev), cache)
            if i in (0, n - 1):
                seen.append(logits)
        return seen[0], seen[-1]

    def full_logits(k):
        logits, _ = prefill(np.concatenate([ids, toks[:k]]), np.concatenate([types, np.full(k, TYPE_SPEECH)]))
        return logits

    with torch.inference_mode():
        kern = decode_logits()
        saved = qwen2.gqa_decode_attention, qwen2.kv_arena_write
        qwen2.gqa_decode_attention, qwen2.kv_arena_write = da.gqa_decode_attention_plain, da.kv_arena_write_plain
        try:
            plain = decode_logits()
        finally:
            qwen2.gqa_decode_attention, qwen2.kv_arena_write = saved
        full = full_logits(1), full_logits(n)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    e_plain, e_floor, e_full = ([rel(a[j], b[j]) for j in (0, 1)] for a, b in ((kern, plain), (plain, full),
                                                                              (kern, full)))
    print(f"LM logits rel L2 after 1 / {n} decode steps: kernel vs plain decode {e_plain[0]:.2e} / {e_plain[1]:.2e} "
          f"(tol {LOGIT_TOL}); floor, plain decode vs one prefill {e_floor[0]:.2e} / {e_floor[1]:.2e}; "
          f"kernel vs one prefill {e_full[0]:.2e} / {e_full[1]:.2e} (tol {LOGIT_TOL}); argmax after {n} "
          f"agrees: {int(kern[1].argmax()) == int(plain[1].argmax())}, {int(kern[1].argmax()) == int(full[1].argmax())}")
    if not max(e_plain + e_full) <= LOGIT_TOL:
        raise AssertionError("LM decode through the kernels disagrees with the plain path")


def main(argv):
    import torch

    sys.stdout.reconfigure(line_buffering=True)  # keep every line if a phase budget ends the process

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one GPU", file=sys.stderr)
        return 2
    from cosyvoice_tpu_torch.models.llm import LMConfig

    with Phase("device"):
        phase_device()
    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        kernels = phase_kernels(LMConfig())
    with Phase("slice"):
        eng = build_engine()
        prompt, reqs, launches = phase_slice(eng)
    with Phase("check"):
        phase_check(eng, prompt, reqs)
    for key, n in launches.items():
        kernels[key]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
