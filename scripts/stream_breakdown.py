"""Where a streamed request's time goes on one card: token->wav alone against token->wav beside the LM; needs one
CUDA card.

For the full-width engine with the bf16 LM and with the int4p LM over a bf16 arena (K7), random weights from seed 0,
chip_smoke.py's prompt and its text-16 and text-48 requests (320 and 960 tokens) are streamed four ways (cuDNN
deterministic, TF32 off):

  alone           the request's tokens, decoded beforehand, fed to the stream as finished 28-token blocks: token->wav
                  with no LM on the card;
  alone, traced   the same under torch.profiler (utils/profiling.py:device_idle): token->wav's device busy ms and
                  idle share;
  LM, priority 0  the real stream, the token->wav CUDA stream at the LM's (default) priority;
  LM, priority -1 the engine's default: the token->wav stream at the higher priority.

Prints per mode each chunk's path, tokens and wall ms, the first-chunk ms, the stream's wall ms and RTF and the LM's
tokens/s, then one JSON line of them all:

    python3 scripts/stream_breakdown.py
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

TEXTS = (16, 48)


def main():
    import numpy as np
    import torch

    import chip_smoke
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine
    from cosyvoice_tpu_torch.utils.profiling import device_idle

    if not torch.cuda.is_available():
        print("stream_breakdown: needs one GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    bf16 = LMConfig()
    out = {}
    for name, cfg in (("bf16", bf16), ("int4p_bf16 (K7)", dataclasses.replace(
            bf16, qwen=dataclasses.replace(bf16.qwen, quant="int4p")))):
        eng = build_random_engine(0, "cuda", cfg)
        prompt, rng = chip_smoke._prompt(eng)
        prompt_text, prompt_speech, prompt_mel, emb = prompt
        vocab = cfg.qwen.vocab_size
        texts = {}
        for n in (4, 16, 32, 48):  # chip_smoke's phase_slice draws these texts in this order
            texts[n] = rng.integers(0, vocab, n)
        list(eng.tts(texts[4], prompt_text, prompt_speech, prompt_speech, prompt_mel, emb, stream=True))  # warm-up
        high = eng._t2w_stream
        for n_text in TEXTS:
            text = texts[n_text]
            (off,) = list(eng.tts(text, prompt_text, prompt_speech, prompt_speech, prompt_mel, emb))
            toks = off["speech_tokens"]
            blocks = [toks[i : i + 28] for i in range(0, len(toks), 28)]
            audio_s = len(toks) * 2 * 480 / 24000

            def alone():
                t = time.perf_counter()
                chunks = list(eng._stream((b for b in blocks), t, prompt_speech, prompt_mel, emb))
                return chunks, (time.perf_counter() - t) * 1e3, list(eng.stream_log)

            modes = {}
            chunks, wall, log = alone()
            modes["alone"] = {"wall_ms": wall, "chunks": log}
            _, stats = device_idle(alone, eng.device)
            modes["alone, traced"] = {"busy_ms": stats["busy_ms"], "window_ms": stats["window_ms"],
                                      "idle_share": stats["idle_share"], "events": stats["events"]}
            for mode, stream in (("LM, priority 0", torch.cuda.Stream(eng.device, priority=0)),
                                 ("LM, priority -1", high)):
                eng._t2w_stream = stream
                r = chip_smoke._stream_once(eng, prompt, text, False)
                got = np.concatenate([c["speech_tokens"] for c in r["chunks"]])
                if not np.array_equal(got, toks):
                    raise AssertionError(f"{name} text={n_text} {mode}: the streamed tokens differ")
                modes[mode] = {"wall_ms": r["wall_ms"], "first_ms": r["first_ms"], "lm_tok_s": len(toks) / r["lm_s"],
                               "chunks": r["log"]}
            eng._t2w_stream = high
            for mode, m in modes.items():
                if "chunks" in m:
                    per = "; ".join(f"{c['path']} {c['tokens']} {c['wall_ms']:.1f}" for c in m["chunks"])
                    extra = f", first chunk {m['first_ms']:.1f} ms, LM {m['lm_tok_s']:.1f} tok/s" if "first_ms" in m \
                        else ""
                    print(f"{name} text={n_text} ({len(toks)} tokens) {mode}: wall {m['wall_ms']:.0f} ms, RTF "
                          f"{m['wall_ms'] / 1e3 / audio_s:.4f}{extra}; chunks (path tokens wall-ms): {per}")
                else:
                    print(f"{name} text={n_text} {mode}: device busy {m['busy_ms']:.1f} ms of a "
                          f"{m['window_ms']:.1f} ms window, idle {m['idle_share']:.4f}, {m['events']} device events")
            out[f"{name} text={n_text}"] = modes
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
