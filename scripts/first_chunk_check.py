"""chip_smoke.py's holds of the speculative fused first chunk (hold_first_chunk_replay, FIRST_CHUNK_REPLAY_TOL; the
first chunk with the path on against off, STREAM_TOL) read over several seeds; needs one CUDA card.

For each seed, the full-width CosyVoice2-0.5B engine with random weights from that seed (chip_smoke's phases build
seed 0) and chip_smoke's first-chunk prompt (a seeded 3 s voice, text 16): the first chunk's graph replay against its
eager body on the same inputs, with the two planted faults (lp shifted back by one, the source's draws skipped) read
beside it, and the first streamed chunk with the path on against the path off (same rng_seed), no tolerance
applied. Prints hold_first_chunk_replay's line per seed and one JSON line of the readings:

    python3 scripts/first_chunk_check.py [--seeds 0 1 2 3] [--lm bf16 | int4p | int4p_bf16]
"""

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LMS = {"bf16": {}, "int4p": {"quant": "int4p", "kv_quant": True}, "int4p_bf16": {"quant": "int4p"}}


def first_chunk(eng, prompt, text, on):
    """The first streamed chunk's wav with the path on or off (the stream then closed)."""
    prompt_text, prompt_speech, prompt_mel, emb = prompt
    saved, eng.speculative_first_chunk = eng.speculative_first_chunk, on
    try:
        stream = eng.tts(text, prompt_text, prompt_speech, prompt_speech, prompt_mel, emb, stream=True)
        wav = next(stream)["tts_speech"]
        stream.close()
    finally:
        eng.speculative_first_chunk = saved
    return wav


def main(argv):
    import numpy as np
    import torch

    import chip_smoke
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--lm", choices=list(LMS), default="bf16")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("first_chunk_check: no CUDA card")
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    cfg = LMConfig()
    cfg = dataclasses.replace(cfg, qwen=dataclasses.replace(cfg.qwen, **LMS[opts.lm]))
    out = []
    for seed in opts.seeds:
        eng = build_random_engine(seed, "cuda", cfg)
        prompt, text = chip_smoke._first_chunk_prompt(eng)
        got, faults = chip_smoke.hold_first_chunk_replay(eng, f"seed {seed}", prompt, hold=False)
        on, off = first_chunk(eng, prompt, text, True), first_chunk(eng, prompt, text, False)
        d = float(np.abs(on - off).max()) if on.shape == off.shape else math.inf
        print(f"seed {seed}: the first streamed chunk, path on against off: max |diff| {d:.3e} "
              f"(STREAM_TOL {chip_smoke.STREAM_TOL}; wav rms {float(np.sqrt(np.square(off).mean())):.3e})")
        out.append({"seed": seed, "replay_vs_eager": got, "planted_faults": faults, "on_vs_off_first_chunk": d,
                    "captures": eng.first_chunk.captures, "pool_mb": eng.first_chunk.pool_bytes / 1e6})
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "lm": opts.lm,
                      "FIRST_CHUNK_REPLAY_TOL": chip_smoke.FIRST_CHUNK_REPLAY_TOL,
                      "STREAM_TOL": chip_smoke.STREAM_TOL, "first_chunk_check": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
