"""chip_smoke.py's one-pass hold of a CosyVoice3 stream (hold_whole_v3, V3_WHOLE_TOL) read over several seeds; needs
one CUDA card.

For each seed, the full-width Fun-CosyVoice3-0.5B engine with random weights from that seed (chip_smoke's stream_v3
builds seed 0) streams one text of V3_LONG_TEXT random ids (from seed 11, as stream_v3's) with chip_smoke's prompt,
on graphs, cuDNN deterministic; the session crosses flow_incr_min_tok and takes the incremental DiT flow. The chunks,
concatenated, are held against one pass over the same tokens under the streaming masks with no tolerance applied.
Prints hold_whole_v3's line per seed and one JSON line of the readings beside V3_WHOLE_TOL:

    python3 scripts/v3_whole_check.py [--seeds 0 1 2 3]
"""

import argparse
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main(argv):
    import numpy as np
    import torch

    import chip_smoke
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine_v3

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3])
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("v3_whole_check: no CUDA card")
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    out = []
    torch.backends.cudnn.deterministic = True
    for seed in opts.seeds:
        eng = build_random_engine_v3(seed, "cuda")
        prompt = chip_smoke._prompt(eng)[0]
        text = np.random.default_rng(11).integers(0, eng.lm.cfg.qwen.vocab_size, chip_smoke.V3_LONG_TEXT)
        eng.flow_state_max_bytes = 0
        run = chip_smoke._stream_once(eng, prompt, text, False)
        toks = np.concatenate([c["speech_tokens"] for c in run["chunks"]])
        wav, d = chip_smoke.hold_whole_v3(eng, f"seed {seed}", prompt, toks, run["chunks"], tol=math.inf)
        out.append({"seed": seed, "tokens": int(len(toks)), "paths": sorted({c["path"] for c in run["log"]}),
                    "flow_state_bytes": int(eng.flow_state_max_bytes), "max_abs_diff": d,
                    "wav_rms": float(np.sqrt(np.square(wav, dtype=np.float64).mean()))})
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "V3_WHOLE_TOL": chip_smoke.V3_WHOLE_TOL,
                      "v3_whole_check": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
