"""The first generator and discriminator steps of chip_smoke.py's GAN_CUT held against float32 on the host, under each
cuDNN setting, seed and rate fault asked for; needs one CUDA card.

GAN_CUT is the CosyVoice2 24 kHz HiFT (512 channels, one resblock kernel a stage) against the MPD over all five periods
and the first MRD resolution, one row of chip_smoke's GAN batch, TF32 off. Seed s draws the weights from bin/train.py's
default seed plus s and makes the GAN rows from seed s: seed 0 is chip_smoke's check. cuDNN settings:

  off            cuDNN disabled: PyTorch's own CUDA convolutions (chip_smoke's GAN_HOST_CUDNN)
  deterministic  cuDNN's deterministic algorithms
  default        cuDNN's default algorithms

--lr_scale multiplies the card's learning rate (both optimizers) by each factor given: 1 is the held step, and other
factors are faults that GAN_STEP_TOL must refuse. Prints hold_step_on_host's line per run and step (relative errors
of the loss, the gradient norm, the update and the update's scale; no tolerance applied), then one JSON line of them
all, each run beside whether GAN_STEP_TOL passes it:

    python3 scripts/gan_host_check.py [--cudnn off deterministic default] [--seeds 0 1 2] [--lr_scale 1 0.5 1.5]
"""

import argparse
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SETTINGS = {"off": {"enabled": False, "deterministic": False, "benchmark": False},
            "deterministic": {"enabled": True, "deterministic": True, "benchmark": False},
            "default": {"enabled": True, "deterministic": False, "benchmark": False}}


def main(argv):
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--cudnn", nargs="+", choices=list(SETTINGS), default=["off"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--lr_scale", nargs="+", type=float, default=[1.0])
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gan_host_check: no CUDA card")
    chip_smoke.phase_device()
    keys = ("loss", "grad_norm", "update", "scale")
    no_tol = dict.fromkeys(("gen", "disc"), dict.fromkeys(keys, math.inf))
    out = []
    for seed in opts.seeds:
        args = chip_smoke.train_args("hifigan", *chip_smoke.GAN_FLAGS)
        args.seed += seed
        batch = chip_smoke._gan_batches(args, seed)[0]
        for name in opts.cudnn:
            for scale in opts.lr_scale:
                sides = chip_smoke.gan_cut_on_both(args, batch, torch.device("cuda"))
                card = sides[0]
                for opt in (card.g_opt, card.d_opt):
                    opt.sched = (lambda sched: lambda count: scale * sched(count))(opt.sched)
                print(f"== seed {seed}, cuDNN {name}, the card's learning rate x {scale}")
                errs = chip_smoke.hold_gan_step_on_host(*sides, SETTINGS[name], no_tol)
                held = all(errs[s][k] <= chip_smoke.GAN_STEP_TOL[s].get(k, math.inf) for s in errs for k in keys)
                out.append({"seed": seed, "cudnn": name, "lr_scale": scale, "errors": errs, "passes_GAN_STEP_TOL": held})
                del sides, card
                torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "gan_host_check": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
