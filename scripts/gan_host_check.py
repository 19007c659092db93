"""The first generator and discriminator steps of chip_smoke.py's GAN_CUT held against float32 on the host under each
cuDNN setting asked for; needs one CUDA card.

GAN_CUT is the CosyVoice2 24 kHz HiFT (512 channels, one resblock kernel a stage) against the MPD over all five periods
and the first MRD resolution, one row of chip_smoke's GAN batch, random weights from bin/train.py's seed, TF32 off.
Settings:

  off            cuDNN disabled: PyTorch's own CUDA convolutions (chip_smoke's GAN_HOST_CUDNN)
  deterministic  cuDNN's deterministic algorithms
  default        cuDNN's default algorithms

Prints hold_step_on_host's line per setting and step (relative errors of the loss, the gradient norm and the update;
no tolerance applied), then one JSON line of them all:

    python3 scripts/gan_host_check.py [off] [deterministic] [default]
"""

import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SETTINGS = {"off": {"enabled": False, "deterministic": False, "benchmark": False},
            "deterministic": {"enabled": True, "deterministic": True, "benchmark": False},
            "default": {"enabled": True, "deterministic": False, "benchmark": False}}


def main(names):
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("gan_host_check: no CUDA card")
    chip_smoke.phase_device()
    args = chip_smoke.train_args("hifigan", *chip_smoke.GAN_FLAGS)
    batch = chip_smoke._gan_batches(args)[0]
    no_tol = dict.fromkeys(("gen", "disc"), dict.fromkeys(("loss", "grad_norm", "update"), math.inf))
    out = {}
    for name in names or list(SETTINGS):
        sides = chip_smoke.gan_cut_on_both(args, batch, torch.device("cuda"))
        out[name] = chip_smoke.hold_gan_step_on_host(*sides, SETTINGS[name], no_tol)
        del sides
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "gan_host_check": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
