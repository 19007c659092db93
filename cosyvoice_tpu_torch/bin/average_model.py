"""Average the best-N checkpoints by CV loss into one model file.

Counterpart of cosyvoice_tpu/bin/average_model.py: the checkpoints of
`--model_name` in `--src_dir` with the lowest cv_loss in their sidecars
(train/executor.select_best_checkpoints), averaged leafwise in float64
(average_checkpoints: summed in float64 on --device, the card unless
"cpu" is asked for) and written as flax msgpack (utils/msgpack_io.py),
which both packages' APIs load as lm.msgpack / flow.msgpack. A GAN
checkpoint ({"generator", "discriminator"}) keeps the generator.

    python -m cosyvoice_tpu_torch.bin.average_model --src_dir exp/llm --model_name llm \\
        --num 5 --dst_model exp/llm/lm.msgpack [--device cuda]
"""

import argparse

from cosyvoice_tpu_torch.train.executor import average_checkpoints, select_best_checkpoints
from cosyvoice_tpu_torch.utils import msgpack_io
from cosyvoice_tpu_torch.utils.devices import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src_dir", required=True)
    parser.add_argument("--model_name", default="llm")
    parser.add_argument("--num", type=int, default=5)
    parser.add_argument("--dst_model", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    paths = select_best_checkpoints(args.src_dir, args.model_name, args.num)
    if not paths:
        raise FileNotFoundError(f"no checkpoints with cv_loss sidecars in {args.src_dir}")
    avg = average_checkpoints(paths, device)
    if set(avg) == {"generator", "discriminator"}:
        avg = avg["generator"]  # the runtime loads the generator as hift.msgpack
    msgpack_io.write(args.dst_model, avg)
    print(f"averaged {len(paths)} checkpoints -> {args.dst_model}")
    return paths


if __name__ == "__main__":
    main()
