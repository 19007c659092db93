"""Build the GRPO prompt jsonl from kaldi-style `text` files: one
{"utt": ..., "text": ...} prompt per training utterance for the rollouts.

    python -m cosyvoice_tpu_torch.examples.grpo.cosyvoice2.prepare_data \\
        --text data/train/text [data/dev/text ...] --out prompts.jsonl
"""

import argparse
import json


def main(argv=None) -> int:
    """Writes the jsonl; returns the number of prompts written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--text", nargs="+", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--max_chars", type=int, default=200)
    args = parser.parse_args(argv)

    n = 0
    with open(args.out, "w") as out:
        for path in args.text:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(maxsplit=1)
                    if len(parts) != 2 or len(parts[1]) > args.max_chars:
                        continue
                    out.write(json.dumps({"utt": parts[0], "text": parts[1]}, ensure_ascii=False) + "\n")
                    n += 1
    print(f"{args.out}: {n} prompts")
    return n


if __name__ == "__main__":
    main()
