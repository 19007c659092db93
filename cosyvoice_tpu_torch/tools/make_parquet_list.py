"""Pack a kaldi-style dir's utterances into parquet shards and a data list.

Counterpart of cosyvoice_tpu/tools/make_parquet_list.py: rows of utt,
text, audio (float32 at --sample_rate), sample_rate, utt_embedding and
speech_token (from tools/extract_embedding.py and
tools/extract_speech_token.py), instruct where the dir has an `instruct`
file, reject_speech_token with --dpo (from <src_dir>_reject); writes
parquet_<n>.tar.parquet shards and data.list into --des_dir.
data/processor.parquet_opener reads them. pyarrow is imported inside
`main`, the port's one writer of parquet. Host work: it touches no card.

    python -m cosyvoice_tpu_torch.tools.make_parquet_list --src_dir data/train \\
        --des_dir data/train/parquet [--num_utts_per_parquet 1000] [--dpo]
"""

import argparse
import os
import pickle

import numpy as np

from cosyvoice_tpu_torch.tools.extract_embedding import read_scp


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src_dir", required=True)
    parser.add_argument("--des_dir", required=True)
    parser.add_argument("--num_utts_per_parquet", type=int, default=1000)
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--dpo", action="store_true",
                        help="attach reject_speech_token from <src_dir>_reject/utt2speech_token.pkl")
    args = parser.parse_args(argv)

    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("make_parquet_list needs the pyarrow package to write parquet shards") from e

    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    d = args.src_dir
    utt2wav, utt2text = read_scp(f"{d}/wav.scp"), read_scp(f"{d}/text")
    with open(f"{d}/utt2embedding.pkl", "rb") as f:
        utt2embedding = pickle.load(f)
    with open(f"{d}/utt2speech_token.pkl", "rb") as f:
        utt2token = pickle.load(f)
    utt2instruct = read_scp(f"{d}/instruct") if os.path.exists(f"{d}/instruct") else None
    utt2reject = {}
    if args.dpo:
        with open(f"{d}_reject/utt2speech_token.pkl", "rb") as f:
            utt2reject = pickle.load(f)

    os.makedirs(args.des_dir, exist_ok=True)
    utts = [u for u in utt2wav if u in utt2text and u in utt2embedding and u in utt2token]
    if utt2instruct is not None:  # a partial instruct file must not fail mid-shard
        utts = [u for u in utts if u in utt2instruct]
    if args.dpo:
        utts = [u for u in utts if u in utt2reject]
    paths = []
    for shard_i in range(0, len(utts), args.num_utts_per_parquet):
        shard = utts[shard_i : shard_i + args.num_utts_per_parquet]
        rows = {"utt": [], "text": [], "audio": [], "sample_rate": [], "utt_embedding": [], "speech_token": []}
        if utt2instruct is not None:
            rows["instruct"] = []
        if args.dpo:
            rows["reject_speech_token"] = []
        for u in shard:
            rows["utt"].append(u)
            rows["text"].append(utt2text[u])
            rows["audio"].append(load_wav(utt2wav[u], args.sample_rate)[0].tolist())
            rows["sample_rate"].append(args.sample_rate)
            rows["utt_embedding"].append(np.asarray(utt2embedding[u], np.float32).tolist())
            rows["speech_token"].append(list(utt2token[u]))
            if utt2instruct is not None:
                rows["instruct"].append(utt2instruct[u])
            if args.dpo:
                rows["reject_speech_token"].append(list(utt2reject[u]))
        path = os.path.join(args.des_dir, f"parquet_{shard_i // args.num_utts_per_parquet:09d}.tar.parquet")
        pq.write_table(pa.table(rows), path)
        paths.append(path)
        print(f"wrote {path} ({len(shard)} utts)")
    with open(os.path.join(args.des_dir, "data.list"), "w") as f:
        f.write("\n".join(paths) + "\n")


if __name__ == "__main__":
    main()
