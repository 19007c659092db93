"""Extract CAM++ x-vectors for a kaldi-style dir (wav.scp, utt2spk).

Counterpart of cosyvoice_tpu/tools/extract_embedding.py: the port's
frontend (runtime/api.load_frontend: CAM++ from the model dir's
campplus.msgpack, random weights without one) embeds each utterance at 16
kHz on the device; writes utt2embedding.pkl and spk2embedding.pkl (each
speaker's mean) into the dir, {id: float32 [192]}.

    python -m cosyvoice_tpu_torch.tools.extract_embedding --dir data/train \\
        [--model_dir MODEL] [--device cuda]
"""

import argparse
import pickle

import numpy as np


def read_scp(path: str) -> dict:
    with open(path) as f:
        return {k: v.strip() for k, v in (line.split(maxsplit=1) for line in f.read().splitlines())}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", required=True, help="kaldi-style dir with wav.scp and utt2spk")
    parser.add_argument("--model_dir", default="", help="model dir with a converted campplus.msgpack")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.runtime.api import load_frontend
    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    fe = load_frontend(args.model_dir, device=args.device)
    utt2wav = read_scp(f"{args.dir}/wav.scp")
    utt2spk = read_scp(f"{args.dir}/utt2spk")
    utt2embedding = {utt: fe._extract_spk_embedding(load_wav(path, 16000))[0] for utt, path in utt2wav.items()}
    spk2embedding = {}
    for utt, emb in utt2embedding.items():
        spk2embedding.setdefault(utt2spk[utt], []).append(emb)
    spk2embedding = {k: np.mean(v, axis=0) for k, v in spk2embedding.items()}
    with open(f"{args.dir}/utt2embedding.pkl", "wb") as f:
        pickle.dump(utt2embedding, f)
    with open(f"{args.dir}/spk2embedding.pkl", "wb") as f:
        pickle.dump(spk2embedding, f)
    print(f"wrote {len(utt2embedding)} utt embeddings, {len(spk2embedding)} spk embeddings")


if __name__ == "__main__":
    main()
