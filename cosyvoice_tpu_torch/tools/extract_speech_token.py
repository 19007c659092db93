"""Extract S3 speech tokens for a kaldi-style dir (wav.scp).

Counterpart of cosyvoice_tpu/tools/extract_speech_token.py: the port's
frontend (runtime/api.load_frontend: the S3 tokenizer of the model dir's
config.json "frontend": {"s3": ...} and speech_tokenizer.msgpack, random
weights without one) tokenizes each utterance at 16 kHz on the device,
skipping those over 30 s; writes utt2speech_token.pkl, {utt: [int]}.

    python -m cosyvoice_tpu_torch.tools.extract_speech_token --dir data/train \\
        [--model_dir MODEL] [--device cuda]
"""

import argparse
import pickle

from cosyvoice_tpu_torch.tools.extract_embedding import read_scp


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", required=True, help="kaldi-style dir with wav.scp")
    parser.add_argument("--model_dir", default="", help="model dir with a converted speech_tokenizer.msgpack "
                        "and config.json's frontend.s3 section")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.runtime.api import load_frontend
    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    fe = load_frontend(args.model_dir, device=args.device)
    utt2token = {}
    for utt, path in read_scp(f"{args.dir}/wav.scp").items():
        wav = load_wav(path, 16000)
        if wav.shape[1] / 16000 > 30:
            print(f"skip {utt}: longer than 30s")
            continue
        utt2token[utt] = fe._extract_speech_token(wav).tolist()
    with open(f"{args.dir}/utt2speech_token.pkl", "wb") as f:
        pickle.dump(utt2token, f)
    print(f"wrote {len(utt2token)} token sequences")


if __name__ == "__main__":
    main()
