"""HTTP client of the server's JSON endpoints.

Counterpart of cosyvoice_tpu/serving/http_client.py (the reference's
runtime/python/fastapi/client.py):

    python -m cosyvoice_tpu_torch.serving.http_client --mode zero_shot --tts_text "..." \
        --prompt_text "..." --prompt_wav prompt.wav --out out.wav
"""

import argparse
import base64
import http.client
import json

import numpy as np


def request(host: str, port: int, endpoint: str, body: dict, timeout: float = 600.0) -> np.ndarray:
    """POST `body` to /`endpoint`; the response's int16 PCM samples."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", f"/{endpoint}", json.dumps(body))
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
    return np.frombuffer(data, np.int16)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=50000)
    parser.add_argument("--mode", default="zero_shot", choices=["sft", "zero_shot", "cross_lingual", "instruct",
                                                                  "instruct2"])
    parser.add_argument("--tts_text", default="Hello, this is a test.")
    parser.add_argument("--prompt_text", default="A prompt.")
    parser.add_argument("--prompt_wav", default="")
    parser.add_argument("--spk_id", default="")
    parser.add_argument("--instruct_text", default="")
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--out", default="out.wav")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.utils.audio_io import load_wav, save_wav

    body = {"tts_text": args.tts_text, "stream": args.stream}
    if args.prompt_wav:
        wav = load_wav(args.prompt_wav, 16000)
        body["prompt_audio_b64"] = base64.b64encode((np.clip(wav[0], -1, 1) * 32767).astype(np.int16).tobytes()).decode()
    if args.mode in ("sft", "instruct"):
        body["spk_id"] = args.spk_id
    if args.mode == "zero_shot":
        body["prompt_text"] = args.prompt_text
    if args.mode in ("instruct", "instruct2"):
        body["instruct_text"] = args.instruct_text
    pcm = request(args.host, args.port, f"inference_{args.mode}", body)
    save_wav(args.out, pcm.astype(np.float32) / 32767.0, 24000)
    print(f"wrote {args.out} ({len(pcm) / 24000:.2f}s)")


if __name__ == "__main__":
    main()
