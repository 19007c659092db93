"""HTTP serving over the standard library.

Counterpart of the stdlib route of cosyvoice_tpu/serving/http_server.py
(the reference's runtime/python/fastapi/server.py endpoints):

- POST /inference_sft, /inference_zero_shot, /inference_cross_lingual,
  /inference_instruct, /inference_instruct2 with a JSON body
  ({"tts_text": ..., "prompt_text": ..., "prompt_audio_b64": <base64 int16
  PCM at 16 kHz>, "spk_id": ..., "instruct_text": ..., "stream": ...}):
  the model's chunks as raw int16 PCM at its sample rate, one HTTP chunk
  each (chunked transfer encoding); 400 with the error's text on a bad
  body or endpoint;
- GET /metrics: requests per endpoint, audio seconds served and the
  engine's per-stage wall-time percentiles (StageTimer.summary); POST
  /metrics/reset clears them; GET / the browser page (web_page.py); 404
  otherwise.

Each server counts its own requests. With `--max_batch` the model serves
concurrent requests through one batched LM decode loop
(CosyVoice2.enable_continuous_batching); the server's threads take one
request each. Without it the model runs the requests one at a time, and
a request that arrives during another waits for its turn.

    python -m cosyvoice_tpu_torch.serving.http_server --max_batch 4 [--port 50000] [--model_dir DIR]
"""

import argparse
import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cosyvoice_tpu_torch.serving.web_page import render


def _pcm(wav: np.ndarray) -> bytes:
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes()


def _wav_from_b64(b64: str) -> np.ndarray:
    raw = base64.b64decode(b64)
    return (np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0)[None, :]


class Metrics:
    """A server's request counters and audio seconds, updated by its
    handler threads."""

    def __init__(self):
        self.requests = {}
        self.audio_seconds = 0.0
        self._lock = threading.Lock()

    def count(self, endpoint: str):
        with self._lock:
            self.requests[endpoint] = self.requests.get(endpoint, 0) + 1

    def add_audio(self, seconds: float):
        with self._lock:
            self.audio_seconds += seconds

    def summary(self, model) -> dict:
        with self._lock:
            out = {"requests": dict(self.requests), "audio_seconds": self.audio_seconds}
        timer = getattr(getattr(model, "engine", None), "timer", None)
        if timer is not None:
            out["stages"] = timer.summary()
        return out

    def reset(self, model) -> dict:
        """Clear the counters and the engine's StageTimer, so that a
        benchmark window starts clean."""
        with self._lock:
            self.requests.clear()
            self.audio_seconds = 0.0
        timer = getattr(getattr(model, "engine", None), "timer", None)
        if timer is not None:
            timer.reset()
        return {"ok": True}


def _truthy(v) -> bool:
    """Form values arrive as strings: 'false' and '0' must not enable
    streaming the way bool('false') would."""
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _dispatch(model, endpoint: str, body: dict):
    stream = _truthy(body.get("stream", False))
    if endpoint == "inference_sft":
        return model.inference_sft(body["tts_text"], body["spk_id"], stream=stream)
    if endpoint == "inference_zero_shot":
        return model.inference_zero_shot(body["tts_text"], body.get("prompt_text", ""),
                                         _wav_from_b64(body["prompt_audio_b64"]), stream=stream)
    if endpoint == "inference_cross_lingual":
        return model.inference_cross_lingual(body["tts_text"], _wav_from_b64(body["prompt_audio_b64"]), stream=stream)
    if endpoint == "inference_instruct":
        return model.inference_instruct(body["tts_text"], body["spk_id"], body["instruct_text"], stream=stream)
    if endpoint == "inference_instruct2":
        return model.inference_instruct2(body["tts_text"], body["instruct_text"],
                                         _wav_from_b64(body["prompt_audio_b64"]), stream=stream)
    raise KeyError(endpoint)


def make_stdlib_server(model, host: str = "0.0.0.0", port: int = 50000) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer serving `model` (port 0: a free port, see
    `server_address`); its counters are `server.metrics`."""
    metrics = Metrics()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, payload: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802
            path = self.path.split("?")[0].strip("/")
            if path == "metrics":
                self._send(json.dumps(metrics.summary(model)).encode(), "application/json")
            elif path == "":
                self._send(render(getattr(model, "sample_rate", 24000)), "text/html; charset=utf-8")
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):  # noqa: N802
            endpoint = self.path.strip("/")
            if endpoint == "metrics/reset":
                # read the body, so that a keep-alive connection stays framed
                self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
                self._send(json.dumps(metrics.reset(model)).encode(), "application/json")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                gen = _dispatch(model, endpoint, body)
            except Exception as e:  # noqa: BLE001 — a bad request, not a server fault
                self.send_response(400)
                self.end_headers()
                self.wfile.write(str(e).encode())
                return
            metrics.count(endpoint)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            sr = getattr(model, "sample_rate", 24000)
            for out in gen:
                metrics.add_audio(out["tts_speech"].shape[1] / sr)
                chunk = _pcm(out["tts_speech"])
                self.wfile.write(f"{len(chunk):x}\r\n".encode())
                self.wfile.write(chunk)
                self.wfile.write(b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, fmt, *args):
            logging.info("http: " + fmt, *args)

    server = ThreadingHTTPServer((host, port), Handler)
    server.metrics = metrics
    return server


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", type=int, default=50000)
    parser.add_argument("--model_dir", type=str, default="")
    parser.add_argument("--max_batch", type=int, default=0,
                        help=">0: continuous batching, concurrent requests share one batched LM decode loop")
    parser.add_argument("--hop_policy", type=str, default="", choices=["", "doubling", "exponential", "time_based"],
                        help="streaming hop growth (default: the model dir's config, else doubling)")
    parser.add_argument("--top_p", type=float, default=None, help="decode nucleus top_p (default 0.8)")
    parser.add_argument("--top_k", type=int, default=None, help="decode top_k (default 25)")
    parser.add_argument("--temperature", type=float, default=None, help="decode softmax temperature (default 1.0)")
    parser.add_argument("--repetition_penalty", type=float, default=None,
                        help="repetition penalty over prompt and generated speech tokens (default 1.0: off)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.runtime.api import AutoModel

    model = AutoModel(args.model_dir, hop_policy=args.hop_policy, device=args.device)
    if any(v is not None for v in (args.top_p, args.top_k, args.temperature, args.repetition_penalty)):
        model.set_sampling(top_p=args.top_p, top_k=args.top_k, temperature=args.temperature,
                           repetition_penalty=args.repetition_penalty)
        logging.info("sampling: %s", model.lm.cfg)
    if args.max_batch > 0:
        model.enable_continuous_batching(max_batch=args.max_batch)
    logging.info("stdlib http server on :%d", args.port)
    make_stdlib_server(model, port=args.port).serve_forever()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
