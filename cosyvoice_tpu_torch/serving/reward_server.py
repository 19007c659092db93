"""The GRPO reward server: the rolled-out speech tokens synthesized by the
flow and the vocoder, transcribed by a pluggable ASR, and scored as
1 - CER against the prompt text, behind a KServe v2 JSON endpoint.

Counterpart of cosyvoice_tpu/serving/reward_server.py: the scoring
functions (`edit_distance`, `cer`, which tools/eval_quality.py uses too),
`make_reward_fn` (token->wav through the API's engine with no prompt,
the JAX engines' token2wav(finalize=True) outside a stream:
`synthesize_finalize` for CosyVoice2/3, a `V1SessionState` finalize for
CosyVoice-300M; an empty rollout scores 0.0), `make_server`
(ThreadingHTTPServer; the response's bytes are the JAX server's) and
`main`. The ASR is ``--asr module:function``, a
``fn(wav: np.ndarray, sample_rate: int) -> str``. The protocol is the one
train/grpo.http_reward speaks: POST {"inputs": [{"name": "TOKENS", ...},
{"name": "TOKEN_LENS", ...}, {"name": "GT", ...}]} ->
{"outputs": [{"name": "REWARD", "shape": [n], "datatype": "FP32",
"data": [r, ...]}]}.

    python -m cosyvoice_tpu_torch.serving.reward_server --model_dir DIR \\
        --asr mypkg.asr:transcribe [--port 8000] [--device cuda]
"""

import argparse
import importlib
import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _normalize(s: str) -> str:
    return re.sub(r"[\s\W]+", "", s.lower())


def cer(hyp: str, ref: str) -> float:
    """Character error rate of `hyp` against `ref`, lower-cased, whitespace
    and punctuation removed (a plain character CER, not the reference's
    pinyin CER). An empty reference scores 0 against an empty hypothesis,
    else 1."""
    h, r = _normalize(hyp), _normalize(ref)
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(h, r) / len(r)


def make_reward_fn(model, asr_fn):
    """reward_fn(tokens, ground_truth) -> 1 - min(CER, 1) of `asr_fn`'s
    transcript of the tokens' wav, synthesized by `model` (a CosyVoice,
    CosyVoice2 or CosyVoice3 of runtime/api.py) with no prompt."""
    from cosyvoice_tpu_torch.runtime.engine import CosyVoiceV1Engine, V1SessionState

    spk_dim = model.flow.cfg.spk_embed_dim
    lock = threading.Lock()  # one token->wav at a time: the server's threads share the engine

    def fn(tokens: np.ndarray, ground_truth: str) -> float:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            return 0.0
        no_prompt = (np.zeros(0, np.int32), np.zeros((1, 0, 80), np.float32), np.zeros((1, spk_dim), np.float32))
        with lock:
            if isinstance(model.engine, CosyVoiceV1Engine):
                wav = model.engine.token2wav(V1SessionState(), tokens, *no_prompt, finalize=True)
            else:
                wav = model.engine.synthesize_finalize(tokens, *no_prompt)
        hyp = asr_fn(np.asarray(wav).reshape(-1), model.sample_rate)
        return 1.0 - min(cer(hyp, ground_truth), 1.0)

    return fn


def make_server(reward_fn, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer scoring each POSTed request's rollouts with
    `reward_fn` (module docstring; batched rollouts are cut to TOKEN_LENS)."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0)) or 0))
            inputs = {i.get("name"): i for i in body.get("inputs", [])}
            toks = np.asarray(inputs["TOKENS"]["data"], np.int32).reshape(inputs["TOKENS"]["shape"])
            gts = inputs["GT"]["data"]
            if "TOKEN_LENS" in inputs:
                lens = np.asarray(inputs["TOKEN_LENS"]["data"], np.int32).reshape(-1)
            else:
                lens = np.full(toks.shape[0], toks.shape[1], np.int32)
            preds = [float(reward_fn(toks[i, : lens[i]], gts[i])) for i in range(toks.shape[0])]
            data = json.dumps(
                {"outputs": [{"name": "REWARD", "shape": [len(preds)], "datatype": "FP32", "data": preds}]}
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            logging.debug(*a)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default="")
    parser.add_argument("--asr", required=True, help="module:function -> fn(wav, sr) -> str")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    mod, _, fn = args.asr.partition(":")
    asr_fn = getattr(importlib.import_module(mod), fn or "transcribe")

    from cosyvoice_tpu_torch.runtime.api import AutoModel

    model = AutoModel(args.model_dir, device=args.device)
    server = make_server(make_reward_fn(model, asr_fn), args.host, args.port)
    logging.info("reward server on %s:%d", args.host, args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
