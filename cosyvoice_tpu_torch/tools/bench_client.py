"""Load generator for the HTTP server: a concurrency sweep.

Counterpart of cosyvoice_tpu/tools/bench_client.py (the role of the
reference's Triton perf client, runtime/triton_trtllm/client_grpc.py): at
each concurrency level, `n_requests` requests to one endpoint, sent in
waves of that many at once, each on a thread of its own. Per level one
JSON line: first-chunk seconds (the first bytes of the response), total
seconds and per-request RTF (total / audio seconds) as p50 / p90 / max,
the audio seconds served, the level's RTF (wall / audio) and audio seconds
per wall second, the server's stage percentiles (GET /metrics), and each
request's (first-chunk s, total s, audio s).

    python -m cosyvoice_tpu_torch.tools.bench_client --host 127.0.0.1 --port 50000 \
        --concurrency 1,2,4 --n_requests 8 --text "..." [--stream]
"""

import argparse
import base64
import http.client
import json
import threading
import time

import numpy as np


def _percentiles(xs):
    xs = sorted(xs)
    if not xs:
        return {}
    at = lambda q: xs[min(int(q * len(xs)), len(xs) - 1)]  # noqa: E731
    return {"p50": at(0.50), "p90": at(0.90), "max": xs[-1]}


def one_request(host, port, endpoint, body, sample_rate, chunk_hook=None):
    """One request read to its end: (first_chunk_s, total_s, audio_s)."""
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", f"/{endpoint}", json.dumps(body))
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:200]!r}")
        first, n_bytes = None, 0
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            if first is None:
                first = time.perf_counter() - t0
            n_bytes += len(chunk)
            if chunk_hook:
                chunk_hook(chunk)
        total = time.perf_counter() - t0
    finally:
        conn.close()
    return first if first is not None else total, total, n_bytes / 2 / sample_rate  # int16 PCM


def _server_stages(host, port):
    """The engine's StageTimer summary from GET /metrics, or None."""
    try:
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        return json.loads(resp.read()).get("stages") if resp.status == 200 else None
    except (OSError, ValueError):
        return None


def sweep(host, port, endpoint, body, concurrency_levels, n_requests, sample_rate=24000, quiet=False):
    """Each level's line (a dict, printed as JSON unless `quiet`)."""
    results = []
    for conc in concurrency_levels:
        firsts, totals, audios, errors, per_request = [], [], [], [], []
        lock = threading.Lock()

        def worker():
            try:
                f, t, a = one_request(host, port, endpoint, body, sample_rate)
                with lock:
                    firsts.append(f)
                    totals.append(t)
                    audios.append(a)
                    per_request.append([f, t, a])
            except Exception as e:  # noqa: BLE001 — counted in the line
                with lock:
                    errors.append(str(e))

        t0 = time.perf_counter()
        done = 0
        while done < n_requests:
            threads = [threading.Thread(target=worker) for _ in range(min(conc, n_requests - done))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            done += len(threads)
        wall = time.perf_counter() - t0
        total_audio = sum(audios)
        line = {
            "concurrency": conc,
            "n_requests": len(totals),
            "errors": len(errors),
            "first_chunk_s": _percentiles(firsts),
            "latency_s": _percentiles(totals),
            "request_rtf": _percentiles([t / a for t, a in zip(totals, audios) if a]),
            "audio_s_total": total_audio,
            "wall_s": wall,
            "rtf": wall / total_audio if total_audio else None,
            "throughput_audio_s_per_s": total_audio / wall if wall else None,
            "per_request": per_request,
        }
        if errors:
            line["first_error"] = errors[0][:200]
        stages = _server_stages(host, port)
        if stages:
            line["server_stages"] = stages
        results.append(line)
        if not quiet:
            print(json.dumps(line), flush=True)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=50000)
    parser.add_argument("--endpoint", default="inference_zero_shot")
    parser.add_argument("--text", default="Hello, this is a test of the speech server.")
    parser.add_argument("--prompt_text", default="A voice prompt.")
    parser.add_argument("--prompt_wav", default="", help="raw int16 PCM at 16 kHz; one second of zeros if empty")
    parser.add_argument("--concurrency", default="1,2,4")
    parser.add_argument("--n_requests", type=int, default=8)
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--stream", action="store_true")
    args = parser.parse_args(argv)

    if args.prompt_wav:
        with open(args.prompt_wav, "rb") as f:
            pcm = f.read()
    else:
        pcm = np.zeros(16000, np.int16).tobytes()
    body = {"tts_text": args.text, "prompt_text": args.prompt_text,
            "prompt_audio_b64": base64.b64encode(pcm).decode(), "stream": bool(args.stream)}
    levels = [int(x) for x in args.concurrency.split(",") if x]
    sweep(args.host, args.port, args.endpoint, body, levels, args.n_requests, args.sample_rate)


if __name__ == "__main__":
    main()
