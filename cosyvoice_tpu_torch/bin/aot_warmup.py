"""Warm-up of a model dir before serving: the kernels built, the model
loaded, one offline and one streamed pass run, their decode graphs captured,
and the speculative first chunk's graphs (runtime/first_chunk.py, one per
prompt shape) captured for each prompt length asked for.

Counterpart of cosyvoice_tpu/bin/aot_warmup.py, whose role on the TPU is to
fill XLA's persistent compilation cache. Here the kernel library
(ops/_build.py) is what persists on disk (build/cosyvoice_tpu_torch/, keyed
by the sources' hash), so a later process on the same checkout loads it
without nvcc; the decode graphs live in the process that captured them, so
a server warms itself the same way. The passes use a 50-token prompt;
`--prompt_tokens` lists the flow prompt lengths (in speech tokens, 25 per
second of prompt audio) whose first-chunk graphs are captured too, so that a
served stream with such a prompt pays no capture on its first chunk (an
engine with the path off, or a v1 engine, has none). Prints the seconds of
the build, the load, the graph captures and each pass, and last one JSON
line {"device", "built", "build_s", "load_s", "offline_s", "stream_s",
"graph_captures", "capture_s", "first_chunk_graphs", "first_chunk_capture_s",
"first_chunk_pool_mb", "wall_s"}.

    python -m cosyvoice_tpu_torch.bin.aot_warmup --model_dir DIR [--device cuda] [--prompt_tokens 50 75 ...]
"""

import argparse
import json
import time

import numpy as np


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default="")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--prompt_tokens", type=int, nargs="+", default=[50],
                        help="flow prompt lengths whose first-chunk graphs are captured")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.runtime.api import AutoModel
    from cosyvoice_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    built, build_s = False, 0.0
    if device.type == "cuda":  # the CPU path runs the kernels' plain versions: nothing to build
        from cosyvoice_tpu_torch.ops._build import build, load_library

        info = build()
        load_library()
        built, build_s = info["built"], time.perf_counter() - t0
    print(f"kernels: {'built' if built else 'found built'} in {build_s:.1f}s" if device.type == "cuda"
          else "kernels: none on the CPU (the wrappers run their plain versions)", flush=True)

    t1 = time.perf_counter()
    model = AutoModel(args.model_dir, device=device)
    load_s = time.perf_counter() - t1
    print(f"model loaded in {load_s:.1f}s", flush=True)
    engine, lm = model.engine, model.engine.lm
    rng = np.random.default_rng(0)
    n_speech = min(lm.cfg.speech_token_size, engine.flow.cfg.vocab_size)
    prompt_tokens = rng.integers(0, n_speech, 50).astype(np.int32)
    prompt_feat = rng.random((1, 100, 80)).astype(np.float32) * 2 - 12
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    text = rng.integers(0, min(1000, lm.cfg.qwen.vocab_size), 30).astype(np.int32)

    passes = {}
    for stream in (False, True):
        t2 = time.perf_counter()
        for _ in engine.tts(text_tokens=text, prompt_text_tokens=np.zeros(0, np.int32),
                            llm_prompt_speech_token=prompt_tokens, flow_prompt_speech_token=prompt_tokens,
                            prompt_speech_feat=prompt_feat, flow_embedding=emb, stream=stream, rng_seed=7):
            pass
        passes["stream" if stream else "offline"] = time.perf_counter() - t2
        print(f"{'streamed' if stream else 'offline'} pass in {passes['stream' if stream else 'offline']:.1f}s",
              flush=True)
    first_chunk = getattr(engine, "first_chunk", None) if getattr(engine, "speculative_first_chunk", False) else None
    if first_chunk is not None:
        for n in args.prompt_tokens:
            first_chunk.capture(n)
    summary = {"device": str(device), "built": built, "build_s": round(build_s, 3), "load_s": round(load_s, 3),
               "offline_s": round(passes["offline"], 3), "stream_s": round(passes["stream"], 3),
               "graph_captures": lm.graph_captures, "capture_s": round(lm.graph_capture_s, 3),
               "first_chunk_graphs": first_chunk.captures if first_chunk else 0,
               "first_chunk_capture_s": round(first_chunk.capture_s, 3) if first_chunk else 0.0,
               "first_chunk_pool_mb": round(first_chunk.pool_bytes / 1e6, 3) if first_chunk else 0.0,
               "wall_s": round(time.perf_counter() - t0, 3)}
    print(f"warmup complete in {summary['wall_s']:.1f}s; {lm.graph_captures} decode graphs captured in "
          f"{lm.graph_capture_s:.1f}s, {summary['first_chunk_graphs']} first-chunk graphs in "
          f"{summary['first_chunk_capture_s']:.1f}s (pool {summary['first_chunk_pool_mb']:.1f} MB)", flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
