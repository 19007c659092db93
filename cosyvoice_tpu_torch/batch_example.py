"""Batched-serving example: concurrent zero-shot requests through continuous
batching, then a reseeded stability loop.

Counterpart of batch_example.py (the reference vllm_example.py's role). The
API's `enable_continuous_batching(max_batch)` starts the LM's batch
scheduler (runtime/batch_scheduler.py, its decode graphs captured up front
on the card); `--concurrency` threads then send one zero-shot request each,
and the loop sends `--iters` more one at a time. Tiny random-weight models
by default; `--model_dir` loads a model dir (`--quant_lm int8 | int4 |
int4p` quantises its LM). Prints the wave's wall and real-time factor, the
loop's RTF spread and, last, one JSON line {"device", "concurrency",
"requests", "wave_s", "audio_s", "rtf", "iters", "degenerate", "rtf_p50"}.

    python -m cosyvoice_tpu_torch.batch_example [--model_dir DIR] [--iters 8] [--concurrency 4] [--device cuda]
"""

import argparse
import json
import threading
import time

import numpy as np
import torch

PROMPT_TEXT = "prompt transcript"


def tiny_configs():
    """batch_example.py's tiny random-weight CosyVoice2: the example's LM, a
    flow of one mid block and 2 solver steps, a 32-channel HiFT."""
    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.flow_decoder import EstimatorConfig
    from cosyvoice_tpu_torch.models.flow_matching import CFMConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config

    return dict(
        lm_cfg=LMConfig(
            speech_token_size=6561, block_size=28,
            qwen=Qwen2Config(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                             intermediate_size=128, vocab_size=512, max_cache_len=1024, dtype=torch.float32),
        ),
        flow_cfg=FlowConfig(
            input_size=64, vocab_size=6561, attention_heads=2, linear_units=128, num_blocks=1, num_up_blocks=1,
            estimator=EstimatorConfig(channels=(32,), n_blocks=1, num_mid_blocks=1, num_heads=2),
            cfm=CFMConfig(n_timesteps=2),
        ),
        hift_cfg=HiFTConfig(base_channels=32),
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default="")
    parser.add_argument("--iters", type=int, default=8, help="stability loop iterations (the reference runs 100)")
    parser.add_argument("--concurrency", type=int, default=4)
    parser.add_argument("--quant_lm", default="", choices=["", "int8", "int4", "int4p"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    if args.model_dir:
        model = CosyVoice2(args.model_dir, quant_lm=args.quant_lm or False, device=args.device)
    else:
        model = CosyVoice2(quant_lm=args.quant_lm or False, device=args.device, **tiny_configs())

    sched = model.enable_continuous_batching(max_batch=args.concurrency)
    prompt = np.random.RandomState(0).randn(1, 16000).astype(np.float32) * 0.05
    try:
        def synthesize(i, out):
            try:
                t0, n = time.time(), 0
                for chunk in model.inference_zero_shot(
                        f"Concurrent request number {i}, checking the batched decode path.", PROMPT_TEXT, prompt,
                        stream=False, text_frontend=False):
                    n += chunk["tts_speech"].shape[-1]
                out[i] = (time.time() - t0, n)
            except BaseException as e:  # noqa: BLE001 - raised again on the main thread
                out[i] = e

        print(f"== {args.concurrency} concurrent zero-shot requests (continuous batching) ==", flush=True)
        results = {}
        threads = [threading.Thread(target=synthesize, args=(i, results)) for i in range(args.concurrency)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        for r in results.values():
            if isinstance(r, BaseException):
                raise r
        audio = sum(n for _, n in results.values()) / model.sample_rate
        rtf = wall / max(audio, 1e-9)
        print(f"  {args.concurrency} requests in {wall:.2f}s, {audio:.2f}s audio, aggregate RTF {rtf:.4f}",
              flush=True)

        print(f"== stability loop x{args.iters} ==", flush=True)
        rtfs = []
        for i in range(args.iters):
            np.random.seed(i)
            t1, n = time.time(), 0
            for chunk in model.inference_zero_shot("A short stability check sentence.", PROMPT_TEXT, prompt,
                                                   stream=False, text_frontend=False):
                n += chunk["tts_speech"].shape[-1]
            rtfs.append((time.time() - t1, n / model.sample_rate))
    finally:
        sched.stop()
        model.engine.scheduler = None
    # a random-weight LM may stop after a token or two: those iterations are
    # reported apart instead of blowing up the RTF spread
    good = np.sort([w / a for w, a in rtfs if a >= 0.2])
    print(f"  {len(rtfs)} iterations complete ({len(rtfs) - len(good)} degenerate-length); "
          f"RTF min {good[0]:.4f} p50 {good[len(good) // 2]:.4f} p95 {good[int(len(good) * 0.95)]:.4f} "
          f"max {good[-1]:.4f}" if len(good) else f"  {len(rtfs)} iterations complete, all degenerate-length",
          flush=True)
    summary = {"device": str(model.engine.device), "concurrency": args.concurrency, "requests": len(results),
               "wave_s": round(wall, 4), "audio_s": round(audio, 4), "rtf": round(rtf, 6), "iters": len(rtfs),
               "degenerate": len(rtfs) - len(good),
               "rtf_p50": round(float(good[len(good) // 2]), 6) if len(good) else None}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
