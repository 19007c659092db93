"""End-to-end example of the public API: zero-shot (offline and streamed),
cross-lingual, instruct2 and voice conversion on a synthetic prompt.

Counterpart of example.py. Tiny random-weight models by default, so that it
finishes in seconds; `--model_dir` loads a model dir, `--full_size` random
weights at full CosyVoice2 width. Writes the zero-shot chunks as wavs
(`--out_prefix`), prints each chunk's seconds and, last, one JSON line:
{"device", "sample_rate", "modes": {mode: {"chunks", "seconds"}}}.

    python -m cosyvoice_tpu_torch.example [--model_dir DIR | --full_size] [--out_prefix demo] [--device cuda]
"""

import argparse
import json

import numpy as np
import torch

TEXTS = {
    "zero_shot": "Hello there, nice to meet you.",
    "zero_shot_stream": "Streaming synthesis, chunk by chunk.",
    "cross_lingual": "A different language text.",
    "instruct2": "Read this warmly.",
}


def tiny_configs():
    """example.py's tiny random-weight CosyVoice2: a 2-layer float32 Qwen2 LM
    (hidden 64, 4 heads, 2 KV heads of 16), a 1 + 1 block flow, a one-kernel
    HiFT."""
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
            input_size=64, attention_heads=2, linear_units=128, num_blocks=1, num_up_blocks=1,
            estimator=EstimatorConfig(channels=(32,), attention_head_dim=8, n_blocks=1, num_mid_blocks=2,
                                      num_heads=2),
            cfm=CFMConfig(n_timesteps=4),
        ),
        hift_cfg=HiFTConfig(base_channels=64, resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
                            source_resblock_kernel_sizes=(7, 7, 11), source_resblock_dilations=((1,), (1,), (1,))),
    )


def run(model, out_prefix: str = "") -> dict:
    """The four modes on `model` (an API instance); returns {mode: {"chunks",
    "seconds"}} and writes the zero-shot chunks under out_prefix (if set)."""
    from cosyvoice_tpu_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(0)
    prompt_wav = (rng.standard_normal((1, 32000)) * 0.05).astype(np.float32)
    src = (rng.standard_normal((1, 16000)) * 0.05).astype(np.float32)
    calls = {
        "zero_shot": lambda: model.inference_zero_shot(TEXTS["zero_shot"], "A prompt.", prompt_wav),
        "zero_shot_stream": lambda: model.inference_zero_shot(TEXTS["zero_shot_stream"], "A prompt.", prompt_wav,
                                                              stream=True),
        "cross_lingual": lambda: model.inference_cross_lingual(TEXTS["cross_lingual"], prompt_wav),
        "instruct2": lambda: model.inference_instruct2(TEXTS["instruct2"], "Speak softly", prompt_wav),
        "vc": lambda: model.inference_vc(src, prompt_wav),
    }
    out = {}
    for mode, call in calls.items():
        print(f"== {mode} ==", flush=True)
        n, seconds = 0, 0.0
        for i, o in enumerate(call()):
            s = o["tts_speech"].shape[1] / model.sample_rate
            if mode == "zero_shot" and out_prefix:
                save_wav(f"{out_prefix}_zero_shot_{i}.wav", o["tts_speech"], model.sample_rate)
            print(f"  chunk {i}: {s:.2f}s", flush=True)
            n, seconds = n + 1, seconds + s
        out[mode] = {"chunks": n, "seconds": round(seconds, 4)}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default="")
    parser.add_argument("--full_size", action="store_true")
    parser.add_argument("--out_prefix", default="demo")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    if args.model_dir or args.full_size:
        model = CosyVoice2(args.model_dir, device=args.device)
    else:
        model = CosyVoice2(device=args.device, **tiny_configs())
    modes = run(model, args.out_prefix)
    summary = {"device": str(model.engine.device), "sample_rate": model.sample_rate, "modes": modes}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
