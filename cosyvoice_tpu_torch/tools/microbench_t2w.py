"""Stage breakdown of token -> wav at production shapes on the card.

Counterpart of cosyvoice_tpu/tools/microbench_t2w.py. For a 5 s utterance
(125 speech tokens, 250 mel frames) after a 2 s prompt (50 tokens, 100 mel
frames) at full CosyVoice2 width (random weights, float32, the engine's
settings), times:

  - the flow encoder (upsample conformer) forward;
  - one CFM Euler step (the estimator on the CFG batch of 2);
  - the full solve (cfm.n_timesteps steps);
  - the HiFT vocoder;
  - the engine's whole offline token -> wav (`synthesize_offline`, what
    serving runs),

each the mean of 5 calls after two warm ones, between CUDA events on the
card (host clock on the CPU). Prints a line per stage and last one JSON
line {"device", "ms": {stage: ms}, "audio_s", "t2w_rtf"}. `--tiny` runs
tiny models (a check of the harness, no device number; with `--device cpu`
it runs on the host).

    python -m cosyvoice_tpu_torch.tools.microbench_t2w [--tiny] [--device cuda|cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

REPS = 5


def timed(fn, device, reps: int = REPS) -> float:
    """Mean ms of `fn()` over `reps` calls after two warm ones: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def models(tiny: bool, device):
    """(flow, hift, engine) with random weights: full CosyVoice2 width, or
    the JAX tool's tiny configs."""
    from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
    from cosyvoice_tpu_torch.models.flow_decoder import EstimatorConfig
    from cosyvoice_tpu_torch.models.flow_matching import CFMConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.engine import CosyVoice2Engine, random_lm
    from cosyvoice_tpu_torch.utils.init import init_random_

    if tiny:
        flow_cfg = FlowConfig(input_size=32, attention_heads=2, linear_units=64, num_blocks=1, num_up_blocks=1,
                              estimator=EstimatorConfig(channels=(32,), attention_head_dim=8, n_blocks=1,
                                                        num_mid_blocks=1, num_heads=2),
                              cfm=CFMConfig(n_timesteps=2))
        hift_cfg = HiFTConfig(base_channels=32, resblock_kernel_sizes=(3,), resblock_dilations=((1,),),
                              source_resblock_kernel_sizes=(7, 7, 11), source_resblock_dilations=((1,), (1,), (1,)))
        lm_cfg = LMConfig(qwen=Qwen2Config(hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=1, head_dim=16,
                                           intermediate_size=64, vocab_size=64, max_cache_len=64,
                                           dtype=torch.float32))
    else:
        flow_cfg, hift_cfg = FlowConfig(), HiFTConfig()
        # the LM is not timed: a 1-layer one keeps the engine's construction short
        lm_cfg = LMConfig(qwen=Qwen2Config(num_layers=1))
    flow = init_random_(CausalFlow(flow_cfg, device=device), 1)
    hift = init_random_(HiFTGenerator(hift_cfg, device=device), 2)
    lm, _ = random_lm(3, device, lm_cfg)
    return flow, hift, CosyVoice2Engine(lm, flow, hift)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tiny", action="store_true", help="tiny models, a check of the harness")
    parser.add_argument("--device", default="cuda", help="cuda (default), or cpu")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.models.flow_matching import solve_euler
    from cosyvoice_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    flow, hift, eng = models(args.tiny, device)
    rng = np.random.default_rng(0)
    n_tok, n_prompt = (10, 4) if args.tiny else (125, 50)
    L = n_tok + n_prompt
    Lpad = (L + 31) // 32 * 32
    tok = torch.zeros((1, Lpad), dtype=torch.long, device=device)
    tok[0, :L] = torch.from_numpy(rng.integers(0, flow.cfg.vocab_size, L))
    tl = torch.tensor([L], device=device)
    pm = n_prompt * 2  # prompt mel frames (token : mel = 1 : 2)
    conds = torch.zeros((1, Lpad * 2, 80), device=device)
    conds[0, :pm] = torch.from_numpy((rng.random((pm, 80)) * 2 - 12).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((1, 192)).astype(np.float32)).to(device)

    with torch.inference_mode():
        mu, mel_mask = flow.encoder(tok, tl, None, False)
        spks = flow.encoder.project_spk(emb)
        T = mu.shape[1]
        mask_f = mel_mask.to(mu.dtype)
        z = torch.from_numpy(rng.standard_normal((1, T, 80)).astype(np.float32)).to(device)
        cond = conds[:, :T]
        c = flow.cfg.cfm
        two = lambda x: torch.cat([x, torch.zeros_like(x)])  # noqa: E731 - the CFG batch

        def one_step():
            t = torch.full((2,), 0.5, device=device)
            return flow.estimator(torch.cat([z, z]), torch.cat([mask_f, mask_f]), two(mu), t, two(spks), two(cond),
                                  False)

        def full_solve():
            return solve_euler(flow.estimator, z, mu, mask_f, spks, cond, c, False)

        mel = full_solve()
        gen = torch.Generator(device=device).manual_seed(7)
        prompt_tok = tok[0, :n_prompt].cpu().numpy()
        body = tok[0, n_prompt:L].cpu().numpy()
        prompt_feat = conds[:, :pm].cpu().numpy()
        emb_np = emb.cpu().numpy()
        ms = {
            "flow encoder": timed(lambda: flow.encoder(tok, tl, None, False), device),
            "CFM 1 euler step (CFG x2)": timed(one_step, device),
            f"CFM full solve ({c.n_timesteps} steps)": timed(full_solve, device),
            "HiFT vocoder": timed(lambda: hift.inference(mel, gen), device),
        }
    ms["engine offline t2w (serving path)"] = timed(
        lambda: eng.synthesize_offline(body, prompt_tok, prompt_feat, emb_np), device)
    for name, v in ms.items():
        print(f"{name:<36}{v:10.3f} ms", flush=True)
    audio_s = n_tok / 25.0
    t2w = ms["engine offline t2w (serving path)"]
    parts = ms["flow encoder"] + ms[f"CFM full solve ({c.n_timesteps} steps)"] + ms["HiFT vocoder"]
    print(f"\nsum of stages: {parts:.2f} ms, engine: {t2w:.2f} ms, audio {audio_s:.1f}s -> t2w RTF "
          f"{t2w / 1000 / audio_s:.4f}", flush=True)
    summary = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "ms": {k: round(v, 4) for k, v in ms.items()}, "audio_s": audio_s,
               "t2w_rtf": round(t2w / 1000 / audio_s, 6)}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
