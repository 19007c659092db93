"""The host cost of replaying the LM's decode-step CUDA graph, per route of the full-width LM; needs one CUDA card.

The LM replays one captured step per token (models/decode_graph.py). For each route this script captures the same
step (`decode_graph.step` over the LM's static state and arena, the sampling drawing from the decoder's registered
generator) once as a one-step graph and once 28 times in one graph, as a whole `generate` block, and times both with
utils/profiling.py:enqueue_cost (the helper chip_smoke.py's `replay_cost` uses): host microseconds to enqueue one
replay (median of 5 batches enqueued without waiting, after a warm-up batch; 4 replays per batch of the one-step
graph, 1 of the block graph) and device milliseconds per step (CUDA events). Routes: the bf16 LM and the int4p LM
over an int8 arena at 512 rows, the int4p LM over a bf16 arena per layer at 2560 rows and through K7 at 512 rows;
random weights from seed 0, replays from row 128.

Then the one-step graph of each route again under the conditions of a serving process: while `generate` serves a
request (the host seconds of the LM's own replay loop per replay, `Qwen2LM.graph_replay_s / graph_replays`), with
16 more graphs of the step alive, and after one torch.profiler session in the process (utils/profiling.py:
device_idle, as chip_smoke's idle phase runs it), beside the enqueue cost of one eager elementwise kernel. Prints one
line per measurement, then one JSON line of them all:

    python3 scripts/decode_graph_block.py
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BLOCK = 28
ROUTES = (("bf16 per-layer", {}, 512), ("int4p + int8 arena per-layer", {"quant": "int4p", "kv_quant": True}, 512),
          ("int4p per-layer", {"quant": "int4p"}, 2560), ("int4p K7", {"quant": "int4p"}, 512))
ROW = 128  # the replays' write position


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_graph_block: torch.cuda.is_available() is False; this script needs one GPU", file=sys.stderr)
        return 2
    from cosyvoice_tpu_torch.models.decode_graph import step
    from cosyvoice_tpu_torch.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT, LMConfig
    from cosyvoice_tpu_torch.runtime.engine import random_lm
    from cosyvoice_tpu_torch.utils.profiling import device_idle, enqueue_cost

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    print(smi.stdout.strip())
    rows, lms = [], {}

    def record(row):
        rows.append(row)
        print(", ".join(f"{k} {round(v, 4) if isinstance(v, float) else v}" for k, v in row.items()))

    def capture(lm, cache, stacked, steps):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(lm.decoder.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            for _ in range(steps):
                step(lm, lm.decoder.state, cache, lm.decoder.generator, stacked, False)
        return graph, time.perf_counter() - t0

    def reset(s):
        def fn():
            s.cur.fill_(ROW)
            s.fin.zero_()
            s.slot.zero_()
        return fn

    def one_step(label, condition):
        lm, cache, stacked, graph = lms[label]
        host_us, dev_ms, _ = enqueue_cost(graph.replay, reset(lm.decoder.state))
        record({"route": label, "condition": condition, "steps_per_graph": 1, "host_us_per_step": host_us,
                "device_ms_per_step": dev_ms, "host_over_device": host_us / (dev_ms * 1e3)})

    for label, quant, arena in ROUTES:
        cfg = LMConfig()
        lm, _ = random_lm(0, "cuda", dataclasses.replace(cfg, qwen=dataclasses.replace(cfg.qwen, **quant)))
        s = lm.decoder.state
        with torch.inference_mode():
            cache = lm.arenas.first(1, arena)
            stacked = lm._decode_pack(cache)
            dev = lm.device
            s.load(torch.zeros_like(s.logits), torch.tensor([ROW], dtype=torch.int32, device=dev),
                   torch.full_like(s.recent, -1), torch.zeros_like(s.n_dec), torch.zeros_like(s.min_len),
                   torch.zeros_like(s.fin))
            lm.decoder.generator.manual_seed(0)
            step(lm, s, cache, lm.decoder.generator, stacked, False)  # builds, plans and workspaces before capture
            for steps in (1, BLOCK):
                graph, capture_s = capture(lm, cache, stacked, steps)
                host_us, dev_ms, _ = enqueue_cost(graph.replay, reset(s), n=4 if steps == 1 else 1)
                dev_ms /= steps
                record({"route": label, "condition": "alone", "steps_per_graph": steps, "capture_s": capture_s,
                        "host_us_per_replay": host_us, "host_us_per_step": host_us / steps,
                        "device_ms_per_step": dev_ms, "host_over_device": host_us / steps / (dev_ms * 1e3)})
                if steps == 1:
                    lms[label] = (lm, cache, stacked, graph)
                else:
                    del graph

    c = LMConfig()
    rng = np.random.default_rng(0)
    ids = np.concatenate([[c.sos_id], rng.integers(0, c.qwen.vocab_size, 30), [c.task_id],
                          rng.integers(0, c.speech_token_size, 50)]).astype(np.int32)
    types = np.array([TYPE_SPECIAL] + [TYPE_TEXT] * 30 + [TYPE_SPECIAL] + [TYPE_SPEECH] * 50, np.int32)
    for label, (lm, *_rest) in lms.items():
        if label == "int4p per-layer":
            continue  # a request of this short prompt runs K7, as the "int4p K7" LM's does
        gen = torch.Generator(device="cuda").manual_seed(1986)
        for _ in range(2):  # the first request captures its keys
            lm.graph_replay_s, lm.graph_replays = 0.0, 0
            n = sum(len(b) for b in lm.generate(ids, types, gen, 280, 280))
        record({"route": label, "condition": f"in generate ({n} tokens)", "steps_per_graph": 1,
                "host_us_per_step": lm.graph_replay_s / lm.graph_replays * 1e6, "replays": lm.graph_replays})

    extra = []
    with torch.inference_mode():
        for label, (lm, cache, stacked, _) in lms.items():
            extra += [capture(lm, cache, stacked, 1)[0] for _ in range(16)]
            one_step(label, "16 more graphs alive")

    x = torch.zeros(1024, device="cuda")
    host_us, _, _ = enqueue_cost(lambda: x.add_(1), n=16)
    record({"route": "eager x.add_(1)", "condition": "before a profiler session", "host_us_per_call": host_us})
    lm, cache, stacked, graph = lms["bf16 per-layer"]
    _, stats = device_idle(lambda: [graph.replay() for _ in range(4)], lm.device)
    print(f"profiler session: {stats['events']} device events, idle share {stats['idle_share']:.4f}")
    host_us, _, _ = enqueue_cost(lambda: x.add_(1), n=16)
    record({"route": "eager x.add_(1)", "condition": "after a profiler session", "host_us_per_call": host_us})
    for label in lms:
        one_step(label, "after a profiler session")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi.stdout.strip(), "replay_cost": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
