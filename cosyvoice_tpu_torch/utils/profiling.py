"""Per-stage wall-time accounting (copy of cosyvoice_tpu/utils/profiling.py:StageTimer),
and the device's idle share over a window (`device_idle`, over torch.profiler)."""

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class StageTimer:
    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.records[name].append(seconds)

    def reset(self):
        """Drop accumulated records (e.g. to exclude warmup entries)."""
        self.records.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            arr = np.asarray(vals)
            out[name] = {
                "n": len(arr),
                "mean_ms": float(arr.mean() * 1000),
                "p50_ms": float(np.percentile(arr, 50) * 1000),
                "p95_ms": float(np.percentile(arr, 95) * 1000),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<16}{'n':>5}{'mean ms':>10}{'p50 ms':>10}{'p95 ms':>10}{'total s':>10}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<16}{s['n']:>5}{s['mean_ms']:>10.2f}{s['p50_ms']:>10.2f}{s['p95_ms']:>10.2f}{s['total_s']:>10.2f}"
            )
        return "\n".join(lines)


def busy_union(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def device_idle(work, device, per_trace=0):
    """Run `work` under torch.profiler (CUDA activity) and return (its
    result, stats): work() once where it is callable; else `work` is an
    iterable, consumed with a new trace every `per_trace` items (0: one
    trace), and the result is the list of its items. The profiler drops
    some device records: up to 0.9 % of a trace of ~34,000 events (one
    eager block of a full-width per-layer LM) and more past ~410,000, hence
    the cut into short traces; counts and busy time are lower bounds. Each
    trace's window runs from the start of a marker kernel launched on an
    idle device before its work to the end of one launched after that work
    has finished: what the host's clock sees of it. stats,
    summed over the traces: {"window_ms", "busy_ms" (the union of every
    kernel, copy and set on the device inside the windows), "idle_share"
    (1 - busy / window), "events", "traces", "trace_events" (the events of
    each), "names" ({device event name: count}, the markers included),
    "top" ([(name, ms, count)] of the five names with the most device
    time)}, or None where the traces hold no device activity. The profiler
    adds host time to every launch and graph replay while it records (and
    to every graph replay after it, for the process's life), so the windows
    are longer than the work's untraced wall time."""
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    traces = []

    def trace(body):
        mark = torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mark.add_(1)
            out = body()
            torch.cuda.synchronize(device)
            mark.add_(1)
            torch.cuda.synchronize(device)
        # the raw trace: building FunctionEvents for a request's device events takes minutes
        traces.append(sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                             for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA))
        return out

    if callable(work):
        out = trace(work)
    else:
        items, out = iter(work), []
        while True:
            part = trace(lambda: list(itertools.islice(items, per_trace or None)))
            out += part
            if not per_trace or len(part) < per_trace:
                break
    window = busy = 0.0
    by_name, n = {}, 0
    for events in traces:
        if len(events) < 2:
            continue
        for start, end, name in events:
            ms, k = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + (end - start) / 1e6, k + 1)
        window += (max(end for _, end, _ in events) - events[0][0]) / 1e6
        busy += busy_union((start, end) for start, end, _ in events) / 1e6
        n += len(events)
    if n == 0:
        return out, None
    return out, {"window_ms": window, "busy_ms": busy, "idle_share": 1 - busy / window, "events": n,
                 "traces": len(traces), "trace_events": [len(events) for events in traces],
                 "names": {k: c for k, (_, c) in by_name.items()},
                 "top": sorted(((k,) + v for k, v in by_name.items()), key=lambda t: -t[1])[:5]}


def enqueue_cost(fn, reset=lambda: None, n=4, batches=5):
    """Host microseconds to enqueue one fn() (the median over `batches`
    batches of n calls made without waiting, each batch after reset() and a
    synchronize, after one warm-up batch) and device milliseconds per call
    (CUDA events around 2 batches): whether the host stays ahead of the
    device. Returns (host us, device ms, [host us of each batch])."""
    import torch

    host = []
    for b in range(batches + 1):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        if b:
            host.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    dev_ms = 0.0
    for _ in range(2):
        reset()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        dev_ms += start.elapsed_time(end) / (2 * n)
    return sorted(host)[len(host) // 2], dev_ms, host
