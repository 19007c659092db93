"""Per-stage wall-time accounting (copy of cosyvoice_tpu/utils/profiling.py:StageTimer)."""

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
