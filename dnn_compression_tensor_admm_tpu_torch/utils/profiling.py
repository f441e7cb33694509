"""Tracing and timing (the JAX package's `utils/profiling.py`).

* `trace(logdir)` — `torch.profiler` around the block (CPU, and CUDA
  activity where there is a card), written as a Chrome trace
  `logdir/trace.json`; `trace_summary` reads one back: the device's busy
  and idle shares of the traced span and its longest ops.
* `PhaseTimer` — named totals of timed spans, printed as one JSON line.
* `device_sync()` — waits for the card's queue to drain.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict
from typing import Dict

import torch

# Chrome-trace event categories that run on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_sync() -> None:
    """Waits for every queued launch where there is a card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block; its Chrome trace goes to `logdir/trace.json`.
    The process's later steps run slower after it, more the longer the
    traced span (`tools/torch_step_drift.py`), so time them elsewhere."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        device_sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def trace_summary(path: str, top: int = 10) -> dict:
    """From a Chrome trace: the traced span (first to last event, ms), the
    time the device ran anything (the union of its events' intervals),
    `idle_share` = 1 - busy / span, and the `top` device ops by total
    time ({name, ms, count})."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path} holds no timed events")
    start = min(e["ts"] for e in events)
    span = max(e["ts"] + e["dur"] for e in events) - start
    device = sorted((e for e in events
                     if e.get("cat") in DEVICE_CATEGORIES),
                    key=lambda e: e["ts"])
    busy, end = 0.0, float("-inf")
    totals: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in device:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        totals[e["name"]][0] += e["dur"]
        totals[e["name"]][1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return {"span_ms": span / 1000, "device_busy_ms": busy / 1000,
            "idle_share": 1.0 - busy / span if span else None,
            "device_events": len(device),
            "top_ops": [{"name": n, "ms": t / 1000, "count": c}
                        for n, (t, c) in ranked]}


class PhaseTimer:
    """Named totals of spans the caller timed (the engine's `z_step_s`
    and `x_step_s` rows), printed as one JSON line."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1000 * self.totals[name]
                                        / max(1, self.counts[name]), 3)}
                for name in self.totals}

    def log(self, print_fn=print):
        print_fn(json.dumps({"phase_timings": self.summary()}))
