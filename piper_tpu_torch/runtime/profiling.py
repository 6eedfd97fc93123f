"""Profiling and observability.

Counterpart of piper_tpu/runtime/profiling.py, over torch.profiler
instead of jax.profiler:

- RTF / audio-seconds-per-second counters: SynthesisStats (voice.py).
- Device traces: `with device_trace(dir):` runs torch.profiler over the
  CPU and, on a card, CUDA activity, and writes a Chrome/Perfetto trace
  into dir; the profiler object is yielded for key_averages().
- Per-stage timers: StageTimer accumulates named host-side spans and
  reports a JSON breakdown. A TorchVoice with `timer` set times the
  phases of submit() with it (voice.py).

StageTimer is shared by threads (a server's dispatcher and its stream
handlers), so its sums are updated under a lock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Trace this process's CPU ops and, when a card is present, its CUDA
    kernels into log_dir/trace.json (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Named wall-clock span accumulator."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": round(self.totals[name], 4),
                    "count": self.counts[name],
                    "mean_ms": round(
                        1000 * self.totals[name] / max(self.counts[name], 1), 2
                    ),
                }
                for name in sorted(self.totals)
            }

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)


def annotate(name: str):
    """Decorator: mark a function as a named trace span (shows up in
    torch.profiler traces through record_function)."""

    def wrap(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
