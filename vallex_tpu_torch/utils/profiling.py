"""Observability: per-phase synthesis timing and torch.profiler traces (port
of vallex_tpu/utils/profiling.py).

- `PhaseTimer`: phase accounting of `synthesize_async`. `phase(name)`
  times a host-clock span; `device_phase(name, stream)` times work
  enqueued on a CUDA stream by a pair of CUDA events recorded on it, read
  only when the caller fetches the result (`DeviceSpan.seconds()`), so
  timing never blocks the host. On the CPU there is no stream to time and
  the span is the host clock around the (eager) work. The single-request
  pipeline records "ar", "nar", "vocos" and "sync" into it; the batched
  path (`synthesize_batch`) returns its phase seconds in the result's
  `seconds` instead, and times its AR prefill with a `DeviceSpan` of its
  own.
- `trace(log_dir)`: a torch.profiler trace of a code region (CPU ops and,
  on the card, CUDA kernels), written as `trace.json` under log_dir; the
  pipeline's `vallex.ar`, `vallex.nar` and `vallex.vocos` spans mark its
  phases in it, and the batched AR's `vallex.ar.*` spans its prefill,
  blocks and host reads (engine/ar.py).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class DeviceSpan:
    """One phase's time: a pair of CUDA events on a stream, or the host
    clock when there is no stream. `close(stream)` ends it; `seconds()`
    reads it once the work is done (it waits for the end event) and adds it
    to the timer, if there is one, once."""

    __slots__ = ("name", "_timer", "_start", "_end", "_host", "_seconds")

    def __init__(self, name: str, timer: Optional["PhaseTimer"] = None, stream=None):
        self.name, self._timer, self._seconds = name, timer, None
        self._start = self._end = None
        self._host = time.perf_counter()
        if stream is not None:
            import torch

            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(stream)

    def close(self, stream=None) -> None:
        if self._end is not None:
            self._end.record(stream)
        else:
            self._host = time.perf_counter() - self._host

    def seconds(self) -> float:
        if self._seconds is None:
            if self._end is None:
                self._seconds = self._host
            else:
                self._end.synchronize()
                self._seconds = self._start.elapsed_time(self._end) / 1e3
            if self._timer is not None:
                self._timer.add(self.name, self._seconds)
        return self._seconds


class PhaseTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()  # a stream's worker and its reader share one

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def device_phase(self, name: str, stream=None) -> Iterator[DeviceSpan]:
        """Time the work enqueued inside on `stream` (a torch.cuda.Stream)
        by CUDA events; with stream=None by the host clock."""
        span = DeviceSpan(name, self, stream)
        try:
            yield span
        finally:
            span.close(stream)

    def report(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str = "vallex-trace") -> Iterator[object]:
    """Profile a code region with torch.profiler (CPU ops, and CUDA kernels
    and copies when a GPU is present) and write `log_dir/trace.json`
    (chrome://tracing or Perfetto). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

