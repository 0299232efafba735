"""Reading a torch.profiler trace: device intervals, their union, device time
by kernel name, and idle gaps by the host span around them (the arithmetic
of the port's `chip_smoke.py` phase 7, copied here so that the yardstick
does not move with the program).

Device time by name is each event's own time: from the later of its start
and the end of the events before it on its stream, to its end. A kernel
started early by programmatic dependent launch spans its wait for its
predecessor; that stretch is the predecessor's time, counted there. A
stream's own times sum to the union of its intervals."""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

Interval = Tuple[float, float]  # µs


def trace_events(prof) -> List[Dict]:
    """The events of a finished profiler run, from its chrome trace."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def union_us(intervals: List[Interval], lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals clipped to [lo, hi)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps_us(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and a <= hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


@dataclass
class Trace:
    """The device work of one traced stretch [lo, hi) (µs, trace clock)."""
    lo: float
    hi: float
    kernels: List[Tuple[float, float, str]]  # kernels, copies and memsets
    spans: List[Tuple[float, float, str]] = field(default_factory=list)  # host spans
    streams: List[Hashable] = field(default_factory=list)  # each kernel's; empty: one stream

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for a, b, _ in self.kernels], self.lo, self.hi) / 1e6

    def own(self) -> List[Tuple[float, float, str]]:
        """Each kernel's own interval, in the order of `kernels`: its start
        moved to the end of the events that started before it on its
        stream where they end later (never past its own end)."""
        streams = self.streams or [None] * len(self.kernels)
        out = list(self.kernels)
        ends: Dict[Hashable, float] = {}
        for i in sorted(range(len(out)), key=lambda i: out[i][:2]):
            a, b, n = out[i]
            s = streams[i]
            out[i] = (min(max(a, ends.get(s, a)), b), b, n)
            ends[s] = max(ends.get(s, b), b)
        return out

    def seconds_matching(self, pattern: str) -> Optional[float]:
        """Own device seconds, inside [lo, hi), of the kernels whose name
        matches `pattern`; None when no kernel does."""
        rx = re.compile(pattern)
        hits = [(a, b) for a, b, n in self.own() if rx.search(n)]
        if not hits:
            return None
        return sum(max(0.0, min(b, self.hi) - max(a, self.lo)) for a, b in hits) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        """Own device seconds by name, the largest first."""
        by: Dict[str, float] = {}
        for a, b, n in self.own():
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n[:120], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time summed by the innermost host span around each
        gap's midpoint ("between phases" outside every span)."""
        by: Dict[str, float] = {}
        for a, b in gaps_us([(x, y) for x, y, _ in self.kernels], self.lo, self.hi):
            mid = (a + b) / 2
            inner = [s for s in self.spans if s[0] <= mid < s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "between phases"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def read(events: List[Dict], window_name: str, span_prefix: str = "vallex.") -> Optional[Trace]:
    """The Trace of the user span `window_name` (the traced batch), with the
    program's spans named `span_prefix`* and each device event's stream
    (`args.stream`, else `tid`); None if the span or the device events are
    missing."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == window_name and "dur" in e]
    if not win:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
              and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    if not device:
        return None
    kernels = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]))
               for e in device]
    streams = [(e.get("args") or {}).get("stream", e.get("tid")) for e in device]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]))
             for e in events if e.get("cat") == "user_annotation" and "dur" in e
             and str(e.get("name", "")).startswith(span_prefix)
             and lo <= float(e["ts"]) < hi]
    return Trace(lo, hi, kernels, spans, streams)
