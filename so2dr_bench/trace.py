"""The traced window: ``torch.profiler`` over the card and the host, the
benchmark's own host spans, and the reduction of the trace to device
activity, copies, idle gaps and the breakdown.

The trace is exported as Chrome JSON into the run's temporary directory,
read back and deleted.  Device events are kernels, memcpys and memsets;
a memcpy carries its bytes.  Host spans are the benchmark's
``record_function`` ranges (``so2dr_bench.solve``, ``so2dr_bench.round``);
the program's host events are the profiler's ``cpu_op`` and
``cuda_runtime`` ones.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "so2dr_bench."
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")

Span = Tuple[float, float, str]   # start s, end s, name


@dataclass
class Trace:
    """A window's events, in seconds on the profiler's clock."""

    start: float
    end: float
    kernels: List[Span] = field(default_factory=list)
    copies: List[Tuple[float, float, str, int]] = field(default_factory=list)
    memsets: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def device_spans(self) -> List[Tuple[float, float]]:
        out = [(s, e) for s, e, _ in self.kernels]
        out += [(s, e) for s, e, _, _ in self.copies]
        out += [(s, e) for s, e, _ in self.memsets]
        return sorted(out)

    def busy_s(self) -> float:
        """Seconds of the window in which the device ran anything."""
        return sum(max(0.0, min(e, self.end) - max(s, self.start))
                   for s, e in union(self.device_spans()))

    def copy_rate(self, direction: str) -> Optional[float]:
        """Bytes over device seconds of the ``HtoD`` or ``DtoH`` memcpys,
        in GB/s; None without one."""
        nbytes = secs = 0.0
        for s, e, name, b in self.copies:
            if direction in name and e > s:
                nbytes += b
                secs += e - s
        return nbytes / secs / 1e9 if secs > 0 else None

    def kernel_s(self) -> float:
        return sum(e - s for s, e, _ in self.kernels)


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """Device-idle intervals inside the window."""
    out, t = [], trace.start
    for s, e in union(trace.device_spans()):
        s, e = max(s, trace.start), min(e, trace.end)
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.end > t:
        out.append((t, trace.end))
    return out


def _label(gap: Tuple[float, float], trace: Trace) -> str:
    """The innermost benchmark span over the gap's middle, and the host
    event that overlaps the gap the longest."""
    mid = (gap[0] + gap[1]) / 2
    covering = [sp for sp in trace.spans if sp[0] <= mid <= sp[1]]
    span = min(covering, key=lambda sp: sp[1] - sp[0])[2] if covering \
        else "between solves"
    best, best_overlap = None, 0.0
    for s, e, name in trace.host:
        overlap = min(e, gap[1]) - max(s, gap[0])
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    return f"{span}: {best}" if best else span


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    by_name: Dict[str, float] = {}
    for s, e, name in trace.kernels + trace.memsets:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    for s, e, name, _ in trace.copies:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name[:160], secs] for name, secs in ops],
            "idle_gaps": [[_label(g, trace)[:160], g[1] - g[0]]
                          for g in longest]}


class Profiler:
    """``with Profiler() as p: ...`` traces the card and the host; on exit
    :attr:`trace` holds the window's events."""

    def __init__(self):
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self) -> "Profiler":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = read_chrome(self._prof)

    @staticmethod
    def span(name: str):
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)


def read_chrome(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return parse(doc.get("traceEvents", doc) if isinstance(doc, dict) else doc)


def parse(events: list) -> Trace:
    """A :class:`Trace` from Chrome trace events (``ts``/``dur`` in us).
    The window is the span of the benchmark's ``window`` range when the
    trace holds one, else of all complete events."""
    tr = Trace(start=float("inf"), end=float("-inf"))
    window = None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) / 1e6
        e = s + float(ev["dur"]) / 1e6
        cat, name = str(ev.get("cat", "")).lower(), ev.get("name", "")
        tr.start, tr.end = min(tr.start, s), max(tr.end, e)
        if cat == "kernel":
            tr.kernels.append((s, e, name))
        elif cat == "gpu_memcpy":
            nbytes = int((ev.get("args") or {}).get("bytes", 0))
            tr.copies.append((s, e, name, nbytes))
        elif cat == "gpu_memset":
            tr.memsets.append((s, e, name))
        elif cat in HOST_CATS:
            tr.host.append((s, e, name))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            short = name[len(SPAN_PREFIX):]
            if short == "window":
                window = (s, e)
            else:
                tr.spans.append((s, e, short))
    if window is not None:
        tr.start, tr.end = window
    return tr
