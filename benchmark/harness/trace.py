"""Host spans and the device trace of a run.

Every run records a span (host clock) around each call into a layer of the
program. With ``--trace 1`` the last ``trace_seconds`` of the window run
under ``torch.profiler``: those spans are also named ranges on the
profiler's timeline, and the kernels, copies and sets that ran on the card
in that slice give the busy time, each kernel's device time and the idle
gaps, each gap labelled by the span the host was in when it began.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_PREFIX = "bench."


@dataclasses.dataclass
class TraceData:
    kernels: list[tuple[str, float, float]]   # (name, start us, dur us)
    device: list[tuple[float, float]]         # every device op (us)
    window_us: tuple[float, float]
    busy_us: float
    spans: list[tuple[str, float, float]]     # host ranges (name, ts, dur)
    launches: dict[str, int]                  # counter deltas in the slice
    units: int                                # units begun in the slice

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return self.busy_us * 1e-6

    def kernel_time(self, match: str) -> tuple[float, int]:
        """(seconds, events) of the kernels whose name holds ``match``."""
        ds = [d for n, _, d in self.kernels if match in n]
        return sum(ds) * 1e-6, len(ds)


class Tracer:
    """Spans for every run; the profiler over the window's last
    ``trace_seconds`` when ``enabled``. ``counters()`` reads the program's
    launch counters (a dict), at the slice's start and end."""

    def __init__(self, enabled: bool, trace_seconds: float, counters=None):
        self.enabled = enabled
        self.trace_seconds = trace_seconds
        self.counters = counters or (lambda: {})
        self.spans: dict[str, list[tuple[float, float]]] = \
            collections.defaultdict(list)
        self.prof = None             # while the slice records
        self._prof = None
        self.t_slice = None          # host time the slice began
        self.slice_units = 0
        self.data: TraceData | None = None
        self._slice_range = None
        self._c0: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.prof is not None:
            with torch.profiler.record_function(_PREFIX + name):
                yield
        else:
            yield
        self.spans[name].append((t0, time.perf_counter()))

    def prepare(self) -> None:
        """Set the profiler up before the window (its start costs seconds),
        recording nothing until ``maybe_start`` begins the slice."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, schedule
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1))
        self._prof.__enter__()

    def maybe_start(self, t_start: float, seconds: float, now: float) -> bool:
        """Begin the slice once ``now`` is within ``trace_seconds`` of the
        window's end (a driver calls this between units). True while the
        slice runs."""
        if not self.enabled:
            return False
        if self.prof is None and self.data is None and (
                now >= t_start + seconds - self.trace_seconds):
            self._c0 = dict(self.counters())
            self._prof.step()
            self.prof = self._prof
            self._slice_range = torch.profiler.record_function(
                _PREFIX + "slice")
            self._slice_range.__enter__()
            self.t_slice = time.perf_counter()
        return self.prof is not None

    def unit_begun(self) -> None:
        """Count a unit begun inside the slice."""
        if self.prof is not None:
            self.slice_units += 1

    def stop(self, device: torch.device) -> None:
        """End the slice (after the window has closed) and read the
        trace."""
        if self.prof is None:
            return
        torch.cuda.synchronize(device)
        self._slice_range.__exit__(None, None, None)
        c1 = self.counters()
        launches = {k: c1[k] - self._c0.get(k, 0) for k in c1}
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.data = parse(events, launches, self.slice_units)


def span(tracer: Tracer | None, name: str):
    """``tracer.span(name)``, or nothing without a tracer (set-up)."""
    return tracer.span(name) if tracer is not None else \
        contextlib.nullcontext()


def parse(events: list, launches: dict, units: int) -> TraceData:
    kernels, device, spans = [], [], []
    slice_us = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in _DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((name, ts, dur))
        elif cat == "user_annotation" and name.startswith(_PREFIX):
            if name == _PREFIX + "slice":
                slice_us = (ts, ts + dur)
            else:
                spans.append((name[len(_PREFIX):], ts, dur))
    if slice_us is None:
        raise RuntimeError("the trace holds no slice range")
    # kernels enqueued before the profiler began are not in the trace: the
    # window starts at the first device event seen in the slice
    first = min((a for a, _ in device if a >= slice_us[0]),
                default=slice_us[0])
    window = (max(slice_us[0], first), slice_us[1])
    busy = sum(b - a for a, b in union(device, window))
    return TraceData(kernels, device, window, busy, spans, launches, units)


def union(intervals, window) -> list[tuple[float, float]]:
    """The union of ``intervals`` clipped to ``window``, in order."""
    lo, hi = window
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def breakdown(data: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost span the host was in at its start."""
    by_name: dict[str, float] = collections.defaultdict(float)
    for name, _, dur in data.kernels:
        by_name[name] += dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(data.device, data.window_us)
    edges = [data.window_us[0]] + [x for iv in busy for x in iv] + [
        data.window_us[1]]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    spans = sorted(data.spans, key=lambda s: s[1])
    labelled = []
    for a, b in gaps:
        inner = [s for s in spans if s[1] <= a < s[1] + s[2]]
        label = max(inner, key=lambda s: s[1])[0] if inner else "no span"
        labelled.append([label, (b - a) * 1e-6])
    labelled.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": labelled[:top]}
