"""The program's own spans and counters of the traced slice.

The program keeps them while a profiler session records
(``r2l_tpu_torch/trace.py``: each span's name, unit, parent, thread and
``perf_counter_ns`` ends; counters by span). They are taken once a run,
by the first metric that asks, and kept on ``ctx.program``. A run with no
traced slice, or a program without that module, gives None, and so does
every metric that reads them.

Each span is also a profiler range named ``r2l.<name>``, recorded on the
profiler's own clock on the threads the session records. ``ranges`` reads
those ranges from the slice's session (``ctx.tracer``'s profiler, which
keeps its events after the trace is written) and moves them onto the
trace's microseconds by the one offset between the session's events and
the written trace: the ``bench.slice`` range's end on both. So the ranges
the readers lay against the device's idle time are the ones on the trace,
and no second clock is mapped.
"""
from __future__ import annotations

import dataclasses

from torch.autograd import DeviceType

from . import trace as trace_mod

PREFIX = "r2l."


@dataclasses.dataclass
class Program:
    spans: list                 # r2l_tpu_torch.trace.Span records
    counters: dict              # {(span name, counter name): total}
    ranges: list | None = None  # (name, thread, start us, end us)


def of(ctx) -> Program | None:
    """The program's records of the run's traced slice, or None."""
    if "program" not in vars(ctx):
        ctx.program = _take(ctx)
    return ctx.program


def _take(ctx) -> Program | None:
    if ctx.trace is None:
        return None
    try:
        from r2l_tpu_torch import trace
    except ImportError:         # a program with no spans of its own
        return None
    spans, counters = trace.records(), trace.counters()
    return Program(spans, counters) if spans else None


def _units(p: Program, root: str) -> set:
    return {s.unit for s in p.spans if s.name == root}


def per_unit_ms(ctx, root: str, names: tuple[str, ...]) -> float | None:
    """The mean time, in ms, that a unit of the slice (one ``root`` span:
    a frame, a pose batch) spent in the spans ``names`` of the same unit."""
    p = of(ctx)
    units = _units(p, root) if p is not None else set()
    if not units:
        return None
    ns = sum(s.end_ns - s.start_ns for s in p.spans
             if s.name in names and s.unit in units)
    return ns * 1e-6 / len(units)


def per_unit_count(ctx, root: str, counter: str) -> float | None:
    """Counter ``counter`` of the ``root`` spans over their number."""
    p = of(ctx)
    units = _units(p, root) if p is not None else set()
    if not units:
        return None
    return p.counters.get((root, counter), 0) / len(units)


def mean_ms(ctx, name: str) -> float | None:
    """The mean time of the spans ``name`` of the slice, in ms."""
    p = of(ctx)
    ns = [s.end_ns - s.start_ns for s in p.spans if s.name == name] \
        if p is not None else []
    return 1e-6 * sum(ns) / len(ns) if ns else None


def ranges(ctx) -> list[tuple[str, int, float, float]]:
    """The program's ``r2l.`` ranges of the slice on the host's threads:
    (span name, thread, start, end) in the trace's microseconds."""
    p = of(ctx)
    if p.ranges is None:
        events = [e for e in ctx.tracer._prof.events()
                  if e.device_type == DeviceType.CPU]
        end = [e.time_range.end for e in events
               if e.name == trace_mod._PREFIX + "slice"]
        off = ctx.trace.window_us[1] - end[-1]
        p.ranges = [(e.name[len(PREFIX):], e.thread,
                     e.time_range.start + off, e.time_range.end + off)
                    for e in events if e.name.startswith(PREFIX)]
    return p.ranges


def idle_in_program_pct(ctx, root: str, leave_out: tuple[str, ...] = ()
                        ) -> float | None:
    """The share, in %, of the slice's device-idle time during which the
    host was inside a range of the program on the thread that runs the
    ``root`` spans, less the time in the ranges ``leave_out`` (a caller's
    work the program calls back)."""
    if of(ctx) is None:
        return None
    rs = ranges(ctx)
    threads = {t for n, t, _, _ in rs if n == root}
    window = ctx.trace.window_us
    busy = trace_mod.union(ctx.trace.device, window)
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    total = sum(b - a for a, b in idle)
    if not threads or total <= 0:
        return None
    mine = [r for r in rs if r[1] in threads]
    inside = trace_mod.union([(a, b) for n, _, a, b in mine], window)
    out = trace_mod.union([(a, b) for n, _, a, b in mine if n in leave_out],
                          window)
    return 100.0 * (_overlap(idle, inside) - _overlap(idle, out)) / total


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    out, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            out += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return out
