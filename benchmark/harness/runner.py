"""One run of a cell: set-up, the measured window, the trace, the check
against the reference, and the result line.

A driver (``harness/drivers/<kind>.py``, ``kind`` from the traffic file)
gives ``setup(job)``, ``window(job, seconds, tracer) -> Window``,
optionally ``after_window(job)`` (the program's work that the check reads
but the window does not time), ``release(job)`` (frees the program's
state) and ``check(job, window) -> [Check]``. The kernels whose rooflines
a cell reads are data: the traffic's ``kernels`` entries (``kernels_of``).
The metrics are read by the readers that ``BENCHMARK.json`` names for the
cell.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import sys
import time
import types

import torch

from . import cells, trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "r2l_tpu")


@dataclasses.dataclass
class Window:
    t_start: float
    t_end: float
    attempted: int
    completions: list[float]              # host time each unit completed
    latencies: list[float] = dataclasses.field(default_factory=list)

    @property
    def units(self) -> int:
        return len(self.completions)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float | None

    @property
    def ok(self) -> bool:
        return (self.limit is not None and not math.isnan(self.value)
                and self.value <= self.limit)


@dataclasses.dataclass
class KernelInfo:
    match: tuple[str, ...]  # substrings of the kernels' names in the trace
    launches: int           # launches the program counted in the slice
    bound_s: float          # the least time of those launches, together
    count: str = ""         # the kernel with one event a launch (match[0])


def driver(kind: str):
    return importlib.import_module(f"harness.drivers.{kind}")


def resolve(ref: str, package: str = ""):
    """The object ``module:attr.attr`` names (``module`` under
    ``package``), read when called: a launch counter is read anew each
    time."""
    mod, _, attr = ref.partition(":")
    obj = importlib.import_module(f"{package}.{mod}" if package else mod)
    for a in attr.split("."):
        obj = getattr(obj, a)
    return obj


def counters_of(traffic: dict):
    """``counters() -> {key: launches}`` of the traffic's ``kernels``: each
    entry's ``counter``, a launch counter of the program."""
    entries = traffic.get("kernels", {})

    def counters() -> dict:
        return {k: int(resolve(e["counter"])) for k, e in entries.items()}
    return counters


def kernels_of(config: dict, traffic: dict, trace) -> dict:
    """{key: KernelInfo} of the traffic's ``kernels`` entries. Each names
    the kernels' names in the trace (``match``; ``count``, the one with an
    event a launch, default the first), its launch counter, its counts
    (``counts``: ``module:function`` of ``benchmark/counts``, giving the
    (operations, bytes) of each launch one unit of the traffic makes) and
    the peak its work is held to (``precision``)."""
    from .peaks import bound_s
    out = {}
    for key, e in traffic.get("kernels", {}).items():
        per = [bound_s(ops, nbytes, e["precision"])
               for ops, nbytes in resolve(e["counts"], "counts")(config,
                                                                 traffic)]
        n = trace.launches.get(key, 0)
        out[key] = KernelInfo(tuple(e["match"]), n, n * sum(per) / len(per),
                              e.get("count", ""))
    return out


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``r2l_tpu_torch`` is not ``r2l_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def limits_of(job) -> dict:
    return job.traffic.get("check", {}).get("limits", {})


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s entries, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merged(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        t0: float, device: torch.device, tiny: dict | None = None) -> dict:
    """The result of one run (the keys of the result line) plus ``checks``
    [Check] (the numbers the traffic's check holds to a limit),
    ``readings`` (the traffic module's other numbers, not compared) and
    ``forbidden`` (forbidden modules loaded by the end of the run, the
    check included).
    ``tiny`` overrides sizes of the configuration and the traffic (the
    CPU tests)."""
    config = merged(cell.config, (tiny or {}).get("config", {}))
    traffic = merged(cell.traffic, (tiny or {}).get("traffic", {}))
    job = types.SimpleNamespace(cell=cell, config=config, traffic=traffic,
                                seed=seed, device=device)
    drv = driver(traffic["kind"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(0, device=device)        # the allocator, to reset
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup(job)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    tracer = trace_mod.Tracer(trace and cuda,
                              float(traffic.get("trace_seconds", 3.0)),
                              counters_of(traffic))
    tracer.prepare()
    win = drv.window(job, seconds, tracer)
    tracer.stop(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kernels = (kernels_of(config, traffic, tracer.data) if tracer.data
               else {})
    ctx = types.SimpleNamespace(cell=cell, job=job, config=config,
                                traffic=traffic, setup_s=setup_s,
                                window=win, tracer=tracer,
                                trace=tracer.data, kernels=kernels)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if hasattr(drv, "after_window"):
        drv.after_window(job)
    drv.release(job)
    if cuda:
        torch.cuda.empty_cache()
    lim = limits_of(job)
    numbers = drv.check(job, win)
    # last: whatever ran after the window (the readers, the check and its
    # reference) is in sys.modules too
    forbidden = forbidden_modules()
    checks = [c for c in numbers if c.name in lim]
    readings = [c for c in numbers if c.name not in lim]
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(checks) and all(c.ok for c in checks),
           "attempted": win.attempted,
           "failed": win.attempted - win.units,
           "metrics": metrics, "device": dev}
    if tracer.data is not None:
        dev["busy_s"] = tracer.data.busy_s
        dev["window_s"] = tracer.data.window_s
        out["breakdown"] = trace_mod.breakdown(tracer.data)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return {"result": out, "checks": checks, "readings": readings,
            "forbidden": forbidden, "ctx": ctx}


def rate_before_slice(ctx) -> tuple[int, float] | None:
    """(units, seconds) completed in the window before the traced slice
    began: the part of a traced run that the profiler did not slow."""
    w, t = ctx.window, ctx.tracer.t_slice
    done = [c for c in w.completions if t is None or c <= t]
    if not done:
        return None
    return len(done), done[-1] - w.t_start


def kernel_roofline(ctx, key: str) -> float | None:
    """A kernel's share of its roofline, in %: the least time of its
    launches in the slice over their device time. Where the trace holds
    fewer events than the program counted launches, the run says so and
    scales the least time to the events seen."""
    info = ctx.kernels.get(key)
    if ctx.trace is None or info is None or info.launches <= 0:
        return None
    seconds = sum(ctx.trace.kernel_time(m)[0] for m in info.match)
    events = ctx.trace.kernel_time(info.count or info.match[0])[1]
    if events == 0 or seconds <= 0:
        return None
    if events != info.launches:
        print(f"[trace] {key}: {events} events of "
              f"{info.count or info.match[0]!r} in the "
              f"trace, {info.launches} launches counted: the least time is "
              f"scaled by {events}/{info.launches}", file=sys.stderr)
    return 100.0 * info.bound_s * events / info.launches / seconds


def idle_pct(ctx) -> float | None:
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def span_ms(ctx, name: str) -> float | None:
    """The mean host time of a span, in ms, over the spans before the
    traced slice."""
    t = ctx.tracer.t_slice
    s = [b - a for a, b in ctx.tracer.spans.get(name, [])
         if t is None or b <= t]
    return 1e3 * sum(s) / len(s) if s else None
