"""The readers of the program's own spans and counters (``harness/program.py``
and its nine metrics) on a made-up traced slice: device intervals, the
profiler's events of the slice and the program's records, each metric
against the number worked out by hand; None without records; and the
program's ranges read from a real CPU profiler session, against the trace
it wrote."""
import json
import sys
import threading
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from harness import cells, program
from harness.trace import TraceData, parse

from r2l_tpu_torch import trace

A, B = 1e6, 3.5e6        # trace microseconds = A * host seconds + B
OFF = 1234.5             # trace microseconds less the session's own
MAIN = threading.main_thread().ident
WRITER = MAIN + 1

VIEW = ("frame_sample_ms", "frame_launch_ms", "frame_syncs",
        "idle_in_program_pct.view")
DATAGEN = ("batch_rays_ms", "batch_records_ms", "writer_wait_ms",
           "idle_in_program_pct.datagen", "writer_write_ms")


def _us(t: float) -> float:
    return A * t + B


def _rec(name, unit, parent, t0, t1, thread=MAIN):
    """A program span from ``t0`` to ``t1`` host seconds past 100 s."""
    return trace.Span(name, unit, parent, thread, round((100 + t0) * 1e9),
                      round((100 + t1) * 1e9))


def _event(name, start, end, thread=MAIN, device=DeviceType.CPU):
    """A profiler event of the session, ``start`` and ``end`` in trace
    microseconds."""
    return types.SimpleNamespace(
        name=name, thread=thread, device_type=device,
        time_range=types.SimpleNamespace(start=start - OFF, end=end - OFF))


def _ctx(device: list, window: tuple, records: list,
         counters: dict | None = None):
    """A traced run's ctx: the device's operations and the window (host
    seconds past 100 s, on the trace's clock through A, B), the program's
    records, and the session's events: the slice's range, each record's
    range on its thread (the writer's thread is not recorded), a device
    copy of a range and one of the program's operations."""
    dev = [(_us(100 + a), _us(100 + b)) for a, b in device]
    win = (_us(100 + window[0]), _us(100 + window[1]))
    events = [_event("bench.slice", win[0] - 5.0, win[1]),
              _event("aten::mul", win[0], win[0] + 3.0)]
    for r in records:
        if r.thread != WRITER:
            a, b = _us(r.start_ns * 1e-9), _us(r.end_ns * 1e-9)
            events.append(_event(trace.PREFIX + r.name, a, b, r.thread))
            events.append(_event(trace.PREFIX + r.name, a, b + 1e4,
                                 device=DeviceType.CUDA))
    data = TraceData([], dev, win, 0.0, [], {}, 0)
    return types.SimpleNamespace(
        trace=data, tracer=types.SimpleNamespace(
            _prof=types.SimpleNamespace(events=lambda: events)),
        program=program.Program(records, counters or {}))


def _view_ctx():
    """Two frames of 0.8 ms host time in a 20-ms slice; the device idles
    0-0.8, 9.8-10.8 and 19.5-20 ms (2.3 ms), the frame calls cover 0.7 ms
    of each of the first two gaps."""
    ms = 1e-3
    recs = []
    for unit, t, sample, launch in ((0, 0.0, 0.2, 0.1), (1, 10.0, 0.3, 0.2)):
        recs += [
            _rec("frame.sample", unit, "frame", (t + 0.1) * ms,
                 (t + 0.1 + sample) * ms),
            _rec("kernel.launch", unit, "frame.net", (t + 0.5) * ms,
                 (t + 0.5 + launch) * ms),
            _rec("frame.net", unit, "frame", (t + 0.45) * ms,
                 (t + 0.8) * ms),
            _rec("frame", unit, None, (t + 0.1) * ms, (t + 0.9) * ms)]
    device = [(0.8 * ms, 9.8 * ms), (10.8 * ms, 19.5 * ms)]
    return _ctx(device, (0.0, 20 * ms), recs,
                {("frame", "sync"): 3, ("frame.net", "sync"): 7})


def _datagen_ctx():
    """Two pose batches (units 0 and 8), each followed by its flush, and the
    writer's end; the writer's thread writes twice meanwhile. The device
    idles 0-100 and 900-1000 ms; the loop's spans cover 50 ms of the first
    gap, 10 of them the benchmark's draws, and 40 of the second (the second
    flush, the join), the writer's spans none: they are on another
    thread."""
    ms = 1e-3
    recs = [
        _rec("datagen.rays", 0, "datagen.batch", 50 * ms, 80 * ms),
        _rec("datagen.upload", 0, "datagen.render", 80 * ms, 85 * ms),
        _rec("datagen.draws", 0, "datagen.render", 85 * ms, 95 * ms),
        _rec("datagen.render", 0, "datagen.batch", 80 * ms, 300 * ms),
        _rec("datagen.records", 0, "datagen.batch", 310 * ms, 350 * ms),
        _rec("datagen.batch", 0, None, 50 * ms, 350 * ms),
        _rec("datagen.flush", 0, None, 355 * ms, 365 * ms),
        _rec("datagen.write", None, None, 370 * ms, 950 * ms, WRITER),
        _rec("datagen.rays", 8, "datagen.batch", 400 * ms, 450 * ms),
        _rec("datagen.upload", 8, "datagen.render", 450 * ms, 465 * ms),
        _rec("datagen.records", 8, "datagen.batch", 800 * ms, 860 * ms),
        _rec("datagen.batch", 8, None, 400 * ms, 900 * ms),
        _rec("datagen.flush", 8, None, 920 * ms, 940 * ms),
        _rec("datagen.write", None, None, 950 * ms, 1050 * ms, WRITER),
        _rec("datagen.join", 8, None, 940 * ms, 960 * ms)]
    device = [(100 * ms, 900 * ms)]
    return _ctx(device, (0.0, 1000 * ms), recs)


def _read(name, ctx):
    return cells.reader(name)(ctx)


def test_the_ranges_are_the_sessions_on_the_traces_clock():
    ctx = _view_ctx()
    rs = program.ranges(ctx)
    recs = [r for r in ctx.program.spans]
    assert [n for n, _, _, _ in rs] == [r.name for r in recs]
    for (_, thread, a, b), r in zip(rs, recs):
        assert thread == MAIN
        assert a == pytest.approx(_us(r.start_ns * 1e-9), abs=1e-3)
        assert b == pytest.approx(_us(r.end_ns * 1e-9), abs=1e-3)
    assert program.ranges(ctx) is rs          # read once a run


@pytest.mark.parametrize("name, want", [
    ("frame_sample_ms", (0.2 + 0.3) / 2),
    ("frame_launch_ms", (0.1 + 0.2) / 2),
    ("frame_syncs", 3 / 2),
    ("idle_in_program_pct.view", 100 * (0.7 + 0.7) / (0.8 + 1.0 + 0.5))])
def test_view_readers(name, want):
    assert _read(name, _view_ctx()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name, want", [
    ("batch_rays_ms", ((30 + 5) + (50 + 15)) / 2),
    ("batch_records_ms", (40 + 60) / 2),
    ("writer_wait_ms", (10 + 20) / 2),
    ("idle_in_program_pct.datagen", 100 * (50 - 10 + 40) / (100 + 100)),
    ("writer_write_ms", (580 + 100) / 2)])
def test_datagen_readers(name, want):
    assert _read(name, _datagen_ctx()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", VIEW + DATAGEN)
def test_no_records_read_none(name):
    untraced = types.SimpleNamespace(trace=None, tracer=types.SimpleNamespace(
        t_slice=None, spans={}))
    assert _read(name, untraced) is None
    trace.records(), trace.counters()
    empty = _view_ctx()
    del empty.program          # taken from the program: nothing recorded
    assert _read(name, empty) is None
    other = _datagen_ctx() if name in VIEW else _view_ctx()
    assert _read(name, other) is None     # another kind's records


def test_a_program_without_spans_reads_none(monkeypatch):
    import r2l_tpu_torch
    monkeypatch.delattr(r2l_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "r2l_tpu_torch.trace", None)
    for name in VIEW + DATAGEN:
        ctx = _view_ctx() if name in VIEW else _datagen_ctx()
        del ctx.program
        assert _read(name, ctx) is None


def test_the_ranges_of_a_cpu_session_are_its_traces(tmp_path):
    """A session as the harness's tracer runs one (a step into the slice,
    the slice's range, the trace written): the program's ranges read from
    the session lie on the written trace's ``r2l.`` ranges, and the idle
    share reads every gap between two device operations that a frame
    fills."""
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1))
    prof.__enter__()
    prof.step()
    slice_range = torch.profiler.record_function("bench.slice")
    slice_range.__enter__()
    x = torch.ones(256)
    for k in range(6):
        trace.unit(k)
        with trace.span("frame"):
            with trace.span("frame.sample"):
                x = x * 1.5
            time.sleep(1e-3)
    slice_range.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    want = sorted((e["name"][len(trace.PREFIX):], float(e["ts"]),
                   float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith(trace.PREFIX))
    data = parse(events, {}, 6)
    # the device: busy but for 0.3 ms inside each frame's sleep
    frames = [(a, b) for n, a, b in want if n == "frame"]
    data.device = [(data.window_us[0], frames[0][1] - 400.0)] + [
        (frames[k][1] - 100.0, frames[k + 1][1] - 400.0)
        for k in range(5)] + [(frames[5][1] - 100.0, data.window_us[1])]
    ctx = types.SimpleNamespace(trace=data,
                                tracer=types.SimpleNamespace(_prof=prof))
    assert len(want) == 12
    got = sorted((n, a, b) for n, _, a, b in program.ranges(ctx))
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, a, b), (_, wa, wb) in zip(got, want):
        assert a == pytest.approx(wa, abs=1.0)
        assert b == pytest.approx(wb, abs=1.0)
    assert program.idle_in_program_pct(ctx, "frame") == pytest.approx(
        100.0, abs=1e-6)
