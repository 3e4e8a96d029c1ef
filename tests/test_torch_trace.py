"""The port's spans and counters (``r2l_tpu_torch/trace.py``): nothing
recorded and no profiler range entered with tracing off; under a
``torch.profiler`` session the frame function's and the pseudo-data loop's
spans with their parents, units and threads, the writer's spans, and the
records as the exported chrome trace's ranges. The ``cuda`` test reads
the frame's ``sync`` counter on the card."""
import json
import threading
import types

import numpy as np
import pytest
import torch
from torch.autograd import profiler as _profiler
from torch.profiler import ProfilerActivity, profile

from r2l_tpu_torch import datagen, render, trace
from r2l_tpu_torch.evaluate import make_r2l_frame_fn
from r2l_tpu_torch.models import NeRFConfig, R2LConfig, init_nerf, init_r2l
from r2l_tpu_torch.rays import pose_spherical
from r2l_tpu_torch.sampler import PointSampler

FRAME_CHILDREN = ("frame.sample", "frame.net", "frame.out")
BATCH_CHILDREN = ("datagen.rays", "datagen.render", "datagen.readback",
                  "datagen.records")
Lp, Lv = 4, 2


@pytest.fixture(autouse=True)
def _empty_store():
    trace.records(), trace.counters()
    yield
    trace.records(), trace.counters()


def _frame_fn():
    cfg = R2LConfig(input_dim=6 * 21, netdepth=6, netwidth=64)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), "cpu")
    sampler = PointSampler(H=4, W=4, focal=5.0, n_sample=2, near=2.0,
                           far=6.0)
    return make_r2l_frame_fn(model, cfg, sampler, use_pallas=False)


def _pose(theta=0.0):
    return pose_spherical(theta, -30.0, 4.0)[:3, :4]


def _pseudo_data(tmp_path, n_pose=5, draws_fn=None):
    ncfg = NeRFConfig(D=3, W=32, skips=(1,), use_viewdirs=True,
                      input_ch=3 + 6 * Lp, input_ch_views=3 + 6 * Lv,
                      output_ch=5)
    g = torch.Generator().manual_seed(0)
    mc, mf = init_nerf(ncfg, g, "cpu"), init_nerf(ncfg, g, "cpu")
    vcfg = render.VolRenderConfig(
        n_coarse=6, n_fine=4, perturb=False, use_viewdirs=True,
        multires=Lp, multires_views=Lv, near=2.0, far=6.0, white_bkgd=True,
        ray_chunk=40)
    gcfg = datagen.DataGenConfig(n_pose=n_pose, H=8, W=8, focal=10.0,
                                 save_every=2, shard_size=50, seed=3,
                                 poses_per_batch=2)
    return datagen.generate_pseudo_data(mc, mf, ncfg, vcfg, gcfg,
                                        str(tmp_path), device="cpu",
                                        draws_fn=draws_fn)


def _cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_enters_no_range(monkeypatch, tmp_path):
    ranges, clock = [], []

    def counting_range(name):
        ranges.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting_range)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: clock.append(1) or 0))
    assert not _profiler._is_profiler_enabled
    assert trace.span("frame") is trace.span("datagen.batch")
    fn = _frame_fn()
    fn(_pose()), fn(_pose(30.0))
    _pseudo_data(tmp_path, n_pose=3)
    trace.count("records", 5)
    assert (ranges, clock) == ([], [])
    assert trace.records() == [] and trace.counters() == {}


def test_frame_spans_under_a_profiler_session():
    fn = _frame_fn()
    fn(_pose())                      # outside the session: not recorded
    with _cpu_session():
        assert _profiler._is_profiler_enabled
        for theta in (0.0, 30.0, 60.0):
            fn(_pose(theta))
    assert not _profiler._is_profiler_enabled
    recs = trace.records()
    roots = [r for r in recs if r.name == "frame"]
    assert [r.parent for r in roots] == [None] * 3
    units = [r.unit for r in roots]
    assert len(set(units)) == 3 and units == sorted(units)
    for root in roots:
        kids = sorted((r for r in recs if r.unit == root.unit
                       and r.name != "frame"), key=lambda r: r.start_ns)
        assert tuple(r.name for r in kids) == FRAME_CHILDREN
        for r in kids:
            assert r.parent == "frame"
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    # the plain path on the host: no kernel launched, no sync watched
    assert not any(r.name == "kernel.launch" for r in recs)
    assert trace.counters() == {}


def test_datagen_spans_and_the_writers_counters(tmp_path):
    main = threading.get_ident()
    seen = []

    def draws_fn(i, rays_o, rays_d):
        seen.append(i)

    with _cpu_session():
        n = _pseudo_data(tmp_path, draws_fn=draws_fn)
    recs = trace.records()
    batches = [r for r in recs if r.name == "datagen.batch"]
    assert [r.unit for r in batches] == seen == [0, 2, 4]
    for b in batches:
        kids = sorted((r for r in recs if r.unit == b.unit
                       and r.parent == "datagen.batch"),
                      key=lambda r: r.start_ns)
        assert tuple(r.name for r in kids) == BATCH_CHILDREN
        for r in kids:
            assert b.start_ns <= r.start_ns <= r.end_ns <= b.end_ns
            assert r.thread == main
        inner = {r.name for r in recs if r.unit == b.unit
                 and r.parent == "datagen.render"}
        assert inner == {"datagen.upload", "datagen.draws"}
    # the flushes (two full batches, then the last pose's record after the
    # loop) and the writer's end are roots of the loop's thread, each after
    # its batch's span
    tail = [r for r in recs if r.parent is None
            and r.name != "datagen.batch" and r.thread == main]
    assert [(r.name, r.unit) for r in tail] == [
        ("datagen.flush", 0), ("datagen.flush", 2), ("datagen.flush", 4),
        ("datagen.join", 4)]
    for r, b in zip(tail, batches):
        assert r.start_ns >= b.end_ns
    # one write a flush, on the writer's thread
    writes = [r for r in recs if r.name == "datagen.write"]
    assert len(writes) == 3 and n == 5 * 64
    assert len({r.thread for r in writes}) == 1
    assert writes[0].thread != main and writes[0].parent is None
    assert trace.counters() == {}


def test_records_map_onto_the_chrome_traces_ranges(tmp_path):
    """Every record is one ``r2l.`` range of the exported trace: the same
    names in the same order on the frame loop's one thread, each range
    inside the range of the parent its record names, and the record's
    duration that of its range (the median gap under 50 us: a record's
    clock is read just after the profiler stamps its range's ends)."""
    fn = _frame_fn()
    with _cpu_session() as prof:
        for k in range(12):
            fn(_pose(30.0 * k))
    recs = trace.records()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = sorted(
        (float(e["ts"]), -float(e["dur"]), e["name"][len(trace.PREFIX):],
         e["tid"])
        for e in json.loads(path.read_text())["traceEvents"]
        if e.get("ph") == "X" and e.get("name", "").startswith(trace.PREFIX))
    ranges = [(a, a - d, name, tid) for a, d, name, tid in ranges]
    mine = sorted(recs, key=lambda r: (r.start_ns, -r.end_ns))
    assert [r[2] for r in ranges] == [r.name for r in mine]
    assert len(mine) == 12 * 4 and len({r[3] for r in ranges}) == 1
    # the parent of each range: the innermost range open at its start
    for k, (a, b, name, _) in enumerate(ranges):
        outer = [r for r in ranges[:k] if r[0] <= a and b <= r[1]]
        assert (outer[-1][2] if outer else None) == mine[k].parent, k
    gaps = [abs((r.end_ns - r.start_ns) * 1e-3 - (b - a))
            for r, (a, b, _, _) in zip(mine, ranges)]
    assert np.median(gaps) < 50


def test_counters_go_to_the_innermost_span_and_the_store_is_bounded(
        monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with _cpu_session():
        trace.count("outside", 2)
        with trace.span("outer"):
            trace.count("n")
            with trace.span("inner"):
                trace.count("n", 4)
        for _ in range(3):
            with trace.span("more"):
                pass
    assert trace.counters() == {(None, "outside"): 2, ("outer", "n"): 1,
                                ("inner", "n"): 4, (None, "dropped_spans"): 2}
    assert [r.name for r in trace.records()] == ["inner", "outer", "more"]
    assert trace.records() == [] and trace.counters() == {}


def test_a_decorated_function_is_one_span_a_call():
    @trace.spanned("kernel.launch")
    def launch(x, *, y):
        """Doc."""
        return x + y

    assert launch.__name__ == "launch" and launch.__doc__ == "Doc."
    assert launch(1, y=2) == 3 and trace.records() == []
    with _cpu_session():
        with trace.span("frame.net"):
            launch(1, y=2)
    inner, outer = trace.records()
    assert (inner.name, inner.parent) == ("kernel.launch", "frame.net")
    assert outer.name == "frame.net"


@pytest.mark.cuda
def test_a_sync_in_a_frame_span_is_counted():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    dev = torch.device("cuda", 0)
    x = torch.ones(1024, device=dev)
    float(x.sum())                   # the allocator warmed, outside
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trace.unit(0)
        with trace.span("frame", syncs=dev):
            y = x * 2
            held = y.sum().item()    # the deliberate sync
        trace.unit(1)
        with trace.span("frame", syncs=dev):
            (x * 3).sum()
    assert held == 2048.0
    counts = trace.counters()
    assert counts[("frame", "sync")] >= 1
    assert torch.cuda.get_sync_debug_mode() == 0
    assert [r.unit for r in trace.records()] == [0, 1]
