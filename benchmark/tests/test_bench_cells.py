"""Each cell of BENCHMARK.json runs its traffic on the CPU at a tiny size,
through the program's plain versions, and comes out correct against the
reference with the cell's own limits; a cell added as data alone is
found, its kernels' counters and rooflines with it; a module of JAX's
loaded after the window keeps the result from being printed."""
import json
import shutil
import sys
import time
import types

import torch

import pytest

from _tiny import STAGED, find, run

from harness import cells, runner

CELLS = [w["name"] for w in cells.load_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS + [w["name"] for w in STAGED])
def test_cell_runs_on_the_cpu_and_is_correct(name):
    out = run(name)
    r = out["result"]
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    cell = find(name)
    want = {m["name"] for m in cell.end_to_end}
    assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert m["value"] > 0
    assert list(r)[-1] == "checks"
    assert out["forbidden"] == []


def test_every_metric_has_a_reader_and_every_cell_a_file():
    spec = cells.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for w in spec["workloads"]:
        c = cells.find(w["name"])
        assert runner.driver(c.traffic["kind"]).setup
        assert c.per_layer and c.end_to_end


def test_a_cell_added_as_data_alone_is_found(tmp_path):
    spec = cells.load_spec()
    bench = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((bench / "traffic" / "view_int8.json").read_text())
    traffic["warmup_frames"] = 4
    (bench / "traffic" / "view_int8_two.json").write_text(
        json.dumps(traffic))
    conf = json.loads((bench / "configs" / "r2l_w256_d88.json").read_text())
    conf["name"] = "r2l_w256_d44"
    conf["netdepth"], conf["num_blocks"] = 44, 21
    (bench / "configs" / "r2l_w256_d44.json").write_text(json.dumps(conf))
    (bench / "metrics" / "dummy_frames.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.window.units\n")
    spec["configs"].append({"name": "r2l_w256_d44", "source": "x",
                            "file": "benchmark/configs/r2l_w256_d44.json",
                            "reduced": ["netdepth"], "why": "x"})
    spec["workloads"].append({"name": "r2l_w256_d44.view_int8_two",
                              "config": "r2l_w256_d44",
                              "traffic": "view_int8_two", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "dummy_frames", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "frame entry",
                              "moves": "frames_per_s",
                              "workloads": ["r2l_w256_d44.view_int8_two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cells.find("r2l_w256_d44.view_int8_two", tmp_path)
    assert c.traffic["warmup_frames"] == 4 and c.config["netdepth"] == 44
    assert [m["name"] for m in c.per_layer][-1] == "dummy_frames"
    read = cells.reader("dummy_frames", bench / "metrics")

    class W:
        units = 3

    class Ctx:
        window = W()

    assert read(Ctx()) == 6.0


def test_an_int8_datagen_mix_is_found_with_its_kernel(tmp_path):
    """The teacher's int8 pseudo data (K7) as files alone: a traffic file
    naming its kernel, counter, counts and peak; no driver changes."""
    spec = cells.load_spec()
    bench = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH_DIR / "traffic", bench / "traffic")
    traffic = json.loads((bench / "traffic" / "datagen_f32.json")
                         .read_text())
    traffic.update(quantize="int8", precision="int8", kernels={"k7": {
        "match": ["nerf_int8_hopper_kernel"],
        "counter": "r2l_tpu_torch.kernels.nerf_render:"
                   "fused_nerf_render.launches_int8",
        "counts": "nerf_render:k6_launches", "precision": "int8"}})
    (bench / "traffic" / "datagen_int8.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": "nerf_w256_d8.datagen_int8",
                              "config": "nerf_w256_d8",
                              "traffic": "datagen_int8", "chips": 1,
                              "why": "x"})
    shutil.copytree(cells.BENCH_DIR / "configs", bench / "configs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cells.find("nerf_w256_d8.datagen_int8", tmp_path)
    assert runner.counters_of(c.traffic)() == {
        "k7": fused_nerf_render_launches_int8()}

    class Trace:
        launches = {"k7": 160}

    info = runner.kernels_of(c.config, c.traffic, Trace())["k7"]
    from counts import nerf_render
    from harness.peaks import PEAK_OPS
    batch = nerf_render.pose_ops(c.config, 400 * 400, 64, 128) * 8
    # 160 launches: two batches of 8 poses, operations-bound at int8
    assert info.bound_s == pytest.approx(2 * batch / PEAK_OPS["int8"])
    assert info.match == ("nerf_int8_hopper_kernel",)
    # and the driver runs it (on the CPU the teacher's plain version)
    from _tiny import TINY
    out = runner.run(c, 5, 0.2, False, time.perf_counter(),
                     torch.device("cpu"), TINY["datagen"])
    assert out["result"]["correct"], out["result"]["checks"]


def fused_nerf_render_launches_int8() -> int:
    from r2l_tpu_torch.kernels.nerf_render import fused_nerf_render
    return fused_nerf_render.launches_int8


def test_jax_loaded_after_the_window_is_found(monkeypatch):
    from harness.drivers import view
    check = view.check

    def loads_jax(job, win):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(job, win)

    monkeypatch.setattr(view, "check", loads_jax)
    assert run("r2l_w256_d88.view_f32")["forbidden"] == ["jax"]


def test_run_prints_no_result_when_jax_is_loaded(monkeypatch, capsys):
    import run as bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def fake_run(*a, **k):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return {"result": {"correct": True}, "checks": [], "readings": [],
                "forbidden": []}

    monkeypatch.setattr(runner, "run", fake_run)
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 1 and out.out == "" and "flax" in out.err
