"""Finding a cell by its name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration (a file of sizes under ``benchmark/configs``),
its traffic (``benchmark/traffic/<traffic>.json``) and its metrics (each a
reader ``benchmark/metrics/<name>.py``). A later cell or metric is added as
files and entries; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
TRAFFIC_DIR = BENCH_DIR / "traffic"
METRICS_DIR = BENCH_DIR / "metrics"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]      # the entries of BENCHMARK.json it reports
    per_layer: list[dict]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, root: Path = ROOT, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files read."""
    spec = spec or load_spec(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / TRAFFIC_DIR.relative_to(ROOT)
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def reader(metric: str, metrics_dir: Path = METRICS_DIR):
    """The ``read(ctx)`` function of metric ``metric``."""
    path = metrics_dir / f"{metric}.py"
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
