#!/usr/bin/env python3
"""The benchmark of ``r2l_tpu_torch`` on one NVIDIA H100: one run of one
cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. It sets up the cell (weights and traffic
from ``--seed``; the kernels built once into ``build/`` inside the
checkout), measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks`` (each compared number
beside its limit, also the last lines of standard error). Without a card,
or with fewer cards than the cell asks for, it exits 1 and prints no
result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BUILD = ROOT / "build"

# every build and kernel cache of the program at a fixed place inside the
# checkout, so that only a cell's first run in it builds
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from harness import cells, runner
    cell = cells.find(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is false; the benchmark "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), T0,
                     torch.device("cuda", 0))
    for c in out["readings"]:
        print(f"reading {c.name} {c.value!r} (not compared)",
              file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              + ("ok" if c.ok else "FAILED"), file=sys.stderr)
    line = json.dumps(out["result"])
    # read once more right before the result: nothing loaded after the
    # window, this process's own printing included, may be JAX's
    found = sorted(set(out["forbidden"]) | set(runner.forbidden_modules()))
    if found:
        print("benchmark: the run loaded " + ", ".join(found)
              + ": the port must not", file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
