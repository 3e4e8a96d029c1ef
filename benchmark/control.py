#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, one run
of the cell (a short window), the numbers its check compares (the
program's), then the same numbers with the reference in the program's
place one precision below the path's (the control's). One JSON line a
seed; the benchmark's own runs do not run the control.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--out PATH] [--fault NAME]

With ``--fault`` the program runs with that fault of ``harness/faults.py``
planted and the line holds its readings (no control).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    p.add_argument("--fault", default="",
                   help="a fault of harness/faults.py planted in the "
                        "program: its readings, no control")
    a = p.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch
    import contextlib
    from harness import cells, faults, runner
    if not torch.cuda.is_available():
        print("control: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cell = cells.find(a.workload, ROOT)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        with (faults.FAULTS[a.fault]() if a.fault
              else contextlib.nullcontext()):
            out = runner.run(cell, seed, a.seconds, False, t0, dev)
        ctl = ({} if a.fault else
               runner.driver(cell.traffic["kind"]).control(out["ctx"].job))
        rec = {"workload": a.workload, "seed": seed,
               "program": {c.name: c.value
                           for c in out["checks"] + out["readings"]},
               "control": ctl, "control_kind": cell.traffic["check"][
                   "control"], "fault": a.fault,
               "units": out["result"]["attempted"],
               "metrics": out["result"]["metrics"],
               "device": out["result"]["device"]}
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
