"""Small sizes of each kind of traffic at the published widths (a 64x64
frame, 8x8 datagen poses, a 1,280-ray step whose pool fills in five
steps), for runs of the harness on the CPU (the program's kernels then run
their plain versions)."""
import time

import torch

TINY = {
    "view": {"config": {"H": 64, "W": 64, "focal": 88.888888},
             "traffic": {"warmup_frames": 2,
                         "check": {"frames": 3, "block_rays": 512}}},
    "datagen": {"config": {"img_H": 8, "img_W": 8, "chunk": 32},
                "traffic": {"check": {"rays": 64}}},
    "distill": {"config": {"pseudo_rays": 4096, "shard_rays": 128},
                "traffic": {"batch_rays": 1280, "hard_mul": 1,
                            "loader_workers": 2}},
}


# Cells whose files are here but that BENCHMARK.json does not list (PERF.md,
# open questions): their drivers, limits and faults stay under test, and
# listing one again is its entries in BENCHMARK.json alone.
STAGED = [{"name": "r2l_w256_d88.distill_bf16", "config": "r2l_w256_d88",
           "traffic": "distill_bf16", "chips": 1}]


def find(name: str):
    """Cell ``name`` of BENCHMARK.json, or of ``STAGED``."""
    from harness import cells
    spec = cells.load_spec()
    listed = {w["name"] for w in spec["workloads"]}
    spec["workloads"] += [w for w in STAGED if w["name"] not in listed]
    return cells.find(name, spec=spec)


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.3,
        tiny: dict | None = None) -> dict:
    """One run of cell ``name`` on the CPU at its kind's tiny size."""
    from harness import runner
    cell = find(name)
    sizes = runner.merged(TINY[cell.traffic["kind"]], tiny or {})
    return runner.run(cell, seed, seconds, False, time.perf_counter(),
                      torch.device("cpu"), sizes)
