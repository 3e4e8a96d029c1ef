"""Each cell's control (the reference in the program's place, one
precision below the path's; for training the program's own int8 path)
comes out not correct against the cell's limits, while the program comes
out correct. On the CPU where the control can run there (int4 codes, the
int8 training path) at full widths and a small frame or batch; on the card
(``cuda``) at each cell's own size with a short window."""
import time

import pytest

from _tiny import run

from harness import cells, runner


def _fails(readings: dict, limits: dict) -> list[str]:
    return [k for k, v in readings.items()
            if limits.get(k) is not None and v > limits[k]]


@pytest.mark.parametrize("name", ["r2l_w256_d88.view_int8",
                                  "r2l_w256_d88.distill_bf16"])
def test_the_control_fails_on_the_cpu(name):
    out = run(name)
    assert out["result"]["correct"], out["result"]["checks"]
    job = out["ctx"].job
    ctl = runner.driver(job.traffic["kind"]).control(job)
    assert _fails(ctl, runner.limits_of(job)), ctl


CELLS = [w["name"] for w in cells.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name, cuda_device):
    cell = cells.find(name)
    out = runner.run(cell, 2 ** 31 + 77, 1.0, False, time.perf_counter(),
                     cuda_device)
    assert out["result"]["correct"], out["result"]["checks"]
    job = out["ctx"].job
    ctl = runner.driver(cell.traffic["kind"]).control(job)
    assert _fails(ctl, runner.limits_of(job)), ctl
