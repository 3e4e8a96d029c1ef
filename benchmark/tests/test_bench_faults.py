"""A run of each cell with its timed path broken underneath comes out not
correct: once for each fault the cell can have (a frame, a pose batch or a
step's batch with half its rays left out; an answer altered where it is
produced; rays moved; a step that leaves its state unchanged; the full
hard pool's slots drawn wrong). The runs
are the harness's own, on the CPU at a small size, past its look for a
card; the faults are ``harness/faults.py``'s."""
import pytest

from _tiny import run

from harness.faults import FAULTS

CASES = [
    ("r2l_w256_d88.view_int8", "view_half_left_out", "frame_rmse"),
    ("r2l_w256_d88.view_f32", "view_half_left_out", "frame_rmse"),
    ("r2l_w256_d88.view_int8", "view_altered_int8", "frame_max_abs"),
    ("r2l_w256_d88.view_f32", "view_altered_pe", "frame_max_abs"),
    ("nerf_w256_d8.datagen_f32", "datagen_half_left_out", "records_short"),
    ("nerf_w256_d8.datagen_f32", "datagen_altered_plain", "rgb_max_abs"),
    ("nerf_w256_d8.datagen_f32", "datagen_rays_moved", "rays_off"),
    ("r2l_w256_d88.distill_bf16", "distill_unchanged", "change_gap"),
    ("r2l_w256_d88.distill_bf16", "distill_half_batch", "mined_off"),
    ("r2l_w256_d88.distill_bf16", "distill_pool_slots", "full_mined_off"),
]


@pytest.mark.parametrize("name,fault,number", CASES)
def test_a_fault_makes_the_run_not_correct(name, fault, number):
    with FAULTS[fault]():
        r = run(name)["result"]
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]
