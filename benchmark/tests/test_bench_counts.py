"""The operations and bytes of K1, K2, K3, K5 and K6 at W256 against counts
made by hand."""
import json

import pytest

from counts import nerf_render, r2l_fused, r2l_train
from harness import cells

R2L = json.loads((cells.BENCH_DIR / "configs" /
                  "r2l_w256_d88.json").read_text())
NERF = json.loads((cells.BENCH_DIR / "configs" /
                   "nerf_w256_d8.json").read_text())
FRAME = 400 * 400
STEP = 81920


def test_k1_and_k2_a_frame():
    # head 1008x256, 86 body layers 256x256, tail 256x3
    macs = 1008 * 256 + 86 * 256 * 256 + 256 * 3
    assert macs == 5_894_912
    ops, nbytes = r2l_fused.k2_counts(R2L, FRAME)
    assert ops == 2 * FRAME * macs == pytest.approx(1.886e12, rel=1e-3)
    biases = 256 * 87 + 3
    assert nbytes == FRAME * 48 * 4 + FRAME * 3 * 4 + macs + biases * 8
    ops1, nbytes1 = r2l_fused.k1_counts(R2L, FRAME)
    assert ops1 == ops
    assert nbytes1 == FRAME * 48 * 4 + FRAME * 3 * 4 + macs * 4 + biases * 4
    # at the published peaks: 0.953 ms int8, 3.81 ms of TF32
    from harness.peaks import bound_s
    assert bound_s(ops, nbytes, "int8") == pytest.approx(0.953e-3, rel=1e-3)
    assert bound_s(ops1, nbytes1, "tf32") == pytest.approx(3.81e-3, rel=1e-3)


def test_k3_a_step():
    ops, nbytes = r2l_train.k3_counts(R2L, STEP)
    assert ops == 2 * STEP * 5_894_912
    stash = 87 * STEP * 256 * 2                     # 3.65 GB of bf16 rows
    assert stash == pytest.approx(3.65e9, rel=1e-3)
    assert nbytes == (STEP * 48 * 4 + STEP * 3 * 4 + 5_894_912 * 2
                      + (256 * 87 + 3) * 4 + stash)


def test_k5_a_group_and_a_walk():
    ops, nbytes = r2l_train.k5_counts(R2L, STEP, 4)
    # 8 layers, each dL/dx and dL/dW: 2 x 2 x n x W x W
    assert ops == 8 * 4 * STEP * 256 * 256
    from harness.peaks import bound_s
    assert bound_s(ops, nbytes, "bf16") == pytest.approx(0.174e-3, rel=1e-2)
    assert nbytes == (8 * STEP * 256 * 2 + 2 * STEP * 256 * 4
                      + 8 * (256 * 256 + 256) * 6)
    assert r2l_train.k5_walk_calls(R2L) == [4] * 10 + [3]


def test_k6_a_pose():
    # 63x256, six 256x256, one (256+63)x256, then alpha 256x1, feature
    # 256x256, view (256+27)x128, rgb 128x3
    macs = (63 * 256 + 6 * 256 * 256 + 319 * 256 + 256 + 256 * 256
            + 283 * 128 + 128 * 3)
    assert nerf_render.point_macs(NERF) == macs == 593_408
    ops, nbytes = nerf_render.k6_counts(NERF, FRAME, 64)
    assert ops == 2 * FRAME * 64 * macs
    params = (63 * 256 + 256 + 6 * (256 * 256 + 256) + 319 * 256 + 256
              + 257 + 256 * 256 + 256 + 283 * 128 + 128 + 128 * 3 + 3)
    assert nerf_render.n_params(NERF) == params
    assert nbytes == FRAME * 70 * 4 + FRAME * 69 * 4 + params * 4
    pose = nerf_render.pose_ops(NERF, FRAME, 64, 128)
    assert pose == 2 * FRAME * 256 * macs == pytest.approx(48.6e12, rel=1e-3)


def test_the_launches_of_a_unit():
    from harness.peaks import bound_s
    view = {"compute_dtype": "float32"}
    assert r2l_fused.k1_launches(R2L, view) == [r2l_fused.k1_counts(R2L,
                                                                     FRAME)]
    assert r2l_fused.k2_launches(R2L, view) == [r2l_fused.k2_counts(R2L,
                                                                     FRAME)]
    step = {"batch_rays": STEP, "compute_dtype": "bfloat16",
            "group_blocks": 4}
    assert r2l_train.k3_launches(R2L, step) == [r2l_train.k3_counts(R2L,
                                                                     STEP)]
    k5 = r2l_train.k5_launches(R2L, step)
    assert k5 == [r2l_train.k5_counts(R2L, STEP, b) for b in [4] * 10 + [3]]
    # a batch of 8 poses: 40 chunks of 32,768 rays, a coarse and a fine
    # launch each, together the batch's work once
    k6 = nerf_render.k6_launches(NERF, {"poses_per_batch": 8})
    assert len(k6) == 80
    ops = sum(o for o, _ in k6)
    assert ops == pytest.approx(nerf_render.pose_ops(NERF, FRAME, 64, 128)
                                * 8)
    assert sum(bound_s(o, b, "tf32") for o, b in k6) == pytest.approx(
        ops / 495e12)
