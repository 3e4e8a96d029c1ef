"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; every test here is marked ``cuda`` and skips
without a GPU. Imports neither JAX nor the JAX package, so it also runs on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from r2l_tpu_torch.evaluate import _calibration_points
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.models import R2L, R2LConfig, init_r2l, params_from_jax
from r2l_tpu_torch.rays import pose_spherical
from r2l_tpu_torch.sampler import PointSampler

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# K1 f32: the same f32 chain, sums in another order. K1 bf16: a flipped
# bf16 rounding of an activation propagates (tests/test_pallas_pe.py:50).
# K2: exact int32 dots and the plain version's epilogue order; a flipped
# requantize may move a few outputs (tests/test_pallas_int8_pe.py:45-46).
TOL_F32, TOL_BF16 = 1e-4, 3e-2
TOL_INT8_MAX, TOL_INT8_RMS = 2.5e-2, 2.5e-3

# (netwidth, n_learnable, n_sample (dim_pts/3), L, other knobs): the
# canonical layout, then the other widths and depths the kernels take.
CASES = {
    "w256_canonical": (256, 2, 16, 10, {}),
    "w128_nl3_dim6": (128, 3, 2, 10, {"res_scale": 0.5}),
    "w64_nl1_linear": (64, 1, 16, 4, {"use_residual": False,
                                      "linear_tail": True}),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(name, dev, compute_dtype=torch.bfloat16, n_rays=1000):
    W, nl, n_sample, L, kw = CASES[name]
    dp = 3 * n_sample
    cfg = R2LConfig(input_dim=dp * (2 * L + 1), netdepth=12, netwidth=W,
                    n_learnable=nl, compute_dtype=compute_dtype, **kw)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    sampler = PointSampler(H=40, W=25, focal=30.0, n_sample=n_sample,
                           near=2.0, far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in (0.0, 120.0, 240.0)])
    pts = sampler.sample_test(torch.as_tensor(poses[1], device=dev))
    return cfg, model, sampler, poses, pts[:n_rays].contiguous(), dp, L


def _deltas(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    d = (got - want).double()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_pe_kernel_matches_plain(dev, name, wd):
    cfg, model, _, _, pts, dp, L = _case(name, dev)
    fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd)
    before = F.fused_r2l_apply_pe.launches
    got = F.fused_r2l_apply_pe(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert F.fused_r2l_apply_pe.launches == before + 1
    want = F.fused_r2l_apply_pe_ref(fp, cfg, pts, dp, L)
    mx, _ = _deltas(got, want)
    assert mx < (TOL_F32 if wd == torch.float32 else TOL_BF16), mx


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_kernel_matches_plain(dev, name):
    cfg, model, sampler, poses, pts, dp, L = _case(name, dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev))
    before = F.fused_r2l_apply_int8_pe.launches
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert F.fused_r2l_apply_int8_pe.launches == before + 1
    mx, rms = _deltas(got, F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, dp, L))
    assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (mx, rms)


def test_int8_canary_on_card(dev):
    """The frozen canary: the kernel equals its plain version bit for bit
    and stays within 1e-6 of the JAX reference's output (XLA on the CPU
    fuses acc*m+b into an FMA where the port rounds twice)."""
    case = np.load(os.path.join(FIXTURES, "int8_epilogue_canary_case.npz"))
    want = np.load(os.path.join(FIXTURES, "int8_epilogue_canary.npz"))["rgb"]
    cfg = R2LConfig(input_dim=6 * 9, netdepth=8, netwidth=64)
    model = R2L(cfg)
    model.load_state_dict(params_from_jax(
        {k: {"w": case[f"{k}_w"], "b": case[f"{k}_b"]}
         for k in ("head", "body", "tail")}, cfg))
    model.to(dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4,
                                 torch.from_numpy(case["calib"]).to(dev))
    pts = torch.from_numpy(case["pts"]).to(dev)
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, 6, 4)
    assert torch.equal(got, F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, 6, 4))
    assert float(np.abs(got.cpu().numpy() - want).max()) < 1e-6


def test_wrappers_raise_instead_of_falling_back(dev):
    """A CUDA tensor the kernel does not take raises; nothing runs the
    plain version in its place."""
    cfg, model, _, _, pts, dp, L = _case("w256_canonical", dev)
    fp = F.prepare_fused_params_pe(model, cfg, dp, L)
    with pytest.raises(TypeError):
        F.fused_r2l_apply_pe(fp, cfg, pts.double(), dp, L)
    with pytest.raises(ValueError):
        F.fused_r2l_apply_pe(fp._replace(head_b=fp.head_b.cpu()), cfg, pts,
                             dp, L)
    wide = dataclasses.replace(cfg, netwidth=96)
    with pytest.raises(ValueError):
        F.fused_r2l_apply_pe(fp, wide, pts, dp, L)
