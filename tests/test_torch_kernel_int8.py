"""Port parity: the static-scale int8 kernel module (K2 of
r2l_tpu_torch/kernels/r2l_fused.py) against r2l_tpu/kernels/r2l_pallas.py:
calibration field by field, the plain int8 chain against the Pallas kernel
in interpret mode (fold_requant=True, nobf16_inner=True), and the frozen
epilogue canary."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import kernel_layout, models, n, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.sampler import PointSampler
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.models import R2L, R2LConfig, params_from_jax

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# int8 chain against the Pallas kernel: most outputs agree to an ulp; a
# requantize flipped by an ulp of a scale or of XLA's sin moves a few
# outputs (the bounds of tests/test_pallas_int8_pe.py:45-46).
TOL_MAX, TOL_RMS = 2.5e-2, 2.5e-3
# Calibration scales: f32 forwards summed in another order (relative).
TOL_SCALE = 1e-5
# Quantized weights: an ulp of a scale can carry w*s/ws across a rounding
# midpoint, so a few entries differ by one step (measured 70 of 5.6 M at
# the canonical depth, none at 8 layers).
MAX_Q_FLIPS = 1e-4


def _case(dim_pts, L, W, D, side, seed=0, n_calib_poses=3):
    jcfg = JaxR2LConfig(input_dim=dim_pts * (2 * L + 1), netdepth=D,
                        netwidth=W)
    params, cfg, model = models(jcfg, seed=seed)
    sampler = PointSampler(H=side, W=side, focal=1.2 * side,
                           n_sample=dim_pts // 3, near=2.0, far=6.0)
    calib = np.concatenate([
        np.asarray(sampler.sample_test(jnp.asarray(
            pose_spherical(th, -30.0, 4.0)[:3, :4])))
        for th in np.linspace(0, 360, n_calib_poses, endpoint=False)])
    pts = np.asarray(sampler.sample_test(jnp.asarray(
        pose_spherical(75.0, -40.0, 4.0)[:3, :4])))
    return jcfg, params, cfg, model, calib, pts


def _assert_fields_match(fp, jfp, deep: bool = False):
    """Field by field. ``deep``: at the canonical depth the f32 calibration
    forward sums in another order through 88 layers, and channels whose
    max-abs comes out of a near-cancelling sum move by up to a few percent
    (measured: 0.6% of the body_m entries beyond TOL_SCALE, at most 2.5%),
    so there 98% of each field must meet TOL_SCALE and all of it 5%."""
    for name in fp._fields:
        got = getattr(fp, name)
        want = kernel_layout(name, getattr(jfp, name), got)
        assert tuple(got.shape) == want.shape, name
        if got.dtype == torch.int8:
            d = np.abs(got.numpy().astype(np.int32) - want)
            assert d.max() <= 1, name
            assert np.mean(d > 0) <= MAX_Q_FLIPS, (name, np.mean(d > 0))
        elif not deep:
            np.testing.assert_allclose(n(got), want, rtol=TOL_SCALE,
                                       atol=0, err_msg=name)
        else:
            rel = np.abs(n(got) - want) / np.abs(want)
            assert np.mean(rel > TOL_SCALE) <= 0.02, (name, rel.max())
            assert rel.max() <= 5e-2, (name, rel.max())


@pytest.mark.parametrize("fold_requant", [True, False])
def test_calibration_matches_jax_field_by_field(fold_requant):
    jcfg, params, cfg, model, calib, _ = _case(6, 4, 64, 8, 12)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, 6, 4,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=fold_requant)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4, t(calib),
                                 fold_requant=fold_requant)
    _assert_fields_match(fp, jfp)


@pytest.mark.parametrize("dim_pts,L,W,D,side", [(6, 4, 64, 8, 16),
                                                (48, 10, 64, 8, 8),
                                                (6, 4, 128, 6, 12)])
def test_int8_ref_matches_pallas_interpret(dim_pts, L, W, D, side):
    jcfg, params, cfg, model, calib, pts = _case(dim_pts, L, W, D, side)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, dim_pts, L,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=True)
    want = np.asarray(JP.fused_r2l_apply_int8_pe(
        jfp, jcfg, jnp.asarray(pts), dim_pts, L, tile=64, interpret=True,
        fold_requant=True, nobf16_inner=True))
    fp = F.calibrate_r2l_int8_pe(model, cfg, dim_pts, L, t(calib))
    got = n(F.fused_r2l_apply_int8_pe(fp, cfg, t(pts), dim_pts, L))
    d = got - want
    assert got.shape == want.shape
    assert np.max(np.abs(d)) < TOL_MAX, np.max(np.abs(d))
    assert np.sqrt(np.mean(d * d)) < TOL_RMS, np.sqrt(np.mean(d * d))
    np.testing.assert_array_equal(
        got, n(F.fused_r2l_apply_int8_pe_ref(fp, cfg, t(pts), dim_pts, L)))


def test_int8_canonical_shapes():
    """Canonical D=88/W=256 at 16 rays (as test_int8_pe_canonical_shapes):
    calibration and the int8 chain against the Pallas kernel."""
    jcfg, params, cfg, model, calib, pts = _case(48, 10, 256, 88, 4,
                                                 seed=1, n_calib_poses=1)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, 48, 10,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=True)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, t(calib))
    _assert_fields_match(fp, jfp, deep=True)
    want = np.asarray(JP.fused_r2l_apply_int8_pe(
        jfp, jcfg, jnp.asarray(pts), 48, 10, tile=16, interpret=True,
        fold_requant=True, nobf16_inner=True))
    got = n(F.fused_r2l_apply_int8_pe(fp, cfg, t(pts), 48, 10))
    assert got.shape == (16, 3) and np.isfinite(got).all()
    assert np.max(np.abs(got - want)) < TOL_MAX


def _canary_model():
    case = np.load(os.path.join(FIXTURES, "int8_epilogue_canary_case.npz"))
    cfg = R2LConfig(input_dim=6 * (2 * 4 + 1), netdepth=8, netwidth=64)
    model = R2L(cfg)
    model.load_state_dict(params_from_jax(
        {k: {"w": case[f"{k}_w"], "b": case[f"{k}_b"]}
         for k in ("head", "body", "tail")}, cfg))
    return cfg, model, case


def test_canary_case_fixture_is_build_case():
    """The frozen inputs are those of tools/gen_int8_epilogue_canary.py."""
    from tools.gen_int8_canary_case import case_arrays
    _, _, case = _canary_model()
    for k, v in case_arrays().items():
        np.testing.assert_array_equal(case[k], np.asarray(v, np.float32),
                                      err_msg=k)


def test_int8_epilogue_canary():
    """The port's int8 chain on the canary case against the JAX kernel's
    frozen output. Not bit for bit: XLA on the CPU contracts the dequantize
    acc*m+b into an FMA where the port rounds the product and the sum on
    their own (ROADMAP C). Measured: 4 of 192 outputs 5.96e-8 apart (one
    or two f32 ulp), and with FMA emulated in the tail the two agree bit
    for bit."""
    cfg, model, case = _canary_model()
    want = np.load(os.path.join(FIXTURES, "int8_epilogue_canary.npz"))["rgb"]
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4, t(case["calib"]))
    got = n(F.fused_r2l_apply_int8_pe(fp, cfg, t(case["pts"]), 6, 4))
    np.testing.assert_allclose(got, want, rtol=0, atol=5.97e-8)
    assert int(np.sum(got != want)) <= 4
    fused_tail = _tail_with_fma(fp, cfg, t(case["pts"]))
    np.testing.assert_array_equal(n(fused_tail), want)


def _tail_with_fma(fp, cfg, pts):
    """The plain int8 chain with the tail's acc*m+b computed as one fused
    multiply-add (f64 products of these integers and f32 scales are
    exact), as XLA on the CPU computes it."""
    captured = {}
    mm = F._mm_int

    def spy(q, w):
        captured["acc"] = mm(q, w)
        return captured["acc"]

    F._mm_int = spy
    try:
        F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, 6, 4)
    finally:
        F._mm_int = mm
    acc = captured["acc"].double()
    return torch.sigmoid((acc * fp.tail_m.double()
                          + fp.tail_b.double()).float())
