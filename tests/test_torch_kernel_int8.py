"""Port parity: the static-scale int8 kernel module (K2 of
r2l_tpu_torch/kernels/r2l_fused.py) against r2l_tpu/kernels/r2l_pallas.py:
calibration field by field, the plain int8 chain against the Pallas kernel
in interpret mode (fold_requant=True, nobf16_inner=True, and K2's other two
forms by its flags), and the frozen epilogue canary."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (int8_case, int8_params_from_jax, kernel_layout,
                           models, n, t)
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
# K2's forms on JAX's own packing (carried over field by field): bit for bit
# with a linear tail; with the sigmoid tail one f32 ulp of [0.5, 1), where
# torch's and XLA's CPU sigmoid differ on a few outputs (ROADMAP C).
TOL_SIGMOID = 6e-8
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


@pytest.mark.parametrize("linear_tail", [True, False])
@pytest.mark.parametrize("fold_requant,nobf16_inner",
                         [(True, True), (True, False), (False, False),
                          (False, True)])
def test_int8_flags_match_pallas_interpret(fold_requant, nobf16_inner,
                                           linear_tail):
    """K2's three forms (``nobf16_inner`` acts only with ``fold_requant``),
    each on the packing calibrated with its ``fold_requant``, against the
    Pallas kernel with the same flags on the same packing."""
    jcfg, params, cfg, model, calib, pts = int8_case(
        6, 4, 64, 8, 16, linear_tail=linear_tail)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, 6, 4,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=fold_requant)
    fp = int8_params_from_jax(jfp, F.calibrate_r2l_int8_pe(
        model, cfg, 6, 4, t(calib), fold_requant=fold_requant))
    want = np.asarray(JP.fused_r2l_apply_int8_pe(
        jfp, jcfg, jnp.asarray(pts), 6, 4, tile=64, interpret=True,
        fold_requant=fold_requant, nobf16_inner=nobf16_inner))
    got = n(F.fused_r2l_apply_int8_pe(fp, cfg, t(pts), 6, 4,
                                      fold_requant=fold_requant,
                                      nobf16_inner=nobf16_inner))
    assert got.shape == want.shape
    if linear_tail:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= TOL_SIGMOID
    assert F.int8_epilogue(fold_requant, nobf16_inner) == (
        "unfolded" if not fold_requant
        else "deployed" if nobf16_inner else "fold")


def test_int8_flags_are_three_functions():
    """On one packing the three forms differ from each other."""
    jcfg, params, cfg, model, calib, pts = int8_case(6, 4, 64, 8, 16,
                                                      linear_tail=True)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4, t(calib))
    outs = [n(F.fused_r2l_apply_int8_pe(fp, cfg, t(pts), 6, 4,
                                        fold_requant=f, nobf16_inner=b))
            for f, b in ((True, True), (True, False), (False, False))]
    assert not np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[1], outs[2])


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
    model = R2L(cfg, device="cpu")
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
    frozen output, bit for bit: the dequantize acc*m+b is one fused
    multiply-add, as XLA on the CPU contracts it (it was 1 f32 ulp off in 4
    of 192 outputs while the port rounded the product and the sum on their
    own)."""
    cfg, model, case = _canary_model()
    want = np.load(os.path.join(FIXTURES, "int8_epilogue_canary.npz"))["rgb"]
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4, t(case["calib"]))
    got = n(F.fused_r2l_apply_int8_pe(fp, cfg, t(case["pts"]), 6, 4))
    np.testing.assert_array_equal(got, want)


def test_dequant_is_one_rounding():
    """``_dequant`` rounds acc*m+b once: where the f32 product alone would
    round away the low bits that decide the sum, the result is the exact
    value's nearest f32, not the twice-rounded one."""
    acc = torch.tensor([16777215.0, 3.0, -7.0])
    m = torch.tensor([1.0 + 2.0 ** -23, 1.0 / 3.0, 0.1])
    b = torch.tensor([-16777215.0, -1.0, 0.7])
    exact = acc.double() * m.double() + b.double()
    np.testing.assert_array_equal(n(F._dequant(acc, m, b)),
                                  exact.float().numpy())
    assert float(F._dequant(acc, m, b)[0]) != float(acc[0] * m[0] + b[0])
