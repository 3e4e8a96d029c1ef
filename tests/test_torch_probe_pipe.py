"""Port parity: K2 with its ray tile split into S streams
(r2l_tpu_torch/exp/probe_pipe_lib.py) against exp/probe_pipe_lib.py's
apply_int8_pe_streams, run under pltpu.force_tpu_interpret_mode() (it has no
interpret parameter) on the same int8 packing: JAX's calibration carried
over field by field (tests/_torch_parity.py::int8_params_from_jax), both
packings (fold_requant=True, as the driver uses it, and False), small R2L
configs (width 64 and 256, depth 6-8), 256 rays in 64-ray tiles."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import int8_case, int8_params_from_jax, load_exp_probe, n, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import probe_pipe as PP
from r2l_tpu_torch.exp import probe_pipe_lib as P
from r2l_tpu_torch.kernels import r2l_fused as F

JL = load_exp_probe("probe_pipe_lib")
DP, L = 6, 4
# Tolerances against the JAX probe on the CPU:
# * with a linear tail, bit for bit: exact int32 dots, the same one-FMA
#   dequantize and roundings, the same sin/cos on these inputs;
# * with the sigmoid tail, one f32 ulp of [0.5, 1): torch's and XLA's CPU
#   sigmoid differ by an ulp on a few outputs (ROADMAP C; measured 5.96e-8
#   in 2-4 of 768 outputs), the int8 chain before it being equal.
TOL_SIGMOID = 6e-8


def _case(W, D, fold, linear_tail):
    jcfg, params, cfg, model, calib, pts = int8_case(
        DP, L, W, D, 16, linear_tail=linear_tail)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DP, L,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=fold)
    like = F.calibrate_r2l_int8_pe(model, cfg, DP, L, t(calib),
                                   fold_requant=fold)
    return jcfg, jfp, cfg, int8_params_from_jax(jfp, like), pts


def _jax_streams(jfp, jcfg, pts, streams):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(JL.apply_int8_pe_streams(
            jfp, jcfg, jnp.asarray(pts), DP, L, tile=64, streams=streams))


@pytest.mark.parametrize("linear_tail", [True, False])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("W,D", [(64, 8), (256, 6)])
def test_streams_match_the_jax_probe(W, D, fold, linear_tail):
    """At S = 1, 2, 4 the JAX probe gives its K2 (fold_requant +
    nobf16_inner) bit for bit, and the port's plain version gives it too
    (within the sigmoid's ulp)."""
    jcfg, jfp, cfg, fp, pts = _case(W, D, fold, linear_tail)
    k2 = np.asarray(JP.fused_r2l_apply_int8_pe(
        jfp, jcfg, jnp.asarray(pts), DP, L, tile=64, interpret=True,
        fold_requant=True, nobf16_inner=True))
    for s in P.STREAMS:
        want = _jax_streams(jfp, jcfg, pts, s)
        np.testing.assert_array_equal(want, k2)
        got = n(P.apply_int8_pe_streams(fp, cfg, t(pts), DP, L, streams=s))
        assert got.shape == want.shape == (256, 3)
        if linear_tail:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= TOL_SIGMOID
        np.testing.assert_array_equal(got, n(F.fused_r2l_apply_int8_pe(
            fp, cfg, t(pts), DP, L)))


def test_streams_refuse_other_counts():
    _, _, cfg, fp, pts = _case(64, 8, True, True)
    with pytest.raises(ValueError, match="streams"):
        P.apply_int8_pe_streams(fp, cfg, t(pts), DP, L, streams=3)


def test_runner_checksum_matches_jax():
    """The driver's frame loop (``sample_test`` -> the variant -> the
    frame's sum) on two small frames against JAX's: the same per-frame sums
    up to their f32 order and the sigmoid's ulp."""
    from r2l_tpu.rays import pose_spherical
    from r2l_tpu.sampler import PointSampler as JSampler
    from r2l_tpu_torch.sampler import PointSampler
    jcfg, jfp, cfg, fp, _ = _case(64, 8, True, False)
    kw = dict(H=8, W=8, focal=10.0, n_sample=DP // 3, near=2.0, far=6.0)
    js, ps = JSampler(**kw), PointSampler(**kw)
    want = got = 0.0
    for th in (0.0, 90.0):
        c2w = pose_spherical(th, -30.0, 4.0)[:3, :4]
        want += float(np.sum(_jax_streams(
            jfp, jcfg, np.asarray(js.sample_test(jnp.asarray(c2w))), 2)))
        got += float(P.apply_int8_pe_streams(
            fp, cfg, ps.sample_test(torch.from_numpy(c2w).float()), DP, L,
            streams=2).sum())
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_driver_bound_is_the_frames():
    """The driver's bound: 160,000 rays of the canonical chain at the
    data-sheet int8 rate, 0.953 ms a frame."""
    from r2l_tpu_torch.models import R2LConfig
    ops = _harness.chain_ops(R2LConfig(), 400 * 400, 1008)
    assert _harness.bound_ms(ops, "int8") == pytest.approx(0.9532, abs=1e-4)


def test_runner_needs_a_gpu(capsys):
    """Without CUDA the driver exits non-zero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        PP.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
