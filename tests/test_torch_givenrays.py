"""Port parity: the frame path's remainder (r2l_tpu_torch/evaluate.py)
against r2l_tpu.evaluate: the DONeRF given-rays frames and bench for the
kinds jnp, pe and int8, their int8 calibration points and the calib_pts
form of _prepare_r2l, the reuse of a frame function's packing, and the
teacher's benchmark (make_nerf_bench_fn)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.evaluate as JE
import r2l_tpu.render as jrender
from _torch_parity import n, nerf_models, t
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import evaluate as TE
from r2l_tpu_torch import render
from r2l_tpu_torch.sampler import PointSampler
from test_torch_frame import FLAGS, H, POSES, SAMPLER, TOL, W, _cfgs

# _givenrays_calib_pts against JAX: o + d*z in f32, where XLA may contract
# the product and the sum into one FMA (the geometry tests' bound,
# tests/test_torch_geometry.py).
TOL_PTS = 1e-5
# The teacher's benchmark checksum against JAX's: every pixel within the
# plain frame render's rtol 1e-4 / atol 2e-4 (tests/test_torch_teacher.py),
# summed over 2 frames of 8x8x3 values of about 0.5: relative 1e-4.
RTOL_NERF_CHECKSUM = 1e-4


def _rays(poses):
    """Each pose's own rays (JAX's frame_rays), [K, H*W, 3] each."""
    js = JaxPointSampler(**SAMPLER)
    pairs = [js.frame_rays(jnp.asarray(p)) for p in poses]
    return (np.stack([np.asarray(o) for o, _ in pairs]),
            np.stack([np.asarray(d) for _, d in pairs]))


def _given_fns(kind, dtype="bf16", **kw):
    jcfg, params, cfg, model = _cfgs(
        jnp.float32 if dtype == "f32" else jnp.bfloat16)
    ros, rds = _rays(POSES)
    jfn = JE.make_r2l_givenrays_frame_fn(
        params, jcfg, JaxPointSampler(**SAMPLER), H, W,
        calib_rays=(ros, rds), **FLAGS[kind], **kw)
    tfn = TE.make_r2l_givenrays_frame_fn(
        model, cfg, PointSampler(**SAMPLER), H, W, calib_rays=(ros, rds),
        **FLAGS[kind], **kw)
    return jfn, tfn, model, cfg, ros, rds


@pytest.mark.parametrize("kind,dtype", sorted(TOL))
def test_givenrays_frame_fn_matches_jax(kind, dtype):
    jfn, tfn, *_, ros, rds = _given_fns(kind, dtype)
    assert jfn.kind == tfn.kind == kind
    assert tfn.parts[1:] == (kind, 48)
    tol_max, tol_rms = TOL[(kind, dtype)]
    for ro, rd in zip(ros[:2], rds[:2]):
        want = np.asarray(jfn(jnp.asarray(ro), jnp.asarray(rd)))
        got = n(tfn(ro, rd))
        assert got.shape == want.shape == (H, W, 3)
        d = got - want
        assert np.max(np.abs(d)) < tol_max, np.max(np.abs(d))
        if tol_rms is not None:
            assert np.sqrt(np.mean(d * d)) < tol_rms


@pytest.mark.parametrize("n_rays", [3 * H * W, 20000])
def test_givenrays_calib_pts_match_jax(n_rays):
    """A linspace pick of at most 16,384 of the rays (all of the 3 poses'
    192; 16,384 of 20,000 random ones, [4, 5000, 3]), through
    sample_train's even depths; tensors are picked where they lie."""
    if n_rays == 3 * H * W:
        ros, rds = _rays(POSES)
    else:
        rng = np.random.default_rng(3)
        ros = rng.normal(size=(4, 5000, 3)).astype(np.float32)
        rds = rng.normal(size=(4, 5000, 3)).astype(np.float32)
    js, ts = JaxPointSampler(**SAMPLER), PointSampler(**SAMPLER)
    want = np.asarray(JE._givenrays_calib_pts(js, False, "int8",
                                              (ros, rds)))
    got = TE._givenrays_calib_pts(ts, False, "int8", (ros, rds),
                                  torch.device("cpu"))
    assert got.shape == want.shape == (min(n_rays, 16384), 48)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=TOL_PTS)
    got_t = TE._givenrays_calib_pts(ts, False, "int8", (t(ros), t(rds)),
                                    torch.device("cpu"))
    assert torch.equal(got_t, got)


@pytest.mark.parametrize("plucker,quantize,rays", [
    (False, "", True), (True, "int8", True), (False, "int8", False)])
def test_givenrays_calib_pts_none_where_jax_is(plucker, quantize, rays):
    ros, rds = _rays(POSES[:1])
    calib = (ros, rds) if rays else None
    assert JE._givenrays_calib_pts(JaxPointSampler(**SAMPLER), plucker,
                                   quantize, calib) is None
    assert TE._givenrays_calib_pts(PointSampler(**SAMPLER), plucker,
                                   quantize, calib,
                                   torch.device("cpu")) is None


def test_prepare_r2l_calib_pts_win_over_poses(capsys):
    """calib_pts: no pose pick and no fallback warning; the int8 packing is
    the calibration on exactly those points."""
    from r2l_tpu_torch.kernels.r2l_fused import calibrate_r2l_int8_pe
    _, _, cfg, model = _cfgs(jnp.bfloat16)
    ts = PointSampler(**SAMPLER)
    ros, rds = _rays(POSES)
    pts = TE._givenrays_calib_pts(ts, False, "int8", (ros, rds),
                                  torch.device("cpu"))
    prepared, kind, dim_pts = TE._prepare_r2l(
        model, cfg, ts, 10, False, True, "int8", calib_pts=n(pts))
    assert kind == "int8" and dim_pts == 48
    assert "WARNING" not in capsys.readouterr().err
    want = calibrate_r2l_int8_pe(model, cfg, 48, 10, calib_pts=pts,
                                 fold_requant=True)
    for name in want._fields:
        a, b = getattr(prepared, name), getattr(want, name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), name


@pytest.mark.parametrize("kind", ["jnp", "pe"])
def test_givenrays_frame_on_a_poses_rays_is_its_pose_frame(kind):
    """sample_test is frame_rays then sample_train's even depths, so a
    given-rays frame on a pose's own rays is that pose's frame, bit for
    bit."""
    _, _, cfg, model = _cfgs(jnp.bfloat16)
    ts = PointSampler(**SAMPLER)
    pose_fn = TE.make_r2l_frame_fn(model, cfg, ts, **FLAGS[kind])
    ray_fn = TE.make_r2l_givenrays_frame_fn(model, cfg, ts, H, W,
                                            **FLAGS[kind])
    for c2w in POSES:
        ro, rd = ts.frame_rays(t(c2w))
        assert torch.equal(ray_fn(ro, rd), pose_fn(c2w))


@pytest.mark.parametrize("kind", ["jnp", "pe", "int8"])
def test_givenrays_bench_checksum_and_parts_reuse(kind, monkeypatch):
    """The bench checksum is the sum of the frames; with ``parts`` the bench
    function calibrates no second time (JAX's ``.parts`` contract)."""
    import r2l_tpu_torch.evaluate as ev
    calls = []
    real = ev.calibrate_r2l_int8_pe
    monkeypatch.setattr(ev, "calibrate_r2l_int8_pe",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    _, _, cfg, model = _cfgs(jnp.bfloat16)
    ts = PointSampler(**SAMPLER)
    ros, rds = _rays(POSES)
    frame = TE.make_r2l_givenrays_frame_fn(model, cfg, ts, H, W,
                                           calib_rays=(ros, rds),
                                           **FLAGS[kind])
    n_calib = len(calls)
    assert n_calib == (kind == "int8")
    bench = TE.make_r2l_givenrays_bench_fn(model, cfg, ts, H, W,
                                           parts=frame.parts, **FLAGS[kind])
    assert len(calls) == n_calib and bench.kind == kind
    want = sum(float(frame(ro, rd).double().sum()) for ro, rd in
               zip(ros, rds))
    got = float(bench(t(ros), t(rds)))
    assert abs(got - want) <= 1e-5 * abs(want)
    # without parts it prepares its own, calibrated on the same rays
    fresh = TE.make_r2l_givenrays_bench_fn(model, cfg, ts, H, W,
                                           calib_rays=(ros, rds),
                                           **FLAGS[kind])
    assert len(calls) == 2 * n_calib
    assert float(fresh(ros, rds)) == got


def test_givenrays_bench_matches_jax():
    jcfg, params, cfg, model = _cfgs(jnp.bfloat16)
    ros, rds = _rays(POSES)
    jb = JE.make_r2l_givenrays_bench_fn(params, jcfg,
                                        JaxPointSampler(**SAMPLER), H, W,
                                        use_pallas=False)
    tb = TE.make_r2l_givenrays_bench_fn(model, cfg, PointSampler(**SAMPLER),
                                        H, W, use_pallas=False)
    want = float(jb(jnp.asarray(ros), jnp.asarray(rds)))
    got = float(tb(ros, rds))
    # each pixel within the jnp bf16 frame tolerance (TOL), 3 frames of 192
    assert abs(got - want) <= TOL[("jnp", "bf16")][0] * ros.shape[0] * H * W * 3


def _teacher():
    jcfg = JNeRFConfig(D=3, W=32, skips=(1,), input_ch=3 * 9,
                       input_ch_views=3 * 5, use_viewdirs=True)
    pc, cfg, mc = nerf_models(jcfg, seed=4)
    pf, _, mf = nerf_models(jcfg, seed=5)
    jv = jrender.VolRenderConfig(n_coarse=8, n_fine=6, use_viewdirs=True,
                                 multires=4, multires_views=2, near=2.0,
                                 far=6.0, white_bkgd=True, ray_chunk=48)
    tv = render.VolRenderConfig(**dataclasses.asdict(jv))
    return jcfg, pc, pf, jv, cfg, mc, mf, tv


def test_nerf_bench_fn_matches_jax():
    """The teacher's benchmark, plain on the CPU (use_pallas asks for the
    fused kernel, which runs only on the card), against JAX's checksum and
    against the sum of the port's frames."""
    jcfg, pc, pf, jv, cfg, mc, mf, tv = _teacher()
    sampler = dict(H=H, W=W, focal=10.0, n_sample=8, near=2.0, far=6.0)
    want = float(JE.make_nerf_bench_fn(pc, pf, jcfg, jv,
                                       JaxPointSampler(**sampler))(
        jnp.asarray(POSES[:2])))
    bench = TE.make_nerf_bench_fn(mc, mf, cfg, tv, PointSampler(**sampler),
                                  use_pallas=True, device="cpu")
    assert bench.kind == "plain"
    got = float(bench(POSES[:2]))
    np.testing.assert_allclose(got, want, rtol=RTOL_NERF_CHECKSUM)
    frame = TE.make_nerf_frame_fn(mc, mf, cfg, tv, PointSampler(**sampler),
                                  device="cpu")
    frames = sum(float(frame(p).double().sum()) for p in POSES[:2])
    assert abs(got - frames) <= 1e-5 * abs(frames)


def test_nerf_bench_fn_takes_the_cards_device_rule():
    import inspect
    _, _, _, _, cfg, mc, mf, tv = _teacher()
    assert inspect.signature(TE.make_nerf_bench_fn).parameters[
        "device"].default == torch.device("cuda")
    with pytest.raises(ValueError, match="expected cuda"):
        TE.make_nerf_bench_fn(mc, mf, cfg, tv, PointSampler(**SAMPLER))
