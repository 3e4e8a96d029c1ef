"""Port parity: the student frame path (r2l_tpu_torch/evaluate.py) against
r2l_tpu.evaluate: make_r2l_frame_fn for the kinds jnp, pe and int8 on the
same weights and poses, the bench checksum, and the dispatch rules."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.evaluate as JE
from _torch_parity import models, n
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import evaluate as TE
from r2l_tpu_torch.sampler import PointSampler

H = W = 8
SAMPLER = dict(H=H, W=W, focal=10.0, n_sample=16, near=2.0, far=6.0)
POSES = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                  for t in (-180.0, -60.0, 60.0)])
# Tolerance per kind, as in the kernel and model tests: f32 plain module
# (sum order), bf16 plain module (one f32 ulp measured; room for a flipped
# bf16 rounding), PE-fused bf16 (tests/test_pallas_pe.py:50), int8
# (tests/test_pallas_int8_pe.py:45-46, max and RMS).
TOL = {("jnp", "f32"): (1e-5, None), ("jnp", "bf16"): (1e-3, None),
       ("pe", "bf16"): (3e-2, None), ("int8", "bf16"): (2.5e-2, 2.5e-3)}
FLAGS = {"jnp": dict(use_pallas=False), "pe": dict(use_pallas=True),
         "int8": dict(use_pallas=True, quantize="int8")}


def _cfgs(dtype, **kw):
    kw = {"input_dim": 48 * 21, **kw}
    jcfg = JaxR2LConfig(netdepth=8, netwidth=64, compute_dtype=dtype,
                        precision="highest" if dtype == jnp.float32
                        else "default", **kw)
    return (jcfg, *models(jcfg, seed=7))


@pytest.mark.parametrize("kind,dtype", sorted(TOL))
def test_frame_fn_matches_jax(kind, dtype):
    jcfg, params, cfg, model = _cfgs(
        jnp.float32 if dtype == "f32" else jnp.bfloat16)
    jfn = JE.make_r2l_frame_fn(params, jcfg, JaxPointSampler(**SAMPLER),
                               calib_poses=POSES, **FLAGS[kind])
    tfn = TE.make_r2l_frame_fn(model, cfg, PointSampler(**SAMPLER),
                               calib_poses=POSES, **FLAGS[kind])
    assert tfn.kind == kind
    tol_max, tol_rms = TOL[(kind, dtype)]
    for c2w in POSES[:2]:
        want = np.asarray(jfn(jnp.asarray(c2w)))
        got = n(tfn(c2w))
        assert got.shape == want.shape == (H, W, 3)
        d = got - want
        assert np.max(np.abs(d)) < tol_max, np.max(np.abs(d))
        if tol_rms is not None:
            assert np.sqrt(np.mean(d * d)) < tol_rms


@pytest.mark.parametrize("kind", ["jnp", "int8"])
def test_bench_fn_checksum_is_the_frame_sum(kind):
    _, _, cfg, model = _cfgs(jnp.bfloat16)
    sampler = PointSampler(**SAMPLER)
    frame = TE.make_r2l_frame_fn(model, cfg, sampler, calib_poses=POSES,
                                 **FLAGS[kind])
    bench = TE.make_r2l_bench_fn(model, cfg, sampler, calib_poses=POSES,
                                 **FLAGS[kind])
    assert bench.kind == kind
    want = sum(float(frame(p).double().sum()) for p in POSES)
    got = float(bench(torch.from_numpy(POSES)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("case,kw,cfg_kw,want_kind", [
    ("noncanonical_act", dict(use_pallas=True, quantize="int8"),
     dict(act="lrelu", inact="lrelu"), "jnp"),
    ("int8_without_pallas", dict(use_pallas=False, quantize="int8"), {},
     "jnp"),
    ("int8_plucker", dict(use_pallas=True, quantize="int8", plucker=True),
     dict(input_dim=6 * 21), "pe"),
    ("int8_default_calibration", dict(use_pallas=True, quantize="int8"),
     {}, "int8"),
])
def test_dispatch_rules_and_warnings_match_jax(case, kw, cfg_kw, want_kind,
                                               capsys):
    """The same flags pick the same kind on both sides and print the same
    warnings (int8 without calibration poses falls back to spherical
    cameras)."""
    jcfg, params, cfg, model = _cfgs(jnp.bfloat16, **cfg_kw)
    jfn_parts = JE._prepare_r2l(params, jcfg, JaxPointSampler(**SAMPLER),
                                10, kw.get("plucker", False),
                                kw["use_pallas"], kw["quantize"])
    jerr = capsys.readouterr().err
    tfn = TE.make_r2l_frame_fn(model, cfg, PointSampler(**SAMPLER), **kw)
    terr = capsys.readouterr().err
    assert jfn_parts[1] == tfn.kind == want_kind
    assert [ln for ln in terr.splitlines() if ln.startswith("WARNING")] == \
        [ln for ln in jerr.splitlines() if ln.startswith("WARNING")]
    frame = n(tfn(POSES[0]))
    assert frame.shape == (H, W, 3) and np.isfinite(frame).all()


def test_int8_calibration_uses_linspace_pick_of_eight():
    """Up to 8 deployment poses, picked by linspace, at 1/8 resolution."""
    sampler = PointSampler(H=64, W=48, focal=60.0, n_sample=16, near=2.0,
                           far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in np.linspace(-180, 180, 13, endpoint=False)])
    pts = TE._calibration_points(sampler, poses, torch.device("cpu"))
    sub = dataclasses.replace(sampler, H=8, W=6, focal=7.5)
    pick = np.linspace(0, 12, 8).astype(int)
    want = torch.cat([sub.sample_test(torch.from_numpy(poses[i]))
                      for i in pick])
    assert torch.equal(pts, want)
