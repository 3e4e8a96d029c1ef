"""Port parity of the teacher-frame exp drivers (r2l_tpu_torch/exp/
_teacher.py, probe_teacher_int8.py, probe_teacher_fold.py,
probe_teacher_decomp.py, probe_teacher_chunk.py, probe_teacher_bf16rq.py,
dbg_int8_engage.py) against the JAX drivers of the same names.

Each driver's constants are read from the JAX file (through
load_exp_probe where it has a main() guard, from its source where it runs
at import) and held equal. The variant bodies run at a small size (a D4/W32
teacher, 8 + 8 samples, 8x8 frames, two poses, chunks of 64 rays) on
the same weights (JAX's, carried over, the drivers' density floor added on
both sides) against the JAX driver's composition, its Pallas kernel in
interpret mode. Tolerances:

* rays, poses and calibration points: bit for bit (the same f32 formulas);
  the calibration's view directions within 2.4e-7, two f32 ulps of
  their largest values (numpy's and torch's norms sum in another order);
* bf16 frames (K6's plain version, the plain render): the bound of
  tests/test_render.py:112-118, mean < 1e-2 and 95% of the values < 5e-2
  (a bf16 rounding flipped by a one-ulp difference of a dot propagates);
* int8 frames (K7's plain version), each side calibrating: K2's int8
  bounds, max-abs 2.5e-2 and RMS 2.5e-3 (as tests/test_torch_nerf_kernel
  .py's int8 frame: an ulp of a scale moves a requantize by a step); a sum
  of n values within n x 2.5e-3 (the RMS bound summed).

Without a GPU each driver exits 1 and prints no record."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.render as jrender
from _torch_parity import (exp_assigned, exp_calls, load_exp_probe, n,
                           nerf_models)
from r2l_tpu.checkpoint import load_checkpoint as jax_load
from r2l_tpu.encoding import nerf_embed_dim
from r2l_tpu.kernels.nerf_render_pallas import (fused_nerf_render_t,
                                                prepare_fused_nerf_t)
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.rays import get_rays as jax_get_rays
from r2l_tpu.volume import sample_pdf as jax_sample_pdf
from r2l_tpu_torch import checkpoint
from r2l_tpu_torch.exp import _harness, _teacher
from r2l_tpu_torch.exp import dbg_int8_engage as XG
from r2l_tpu_torch.exp import probe_teacher_chunk as XC
from r2l_tpu_torch.exp import probe_teacher_decomp as XTD
from r2l_tpu_torch.exp import probe_teacher_fold as XF
from r2l_tpu_torch.exp import probe_teacher_int8 as XI
from r2l_tpu_torch.exp import probe_teacher_bf16rq as XBQ
from r2l_tpu_torch.sampler import even_z_vals
from r2l_tpu_torch.train import TeacherTrainConfig, init_teacher_state

HW, FOCAL, K, CHUNK, EVERY = 8, 10.0, 2, 64, 4
TOL_MAX, TOL_RMS = 2.5e-2, 2.5e-3


def _jcfg():
    return JNeRFConfig(D=4, W=32, skips=(2,), use_viewdirs=True,
                       input_ch=nerf_embed_dim(3, 10),
                       input_ch_views=nerf_embed_dim(3, 4), output_ch=5,
                       compute_dtype=jnp.bfloat16)


def _floor(params):
    a = params["alpha_linear"]
    return {**params, "alpha_linear": {**a, "b": a["b"]
                                       + _teacher.DENSITY_FLOOR}}


def _nets(monkeypatch, seed):
    """JAX's (coarse, fine) params and the port's networks with the same
    weights and the drivers' density floor; the drivers' ``networks``
    returns the port's."""
    jcfg = _jcfg()
    pc, cfg, mc = nerf_models(jcfg, seed)
    pf, _, mf = nerf_models(jcfg, seed + 1)
    with torch.no_grad():
        for m in (mc, mf):
            m.alpha_linear.bias += _teacher.DENSITY_FLOOR
    monkeypatch.setattr(_teacher, "networks", lambda c, g, d: (mc, mf))
    return jcfg, (_floor(pc), _floor(pf)), cfg


def _vcfg(chunk=CHUNK):
    return _teacher.vol_cfg(8, 8, chunk)


def _jv(vcfg):
    return jrender.VolRenderConfig(**dataclasses.asdict(vcfg))


def _int8_bounds(got, want):
    d = np.abs(n(got) - np.asarray(want))
    assert d.max() < TOL_MAX and np.sqrt(np.mean(d * d)) < TOL_RMS, d.max()


def _bf16_bounds(got, want):
    d = np.abs(n(got) - np.asarray(want))
    assert d.mean() < 1e-2 and np.quantile(d, 0.95) < 5e-2, d.max()


def _setup(monkeypatch, seed, chunk=CHUNK):
    jcfg, jnets, cfg = _nets(monkeypatch, seed)
    ncfg, vcfg, nets, ro, rd, calib = XI.setup(
        "cpu", torch.Generator().manual_seed(0), K,
        dataclasses.replace(cfg), _vcfg(chunk), hw=HW, focal=FOCAL)
    return jcfg, jnets, ncfg, vcfg, nets, ro, rd


_JAX_FRAMES: dict = {}
SEED = 10       # the networks of the frame tests, whose JAX renders are
#                 shared through _jax_frame


def _jax_frame(jnets, jcfg, vcfg, ro, rd, int8, fold=False):
    """JAX's fused render of frame 0 (exp/probe_teacher_int8.py:81-84),
    int8 calibrated as the JAX driver does, rendered once per (chunk,
    int8, fold) for the file's networks (seed SEED)."""
    key = (vcfg.ray_chunk, int8, fold)
    if key not in _JAX_FRAMES:
        _JAX_FRAMES[key] = np.asarray(jrender.render_frame_nerf_fused(
            *jnets, jcfg, _jv(vcfg), jnp.asarray(n(ro[0])),
            jnp.asarray(n(rd[0])), tile=32,
            int8_calib=_jax_calib(ro, rd) if int8 else None,
            fold_requant=fold)["rgb"])
    return _JAX_FRAMES[key]


def _jax_calib(ro, rd):
    """exp/probe_teacher_int8.py:59-71's calibration, every EVERY-th ray."""
    z = np.linspace(2.0, 6.0, 9, dtype=np.float32)
    ros, rds = n(ro), n(rd)
    sub = slice(None, None, EVERY)
    pts = np.concatenate([
        (o[sub, None, :] + d[sub, None, :] * z[None, :, None]).reshape(-1, 3)
        for o, d in zip(ros, rds)])
    vds = np.concatenate([np.broadcast_to(
        (d[sub] / np.linalg.norm(d[sub], axis=-1, keepdims=True)
         )[:, None, :], (d[sub].shape[0], 9, 3)).reshape(-1, 3)
        for d in rds])
    return jnp.asarray(pts), jnp.asarray(vds)


@pytest.mark.parametrize("name,port", [("probe_teacher_int8", XI),
                                       ("probe_teacher_fold", XF)])
def test_constants_match_the_jax_drivers(name, port):
    """The frame (H, W, FOCAL, K), the teacher (8x256, skip 4, view
    directions, L 10/4, bf16), the render (64 + 128, deterministic, white,
    chunks of 32,768), the calibration (every 640th ray, 9 depths) and the
    timed calls."""
    J = load_exp_probe(name)
    for c in ("H", "W", "FOCAL", "K"):
        assert getattr(_teacher, c) == getattr(J, c), c
    assert port.K == J.K
    nc = exp_calls(name, "NeRFConfig")[0]
    assert (nc["D"], nc["W"], nc["skips"], nc["use_viewdirs"]) == (
        _teacher.D, _teacher.WIDTH, _teacher.SKIPS, True)
    assert nc["output_ch"] == 5
    ncfg = _teacher.nerf_cfg()
    assert (ncfg.input_ch, ncfg.input_ch_views) == (63, 27)
    vc = exp_calls(name, "VolRenderConfig")[0]
    v = _teacher.vol_cfg()
    for k in ("n_coarse", "n_fine", "perturb", "use_viewdirs", "white_bkgd",
              "near", "far", "ray_chunk"):
        assert getattr(v, k) == vc[k], k
    assert exp_calls(name, "slice")[0]["_args"][2] == _teacher.CALIB_EVERY
    assert exp_calls(name, "linspace")[1]["_args"] == [
        2.0, 6.0, _teacher.CALIB_DEPTHS]
    assert exp_calls(name, "range")[0]["_args"] == [port.REPS]
    if name == "probe_teacher_int8":
        assert [v[0] for v in exp_assigned(name)["variants"]] == list(
            XI.VARIANTS)
    else:
        assert exp_assigned(name)["name,fold"] == XF.VARIANTS


def test_decomp_chunk_and_dbg_constants():
    """The drivers that run at import, from their source: the decomposition
    (exp/probe_teacher_decomp.py:36-40, 51-64, 72-73), the chunk sweep
    (probe_teacher_chunk.py:14, 45-48) and dbg_int8_engage's frame (:36-38,
    40-42)."""
    a = exp_assigned("probe_teacher_decomp")
    assert (a["H"], a["CHUNK"], a["K"], a["REPS"], a["S_C"], a["S_F"]) == (
        XTD.H, XTD.CHUNK, XTD.K, XTD.REPS, XTD.S_C, XTD.S_F)
    assert exp_calls("probe_teacher_decomp", "PointSampler")[0]["focal"] \
        == XTD.FOCAL
    assert exp_calls("probe_teacher_decomp", "uniform")[0]["_args"][1] == (
        XTD.N_CALIB, 3)
    assert exp_calls("probe_teacher_decomp", "NeRFConfig")[0]["skips"] == \
        _teacher.SKIPS
    a = exp_assigned("probe_teacher_chunk")
    assert a["chunk"] == XC.CHUNKS and (a["K"], a["FOCAL"]) == (
        XC.K, _teacher.FOCAL)
    assert tuple(m for m, _ in a["mode,cal"]) == XC.MODES
    a = exp_assigned("dbg_int8_engage")
    assert (a["H"], a["Wd"], a["FOCAL"]) == (XG.HW, XG.HW, XG.FOCAL)
    vc = exp_calls("dbg_int8_engage", "VolRenderConfig")[0]
    assert (vc["n_coarse"], vc["ray_chunk"]) == (XG.N_SAMPLES, XG.CHUNK)
    assert exp_calls("dbg_int8_engage", "pose_spherical")[0]["_args"] == \
        list(XG.POSE)


def test_rays_and_calibration_match_jax():
    """The frames' rays bit for bit JAX's get_rays of the same poses, and
    the calibration points bit for bit the JAX driver's numpy composition
    (its view directions within two ulps)."""
    ro, rd = _teacher.frame_rays(K, "cpu", HW, FOCAL)
    for i, p in enumerate(_harness.lego_poses(K)):
        o, d = jax_get_rays(HW, HW, FOCAL, jnp.asarray(p))
        np.testing.assert_array_equal(n(ro[i]), np.asarray(o).reshape(-1, 3))
        np.testing.assert_array_equal(n(rd[i]), np.asarray(d).reshape(-1, 3))
    pts, vds = _teacher.calibration(ro, rd, EVERY)
    jpts, jvds = _jax_calib(ro, rd)
    np.testing.assert_array_equal(n(pts), np.asarray(jpts))
    np.testing.assert_allclose(n(vds), np.asarray(jvds), rtol=0,
                               atol=2.4e-7)


@pytest.mark.parametrize("name", XI.VARIANTS)
def test_teacher_int8_variants_match_jax(monkeypatch, name):
    """fused_bf16, fused_int8, xla (exp/probe_teacher_int8.py:73-91) on
    frame 0: the port's frame function against JAX's render of the same
    variant (fused bf16 and the plain render at the bf16 bound, int8 at
    K2's); the int8 frame's distance from the bf16 one is recorded."""
    jcfg, (pc, pf), ncfg, vcfg, nets, ro, rd = _setup(monkeypatch, SEED)
    calib = _teacher.calibration(ro, rd, EVERY)
    frame = XI.variant(name, nets, ncfg, vcfg, calib)
    got = frame(ro[0], rd[0])
    if name == "xla":
        want = jrender.render_frame_nerf(pc, pf, jcfg, _jv(vcfg),
                                         jnp.asarray(n(ro[0])),
                                         jnp.asarray(n(rd[0])))["rgb"]
        _bf16_bounds(got, want)
    else:
        int8 = name == "fused_int8"
        want = _jax_frame((pc, pf), jcfg, vcfg, ro, rd, int8)
        (_int8_bounds if int8 else _bf16_bounds)(got, want)
    sums = XI.frames_sum(frame, ro, rd)
    assert float(sums) == pytest.approx(
        sum(float(frame(o, d).sum()) for o, d in zip(ro, rd)), rel=1e-6)
    err = _teacher.rgb_errors(got, got, "bf16")
    assert err["psnr_vs_bf16"] == float("inf")


@pytest.mark.parametrize("fold", [False, True])
def test_teacher_fold_matches_jax(monkeypatch, fold):
    """K7 unfolded or folded (exp/probe_teacher_fold.py:78-84) against
    JAX's render_frame_nerf_fused(..., fold_requant=) at K2's bounds."""
    jcfg, jnets, ncfg, vcfg, nets, ro, rd = _setup(monkeypatch, SEED)
    calib = _teacher.calibration(ro, rd, EVERY)
    got = XF.variant(fold, nets, ncfg, vcfg, calib)(ro[0], rd[0])
    _int8_bounds(got, _jax_frame(jnets, jcfg, vcfg, ro, rd, True, fold))


def _jax_decomp(jpacks, jcfg, vcfg, o, d, name):
    """exp/probe_teacher_decomp.py:84-124's chunk functions."""
    run = dict(L_pts=10, L_views=4, white_bkgd=True, tile=32, int8=True,
               fold_requant=True, interpret=True)
    jv = _jv(vcfg)
    z = jrender._coarse_z(jv, o.shape[0], None)
    if name == "fine192_only":
        zf = jnp.linspace(2.0, 6.0, vcfg.n_fine)[None, :].repeat(
            o.shape[0], 0)
        z_all = jnp.sort(jnp.concatenate([z, zf], axis=-1), axis=-1)
        return jnp.sum(fused_nerf_render_t(jpacks[1], jcfg, o, d, z_all,
                                           **run)[0])
    rgb, _, _, w = fused_nerf_render_t(jpacks[0], jcfg, o, d, z, **run)
    if name == "coarse64_only":
        return jnp.sum(rgb) + jnp.sum(w)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_samp = jax_sample_pdf(None, z_mid, w[:, 1:-1], vcfg.n_fine, det=True)
    z_all = jnp.sort(jnp.concatenate([z, z_samp], axis=-1), axis=-1)
    if name == "coarse64_plus_pdf":
        return jnp.sum(rgb) + jnp.sum(z_all)
    return jnp.sum(fused_nerf_render_t(jpacks[1], jcfg, o, d, z_all,
                                       **run)[0])


@pytest.mark.parametrize("name", XTD.VARIANTS)
def test_teacher_decomp_chunks_match_jax(monkeypatch, name):
    """Each variant's chunk function on one chunk against the JAX driver's,
    both networks packed by each side from the same calibration draws
    (uniform points in [-4, 4], normal directions normalised): the sums
    within the summed int8 bound over the chunk's rgb (and weights)
    values, the depths' sum within the bound scaled by the depth range
    (4) over the fine depths. The padding, the frames' offsets and the
    summary are the JAX driver's."""
    jcfg, (pc, pf), cfg = _nets(monkeypatch, 14)
    ncfg, vcfg, packs, ro, rd = XTD.setup(
        "cpu", torch.Generator().manual_seed(3), cfg, hw=HW, focal=FOCAL,
        chunk=48, n_calib=64)
    vcfg = dataclasses.replace(vcfg, n_coarse=8, n_fine=8)
    assert ro.shape == (2, 48, 3)
    assert torch.equal(ro[-1, HW * HW - 48:], torch.zeros(32, 3))
    assert torch.equal(rd[-1, HW * HW - 48:], torch.ones(32, 3))
    g = torch.Generator().manual_seed(3)
    cal_p = torch.rand((64, 3), generator=g) * 8.0 - 4.0
    cal_d = torch.randn((64, 3), generator=g)
    cal_d = cal_d / torch.linalg.norm(cal_d, dim=-1, keepdim=True)
    jpacks = tuple(prepare_fused_nerf_t(p, jcfg, 10, 4, calib=(
        jnp.asarray(n(cal_p)), jnp.asarray(n(cal_d))), fold_requant=True)
        for p in (pc, pf))
    got = XTD.CHUNK_FNS[name](packs, ncfg, vcfg, ro[0], rd[0])
    want = _jax_decomp(jpacks, jcfg, vcfg, jnp.asarray(n(ro[0])),
                       jnp.asarray(n(rd[0])), name)
    n_vals = 48 * (3 + (8 if name == "coarse64_only" else 0))
    tol = n_vals * TOL_RMS + (48 * 16 * 4 * TOL_RMS
                              if name == "coarse64_plus_pdf" else 0.0)
    assert abs(float(got) - float(want)) <= tol, (float(got), float(want))
    offs = even_z_vals(0.0, 1e-5, XTD.K, "cpu")
    np.testing.assert_array_equal(n(offs), np.asarray(
        jnp.linspace(0.0, 1e-5, XTD.K)))
    ms = {"full_int8_fold": 10.0, "coarse64_only": 3.0,
          "coarse64_plus_pdf": 4.0, "fine192_only": 5.0}
    assert XTD.summary(ms) == {"name": "decomp_summary", "full": 10.0,
                               "coarse": 3.0, "pdf": 1.0, "fine": 5.0,
                               "residual_epilogue": 1.0}


@pytest.mark.parametrize("mode", XC.MODES)
def test_teacher_chunk_matches_jax(monkeypatch, mode):
    """The frame at two ray chunks (exp/probe_teacher_chunk.py:45-55), one
    packing per mode: each against JAX's render at that chunk (int8 at
    K2's bounds, bf16 at the bf16 bound)."""
    jcfg, jnets, ncfg, vcfg, nets, ro, rd = _setup(monkeypatch, SEED)
    calib = _teacher.calibration(ro, rd, EVERY)
    packs = XC.packings(nets, ncfg, vcfg, calib)
    for chunk in (32, CHUNK):
        got = XC.frame_fn(nets, ncfg, vcfg, packs[mode], chunk)(ro[0], rd[0])
        want = _jax_frame(jnets, jcfg, dataclasses.replace(
            vcfg, ray_chunk=chunk), ro, rd, mode == "int8")
        (_int8_bounds if mode == "int8" else _bf16_bounds)(got, want)


def test_dbg_int8_engage_matches_the_jax_script(monkeypatch, tmp_path):
    """A teacher saved by the port, read by dbg_int8_engage as the JAX
    script reads it (exp/dbg_int8_engage.py:11-33: the shapes from the
    file, skips (4,) past depth 4, 16 + 16 samples, here 8 + 8), and the
    script's numbers at a small frame against its composition (:34-55) on
    JAX's
    load of the same file: the bf16 frame's range and the plain frame's
    largest acc at the bf16 bound's 5e-2, the int8 frame's distance from
    the bf16 one within K2's max-abs bound of JAX's."""
    jcfg, _, cfg = _nets(monkeypatch, 18)
    monkeypatch.setattr(XG, "N_SAMPLES", 8)
    mc, mf = _teacher.networks(cfg, None, "cpu")
    path = str(tmp_path / "t.msgpack")
    checkpoint.save(path, init_teacher_state(mc, mf, TeacherTrainConfig()),
                    0, -1.0, -1)
    s, ncfg, vcfg, gc, gf = XG.load(path, "cpu")
    assert s == {"D": 4, "W": 32, "in_ch": 63, "in_v": 27, "L": 10,
                 "Lv": 4, "use_vd": True, "fine": True}
    assert ncfg.skips == (2,) and vcfg.n_fine == XG.N_SAMPLES
    for a, b in zip(gc.state_dict().values(), mc.state_dict().values()):
        assert torch.equal(a, b)
    got = XG.engage(ncfg, vcfg, gc, gf, "cpu", hw=HW, focal=FOCAL)
    tree, _ = jax_load(path, None)

    def norm(p):
        p = dict(p)
        for k in ("pts_linears", "views_linears"):
            p[k] = [p[k][i] for i in sorted(p[k], key=int)]
        return p

    jpc, jpf = norm(tree["coarse"]), norm(tree["fine"])
    jc = JNeRFConfig(D=4, W=32, skips=(2,), use_viewdirs=True, input_ch=63,
                     input_ch_views=27, output_ch=5,
                     compute_dtype=jnp.bfloat16)
    jv = jrender.VolRenderConfig(**dataclasses.asdict(vcfg))
    ro, rd = jax_get_rays(HW, HW, FOCAL, jnp.asarray(
        np.asarray(XG.pose_spherical(*XG.POSE))[:3, :4]))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    bf = np.asarray(jrender.render_frame_nerf_fused(jpc, jpf, jc, jv, ro,
                                                    rd)["rgb"])
    z = np.linspace(2., 6., 9, dtype=np.float32)
    ron, rdn = np.asarray(ro)[::16], np.asarray(rd)[::16]
    pts = (ron[:, None, :] + rdn[:, None, :] * z[None, :, None]).reshape(-1,
                                                                       3)
    vd = rdn / np.linalg.norm(rdn, axis=-1, keepdims=True)
    vds = np.broadcast_to(vd[:, None, :], (vd.shape[0], 9, 3)).reshape(-1, 3)
    i8 = np.asarray(jrender.render_frame_nerf_fused(
        jpc, jpf, jc, jv, ro, rd, int8_calib=(jnp.asarray(pts),
                                              jnp.asarray(vds)))["rgb"])
    plain = jrender.render_frame_nerf(jpc, jpf, jc, jv, ro, rd)
    assert abs(got["bf16_min"] - bf.min()) < 5e-2
    assert abs(got["bf16_max"] - bf.max()) < 5e-2
    assert abs(got["plain_acc_max"] - float(np.asarray(plain["acc"]).max())
               ) < 5e-2
    assert abs(got["int8_vs_bf16_max"] - np.abs(bf - i8).max()) < TOL_MAX
    assert not got["identical"]


@pytest.mark.parametrize("mod,argv", [
    (XI, []), (XF, []), (XTD, []), (XC, []), (XG, ["--ckpt", "t.msgpack"]),
    (XBQ, [])],
    ids=["probe_teacher_int8", "probe_teacher_fold", "probe_teacher_decomp",
         "probe_teacher_chunk", "dbg_int8_engage", "probe_teacher_bf16rq"])
def test_driver_needs_a_gpu(mod, argv, capsys):
    """Without CUDA the driver exits 1 and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code == 1
    assert capsys.readouterr().out == ""


def test_bf16rq_constants_match_the_jax_driver():
    """exp/probe_teacher_bf16rq.py runs at import: its frame (400x400),
    chunk, samples, K and interleaved rounds from the source, its teacher
    (8x256, skip 4, view directions, L 10/4, bf16) and render (64 + 128,
    deterministic, white, near 2, far 6) as ``_teacher``'s; its rows one
    per distinct function (the tiles and sample_pairs are not ported)."""
    a = exp_assigned("probe_teacher_bf16rq")
    assert (a["H"], a["W"]) == (_teacher.H, _teacher.W)
    assert a["CHUNK"] == _teacher.CHUNK and XBQ.K == a["K"] == _teacher.K
    assert (a["S_C"], a["S_F"]) == (_teacher.N_COARSE, _teacher.N_FINE)
    assert XBQ.ROUNDS == a["ROUNDS"]
    nc = exp_calls("probe_teacher_bf16rq", "NeRFConfig")[0]
    assert (nc["D"], nc["W"], nc["skips"], nc["use_viewdirs"],
            nc["input_ch"], nc["input_ch_views"], nc["output_ch"]) == (
        _teacher.D, _teacher.WIDTH, _teacher.SKIPS, True, 63, 27, 5)
    vc = exp_calls("probe_teacher_bf16rq", "VolRenderConfig")[0]
    v = _teacher.vol_cfg()
    for k in ("perturb", "use_viewdirs", "white_bkgd", "near", "far",
              "multires", "multires_views"):
        assert getattr(v, k) == vc[k], k
    run_k = exp_calls("probe_teacher_bf16rq", "partial")[0]
    assert (run_k["int8"], run_k["fold_requant"], run_k["white_bkgd"]) == (
        True, True, True)
    assert [v[1] for v in XBQ.VARIANTS] == [False, True]


def test_bf16rq_chunk_matches_jax(monkeypatch):
    """The driver's chunk (exp/probe_teacher_bf16rq.py:81-93's chunk_full:
    coarse, sample_pdf, fine) with the f32 and the bf16 dequantize, each
    side calibrating on the same points: K2's int8 bounds of JAX's in
    interpret mode (here under XLA's default flags, which drop some of
    bf16_requant's roundings; tests/test_torch_teacher_forms.py holds the
    kernel bit for bit without them)."""
    jcfg, (pc, pf), ncfg, vcfg, nets, ro, rd = _setup(monkeypatch, SEED)
    calib = _teacher.calibration(ro, rd, EVERY)
    packed = XBQ.prepare_fused_teacher(*nets, ncfg, vcfg, int8_calib=calib,
                                       fold_requant=True)
    jcal = _jax_calib(ro, rd)
    jpacks = tuple(prepare_fused_nerf_t(p, jcfg, 10, 4, calib=jcal,
                                        fold_requant=True) for p in (pc, pf))
    o, d = ro[0, :CHUNK], rd[0, :CHUNK]
    jo, jd = jnp.asarray(n(o)), jnp.asarray(n(d))
    for brq in (False, True):
        run = dict(L_pts=10, L_views=4, white_bkgd=True, tile=32, int8=True,
                   fold_requant=True, interpret=True, bf16_requant=brq)
        z = jrender._coarse_z(_jv(vcfg), CHUNK, None)
        w = fused_nerf_render_t(jpacks[0], jcfg, jo, jd, z, **run)[3]
        z_samp = jax_sample_pdf(None, 0.5 * (z[:, 1:] + z[:, :-1]),
                                w[:, 1:-1], vcfg.n_fine, det=True)
        z_all = jnp.sort(jnp.concatenate([z, z_samp], axis=-1), axis=-1)
        want = fused_nerf_render_t(jpacks[1], jcfg, jo, jd, z_all, **run)[0]
        _int8_bounds(XBQ.chunk_rgb(packed, ncfg, vcfg, o, d, brq), want)


def test_bf16rq_records_have_the_jax_fields(monkeypatch):
    """The driver's main on the CPU at a small size (its GPU parts, the
    card's record and CUDA-event timing, replaced by the host's): JAX's
    rows and fields (``r5_bf16rq_rgb_rms_delta`` with ``rms`` and
    ``max``; each timed row's ``ms_per_frame``, with ``warmup_s`` for JAX's
    ``compile_s``), bf16_requant engaged, each row's chunk equal to its
    plain version (which the CPU runs)."""
    import time

    def host_calls(fn, reps, per=1, warm=True):
        out = fn() if warm else None
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = fn()
            times.append((time.perf_counter() - t0) * 1e3 / per)
            out = got if out is None else out
        return {"ms": min(times), "all_ms": times, "warmup_s": 0.0}, out

    jcfg, jnets, ncfg, vcfg, nets, ro, rd = _setup(monkeypatch, SEED)
    monkeypatch.setattr(_harness, "require_cuda", lambda prog: "cpu")
    monkeypatch.setattr(_harness, "device_record",
                        lambda: {"name": "device"})
    monkeypatch.setattr(_harness, "time_calls", host_calls)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(XBQ, "setup", lambda dev, g, k: (
        ncfg, vcfg, nets, ro[:k], rd[:k],
        _teacher.calibration(ro[:k], rd[:k], EVERY)))
    recs = XBQ.main(["--frames", "2", "--rounds", "1"])
    assert [r["name"] for r in recs] == [
        "device", "r5_bf16rq_rgb_rms_delta", "r5_f32rq", "r5_bf16rq",
        "done"]
    delta = recs[1]
    assert delta["rms"] > 0 and delta["max"] >= delta["rms"]
    for r in recs[2:4]:
        assert r["ms_per_frame"] > 0 and r["warmup_s"] >= 0
        assert r["bit_for_bit"] and r["max_abs_err_vs_plain"] == 0.0
    assert [r["bf16_requant"] for r in recs[2:4]] == [False, True]
