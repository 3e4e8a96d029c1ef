"""Port parity: the NeRF teacher's geometry, encoding, model, volume math
and plain volumetric render (r2l_tpu_torch/encoding.py, rays.py,
models/nerf.py, volume.py, render.py against r2l_tpu and against the
reference torch code's outputs in tests/fixtures/geometry_golden.npz)."""
import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.encoding as jenc
import r2l_tpu.rays as jrays
import r2l_tpu.render as jrender
import r2l_tpu.volume as jvol
from _torch_parity import jax_chunk_draws, n, nerf_models, np_tree, t
from r2l_tpu.checkpoint import torch_nerf_to_params
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.models.nerf import apply_nerf
from r2l_tpu_torch import datagen, encoding, evaluate, rays, render, volume
from r2l_tpu_torch.models import (NeRF, NeRFConfig, init_nerf,
                                  nerf_params_from_jax)
from r2l_tpu_torch.sampler import PointSampler

FX = os.path.join(os.path.dirname(__file__), "fixtures",
                  "geometry_golden.npz")
# f32 geometry and compositing: the frameworks round the same formulas at
# slightly different points (XLA contracts a*b+c into one FMA; sums run in
# another order), a few ulp at values of size ~10.
TOL = 1e-5


@pytest.fixture(scope="module")
def fx():
    return np.load(FX)


@pytest.mark.parametrize("L,include_input", [(0, True), (4, True),
                                             (10, True), (4, False)])
def test_nerf_embed(L, include_input):
    x = np.random.default_rng(0).uniform(-3, 3, (7, 3)).astype(np.float32)
    want = np.asarray(jenc.nerf_embed(jnp.asarray(x), L, include_input))
    got = n(encoding.nerf_embed(t(x), L, include_input))
    assert got.shape == want.shape == (
        7, jenc.nerf_embed_dim(3, L, include_input))
    assert encoding.nerf_embed_dim(3, L, include_input) == got.shape[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("focal_scale,key", [(1.0, "rays_d"),
                                             (1.7, "rays_d_fs")])
def test_get_rays_golden(fx, focal_scale, key):
    H, W, f = int(fx["H"]), int(fx["W"]), float(fx["focal"])
    for ro, rd in (rays.get_rays(H, W, f, fx["c2w"], focal_scale,
                                 device="cpu"),
                   rays.get_rays(H, W, f, t(fx["c2w"]), focal_scale),
                   (t(a) for a in rays.get_rays_np(H, W, f, fx["c2w"],
                                                   focal_scale))):
        np.testing.assert_allclose(n(ro), fx["rays_o"], rtol=0, atol=TOL)
        np.testing.assert_allclose(n(rd), fx[key], rtol=0, atol=TOL)


@pytest.mark.parametrize("trans_origin", ["", "fixed", "2.5"])
def test_get_rays_trans_origin_matches_jax(trans_origin):
    c2w = rays.pose_spherical(40.0, -35.0, 4.0)[:3, :4]
    want = jrays.get_rays(6, 9, 7.5, jnp.asarray(c2w), focal_scale=1.3,
                          trans_origin=trans_origin)
    want_np = jrays.get_rays_np(6, 9, 7.5, c2w, focal_scale=1.3,
                                trans_origin=trans_origin)
    got = rays.get_rays(6, 9, 7.5, c2w, 1.3, trans_origin, device="cpu")
    got_np = rays.get_rays_np(6, 9, 7.5, c2w, 1.3, trans_origin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=0, atol=TOL)
    for g, w in zip(got_np, want_np):   # the same numpy arithmetic
        np.testing.assert_array_equal(g, w)


def test_ndc_rays(fx):
    H, W, f = int(fx["H"]), int(fx["W"]), float(fx["focal"])
    ro, rd = (t(fx[k]).reshape(-1, 3) for k in ("rays_o", "rays_d"))
    got = rays.ndc_rays(H, W, f, 1.0, ro, rd)
    want = jrays.ndc_rays(H, W, f, 1.0, jnp.asarray(n(ro)),
                          jnp.asarray(n(rd)))
    for g, w, gold in zip(got, want, (fx["ndc_o"], fx["ndc_d"])):
        np.testing.assert_allclose(n(g), gold, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H,W,focal", [(6, 9, 7.5), (400, 400, 555.555)])
def test_donerf_ray_dirs_match_jax(H, W, focal):
    np.testing.assert_array_equal(rays.donerf_ray_dirs(H, W, focal),
                                  jrays.donerf_ray_dirs(H, W, focal))


def test_pose_helpers_match_jax():
    for seed in range(3):
        np.testing.assert_array_equal(
            rays.get_rand_pose(np.random.default_rng(seed), 3.5),
            jrays.get_rand_pose(np.random.default_rng(seed), 3.5))
    for spec in (5, [3, 2, "r:4.0"], [2, "sample:3", 2]):
        np.testing.assert_array_equal(rays.get_novel_poses(spec),
                                      jrays.get_novel_poses(spec))


def test_sample_pdf_det(fx):
    bins, w = fx["pdf_bins"], fx["pdf_weights"]
    got = n(volume.sample_pdf(t(bins), t(w), 7, det=True))
    np.testing.assert_allclose(got, fx["pdf_samples"], rtol=TOL, atol=TOL)
    want = jvol.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 7,
                           det=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_samples", [5, 16])
def test_sample_pdf_with_jax_draws(n_samples):
    """JAX's own uniform draws handed to the port: the same depths."""
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(2.0, 6.0, (9, 12)), -1).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (9, 11)).astype(np.float32)
    w[0] = 0.0                                     # an empty ray
    key = jax.random.key(5)
    u = jax.random.uniform(key, (9, n_samples), dtype=jnp.float32)
    want = jvol.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w),
                           n_samples)
    got = volume.sample_pdf(t(bins), t(w), n_samples, u=t(u))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tag,white", [("bb", False), ("wb", True)])
def test_raw2outputs(fx, tag, white):
    raw, z, rd = fx["raw"], fx["z_vals"], fx["r2o_rays_d"]
    got = volume.raw2outputs(t(raw), t(z), t(rd), 0.0, white)
    want = jvol.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                            jnp.asarray(rd), 0.0, white)
    for name, g, w in zip(("rgb", "disp", "acc", "weights", "depth"), got,
                          want):
        gold = fx[f"{name}_{tag}"]
        # disp = 1/(depth/acc): the reference's own rtol (test_reference_
        # golden.py:71-75) for the quotient of two sums
        rtol = 1e-4 if name in ("disp", "depth") else TOL
        np.testing.assert_allclose(n(g), gold, rtol=rtol, atol=TOL)
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=rtol, atol=TOL)


def test_raw2outputs_noise_is_an_argument():
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(5, 6, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (5, 6)), -1).astype(np.float32)
    rd = rng.normal(size=(5, 3)).astype(np.float32)
    noise = rng.normal(size=(5, 6)).astype(np.float32)
    got = volume.raw2outputs(t(raw), t(z), t(rd), 0.5, noise=t(noise))
    raw_n = raw.copy()
    raw_n[..., 3] += 0.5 * noise
    want = jvol.raw2outputs(jnp.asarray(raw_n), jnp.asarray(z),
                            jnp.asarray(rd))
    np.testing.assert_allclose(n(got.rgb_map), np.asarray(want.rgb_map),
                               rtol=TOL, atol=TOL)


def _jcfg(viewdirs=True, dtype=jnp.float32, D=4, W=32, skips=(2,), Lp=6,
          Lv=3):
    return JNeRFConfig(D=D, W=W, skips=skips, use_viewdirs=viewdirs,
                       input_ch=jenc.nerf_embed_dim(3, Lp),
                       input_ch_views=(jenc.nerf_embed_dim(3, Lv)
                                       if viewdirs else 0),
                       output_ch=5 if viewdirs else 4, compute_dtype=dtype)


@pytest.mark.parametrize("viewdirs", [True, False])
def test_nerf_model_f32(viewdirs):
    jcfg = _jcfg(viewdirs)
    params, cfg, model = nerf_models(jcfg, seed=1)
    width = jcfg.input_ch + jcfg.input_ch_views
    x = np.random.default_rng(5).uniform(-1, 1, (40, width)).astype(
        np.float32)
    want = np.asarray(apply_nerf(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = n(model(t(x)))
    assert got.shape == want.shape == (40, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_nerf_model_bf16():
    """bf16 activations: the bound of tests/test_render.py:112-118 (a
    bf16 rounding flipped by a one-ulp difference of a dot propagates)."""
    jcfg = _jcfg(dtype=jnp.bfloat16)
    params, cfg, model = nerf_models(jcfg, seed=2)
    assert cfg.compute_dtype == torch.bfloat16
    x = np.random.default_rng(6).uniform(-1, 1, (200, 39 + 21)).astype(
        np.float32)
    want = np.asarray(apply_nerf(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = n(model(t(x)))
    d = np.abs(got - want)
    assert d.mean() < 1e-2 and np.quantile(d, 0.95) < 5e-2, (d.mean(),
                                                             d.max())


@pytest.mark.parametrize("viewdirs", [True, False])
def test_nerf_params_round_trip(viewdirs):
    """JAX params -> the port's state_dict (reference names) -> the JAX
    checkpoint loader gives the same params back."""
    jcfg = _jcfg(viewdirs)
    params, cfg, model = nerf_models(jcfg, seed=3)
    sd = model.state_dict()
    assert set(sd) == set(nerf_params_from_jax(np_tree(params)))
    back = torch_nerf_to_params({k: v.numpy() for k, v in sd.items()}, jcfg)
    flat = jax.tree.leaves(np_tree(params))
    for a, b in zip(jax.tree.leaves(back), flat):
        np.testing.assert_array_equal(a, b)
    assert len(jax.tree.leaves(back)) == len(flat)


def _rays(n_rays, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    return o, d


def _vcfg(n_fine, perturb=True, white=True, Lp=6, Lv=3, **kw):
    return jrender.VolRenderConfig(
        n_coarse=8, n_fine=n_fine, perturb=perturb, use_viewdirs=True,
        multires=Lp, multires_views=Lv, near=2.0, far=6.0,
        white_bkgd=white, ray_chunk=16, **kw)


def _compare_frames(got, want):
    for k in ("rgb", "acc", "depth", "disp"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=2e-4, equal_nan=True,
                                   err_msg=k)


@pytest.mark.parametrize("n_fine,perturb,noise", [
    (0, True, 0.0), (6, True, 0.0), (0, False, 0.0), (6, False, 0.0),
    (6, True, 1.0)])
def test_render_frame_nerf_with_jax_draws(n_fine, perturb, noise):
    """The plain frame render, coarse-only and hierarchical, with the sigma
    noise regularizer or without, on JAX's per-chunk draws (30 rays in
    chunks of 16: one padded chunk)."""
    jcfg = _jcfg()
    pc, cfg, mc = nerf_models(jcfg, seed=4)
    pf, _, mf = nerf_models(jcfg, seed=5)
    vcfg = _vcfg(n_fine, perturb, raw_noise_std=noise)
    o, d = _rays(30, 7)
    key = jax.random.key(11)
    want = jrender.render_frame_nerf(pc, pf if n_fine else None, jcfg, vcfg,
                                     jnp.asarray(o), jnp.asarray(d), key=key)
    tv = render.VolRenderConfig(**dataclasses.asdict(vcfg))
    got = render.render_frame_nerf(mc, mf if n_fine else None, cfg, tv,
                                   t(o), t(d),
                                   draws=jax_chunk_draws(key, vcfg, 30))
    _compare_frames(got, want)


def test_render_frame_nerf_distinct_fine_network():
    """A fine network of another width with its own config."""
    jcfg = _jcfg()
    jcfg_f = dataclasses.replace(jcfg, W=16, D=3, skips=(1,))
    pc, cfg, mc = nerf_models(jcfg, seed=6)
    pf, cfg_f, mf = nerf_models(jcfg_f, seed=7)
    vcfg = _vcfg(4, perturb=False, white=False, lindisp=True)
    o, d = _rays(20, 8)
    want = jrender.render_frame_nerf(pc, pf, jcfg, vcfg, jnp.asarray(o),
                                     jnp.asarray(d), ncfg_fine=jcfg_f)
    got = render.render_frame_nerf(
        mc, mf, cfg, render.VolRenderConfig(**dataclasses.asdict(vcfg)),
        t(o), t(d), ncfg_fine=cfg_f)
    _compare_frames(got, want)


def test_render_generator_draws_repeat():
    """Draws from a generator: the same seed gives the same frame, another
    seed another one."""
    jcfg = _jcfg()
    _, cfg, mc = nerf_models(jcfg, seed=8)
    tv = render.VolRenderConfig(**dataclasses.asdict(_vcfg(6)))
    o, d = (t(a) for a in _rays(20, 9))

    def run(seed):
        return render.render_frame_nerf(
            mc, None, cfg, tv, o, d,
            generator=torch.Generator().manual_seed(seed))["rgb"]
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("fn", [NeRF, init_nerf,
                                datagen.generate_pseudo_data,
                                evaluate.make_nerf_frame_fn])
def test_teacher_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == \
        torch.device("cuda")


def test_teacher_entry_points_raise_without_a_card(tmp_path):
    """Without a card, the teacher's entry points called without
    device='cpu' raise instead of running on the CPU; ``get_rays`` of a
    numpy pose goes to the card too."""
    pose = rays.pose_spherical(10.0, -30.0, 4.0)[:3, :4]
    if torch.cuda.is_available():
        assert rays.get_rays(4, 4, 5.0, pose)[0].device.type == "cuda"
        return
    cfg = NeRFConfig(D=2, W=8, skips=(), input_ch=9, input_ch_views=9)
    model = init_nerf(cfg, torch.Generator().manual_seed(0), device="cpu")
    vcfg = render.VolRenderConfig(n_coarse=4, multires=1, multires_views=1)
    sampler = PointSampler(H=4, W=4, focal=5.0, n_sample=4, near=2.0,
                           far=6.0)
    gcfg = datagen.DataGenConfig(n_pose=1, H=4, W=4, focal=5.0)
    for make in (lambda: NeRF(cfg),
                 lambda: init_nerf(cfg, torch.Generator().manual_seed(0)),
                 lambda: rays.get_rays(4, 4, 5.0, pose),
                 lambda: evaluate.make_nerf_frame_fn(model, None, cfg, vcfg,
                                                     sampler),
                 lambda: datagen.generate_pseudo_data(model, None, cfg, vcfg,
                                                      gcfg, str(tmp_path))):
        with pytest.raises((RuntimeError, AssertionError, ValueError)):
            make()
