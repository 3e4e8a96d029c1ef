"""Port parity: the fused volumetric NeRF pass (r2l_tpu_torch/kernels/
nerf_render.py) against r2l_tpu/kernels/nerf_render_pallas.py run in
interpret mode, and the fused frame render against r2l_tpu's.

On the CPU ``fused_nerf_render`` runs its plain version, which repeats the
CUDA kernels' arithmetic step for step (K6/K7 are held to it on the card by
tests/test_torch_cuda.py and chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.render as jrender
from _torch_parity import jax_chunk_draws, n, nerf_models, t
from r2l_tpu.encoding import nerf_embed_dim
from r2l_tpu.kernels.nerf_render_pallas import (_pe_row_map,
                                                fused_nerf_render_t,
                                                prepare_fused_nerf_t)
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu_torch import render
from r2l_tpu_torch.kernels import _build
from r2l_tpu_torch.kernels import nerf_render as NR

Lp, Lv = 6, 3


def _jcfg(viewdirs=True, D=4, W=32, skips=(2,)):
    return JNeRFConfig(D=D, W=W, skips=skips, use_viewdirs=viewdirs,
                       input_ch=nerf_embed_dim(3, Lp),
                       input_ch_views=(nerf_embed_dim(3, Lv)
                                       if viewdirs else 0),
                       output_ch=5 if viewdirs else 4)


def _inputs(n_rays=20, S=7, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n_rays, 3)) * 0.1).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (n_rays, S)), -1).astype(np.float32)
    return o, d, z


def _calib(o, d, z):
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    vds = np.broadcast_to(vd[:, None, :], z.shape + (3,)).reshape(-1, 3)
    return pts.astype(np.float32), vds.astype(np.float32)


def _jax_pass(fpj, jcfg, o, d, z, white, int8=False, fold=False):
    return [np.asarray(a) for a in fused_nerf_render_t(
        fpj, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
        L_pts=Lp, L_views=Lv, white_bkgd=white, tile=8, int8=int8,
        fold_requant=fold, interpret=True)]


@pytest.mark.parametrize("viewdirs,white", [(True, True), (True, False),
                                            (False, True)])
def test_plain_pass_matches_pallas_f32(viewdirs, white):
    """f32 weights, the ladder on both sides: 1e-5 on rgb/acc/weights,
    1e-4 on depth (a sum of w*z, z up to 6)."""
    jcfg = _jcfg(viewdirs)
    params, cfg, model = nerf_models(jcfg, seed=1)
    o, d, z = _inputs()
    want = _jax_pass(prepare_fused_nerf_t(params, jcfg, Lp, Lv,
                                          weight_dtype=jnp.float32),
                     jcfg, o, d, z, white)
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                               weight_dtype=torch.float32)
    got = NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), Lp, Lv, white)
    for name, g, w in zip(("rgb", "acc", "depth", "weights"), got, want):
        np.testing.assert_allclose(n(g), w, rtol=0,
                                   atol=1e-4 if name == "depth" else 1e-5,
                                   err_msg=name)


def _port_from_jax(fpj, jcfg, like: NR.FusedNeRFParams
                   ) -> NR.FusedNeRFParams:
    """JAX's transposed, 8/128-padded, row-remapped int8 parameters in the
    port's layout (the shapes of ``like``)."""
    W, D = jcfg.W, jcfg.D
    k_pts = fpj.pts_inv[0].shape[0]
    rm_p, rm_v = _pe_row_map(Lp), _pe_row_map(Lv)
    kp, kv, ks = NR.layout(jcfg, Lp, Lv)

    def a(x):
        return np.asarray(x)

    ws, invs = [], [np.ones(W, np.float32)]
    for i in range(D):
        w = a(fpj.pts_w[i])
        if i == 0 or (i - 1) in jcfg.skips:
            pe = np.zeros((W, kp), w.dtype)
            pe[:, :len(rm_p)] = w[:, rm_p]
            w = np.concatenate([pe, w[:, k_pts:]], 1)
        ws.append(w.reshape(-1))
        if i > 0:
            inv = a(fpj.pts_inv[i])[:, 0]
            invs.append(inv[k_pts:] if (i - 1) in jcfg.skips else inv)
    pe_inv = np.ones(kp, np.float32)
    pe_inv[:len(rm_p)] = a(fpj.pts_inv[0])[rm_p, 0]
    f = dict(pts_w=np.concatenate(ws),
             pts_m=np.stack([a(m)[:, 0] for m in fpj.pts_m]),
             pts_b=np.stack([a(b)[:, 0] for b in fpj.pts_b]),
             pe_inv=pe_inv, pts_inv=np.stack(invs), h_inv=a(fpj.h_inv)[:, 0])
    if jcfg.use_viewdirs:
        vw = a(fpj.views_w)[:W // 2]
        views_w = np.zeros((W // 2, kv), vw.dtype)
        views_w[:, :W] = vw[:, :W]
        views_w[:, W:W + len(rm_v)] = vw[:, W + rm_v]
        hv = a(fpj.hv_inv)[:, 0]
        hv_inv = np.ones(kv, np.float32)
        hv_inv[:W] = hv[:W]
        hv_inv[W:W + len(rm_v)] = hv[W + rm_v]
        f.update(alpha_w=a(fpj.alpha_w)[0], alpha_m=a(fpj.alpha_m)[:1, 0],
                 alpha_b=a(fpj.alpha_b)[:1, 0], feat_w=a(fpj.feat_w),
                 feat_m=a(fpj.feat_m)[:, 0], feat_b=a(fpj.feat_b)[:, 0],
                 views_w=views_w, views_m=a(fpj.views_m)[:W // 2, 0],
                 views_b=a(fpj.views_b)[:W // 2, 0], hv_inv=hv_inv,
                 rgb_w=a(fpj.rgb_w)[:3, :W // 2],
                 rgb_m=a(fpj.rgb_m)[:3, 0], rgb_b=a(fpj.rgb_b)[:3, 0],
                 hr_inv=a(fpj.hr_inv)[:W // 2, 0])
    else:
        f.update(out_w=a(fpj.out_w)[:4], out_m=a(fpj.out_m)[:4, 0],
                 out_b=a(fpj.out_b)[:4, 0])
    out = like._asdict()
    for k, v in f.items():
        assert v.shape == tuple(out[k].shape), (k, v.shape, out[k].shape)
        out[k] = torch.from_numpy(np.array(v))
    return NR.FusedNeRFParams(**out)


@pytest.mark.parametrize("viewdirs", [True, False])
@pytest.mark.parametrize("fold", [False, True])
def test_int8_packing_matches_jax(viewdirs, fold):
    """Every int8 weight code equal and every multiplier, bias and inverse
    scale within 1e-5 relative, after mapping JAX's layout to the port's.
    Not 1e-6: the two f32 calibration forwards sum in another order, which
    moves a channel's max-abs where its activation is a near-cancelling sum
    (measured 3.8e-6 in 2 of 128 entries; the codes stay equal)."""
    jcfg = _jcfg(viewdirs)
    params, cfg, model = nerf_models(jcfg, seed=2)
    pts, vds = _calib(*_inputs(24, 7, seed=1))
    fpj = prepare_fused_nerf_t(params, jcfg, Lp, Lv,
                               calib=(jnp.asarray(pts), jnp.asarray(vds)
                                      if viewdirs else None),
                               fold_requant=fold)
    got = NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                                calib=(t(pts), t(vds) if viewdirs else None),
                                fold_requant=fold)
    want = _port_from_jax(fpj, jcfg, got)
    assert got.fold_requant == fold
    for name in NR.FusedNeRFParams._fields[:-1]:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.int8:
            assert torch.equal(g, w), name
        else:
            np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=0,
                                       err_msg=name)


def _xla(f):
    """A torch elementwise function computed by XLA on the CPU."""
    fn = jax.jit(f)
    return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(n(x)))))


@pytest.mark.parametrize("viewdirs", [True, False])
@pytest.mark.parametrize("fold", [False, True])
def test_int8_plain_pass_matches_pallas(viewdirs, fold, monkeypatch):
    """The int8 plain version on JAX's own packed parameters against JAX's
    int8 kernel (interpret): the same exact int32 sums, the same one-FMA
    dequantize, requantize points and contracted sums. With the CPU
    libraries' exp and sigmoid it is a few outputs one or two f32 ulp off
    (torch's and XLA's exp differ by an ulp; ROADMAP C); with XLA's exp and
    sigmoid substituted, bit for bit. Then the engagement guard of
    tests/test_nerf_render_pallas.py:90-92 (int8 really moves the output
    away from f32)."""
    jcfg = _jcfg(viewdirs)
    params, cfg, model = nerf_models(jcfg, seed=3)
    o, d, z = _inputs(24, 7, seed=2)
    pts, vds = _calib(o, d, z)
    fpj = prepare_fused_nerf_t(params, jcfg, Lp, Lv,
                               calib=(jnp.asarray(pts), jnp.asarray(vds)
                                      if viewdirs else None),
                               fold_requant=fold)
    want = _jax_pass(fpj, jcfg, o, d, z, True, int8=True, fold=fold)
    like = NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                                 calib=(t(pts), t(vds) if viewdirs else None),
                                 fold_requant=fold)
    fp = _port_from_jax(fpj, jcfg, like)
    def run():
        return NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), Lp, Lv, True)
    got = run()
    for name, g, w in zip(("rgb", "acc", "depth", "weights"), got, want):
        np.testing.assert_allclose(n(g), w, rtol=0, atol=2e-7, err_msg=name)
    with monkeypatch.context() as m:
        m.setattr(torch, "exp", _xla(jnp.exp))
        m.setattr(torch, "sigmoid", _xla(jax.nn.sigmoid))
        exact = run()
    for name, g, w in zip(("rgb", "acc", "depth", "weights"), exact, want):
        np.testing.assert_array_equal(n(g), w, err_msg=name)
    f32 = NR.fused_nerf_render(
        NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                              weight_dtype=torch.float32),
        cfg, t(o), t(d), t(z), Lp, Lv, True)
    assert float((got[0] - f32[0]).abs().max()) > 1e-6, \
        "int8 quantization did not engage"


def _frame_case(seed):
    jcfg = dataclasses.replace(_jcfg(), D=3, skips=(1,))
    pc, cfg, mc = nerf_models(jcfg, seed=seed)
    pf, _, mf = nerf_models(jcfg, seed=seed + 1)
    vcfg = jrender.VolRenderConfig(
        n_coarse=6, n_fine=4, perturb=False, use_viewdirs=True,
        multires=Lp, multires_views=Lv, near=2.0, far=6.0, white_bkgd=True,
        ray_chunk=16)
    rng = np.random.default_rng(seed)
    o = np.zeros((24, 3), np.float32)
    d = rng.normal(size=(24, 3)).astype(np.float32)
    return jcfg, (pc, pf), cfg, (mc, mf), vcfg, o, d


@pytest.mark.parametrize("n_fine", [0, 4])
def test_fused_frame_matches_jax_f32(n_fine):
    """render_frame_nerf_fused, deterministic, f32 weights: the same
    contract as JAX's on the CPU (its kernel in interpret mode)."""
    jcfg, (pc, pf), cfg, (mc, mf), vcfg, o, d = _frame_case(4)
    vcfg = dataclasses.replace(vcfg, n_fine=n_fine)
    want = jrender.render_frame_nerf_fused(
        pc, pf if n_fine else None, jcfg, vcfg, jnp.asarray(o),
        jnp.asarray(d), tile=8)
    got = render.render_frame_nerf_fused(
        mc, mf if n_fine else None, cfg,
        render.VolRenderConfig(**dataclasses.asdict(vcfg)), t(o), t(d))
    for k in ("rgb", "acc", "depth", "disp"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, equal_nan=True,
                                   err_msg=k)


@pytest.mark.parametrize("fold", [False, True])
def test_fused_frame_matches_jax_int8(fold):
    """The int8 frame, each side calibrating on the same points: equal to
    JAX's where the two calibrations give the same codes; the calibration
    forwards' f32 sums may put a scale one ulp apart, which can move a
    requantize by one step, so the bound is K2's int8 bound."""
    jcfg, (pc, pf), cfg, (mc, mf), vcfg, o, d = _frame_case(6)
    z = np.linspace(2.0, 6.0, 6, dtype=np.float32)
    pts, vds = _calib(o, d, np.broadcast_to(z, (24, 6)))
    want = jrender.render_frame_nerf_fused(
        pc, pf, jcfg, vcfg, jnp.asarray(o), jnp.asarray(d), tile=8,
        int8_calib=(jnp.asarray(pts), jnp.asarray(vds)), fold_requant=fold)
    got = render.render_frame_nerf_fused(
        mc, mf, cfg, render.VolRenderConfig(**dataclasses.asdict(vcfg)),
        t(o), t(d), int8_calib=(t(pts), t(vds)), fold_requant=fold)
    for k in ("rgb", "acc"):
        err = np.abs(n(got[k]) - np.asarray(want[k]))
        assert err.max() < 2.5e-2 and np.sqrt((err ** 2).mean()) < 2.5e-3, (
            k, err.max())
    ref = jrender.render_frame_nerf(pc, pf, jcfg, vcfg, jnp.asarray(o),
                                    jnp.asarray(d))
    assert np.abs(n(got["rgb"]) - np.asarray(ref["rgb"])).max() > 1e-6, \
        "int8 quantization did not engage"


def test_fused_frame_with_jax_fused_draws():
    """Perturbed: JAX's fused path splits each chunk's key in two (strat,
    pdf); handed those draws, the port renders the same frame."""
    jcfg, (pc, pf), cfg, (mc, mf), vcfg, o, d = _frame_case(8)
    vcfg = dataclasses.replace(vcfg, perturb=True)
    key = jax.random.key(3)
    want = jrender.render_frame_nerf_fused(pc, pf, jcfg, vcfg,
                                           jnp.asarray(o), jnp.asarray(d),
                                           key=key, tile=8)
    got = render.render_frame_nerf_fused(
        mc, mf, cfg, render.VolRenderConfig(**dataclasses.asdict(vcfg)),
        t(o), t(d), draws=jax_chunk_draws(key, vcfg, 24, fused=True))
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=2e-4, err_msg=k)


def test_cpu_tensor_never_builds(monkeypatch):
    """A CPU tensor takes the plain version: the wrapper never reaches the
    nvcc build or a library."""
    def refuse(*a, **k):
        raise AssertionError("the build was reached for a CPU tensor")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    jcfg = _jcfg()
    params, cfg, model = nerf_models(jcfg, seed=9)
    o, d, z = _inputs(5, 4)
    before = (NR.fused_nerf_render.launches,
              NR.fused_nerf_render.launches_int8)
    for calib in (None, tuple(t(a) for a in _calib(o, d, z))):
        fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv, calib=calib,
                                   weight_dtype=torch.float32)
        out = NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), Lp, Lv)
        assert [tuple(a.shape) for a in out] == [(5, 3), (5,), (5,), (5, 4)]
    assert (NR.fused_nerf_render.launches,
            NR.fused_nerf_render.launches_int8) == before


@pytest.mark.parametrize("int8,fold", [(False, False), (False, True),
                                       (True, False), (True, True)])
def test_packing_records_its_mode(int8, fold):
    """The packing decides int8 (the weights' dtype) and the fold (a field)
    once: the render reads both from the parameters, and the frame render
    refuses packing arguments beside packed parameters."""
    jcfg, _, cfg, (mc, mf), vcfg, o, d = _frame_case(10)
    calib = tuple(t(a) for a in _calib(*_inputs(8, 4, seed=3))) if int8 \
        else None
    vt = render.VolRenderConfig(**dataclasses.asdict(vcfg))
    packed = render.prepare_fused_teacher(mc, mf, cfg, vt, None, calib, fold)
    for fp in packed:
        assert (fp.pts_w.dtype == torch.int8) == int8
        assert fp.fold_requant == (int8 and fold)
    got = render.render_frame_nerf_fused(mc, mf, cfg, vt, t(o), t(d),
                                         packed=packed)
    want = render.render_frame_nerf_fused(mc, mf, cfg, vt, t(o), t(d),
                                          int8_calib=calib,
                                          fold_requant=fold)
    for k in ("rgb", "acc", "depth"):
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError):
        render.render_frame_nerf_fused(mc, mf, cfg, vt, t(o), t(d),
                                       packed=packed, fold_requant=True)
