"""Wide and deep teachers: the teacher kernels' wide form
(``csrc/nerf_wide.cu``, above W256) and K6/K7 at any depth, on the CPU.

The plain version ``fused_nerf_render_ref`` is the plain version of K6, K7
and their wide form alike. Here it is held to the JAX package's teacher
kernel (``fused_nerf_render_t`` in interpret mode) at the shapes the wide
form and the deep chain take: a W384 teacher (view layer 192, which the
wide image pads to 256), a W300 one packed at 384 and a D40 one with two
skips, at the tolerances of ``tests/test_torch_nerf_kernel.py`` (f32 1e-5,
depth 1e-4; int8 on JAX's own packed parameters 2e-7). Then the gate
(every teacher the JAX package's model builds), the wide image (read back
whole over W 300-2200, f32 as both TF32 parts, the padding zero), its
refusal before a launch, the encoding kernel's plain twin against the
plain version's ``pe_ladder`` (int8: against the plain int8 chain's
codes), the scratch a call takes, and CPU
emulations of the wide forms' f32 sum orders against K6 f32's limits. The
card holds the kernels to the plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 23)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from _torch_parity import n, nerf_models, t
from r2l_tpu.kernels.nerf_render_pallas import prepare_fused_nerf_t
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.models.nerf import apply_nerf as japply_nerf
from r2l_tpu.models.nerf import init_nerf as jinit_nerf
from r2l_tpu_torch.kernels import nerf_render as NR
from r2l_tpu_torch.models import NeRFConfig, init_nerf
from test_torch_nerf_kernel import (Lp, Lv, _calib, _inputs, _jax_pass,
                                    _jcfg, _port_from_jax, _xla)

CPU = torch.device("cpu")
NAMES = ("rgb", "acc", "depth", "weights")


def _close_f32(got, want):
    """tests/test_torch_nerf_kernel.py's f32 bounds."""
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(n(g), w, rtol=0,
                                   atol=1e-4 if name == "depth" else 1e-5,
                                   err_msg=name)


# (W, D, skips, viewdirs) of the JAX parity cases: W384 (its view layer 192
# outputs), a deep narrow teacher with two skips.
SHAPES = {"w384": (384, 4, (2,), True), "w384_noview": (384, 4, (1,), False),
          "d40_w64": (64, 40, (4, 24), True), "w300": (300, 3, (0,), True)}


@functools.lru_cache(maxsize=None)
def _models(name: str):
    """(JAX config, JAX params, port config, port ``NeRF``) of a shape, the
    same weights on both sides, made once."""
    W, D, skips, vd = SHAPES[name]
    jcfg = _jcfg(vd, D=D, W=W, skips=skips)
    return (jcfg, *nerf_models(jcfg, seed=11))


@pytest.mark.parametrize("name", ["w384", "w384_noview", "d40_w64"])
def test_plain_pass_matches_pallas_f32(name):
    """f32 weights: the port's packing (the wide image above W256) and
    plain version against JAX's kernel on the same weights."""
    jcfg, params, cfg, model = _models(name)
    W, D = jcfg.W, jcfg.D
    o, d, z = _inputs(8 if D > 8 else 16, 7, seed=3)
    want = _jax_pass(prepare_fused_nerf_t(params, jcfg, Lp, Lv,
                                          weight_dtype=jnp.float32),
                     jcfg, o, d, z, True)
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                               weight_dtype=torch.float32)
    assert fp.staged.numel() == (
        NR.wide_teacher_plan if W > 256 else NR.stage_plan)(
        cfg, torch.float32, Lp, Lv)["nbytes"]
    _close_f32(NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), Lp, Lv, True),
               want)


@pytest.mark.parametrize("name,fold", [("w384", False), ("w384", True),
                                       ("w384_noview", True),
                                       ("d40_w64", True)])
def test_int8_plain_pass_matches_pallas(name, fold, monkeypatch):
    """int8, folded and unfolded: the plain version on JAX's own packed
    parameters against JAX's int8 kernel (the same exact int32 sums and
    one-FMA dequantize): every output within 2e-7, depth (a sum up to 6,
    where torch's and XLA's exp an ulp apart move it 4.8e-7) with XLA's exp
    and sigmoid substituted, as tests/test_torch_nerf_kernel.py does."""
    jcfg, params, cfg, model = _models(name)
    vd = jcfg.use_viewdirs
    o, d, z = _inputs(8 if jcfg.D > 8 else 16, 7, seed=4)
    pts, vds = _calib(o, d, z)
    fpj = prepare_fused_nerf_t(params, jcfg, Lp, Lv,
                               calib=(jnp.asarray(pts), jnp.asarray(vds)
                                      if vd else None),
                               fold_requant=fold)
    want = _jax_pass(fpj, jcfg, o, d, z, True, int8=True, fold=fold)
    like = NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                                 calib=(t(pts), t(vds) if vd else None),
                                 fold_requant=fold)
    fp = _port_from_jax(fpj, jcfg, like)

    def run():
        return NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), Lp, Lv, True)
    got = run()
    for name_, g, w in zip(NAMES, got, want):
        if name_ != "depth":
            np.testing.assert_allclose(n(g), w, rtol=0, atol=2e-7,
                                       err_msg=name_)
    with monkeypatch.context() as m:
        m.setattr(torch, "exp", _xla(jnp.exp))
        m.setattr(torch, "sigmoid", _xla(jax.nn.sigmoid))
        exact = run()
    for name_, g, w in zip(NAMES, exact, want):
        np.testing.assert_allclose(n(g), w, rtol=0, atol=2e-7, err_msg=name_)


def test_w300_packed_at_384_matches_pallas():
    """A W300 teacher packed at 384 (the card's packing, ``pad=True``):
    f32 against JAX's kernel at W300, within the f32 bounds; int8, each
    side calibrating on the same points, within K2's int8 bound (the
    calibration forwards sum in another order, which can move a scale an
    ulp and a requantize a step: tests/test_torch_gates.py)."""
    jcfg, params, cfg, model = _models("w300")
    o, d, z = _inputs(16, 7, seed=5)
    want = _jax_pass(prepare_fused_nerf_t(params, jcfg, Lp, Lv,
                                          weight_dtype=jnp.float32),
                     jcfg, o, d, z, True)
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                               weight_dtype=torch.float32, pad=True)
    assert fp.pts_b.shape == (3, 384) and fp.views_b.shape == (192,)
    _close_f32(NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), Lp, Lv, True),
               want)
    pts, vds = _calib(o, d, z)
    want = _jax_pass(prepare_fused_nerf_t(
        params, jcfg, Lp, Lv, calib=(jnp.asarray(pts), jnp.asarray(vds)),
        fold_requant=True), jcfg, o, d, z, True, int8=True, fold=True)
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv, calib=(t(pts), t(vds)),
                               fold_requant=True, pad=True)
    assert fp.pts_w.dtype == torch.int8 and fp.pts_b.shape == (3, 384)
    got = NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), Lp, Lv, True)
    for name, g, w in zip(NAMES, got, want):
        err = np.abs(n(g) - w)
        assert err.max() < 2.5e-2 and np.sqrt((err ** 2).mean()) < 2.5e-3, \
            name


# ---------------------------------------------------------------------------
# The gate: every teacher the JAX package's model builds
# ---------------------------------------------------------------------------

def _builds(D, skips) -> bool:
    """JAX's model applies only where no skip sits at the last layer (a
    skip there feeds the heads W + input_ch channels), nor before the
    first."""
    return all(0 <= s < D - 1 for s in skips)


@pytest.mark.parametrize("D", [1, 2, 3, 8, 31, 32, 40, 64, 120])
def test_teacher_predicate_over_widths_depths_and_skips(D):
    """Over W 1-2200 and every skip position from -1 to D (one skip, two,
    none): ``fused_teacher_supported`` is "every skip below D - 1", the
    width picks K6/K7 (up to 256, at 128 or 256) or the wide form (at the
    next multiple of 128), and ``check_teacher_supported`` raises exactly
    where the predicate refuses."""
    skip_sets = [()] + [(s,) for s in range(-1, D + 1)] + (
        [(0, D - 2), (D // 2, D - 1)] if D > 2 else [])
    for W in range(1, 2201):
        Wk = NR.teacher_kernel_width(W)
        assert NR.teacher_wide_form(W) == (W > 256)
        assert Wk >= W and (Wk in NR.NERF_KERNEL_WIDTHS if W <= 256
                            else Wk % 128 == 0 and Wk - W < 128)
    for W in (1, 64, 256, 257, 512, 1024, 2200):
        for skips in skip_sets:
            cfg = NeRFConfig(W=W, D=D, skips=skips)
            ok = NR.fused_teacher_supported(cfg)
            assert ok == _builds(D, skips), (W, D, skips)
            if ok:
                NR.check_teacher_supported(cfg, None)
            else:
                with pytest.raises(NotImplementedError,
                                   match="every skip before the last layer"):
                    NR.check_teacher_supported(None, cfg)


def test_jax_cannot_build_a_skip_at_the_last_layer():
    """The refused shape is one the JAX package's model cannot apply: its
    heads get W inputs from ``init_nerf`` and W + input_ch from
    ``apply_nerf``."""
    jcfg = JNeRFConfig(D=3, W=16, skips=(2,), input_ch=9, input_ch_views=6)
    params = jinit_nerf(jax.random.key(0), jcfg)
    with pytest.raises(TypeError):
        japply_nerf(params, jcfg, jnp.zeros((4, 15)))
    ok = dataclasses.replace(jcfg, skips=(1,))
    assert japply_nerf(jinit_nerf(jax.random.key(0), ok), ok,
                       jnp.zeros((4, 15))).shape == (4, 4)


# ---------------------------------------------------------------------------
# The wide image
# ---------------------------------------------------------------------------

def _teacher(W, D=4, skips=(2,), vd=True, wd=torch.bfloat16, fold=False,
             pad=None):
    cfg = NeRFConfig(D=D, W=W, skips=skips, use_viewdirs=vd, input_ch=63,
                     input_ch_views=27 if vd else 0)
    model = init_nerf(cfg, torch.Generator().manual_seed(W + D), CPU)
    calib = None
    if wd == torch.int8:
        g = torch.Generator().manual_seed(5)
        calib = (4.0 * torch.rand((600, 3), generator=g) - 2.0,
                 torch.nn.functional.normalize(
                     torch.randn((600, 3), generator=g), dim=-1)
                 if vd else None)
    fp = NR.prepare_fused_nerf(model, cfg, calib=calib, weight_dtype=wd,
                               fold_requant=fold, pad=pad)
    return NR.teacher_kernel_cfg(cfg) if pad else cfg, fp


@pytest.mark.parametrize("W,vd", [(384, True), (384, False), (300, True),
                                  (640, False), (1024, True), (2200, True)])
@pytest.mark.parametrize("wd,fold", [(torch.float32, False),
                                     (torch.bfloat16, False),
                                     (torch.int8, False), (torch.int8, True)])
def test_wide_image_reads_back_its_weights(W, vd, wd, fold):
    """Every GEMM and head weight of the packed fields comes back bit for
    bit (f32's GEMM weights as their TF32 high and low parts, which the
    card's products read), the padding (to 128 outputs: the W384 view
    layer's 192 to 256, W300 to 384; the encodings to 128 bytes) is zero,
    and the epilogue table holds each layer's bias, int8's multipliers and,
    unfolded, the consumer's inverse scales (1 where folded); its size is
    ``wide_teacher_plan``'s."""
    cfg, fp = _teacher(W, vd=vd, wd=wd, fold=fold, pad=True)
    plan = NR.wide_teacher_plan(cfg, wd)
    Wp = NR._round_up(W, 128)
    assert cfg.W == Wp == plan["Wp"] and plan["Vp"] == NR._round_up(Wp // 2,
                                                                     128)
    assert plan["parts"] == (2 if wd == torch.float32 else 1)
    assert fp.staged.dtype == torch.uint8
    assert fp.staged.numel() == plan["nbytes"] and plan["nbytes"] % 16 == 0
    got = NR.unstage_wide_teacher(fp.staged, cfg, wd)
    fields = (["pts_w", "feat_w", "views_w", "alpha_w", "rgb_w"] if vd
              else ["pts_w", "out_w"])
    gemm = ("pts_w", "feat_w", "views_w")
    for name in fields:
        want = getattr(fp, name)
        if wd == torch.float32 and name in gemm:
            hi, lo = NR.tf32_split(want)
            assert torch.equal(got[name + "_lo"].contiguous().view(
                torch.uint8), lo.contiguous().view(torch.uint8)), name
            want = hi
        else:
            assert name + "_lo" not in got
        assert got[name].shape == want.shape, name
        assert torch.equal(got[name].contiguous().view(torch.uint8),
                           want.contiguous().view(torch.uint8)), name
    assert float(got["padding"]) == 0.0
    table = got["table"]
    sizes = [k for k, _ in plan["layers"]]
    assert table.shape == (sum(sizes), 4)
    rows = torch.split(table, sizes)
    int8 = wd == torch.int8
    bs = [fp.pts_b[i] for i in range(cfg.D)] + [fp.feat_b, fp.views_b]
    if int8:
        invs = ([fp.pts_inv[i] for i in range(1, cfg.D)]
                + [fp.h_inv, fp.hv_inv[:cfg.W], fp.hr_inv])
        ms = [fp.pts_m[i] for i in range(cfg.D)] + [fp.feat_m, fp.views_m]
    for i, r in enumerate(rows):
        k = bs[i].numel()
        assert torch.equal(r[:k, 1], bs[i]) and not r[k:, :2].any()
        assert torch.equal(r[:, 3], torch.zeros_like(r[:, 3]))
        if int8:
            assert torch.equal(r[:k, 0], ms[i])
        if int8 and not fold:
            assert torch.equal(r[:k, 2], invs[i]), i
        else:
            assert torch.equal(r[:, 2], torch.ones_like(r[:, 2]))


def test_deep_chain_image_holds_a_flag_a_layer():
    """K6/K7's image at D40: the skip set as one int32 flag a point layer
    (any depth: no bit mask), after the weights."""
    cfg, fp = _teacher(64, D=40, skips=(4, 24), pad=True)
    plan = NR.stage_plan(cfg, torch.bfloat16)
    off = plan["flags_off"]
    flags = fp.staged[off:off + 4 * 40].clone().view(torch.int32)
    assert flags.tolist() == [int(i in (4, 24)) for i in range(40)]
    assert fp.staged.numel() == plan["nbytes"] == off + 160


def _meta(fp: NR.FusedNeRFParams) -> NR.FusedNeRFParams:
    return fp._replace(**{k: v.to("meta") for k, v in fp._asdict().items()
                          if isinstance(v, torch.Tensor)})


@pytest.mark.parametrize("image", ["none", "truncated", "other_dtype",
                                   "chain_form"])
def test_wide_wrapper_refuses_a_foreign_or_stale_image(image):
    """On a device tensor (meta stands in for the card's) the wrapper
    refuses, before any launch, a W384 packing without its image, with one
    cut short, one staged from the bf16 weights, or K6/K7's form of the
    same weights."""
    cfg, fp = _teacher(384, wd=torch.float32, pad=True)
    other = {"none": None, "truncated": fp.staged[:-16],
             "other_dtype": _teacher(384, pad=True)[1].staged,
             "chain_form": NR.stage_weights(fp, cfg)}[image]
    fp = _meta(fp._replace(staged=other))
    f = NR.fused_nerf_render
    before = (f.launches, f.launches_int8, f.launches_wide,
              f.launches_wide_int8)
    rays = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="staged"):
        f(fp, cfg, rays, rays, torch.empty((8, 5), device="meta"))
    assert (f.launches, f.launches_int8, f.launches_wide,
            f.launches_wide_int8) == before


# ---------------------------------------------------------------------------
# The wide form's f32 sum order
# ---------------------------------------------------------------------------

def _mm_wide_3xtf32(x, w, route="one_sum"):
    """The wide forms' f32 products, for each step of 8 input channels its
    three TF32 products of 8 terms each. ``one_sum`` (the teacher's wide
    form on wgmma, as K6 f32): a_hi w_lo, a_lo w_hi, a_hi w_hi, each added
    in turn to the one running sum in f32. ``k8_apart`` (the student's and
    the training's wide passes on mma.sync): a_lo w_hi, a_hi w_lo, a_hi
    w_hi summed apart from zero in f32, the step's sum then added to the
    running sum in f32."""
    xh, xl = NR.tf32_split(x.float())
    wh, wl = NR.tf32_split(w.float())
    acc = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.float32)
    for k in range(0, x.shape[1], 8):
        s = slice(k, k + 8)
        if route == "one_sum":
            acc = acc + xh[:, s] @ wl[:, s].T
            acc = acc + xl[:, s] @ wh[:, s].T
            acc = acc + xh[:, s] @ wh[:, s].T
        else:
            d = xl[:, s] @ wh[:, s].T
            d = d + xh[:, s] @ wl[:, s].T
            d = d + xh[:, s] @ wh[:, s].T
            acc = acc + d
    return acc


# The share of K6 f32's limits (chip_smoke.TOL_TEACHER["f32"]) the
# emulation may use: measured 1.8% (max-abs) and 3.7% (RMS) at worst.
EMULATION_SHARE = 0.1


@pytest.mark.parametrize("route", ["one_sum", "k8_apart"])
@pytest.mark.parametrize("fine", [False, True])
def test_wide_3xtf32_emulation_keeps_the_f32_limits(fine, route):
    """A W384/D8 teacher (skip 4, viewdirs, L=10/4, the density floor) on
    24 rays of chip_smoke's seeded datagen pose, coarse (S=64) and fine
    (S=192, sample_pdf on the plain coarse weights): the plain version with
    its GEMM layers in a wide form's order (``_mm_wide_3xtf32``: the
    teacher's one running sum, and the k8 steps apart that the student's
    and the training's wide passes keep) against the true-f32 plain
    version, every output within ``EMULATION_SHARE`` of K6 f32's limits
    (the card truncates its sums: chip_smoke.py holds the kernel itself to
    the whole limits)."""
    from r2l_tpu_torch.datagen import _pose_rays
    from r2l_tpu_torch.render import coarse_z, draw_chunk
    from r2l_tpu_torch.volume import sample_pdf
    vcfg = cs.teacher_vcfg()
    ro, rd = (torch.from_numpy(a.reshape(-1, 3)[::6667].copy())
              for a in _pose_rays(np.random.default_rng(cs.SEED + 20),
                                  cs.datagen_cfg("f32", 1), 4.0))
    cfg = NeRFConfig(W=384)
    model = init_nerf(cfg, torch.Generator().manual_seed(7), CPU)
    with torch.no_grad():
        model.alpha_linear.bias += cs.DENSITY_FLOOR
    fp = NR.prepare_fused_nerf(model, cfg, weight_dtype=torch.float32)
    kw = dict(L_pts=vcfg.multires, L_views=vcfg.multires_views,
              white_bkgd=True)
    dr = draw_chunk(vcfg, ro.shape[0], torch.Generator().manual_seed(1),
                    True)
    z = coarse_z(vcfg, ro.shape[0], CPU, dr.u_strat).contiguous()
    if fine:
        w = NR.fused_nerf_render_ref(fp, cfg, ro, rd, z, **kw)[3]
        zf = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w[:, 1:-1],
                        vcfg.n_fine, u=dr.u_pdf)
        z = torch.sort(torch.cat([z, zf], -1), -1).values.contiguous()
    want = NR.fused_nerf_render_ref(fp, cfg, ro, rd, z, **kw)
    got = NR.fused_nerf_render_ref(
        fp, cfg, ro, rd, z, mm=functools.partial(_mm_wide_3xtf32,
                                                 route=route), **kw)
    (tol, tol_rms), (tol_d, tol_d_rms) = cs.TOL_TEACHER["f32"]
    for what, g, w in zip(NAMES, got, want):
        d = g.double() - w.double()
        mx, rms = float(d.abs().max()), float(d.pow(2).mean().sqrt())
        lim = (tol_d, tol_d_rms) if what == "depth" else (tol, tol_rms)
        print(f"wide 3xTF32 {route} emulation S={z.shape[1]} {what}: max-abs "
              f"{mx:.3e} ({mx / lim[0]:.1%} of {lim[0]:.0e}), RMS {rms:.3e} "
              f"({rms / lim[1]:.1%} of {lim[1]:.0e})")
        assert mx <= EMULATION_SHARE * lim[0], (what, mx)
        assert rms <= EMULATION_SHARE * lim[1], (what, rms)
        assert mx > 0, "the emulation changed nothing"


# ---------------------------------------------------------------------------
# The encodings and the scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,Lp,Lv,vd", [
    (384, 10, 4, True), (1024, 10, 4, True), (300, 6, 3, True),
    (512, 10, 4, False), (640, 16, 7, True)])
def test_encoding_twin_equals_pe_ladder(wd, W, Lp, Lv, vd):
    """The encoding kernel's plain twin (``wide_encodings_ref``: each
    coordinate's ladder on its own, as ``nerf::encode``) gives, bit for
    bit, the point and view encodings the plain version computes
    (``pe_ladder`` of ``ray_points`` and of d / |d|), rounded to the
    compute type and zero-padded to the image's 128-byte columns, each
    point row holding its ray's view encoding; the columns are the ones
    the wide image's first and view layers read."""
    from r2l_tpu_torch.volume import ray_points
    cfg = NeRFConfig(W=W, D=4, skips=(2,), use_viewdirs=vd,
                     input_ch=3 + 6 * Lp, input_ch_views=3 + 6 * Lv)
    plan = NR.wide_teacher_plan(cfg, wd, Lp, Lv)
    ke, kve = plan["ke"], plan["kve"]
    es = torch.empty(0, dtype=wd).element_size()
    assert ke * es % 128 == 0 and ke >= plan["kp"] >= 3 + 6 * Lp
    assert plan["layers"][0][1] == ke
    assert (kve * es % 128 == 0 and kve >= plan["kvw"] >= 3 + 6 * Lv
            and plan["layers"][-1][1] == plan["Wp"] + kve) if vd else kve == 0
    g = np.random.default_rng(W + Lp)
    n, S = 37, 11
    o = torch.from_numpy(g.uniform(-4, 4, (n, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    d[0] = 0.0   # |d| = 0 takes the 1e-12 floor
    z = torch.from_numpy(np.sort(g.uniform(2, 6, (n, S)), 1).astype(
        np.float32))
    E, V = NR.wide_encodings_ref(o, d, z, Lp, Lv, ke, kve, wd)
    want = NR.pe_ladder(ray_points(o, d, z), Lp, ke).reshape(n * S, ke)
    assert E.dtype == wd and E.shape == (n * S, ke)
    assert torch.equal(E.view(torch.uint8), want.to(wd).view(torch.uint8))
    if not vd:
        assert V is None
        return
    dn = NR._norm3(d)
    vw = NR.pe_ladder(d / dn.clamp(min=1e-12)[:, None], Lv, kve)
    assert V.dtype == wd and V.shape == (n * S, kve)
    assert torch.equal(V.view(torch.uint8), vw.to(wd).repeat_interleave(
        S, 0).view(torch.uint8))


@pytest.mark.parametrize("W", [384, 1024])
@pytest.mark.parametrize("fold", [False, True])
def test_int8_encoding_twin_equals_the_plain_codes(W, fold):
    """The encoding kernel's plain twin in int8 (``wide_encodings_ref``
    with the teacher's ``pe_inv`` and ``hv_inv[W:]``) gives, bit for bit,
    the codes the plain version's int8 chain quantizes (``_mlp_int8``:
    ``_q8`` of the point encoding by ``pe_inv`` and of the view encoding
    by ``hv_inv[W:]``), zero-padded to the image's 128-byte columns, each
    point row holding its ray's view codes."""
    from r2l_tpu_torch.volume import ray_points
    cfg, fp = _teacher(W, wd=torch.int8, fold=fold, pad=True)
    plan = NR.wide_teacher_plan(cfg, torch.int8)
    kp, kv, _ = NR.layout(cfg, 10, 4)
    ke, kve = plan["ke"], plan["kve"]
    assert ke % 128 == 0 and kve % 128 == 0 and ke >= kp
    g = np.random.default_rng(W)
    n, S = 29, 7
    o = torch.from_numpy(g.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    z = torch.from_numpy(np.sort(g.uniform(2, 6, (n, S)), 1).astype(
        np.float32))
    E, V = NR.wide_encodings_ref(o, d, z, 10, 4, ke, kve, torch.int8,
                                 fp.pe_inv, fp.hv_inv[cfg.W:])
    pe = NR.pe_ladder(ray_points(o, d, z), 10, kp).reshape(n * S, kp)
    want = torch.zeros((n * S, ke), dtype=torch.int8)
    want[:, :kp] = NR._q8(pe, fp.pe_inv).to(torch.int8)
    assert E.dtype == torch.int8 and torch.equal(E, want)
    assert int(E.abs().max()) > 0
    vpe = NR.pe_ladder(d / NR._norm3(d).clamp(min=1e-12)[:, None], 4,
                       kv - cfg.W)
    vq = torch.zeros((n, kve), dtype=torch.int8)
    vq[:, :kv - cfg.W] = NR._q8(vpe, fp.hv_inv[cfg.W:]).to(torch.int8)
    assert torch.equal(V, vq.repeat_interleave(S, 0))


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("W,S,n", [(384, 64, 32768), (1024, 192, 32768),
                                   (2176, 192, 160000), (512, 24, 1)])
def test_wide_scratch_holds_a_pass(wd, W, S, n):
    """The rays of a pass (``teacher_wide_rays``) fit their scratch in
    ``WIDE_SCRATCH_BYTES`` (a pass of one ray where that ray alone is
    larger), and every form's scratch holds the encodings' buffers [rows,
    ke] and [rows, kve] (int8: their codes) beside the activations'."""
    cfg = NeRFConfig(W=W, D=8, skips=(4,))
    plan = NR.wide_teacher_plan(cfg, wd)
    enc = (plan["ke"], plan["kve"])
    rays = NR.teacher_wide_rays(n, S, W, wd, *enc)
    assert 1 <= rays <= n
    need = NR.teacher_wide_scratch_bytes(rays * S, W, wd, *enc)
    assert need <= NR.WIDE_SCRATCH_BYTES or rays == 1
    if rays < n:
        assert NR.teacher_wide_scratch_bytes((rays + 1) * S, W, wd, *enc) \
            > NR.WIDE_SCRATCH_BYTES - 2048
    es = torch.empty(0, dtype=wd).element_size()
    base = NR.teacher_wide_scratch_bytes(rays * S, W, wd)
    assert need - base == (NR._aligned(rays * S * plan["ke"] * es)
                           + NR._aligned(rays * S * plan["kve"] * es))
    if wd == torch.int8:   # the codes: 128 columns of each
        assert plan["ke"] == plan["kve"] == 128
