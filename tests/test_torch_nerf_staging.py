"""The staged weight image of the Hopper teacher kernels (K6, K7) and the
3xTF32 split of K6 f32, on the CPU.

``stage_weights`` packs each GEMM layer once per model into the stages the
kernels bulk-copy (wgmma's core-matrix order); here the image is unpacked
again and held to the packed fields bit for bit. K6 f32 multiplies as
3xTF32 (a_hi w_lo + a_lo w_hi + a_hi w_hi): an emulation of that split
through the plain version, at the canonical 8x256 teacher on a slice of a
datagen pose, is held to the f32 limits ``chip_smoke.py`` holds K6 f32 to
(``TOL_TEACHER["f32"]``) against the true-f32 plain version. The card's
own sums (truncating, ROADMAP C) are held there by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from r2l_tpu_torch.kernels import nerf_render as NR
from r2l_tpu_torch.models import NeRFConfig, init_nerf

CPU = torch.device("cpu")


def _model(W, vd, skips):
    D = 8 if W == 256 else 3
    cfg = NeRFConfig(D=D, W=W, skips=skips, use_viewdirs=vd, input_ch=63,
                     input_ch_views=27 if vd else 0)
    return cfg, init_nerf(cfg, torch.Generator().manual_seed(W + D), CPU)


def _pack(cfg, model, wd):
    calib = None
    if wd == torch.int8:
        g = torch.Generator().manual_seed(5)
        calib = (4.0 * torch.rand((600, 3), generator=g) - 2.0,
                 torch.nn.functional.normalize(
                     torch.randn((600, 3), generator=g), dim=-1)
                 if cfg.use_viewdirs else None)
    return NR.prepare_fused_nerf(model, cfg, calib=calib, weight_dtype=wd,
                                 fold_requant=calib is not None)


def _bits(x):
    return x.contiguous().view(torch.int32)


CASES = [(256, True, (4,)), (256, True, (0,)), (128, True, (0,)),
         (128, False, (0,))]


@pytest.mark.parametrize("W,vd,skips", CASES)
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.int8, torch.float32])
def test_staged_image_unpacks_bit_for_bit(W, vd, skips, wd):
    """The image holds every GEMM weight and head weight of the packed
    fields: bf16 and int8 bit for bit; f32 as its TF32 high and low parts,
    each the split of the packed f32 weight bit for bit (the heads whole).
    int8's dequantize constants (the kernel's table of column pairs) bit
    for bit. Its size and the layers' bytes are ``stage_plan``'s."""
    cfg, model = _model(W, vd, skips)
    fp = _pack(cfg, model, wd)
    plan = NR.stage_plan(cfg, wd)
    assert fp.staged.dtype == torch.uint8
    assert fp.staged.numel() == plan["nbytes"]
    assert fp.staged.numel() % 16 == 0
    got = NR.unstage_weights(fp.staged, cfg, wd)
    gemm = ["pts_w", "feat_w", "views_w"] if vd else ["pts_w"]
    heads = ["alpha_w", "rgb_w"] if vd else ["out_w"]
    consts = []
    if wd == torch.int8:   # the dequantize constants' column-pair table
        consts = ["pts_m", "pts_b"] + (
            ["feat_m", "feat_b", "views_m", "views_b"] if vd else [])
    assert sorted(k for k in got if not k.endswith("_lo")) == \
        sorted(gemm + heads + consts)
    for name in consts:
        assert torch.equal(_bits(got[name]), _bits(getattr(fp, name))), name
    for name in gemm + heads:
        want = getattr(fp, name)
        assert got[name].dtype == wd and got[name].shape == want.shape, name
        if wd == torch.float32 and name in gemm:
            hi, lo = NR.tf32_split(want)
            assert torch.equal(_bits(got[name]), _bits(hi)), name
            assert torch.equal(_bits(got[name + "_lo"]), _bits(lo)), name
        else:
            assert torch.equal(got[name].view(torch.uint8),
                               want.contiguous().view(torch.uint8)), name


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.int8, torch.float32])
def test_stages_are_wgmma_core_matrices(wd):
    """Stage 0 of layer 0: byte b of output row n at ((n//8) * (B//16) +
    b//16) * 128 + (n%8) * 16 + b%16, B = 128 bytes per row (f32: 64, the
    high part first)."""
    cfg, model = _model(128, True, (0,))
    fp = _pack(cfg, model, wd)
    k = NR.STAGE_K[wd]
    kp = NR.layout(cfg, 10, 4)[0]
    w = NR._pad_cols(fp.pts_w[:cfg.W * kp].view(cfg.W, kp),
                     NR.stage_plan(cfg, wd)["kpe"])[:, :k]
    if wd == torch.float32:
        w = NR.tf32_split(w)[0]
    rows = w.contiguous().view(torch.uint8).reshape(cfg.W, -1)
    B = rows.shape[1]
    assert B == (64 if wd == torch.float32 else 128)
    for n_, b in [(0, 0), (5, 17), (9, 100 % B), (127, B - 1), (64, 33)]:
        off = ((n_ // 8) * (B // 16) + b // 16) * 128 + (n_ % 8) * 16 + b % 16
        assert fp.staged[off] == rows[n_, b], (n_, b)


def test_tf32_split_bounds():
    """hi and lo are TF32 values (low 13 mantissa bits zero), hi is w
    rounded to nearest with ties away from zero, and hi + lo is within
    2^-21 of w, relative, over the canonical teacher's weights and random
    values of every magnitude."""
    cfg, model = _model(256, True, (4,))
    fp = _pack(cfg, model, torch.float32)
    g = torch.Generator().manual_seed(3)
    wide = torch.randn(100_000, generator=g) * torch.exp2(
        torch.randint(-60, 60, (100_000,), generator=g).float())
    for w in (fp.pts_w, fp.feat_w.reshape(-1), fp.views_w.reshape(-1), wide,
              torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 0.0])):
        hi, lo = NR.tf32_split(w)
        for p in (hi, lo):
            assert int((_bits(p) & 0x1FFF).abs().max()) == 0
        assert torch.all((hi - w).abs() <= w.abs() * 2.0 ** -11)
        err = ((hi.double() + lo.double()) - w.double()).abs()
        assert torch.all(err <= w.double().abs() * 2.0 ** -21)
    # ties go away from zero, as cvt.rna does
    hi, _ = NR.tf32_split(torch.tensor([1.0 + 2.0 ** -11,
                                        -(1.0 + 2.0 ** -11)]))
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def _mm_3xtf32(x, w):
    """K6 f32's product: a_hi w_lo + a_lo w_hi + a_hi w_hi, each product
    of TF32 values exact in f32, summed in f32."""
    xh, xl = NR.tf32_split(x.float())
    wh, wl = NR.tf32_split(w.float())
    return xh @ wl.T + xl @ wh.T + xh @ wh.T


@pytest.fixture(scope="module")
def datagen_slice():
    """chip_smoke.py's canonical f32 teacher (random weights, the density
    floor) and 256 rays of its seeded datagen pose (every 625th), with the
    coarse pass's stratified depths (S=64) and the fine pass's sorted ones
    (S=192, sample_pdf on the plain coarse weights)."""
    from r2l_tpu_torch.datagen import _pose_rays
    from r2l_tpu_torch.render import coarse_z, draw_chunk, \
        prepare_fused_teacher
    from r2l_tpu_torch.volume import sample_pdf
    vcfg = cs.teacher_vcfg()
    ro, rd = (torch.from_numpy(a.reshape(-1, 3)[::625].copy())
              for a in _pose_rays(np.random.default_rng(cs.SEED + 20),
                                  cs.datagen_cfg("f32", 1), 4.0))
    cfg, mc, mf = cs.teacher_models("f32", CPU)
    fpc, fpf = prepare_fused_teacher(mc, mf, cfg, vcfg)
    dr = draw_chunk(vcfg, ro.shape[0], torch.Generator().manual_seed(1),
                    True)
    zc = coarse_z(vcfg, ro.shape[0], CPU, dr.u_strat).contiguous()
    w = NR.fused_nerf_render_ref(fpc, cfg, ro, rd, zc, vcfg.multires,
                                 vcfg.multires_views, True)[3]
    zf = sample_pdf(0.5 * (zc[:, 1:] + zc[:, :-1]), w[:, 1:-1], vcfg.n_fine,
                    u=dr.u_pdf)
    zf = torch.sort(torch.cat([zc, zf], -1), -1).values.contiguous()
    return cfg, vcfg, ro, rd, ((fpc, zc), (fpf, zf))


@pytest.mark.parametrize("fine", [False, True])
def test_3xtf32_emulation_keeps_the_f32_limits(datagen_slice, fine):
    """The plain version with its GEMM layers as 3xTF32 against the true-f32
    plain version, every output (rgb, acc, weights; depth apart), within
    chip_smoke.py's TOL_TEACHER["f32"] (max-abs 1e-5, RMS 1e-6; depth 1e-4,
    1e-5). The share of each limit used is printed."""
    cfg, vcfg, ro, rd, passes = datagen_slice
    fp, z = passes[int(fine)]
    kw = dict(L_pts=vcfg.multires, L_views=vcfg.multires_views,
              white_bkgd=True)
    want = NR.fused_nerf_render_ref(fp, cfg, ro, rd, z, **kw)
    got = NR.fused_nerf_render_ref(fp, cfg, ro, rd, z, mm=_mm_3xtf32, **kw)
    (tol, tol_rms), (tol_d, tol_d_rms) = cs.TOL_TEACHER["f32"]
    for what, g, w in zip(("rgb", "acc", "depth", "weights"), got, want):
        d = (g.double() - w.double())
        mx, rms = float(d.abs().max()), float(d.pow(2).mean().sqrt())
        lim = (tol_d, tol_d_rms) if what == "depth" else (tol, tol_rms)
        print(f"3xTF32 emulation S={z.shape[1]} {what}: max-abs {mx:.3e} "
              f"({mx / lim[0]:.1%} of {lim[0]:.0e}), RMS {rms:.3e} "
              f"({rms / lim[1]:.1%} of {lim[1]:.0e})")
        assert mx <= lim[0] and rms <= lim[1], (what, mx, rms)
        assert mx > 0, "the emulation changed nothing"


def test_l2_bytes_follow_the_clusters():
    """A launch reads the layers' stages once per 2-block cluster and group
    of 8 samples: 160,000 rays at S=64 in bf16 are 5,000 clusters of 32
    rays, 8 groups each."""
    cfg, _ = _model(256, True, (4,))
    gemm = NR.stage_plan(cfg, torch.bfloat16)["gemm_bytes"]
    assert NR.staged_l2_bytes(cfg, torch.bfloat16, 160_000, 64) == \
        5000 * 8 * gemm
    # a half-empty last cluster counts whole; f32 blocks hold 8 rays
    assert NR.staged_l2_bytes(cfg, torch.bfloat16, 48, 13) == 2 * 2 * gemm
    f32 = NR.stage_plan(cfg, torch.float32)["gemm_bytes"]
    assert NR.staged_l2_bytes(cfg, torch.float32, 24, 8) == 2 * f32
