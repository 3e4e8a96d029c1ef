"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; every test here is marked ``cuda`` and skips
without a GPU. Imports neither JAX nor the JAX package, so it also runs on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from r2l_tpu_torch import evaluate as TE
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.encoding import r2l_embed
from r2l_tpu_torch.evaluate import _calibration_points
from r2l_tpu_torch.kernels import nerf_render as NR
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.models import (NeRFConfig, R2L, R2LConfig, init_nerf,
                                  init_r2l, params_from_jax)
from r2l_tpu_torch.rays import pose_spherical
from r2l_tpu_torch.sampler import PointSampler

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# K1 f32: the same f32 chain, sums in another order. K1 bf16: a flipped
# bf16 rounding of an activation propagates (tests/test_pallas_pe.py:50).
# K2: exact int32 dots and the plain version's epilogue order; a flipped
# requantize may move a few outputs (tests/test_pallas_int8_pe.py:45-46).
TOL_F32, TOL_BF16 = 1e-4, 3e-2
TOL_INT8_MAX, TOL_INT8_RMS = 2.5e-2, 2.5e-3

# (netwidth, n_learnable, n_sample (dim_pts/3), L, other knobs): the
# canonical layout, then the other widths and depths the kernels take, and a
# width they take padded (W96 packed at 128 with zero channels).
CASES = {
    "w256_canonical": (256, 2, 16, 10, {}),
    "w128_nl3_dim6": (128, 3, 2, 10, {"res_scale": 0.5}),
    "w64_nl1_linear": (64, 1, 16, 4, {"use_residual": False,
                                      "linear_tail": True}),
    "w96_padded": (96, 2, 16, 10, {}),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(name, dev, compute_dtype=torch.bfloat16, n_rays=1000,
          cases=CASES):
    W, nl, n_sample, L, kw = cases[name]
    dp = 3 * n_sample
    cfg = R2LConfig(input_dim=dp * (2 * L + 1), netdepth=12, netwidth=W,
                    n_learnable=nl, compute_dtype=compute_dtype, **kw)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    sampler = PointSampler(H=40, W=25, focal=30.0, n_sample=n_sample,
                           near=2.0, far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in (0.0, 120.0, 240.0)])
    pts = sampler.sample_test(torch.as_tensor(poses[1], device=dev))
    return cfg, model, sampler, poses, pts[:n_rays].contiguous(), dp, L


def _deltas(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    d = (got - want).double()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_pe_kernel_matches_plain(dev, name, wd):
    cfg, model, _, _, pts, dp, L = _case(name, dev)
    fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd)
    before = F.fused_r2l_apply_pe.launches
    got = F.fused_r2l_apply_pe(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert F.fused_r2l_apply_pe.launches == before + 1
    want = F.fused_r2l_apply_pe_ref(fp, cfg, pts, dp, L)
    mx, _ = _deltas(got, want)
    assert mx < (TOL_F32 if wd == torch.float32 else TOL_BF16), mx


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_fused_kernel_matches_plain(dev, name, wd):
    """K9 on the encoded rays (r2l_embed's order, the unpadded [N, in_dim]
    input; 1000 rays, not a multiple of the ray tile)."""
    cfg, model, _, _, pts, dp, L = _case(name, dev)
    fp = F.prepare_fused_params(model, cfg, weight_dtype=wd)
    x = r2l_embed(pts, L)
    assert x.shape == (1000, cfg.input_dim)
    before = F.fused_r2l_apply.launches
    got = F.fused_r2l_apply(fp, cfg, x)
    torch.cuda.synchronize()
    assert F.fused_r2l_apply.launches == before + 1
    mx, _ = _deltas(got, F.fused_r2l_apply_ref(fp, cfg, x))
    assert mx < (TOL_F32 if wd == torch.float32 else TOL_BF16), mx
    # a half-precision x is rounded to the compute dtype once, as the plain
    # version rounds it
    got = F.fused_r2l_apply(fp, cfg, x.half())
    mx, _ = _deltas(got, F.fused_r2l_apply_ref(fp, cfg, x.half()))
    assert mx < (TOL_F32 if wd == torch.float32 else TOL_BF16), mx


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_kernel_matches_plain(dev, name):
    cfg, model, sampler, poses, pts, dp, L = _case(name, dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev))
    before = F.fused_r2l_apply_int8_pe.launches
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert F.fused_r2l_apply_int8_pe.launches == before + 1
    mx, rms = _deltas(got, F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, dp, L))
    assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (mx, rms)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fold_requant,nobf16_inner",
                         [(True, False), (False, False)])
def test_int8_kernel_forms_match_plain(dev, name, fold_requant,
                                       nobf16_inner):
    """K2's other two forms, each on the packing of its fold_requant."""
    cfg, model, sampler, poses, pts, dp, L = _case(name, dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev),
                                 fold_requant=fold_requant)
    kw = dict(fold_requant=fold_requant, nobf16_inner=nobf16_inner)
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, L, **kw)
    mx, rms = _deltas(got, F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, dp, L,
                                                         **kw))
    assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (mx, rms)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fold_requant,nobf16_inner",
                         [(True, True), (True, False), (False, False)])
def test_int8_hopper_forms_bit_for_bit(dev, name, fold_requant,
                                       nobf16_inner):
    """K2 on wgmma s8 keeps every rounding of its plain version: its three
    forms at W64, W128 and W256 equal it bit for bit, on 1,000 rays and on
    a ragged 129 (one ray in the second block of a cluster)."""
    cfg, model, sampler, poses, pts, dp, L = _case(name, dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev),
                                 fold_requant=fold_requant)
    assert fp.staged is not None
    kw = dict(fold_requant=fold_requant, nobf16_inner=nobf16_inner)
    for q in (pts, pts[:129].contiguous()):
        got = F.fused_r2l_apply_int8_pe(fp, cfg, q, dp, L, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, F.fused_r2l_apply_int8_pe_ref(
            fp, cfg, q, dp, L, **kw))


def test_int8_hopper_raises_without_its_image(dev):
    """On the card, K2 refuses a calibration without the s8 image."""
    cfg, model, sampler, poses, pts, dp, L = _case("w64_nl1_linear", dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev),
                                 stage=False)
    with pytest.raises(ValueError, match="staged"):
        F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, L)


# The frame kernels' wide form (csrc/r2l_wide.cu): students wider than 256,
# in the layouts above; W300 packed at 384 with zero channels.
WIDE_CASES = {
    "w384_canonical": (384, 2, 16, 10, {}),
    "w512_nl3_dim6": (512, 3, 2, 10, {"res_scale": 0.5}),
    "w300_nl1_linear": (300, 1, 16, 4, {"use_residual": False,
                                         "linear_tail": True}),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_wide_pe_kernel_matches_plain(dev, name, wd, monkeypatch):
    """K1 above W256 runs on its wide form (one launch of its counter, none
    of K1's), within K1's bounds of the plain version; with the scratch cut
    to passes of 128 rays, the one pass's output bit for bit."""
    cfg, model, _, _, pts, dp, L = _case(name, dev, cases=WIDE_CASES)
    fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd)
    before = (F.fused_r2l_apply_pe.launches,
              F.fused_r2l_apply_pe_wide.launches)
    got = F.fused_r2l_apply_pe(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert (F.fused_r2l_apply_pe.launches,
            F.fused_r2l_apply_pe_wide.launches) == (before[0], before[1] + 1)
    mx, _ = _deltas(got, F.fused_r2l_apply_pe_ref(fp, cfg, pts, dp, L))
    assert mx < (TOL_F32 if wd == torch.float32 else TOL_BF16), mx
    monkeypatch.setattr(F, "WIDE_SCRATCH_BYTES", 1)
    assert F.wide_rows(pts.shape[0], F.kernel_width(cfg.netwidth), wd,
                       cfg.n_learnable, cfg.use_residual,
                       F._padded_in(dp * (2 * L + 1))) == 128
    assert torch.equal(got, F.fused_r2l_apply_pe(fp, cfg, pts, dp, L))


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_wide_fused_kernel_matches_plain(dev, name, wd):
    """K9 above W256: its wide form on the encoded rays, within K9's
    bounds of the plain version."""
    cfg, model, _, _, pts, dp, L = _case(name, dev, cases=WIDE_CASES)
    fp = F.prepare_fused_params(model, cfg, weight_dtype=wd)
    x = r2l_embed(pts, L)
    before = (F.fused_r2l_apply.launches, F.fused_r2l_apply_wide.launches)
    got = F.fused_r2l_apply(fp, cfg, x)
    torch.cuda.synchronize()
    assert (F.fused_r2l_apply.launches,
            F.fused_r2l_apply_wide.launches) == (before[0], before[1] + 1)
    mx, _ = _deltas(got, F.fused_r2l_apply_ref(fp, cfg, x))
    assert mx < (TOL_F32 if wd == torch.float32 else TOL_BF16), mx


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
@pytest.mark.parametrize("fold_requant,nobf16_inner",
                         [(True, True), (True, False), (False, False)])
def test_wide_int8_forms_bit_for_bit(dev, name, fold_requant,
                                     nobf16_inner):
    """K2's wide form keeps every rounding of the plain version: its three
    forms equal it bit for bit, on 1,000 rays and on a ragged 129."""
    cfg, model, sampler, poses, pts, dp, L = _case(name, dev,
                                                   cases=WIDE_CASES)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev),
                                 fold_requant=fold_requant)
    assert fp.staged_for == "wide"
    kw = dict(fold_requant=fold_requant, nobf16_inner=nobf16_inner)
    before = (F.fused_r2l_apply_int8_pe.launches,
              F.fused_r2l_apply_int8_pe_wide.launches)
    for q in (pts, pts[:129].contiguous()):
        got = F.fused_r2l_apply_int8_pe(fp, cfg, q, dp, L, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, F.fused_r2l_apply_int8_pe_ref(
            fp, cfg, q, dp, L, **kw))
    assert (F.fused_r2l_apply_int8_pe.launches,
            F.fused_r2l_apply_int8_pe_wide.launches) == (before[0],
                                                         before[1] + 2)


def test_wide_form_raises_without_its_image(dev):
    """On the card, the wide form refuses a packing without its image."""
    cfg, model, sampler, poses, pts, dp, L = _case("w384_canonical", dev,
                                                   cases=WIDE_CASES)
    fp = F.prepare_fused_params_pe(model, cfg, dp, L, stage=False)
    with pytest.raises(ValueError, match="image of the wide form"):
        F.fused_r2l_apply_pe(fp, cfg, pts, dp, L)
    fp8 = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                  _calibration_points(sampler, poses, dev),
                                  stage=False)
    with pytest.raises(ValueError, match="image of the wide form"):
        F.fused_r2l_apply_int8_pe(fp8, cfg, pts, dp, L)


def test_int8_canary_on_card(dev):
    """The frozen canary: the kernel equals its plain version bit for bit
    and stays within one f32 ulp of [0.5, 1) of the JAX reference's output
    (the dequantize is one FMA on both sides; the card's sin/cos/exp differ
    from the CPU's by ulps)."""
    case = np.load(os.path.join(FIXTURES, "int8_epilogue_canary_case.npz"))
    want = np.load(os.path.join(FIXTURES, "int8_epilogue_canary.npz"))["rgb"]
    cfg = R2LConfig(input_dim=6 * 9, netdepth=8, netwidth=64)
    model = R2L(cfg, device=dev)
    model.load_state_dict(params_from_jax(
        {k: {"w": case[f"{k}_w"], "b": case[f"{k}_b"]}
         for k in ("head", "body", "tail")}, cfg))
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4,
                                 torch.from_numpy(case["calib"]).to(dev))
    pts = torch.from_numpy(case["pts"]).to(dev)
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, 6, 4)
    assert torch.equal(got, F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, 6, 4))
    assert float(np.abs(got.cpu().numpy() - want).max()) <= 6e-8


def test_givenrays_pe_frame_is_the_pose_frame_bit_for_bit(dev):
    """sample_test is frame_rays then sample_train's even depths, so K1 on
    a pose's own rays, given, renders that pose's frame bit for bit."""
    from r2l_tpu_torch.evaluate import (make_r2l_frame_fn,
                                        make_r2l_givenrays_frame_fn)
    cfg, model, sampler, poses, _, _, L = _case("w256_canonical", dev)
    pose_fn = make_r2l_frame_fn(model, cfg, sampler, embed_L=L)
    ray_fn = make_r2l_givenrays_frame_fn(model, cfg, sampler, sampler.H,
                                         sampler.W, embed_L=L)
    assert pose_fn.kind == ray_fn.kind == "pe"
    before = F.fused_r2l_apply_pe.launches
    for p in poses:
        ro, rd = sampler.frame_rays(torch.as_tensor(p, dtype=torch.float32,
                                                    device=dev))
        assert torch.equal(ray_fn(ro, rd), pose_fn(p))
    assert F.fused_r2l_apply_pe.launches - before == 2 * len(poses)


def test_metrics_on_card_match_the_cpu_and_the_fixture(dev):
    """SSIM and FLIP (and minmax FLIP) of tests/fixtures/metrics_golden.npz
    on the card, with the caller's cuDNN TF32 flag on (PyTorch's default),
    against the reference torch code's values at the fixture's tolerances
    (tests/test_lpips_flip.py), and against the CPU's at the port's bound
    against JAX (rtol 1e-5, atol 1e-6; measured 6e-8), which TF32
    convolutions would cross (FLIP moves by 1.95e-4, H100, 700 W); the flag
    comes back."""
    from r2l_tpu_torch.flip import flip
    from r2l_tpu_torch.lpips import minmax_rescale
    from r2l_tpu_torch.metrics import ssim
    d = np.load(os.path.join(FIXTURES, "metrics_golden.npz"))
    gts, imgs = torch.from_numpy(d["gts"]), torch.from_numpy(d["imgs"])
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for i in range(len(gts)):
            g, m = gts[i], imgs[i]
            for got, cpu, want, (rtol, atol) in (
                    (ssim(m.to(dev), g.to(dev)), ssim(m, g), d["ssim"][i],
                     (2e-4, 2e-5)),
                    (flip(g.to(dev), m.to(dev)), flip(g, m), d["flip"][i],
                     (2e-3, 2e-4))):
                np.testing.assert_allclose(float(got), float(cpu), 1e-5,
                                           1e-6)
                np.testing.assert_allclose(float(got), want, rtol, atol)
        g_mm = torch.clamp(minmax_rescale(gts.to(dev)), 0.0, 1.0)
        m_mm = torch.clamp(minmax_rescale(imgs.to(dev)), 0.0, 1.0)
        for i, want in enumerate(d["flip_minmax"]):
            np.testing.assert_allclose(float(flip(g_mm[i], m_mm[i])), want,
                                       2e-3, 2e-4)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_wrappers_raise_instead_of_falling_back(dev):
    """A CUDA tensor the kernel does not take raises; nothing runs the
    plain version in its place."""
    cfg, model, _, _, pts, dp, L = _case("w256_canonical", dev)
    fp = F.prepare_fused_params_pe(model, cfg, dp, L)
    with pytest.raises(TypeError):
        F.fused_r2l_apply_pe(fp, cfg, pts.double(), dp, L)
    with pytest.raises(ValueError):
        F.fused_r2l_apply_pe(fp._replace(head_b=fp.head_b.cpu()), cfg, pts,
                             dp, L)
    wide = dataclasses.replace(cfg, netwidth=96)
    with pytest.raises(ValueError):   # a packing of another width
        F.fused_r2l_apply_pe(fp, wide, pts, dp, L)
    wider = dataclasses.replace(cfg, netwidth=512)
    with pytest.raises(ValueError):   # K1's wide form, on a W256 packing
        F.fused_r2l_apply_pe(fp, wider, pts, dp, L)


# K1/K9 on the Hopper chain (csrc/r2l_hopper.cuh): 128-ray blocks in 2-block
# clusters (bf16), 64-ray blocks in 4-block clusters (f32). Row counts that
# leave the last block or cluster half-empty, and a 400x400 frame.
CHAIN_ROWS = {"n1": 1, "n129": 129, "n257": 257, "frame": 160_000}


def _chain_inputs(dev, kernel, wd, n):
    if n == 160_000:   # the canonical width on a 400x400 frame's rays
        cfg, model, _, poses, _, dp, L = _case("w256_canonical", dev)
        sampler = PointSampler(H=400, W=400, focal=555.5555, n_sample=16,
                               near=2.0, far=6.0)
        pts = sampler.sample_test(torch.as_tensor(poses[1], device=dev))
    else:
        cfg, model, _, _, pts, dp, L = _case("w256_canonical", dev,
                                             n_rays=n)
    if wd == torch.float32:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    assert pts.shape[0] == n
    if kernel == "K1":
        fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd)
        return (F.fused_r2l_apply_pe, F.fused_r2l_apply_pe_ref,
                (fp, cfg, pts, dp, L))
    fp = F.prepare_fused_params(model, cfg, weight_dtype=wd)
    return (F.fused_r2l_apply, F.fused_r2l_apply_ref,
            (fp, cfg, r2l_embed(pts, L)))


@pytest.mark.parametrize("rows", sorted(CHAIN_ROWS))
@pytest.mark.parametrize("kernel", ["K1", "K9"])
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_chain_kernels_on_ragged_clusters(dev, rows, kernel, wd):
    """K1 and K9 against their plain versions where the grid's last block
    or cluster holds few rays (or none), and on a whole frame."""
    kern, plain, args = _chain_inputs(dev, kernel, wd, CHAIN_ROWS[rows])
    before = kern.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    mx, _ = _deltas(got, plain(*args))
    assert mx < (TOL_F32 if wd == torch.float32 else TOL_BF16), mx


@pytest.mark.parametrize("name", ["r2l_pe_fused", "r2l_fused"])
def test_chain_kernels_run_on_wgmma(dev, name):
    """The SASS of K1 and K9 (bf16, and f32 as TF32) holds HGMMA, the
    tensor cores' warpgroup products (wgmma), and no mma.sync (HMMA)."""
    import subprocess
    from r2l_tpu_torch.kernels import _build
    _build.load(name)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._library_path(name))],
                          check=True, capture_output=True, text=True).stdout
    assert "HGMMA" in sass
    assert "HMMA" not in sass


@pytest.mark.parametrize("kernel", ["K1", "K9"])
def test_chain_kernels_refuse_an_unstaged_image(dev, kernel):
    """K1/K9 read their weights from the staged image only: without one (the
    training step's packing), or with a short one, they raise and launch
    nothing; nothing runs the plain version in their place."""
    cfg, model, _, _, pts, dp, L = _case("w256_canonical", dev, n_rays=257)
    if kernel == "K1":
        fp = F.prepare_fused_params_pe(model, cfg, dp, L)
        unstaged = F.prepare_fused_params_pe(model, cfg, dp, L, stage=False)
        kern, rest = F.fused_r2l_apply_pe, (cfg, pts, dp, L)
    else:
        fp = F.prepare_fused_params(model, cfg)
        unstaged = fp._replace(staged=None)
        kern, rest = F.fused_r2l_apply, (cfg, r2l_embed(pts, L))
    assert fp.staged is not None and unstaged.staged is None
    before = kern.launches
    for bad in (unstaged, fp._replace(staged=fp.staged[:-16])):
        with pytest.raises(ValueError):
            kern(bad, *rest)
    assert kern.launches == before


# Training kernels (two layers per block): (netwidth, n_sample, L, knobs).
TRAIN_CASES = {
    "w256_canonical": (256, 16, 10, {}),
    "w128_res_half": (128, 2, 10, {"res_scale": 0.5}),
    "w64_linear": (64, 16, 4, {"use_residual": False, "linear_tail": True}),
    "w128_L4": (128, 16, 4, {}),
}
# Gradients (tests/test_train_pallas.py:58, 88-92): f32 norm-relative; bf16
# norm-relative and the share of entries off by more than 5e-2 of the max.
TOL_GRAD_F32, TOL_GRAD_BF16, MAX_BAD_BF16 = 1e-5, 5e-2, 2e-3


def _train_case(name, dev, compute_dtype=torch.bfloat16, n_rays=1000,
                cases=TRAIN_CASES):
    W, n_sample, L, kw = cases[name]
    dp = 3 * n_sample
    cfg = R2LConfig(input_dim=dp * (2 * L + 1), netdepth=12, netwidth=W,
                    compute_dtype=compute_dtype, **kw)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    sampler = PointSampler(H=40, W=25, focal=30.0, n_sample=n_sample,
                           near=2.0, far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in (0.0, 120.0, 240.0)])
    pts = sampler.sample_test(torch.as_tensor(poses[1], device=dev))
    return cfg, model, sampler, poses, pts[:n_rays].contiguous(), dp, L


def _grad_close(got, want, f32):
    got, want = got.double(), want.double()
    rel = float((got - want).norm() / want.norm().clamp(min=1e-12))
    if f32:
        return rel < TOL_GRAD_F32, rel
    bad = float(((got - want).abs() / want.abs().max().clamp(min=1e-12)
                 > 5e-2).double().mean())
    return rel < TOL_GRAD_BF16 and bad < MAX_BAD_BF16, (rel, bad)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_train_fwd_kernel_matches_plain(dev, name, wd):
    cfg, model, _, _, pts, dp, L = _train_case(name, dev)
    fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd)
    before = T.train_fwd.launches
    rgb, stash = T.train_fwd(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert T.train_fwd.launches == before + 1
    rgb_p, stash_p = T.train_fwd_ref(fp, cfg, pts, dp, L)
    mx, _ = _deltas(rgb, rgb_p)
    d = (stash.float() - stash_p.float()).abs().max(dim=2).values.max(dim=1)
    if wd == torch.float32:
        assert mx < TOL_F32 and float(d.values.max()) < TOL_F32, (mx, d)
    else:
        assert mx < TOL_BF16, mx
        # a flipped bf16 rounding propagates through later rows: relative
        # to each row's largest activation
        scale = stash_p.float().abs().amax(dim=(1, 2)).clamp(min=1.0)
        assert float((d.values / scale).max()) < TOL_BF16, d


def _train_int8(cfg, model, sampler, poses, dp, L, dev, stash_q):
    """The int8 training kinds' calibration with K4's or K8's image."""
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev),
                                 fold_requant=False, stage=False)
    return F.stage_int8_train(fp, cfg, dp, L, stash_q)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_fwd_int8_kernel_matches_plain(dev, name):
    cfg, model, sampler, poses, pts, dp, L = _train_case(name, dev)
    fp = _train_int8(cfg, model, sampler, poses, dp, L, dev, True)
    before = T.train_fwd_int8.launches
    rgb, stash = T.train_fwd_int8(fp, cfg, pts, dp, L, stash_q=True)
    torch.cuda.synchronize()
    assert T.train_fwd_int8.launches == before + 1
    rgb_p, stash_p = T.train_fwd_int8_ref(fp, cfg, pts, dp, L, stash_q=True)
    mx, rms = _deltas(rgb, rgb_p)
    assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (mx, rms)
    dq = (stash.int() - stash_p.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).double().mean()) < 1e-3, (
        int(dq.max()), float((dq > 0).double().mean()))


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_fwd_int8_bf16_stash_kernel_matches_plain(dev, name):
    """K8: the int8 forward with train_fwd's rows stashed in bf16."""
    cfg, model, sampler, poses, pts, dp, L = _train_case(name, dev)
    fp = _train_int8(cfg, model, sampler, poses, dp, L, dev, False)
    before = T.train_fwd_int8.launches_bf16
    rgb, stash = T.train_fwd_int8(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert T.train_fwd_int8.launches_bf16 == before + 1
    rgb_p, stash_p = T.train_fwd_int8_ref(fp, cfg, pts, dp, L)
    mx, rms = _deltas(rgb, rgb_p)
    assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (mx, rms)
    assert stash.dtype == stash_p.dtype == torch.bfloat16
    d = (stash.float() - stash_p.float()).abs().amax(dim=(1, 2))
    scale = stash_p.float().abs().amax(dim=(1, 2)).clamp(min=1.0)
    assert float((d / scale).max()) < TOL_BF16, d


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
@pytest.mark.parametrize("stash_q", [True, False])
def test_train_fwd_int8_bit_for_bit(dev, name, stash_q):
    """K4 and K8 keep every rounding of their plain version: rgb and every
    stash value bit for bit (int32 sums are exact, and the card runs the
    same sinf/cosf on both sides), at W64, W128 and W256."""
    cfg, model, sampler, poses, pts, dp, L = _train_case(name, dev)
    fp = _train_int8(cfg, model, sampler, poses, dp, L, dev, stash_q)
    rgb, stash = T.train_fwd_int8(fp, cfg, pts, dp, L, stash_q=stash_q)
    rgb_p, stash_p = T.train_fwd_int8_ref(fp, cfg, pts, dp, L,
                                          stash_q=stash_q)
    assert torch.equal(rgb, rgb_p)
    assert torch.equal(stash.view(torch.uint8), stash_p.view(torch.uint8))


@pytest.mark.parametrize("kind", ["K3", "K4", "K8"])
def test_train_kernels_refuse_an_unstaged_image(dev, kind):
    """K3 reads K1's image and K4/K8 their own: without it, with a short
    one, or (K4/K8) with K2's or the other kind's, they raise and launch
    nothing; nothing runs the plain version in their place."""
    cfg, model, sampler, poses, pts, dp, L = _train_case("w256_canonical",
                                                        dev)
    if kind == "K3":
        fp = F.prepare_fused_params_pe(model, cfg, dp, L)
        bad = [F.prepare_fused_params_pe(model, cfg, dp, L, stage=False),
               fp._replace(staged=fp.staged[:-16])]
        run, counter = (lambda f: T.train_fwd(f, cfg, pts, dp, L),
                        lambda: T.train_fwd.launches)
    else:
        q = kind == "K4"
        fp = _train_int8(cfg, model, sampler, poses, dp, L, dev, q)
        other = _train_int8(cfg, model, sampler, poses, dp, L, dev, not q)
        k2 = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                     _calibration_points(sampler, poses, dev),
                                     fold_requant=False)
        bad = [fp._replace(staged=None), other, k2,
               fp._replace(staged=fp.staged[:-16],
                           staged_for=fp.staged_for)]
        run = (lambda f: T.train_fwd_int8(f, cfg, pts, dp, L, stash_q=q))
        counter = (lambda: T.train_fwd_int8.launches if q
                   else T.train_fwd_int8.launches_bf16)
    before = counter()
    for b in bad:
        with pytest.raises(ValueError):
            run(b)
    assert counter() == before


@pytest.mark.parametrize("name,op", [("r2l_train_fwd", "HGMMA"),
                                     ("r2l_train_fwd_int8", "IGMMA"),
                                     ("r2l_wide_bwd", "HGMMA"),
                                     ("r2l_wide_train", "HGMMA"),
                                     ("r2l_wide_train", "IGMMA")])
def test_train_kernels_run_on_wgmma(dev, name, op):
    """The SASS of K3 (bf16, and f32 as TF32), of K5's wide form (its dh
    walk on the pass skeleton, its dW pass) and of K3's wide form holds
    HGMMA, and K4/K8's (and their wide form's) IGMMA: wgmma, not
    mma.sync's HMMA/IMMA."""
    import subprocess
    from r2l_tpu_torch.kernels import _build
    _build.load(name)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._library_path(name))],
                          check=True, capture_output=True, text=True).stdout
    assert op in sass
    assert "HMMA" not in sass and "IMMA" not in sass


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "f32_bf16stash"])
def test_bwd_group_kernel_matches_plain(dev, name, kind):
    """K5 per stash: in the weights' dtype (f32, bf16), K4's int8 one, and
    K8's bf16 one under f32 weights."""
    cd = torch.float32 if kind.startswith("f32") else torch.bfloat16
    cfg, model, sampler, poses, pts, dp, L = _train_case(name, dev, cd)
    nb, W = cfg.num_blocks, cfg.netwidth
    scale = None
    if kind == "f32_bf16stash":
        fp = F.calibrate_r2l_int8_pe(
            model, cfg, dp, L, _calibration_points(sampler, poses, dev),
            fold_requant=False)
        _, stash = T.train_fwd_int8_ref(fp, cfg, pts, dp, L)
        body_w = F.prepare_fused_params_pe(model, cfg, dp, L,
                                           weight_dtype=cd).body_w
    elif kind == "int8":
        fp = F.calibrate_r2l_int8_pe(
            model, cfg, dp, L, _calibration_points(sampler, poses, dev),
            fold_requant=False)
        _, stash = T.train_fwd_int8_ref(fp, cfg, pts, dp, L, stash_q=True)
        scale = 1.0 / fp.body_inv
        body_w = F.prepare_fused_params_pe(model, cfg, dp, L).body_w
    else:
        fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=cd)
        _, stash = T.train_fwd_ref(fp, cfg, pts, dp, L)
        body_w = fp.body_w
    dh = torch.randn((pts.shape[0], W), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    img = T.stage_bwd_weights(body_w)
    for b0, cnt in ((1, 3), (0, nb)):
        before = T.bwd_group.launches
        got = T.bwd_group(body_w, stash, dh, cfg, b0, cnt, body_scale=scale,
                          staged=img)
        again = T.bwd_group(body_w, stash, dh, cfg, b0, cnt, body_scale=scale,
                            staged=img)
        torch.cuda.synchronize()
        assert T.bwd_group.launches == before + 2
        want = T.bwd_group_ref(body_w, stash, dh, cfg, b0, cnt,
                               body_scale=scale)
        for g, a, w, what in zip(got, again, want, ("dh", "dW", "db")):
            assert torch.equal(g, a), f"{what} differs between two runs"
            ok, err = _grad_close(g, w, kind.startswith("f32"))
            assert ok, (what, b0, cnt, err)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "f32_bf16stash"])
def test_bwd_group_needs_the_steps_image(dev, kind):
    """K5 reads its weights from the step's image only (``stage_bwd_weights``
    of every body layer, as ``_bwd_core`` makes it): without one, or with
    one of another size, it raises and launches nothing; with it, a group
    and the whole body each run twice to the same bits."""
    cd = torch.float32 if kind.startswith("f32") else torch.bfloat16
    name = sorted(TRAIN_CASES)[0]
    cfg, model, sampler, poses, pts, dp, L = _train_case(name, dev, cd)
    nb, W = cfg.num_blocks, cfg.netwidth
    scale = None
    if kind in ("int8", "f32_bf16stash"):
        fp = F.calibrate_r2l_int8_pe(
            model, cfg, dp, L, _calibration_points(sampler, poses, dev),
            fold_requant=False, stage=False)
        _, stash = T.train_fwd_int8_ref(fp, cfg, pts, dp, L,
                                        stash_q=kind == "int8")
        scale = 1.0 / fp.body_inv if kind == "int8" else None
    else:
        fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=cd,
                                       stage=False)
        _, stash = T.train_fwd_ref(fp, cfg, pts, dp, L)
    body_w = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=cd,
                                       stage=False).body_w
    img = T.stage_bwd_weights(body_w)
    dh = torch.randn((pts.shape[0], W), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    before = T.bwd_group.launches
    for bad in (None, img[:-1]):
        with pytest.raises(ValueError, match="staged"):
            T.bwd_group(body_w, stash, dh, cfg, nb - 1, 1, body_scale=scale,
                        staged=bad)
    assert T.bwd_group.launches == before
    for b0, cnt in ((nb - 1, 1), (0, nb)):
        a = T.bwd_group(body_w, stash, dh, cfg, b0, cnt, body_scale=scale,
                        staged=img)
        b = T.bwd_group(body_w, stash, dh, cfg, b0, cnt, body_scale=scale,
                        staged=img)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int8_bf16stash",
                                  "int8_bf16stash_f32"])
def test_fused_apply_grads_match_plain(dev, kind):
    """The autograd Function on the card (K3/K4 + K5) against the same
    Function on the CPU (the plain versions), same weights and points. At
    L=4: the card's and the CPU's sin/cos differ by ulps, which the
    doubling ladder grows by 2^(L-1) in the head's gradient (at L=10 that
    alone is 1.2e-4 norm-relative in f32)."""
    cd = torch.float32 if kind.endswith("f32") else torch.bfloat16
    cfg, model, sampler, poses, pts, dp, L = _train_case("w128_L4", dev, cd,
                                                         700)
    kw = {}
    if kind.startswith("int8"):
        kw = dict(quantize="int8", stash_q=kind == "int8",
                  calib_pts=_calibration_points(sampler, poses, dev))
    tgt = torch.rand((pts.shape[0], 3), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    grads = {}
    for where in ("cuda", "cpu"):
        m = model if where == "cuda" else R2L(cfg, device="cpu")
        if where == "cpu":
            m.load_state_dict(model.state_dict())
        kw_w = {k: (v.to(where) if torch.is_tensor(v) else v)
                for k, v in kw.items()}
        apply = T.make_fused_train_apply(cfg, dp, L, group_blocks=2,
                                         compute_dtype=cd, **kw_w)
        loss = torch.mean((apply(m, pts.to(where)) - tgt.to(where)) ** 2)
        loss.backward()
        grads[where] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    for k, g in grads["cuda"].items():
        ok, err = _grad_close(g, grads["cpu"][k], kind == "f32")
        assert ok, (k, err)


# The training kernels' wide form (csrc/r2l_wide_train.cu, r2l_wide_bwd.cu):
# every width the chain kernels do not take, at the training kernels'
# tolerances above; a W128 int8 step whose 2L+1 overflows K4's head slice.
WIDE_TRAIN_CASES = {
    "w384": (384, 16, 10, {}),
    "w512_res_half": (512, 2, 10, {"res_scale": 0.5}),
    "w640_linear": (640, 16, 4, {"use_residual": False,
                                 "linear_tail": True}),
}


def _wide_train_case(name, dev, compute_dtype=torch.bfloat16):
    return _train_case(name, dev, compute_dtype, cases=WIDE_TRAIN_CASES)


@pytest.mark.parametrize("name", sorted(WIDE_TRAIN_CASES))
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_wide_train_fwd_kernel_matches_plain(dev, name, wd):
    cfg, model, _, _, pts, dp, L = _wide_train_case(name, dev)
    fp = T.prepare_train_params(model, cfg, dp, L, wd)
    assert fp.staged_for == "wide"
    before = (T.train_fwd.launches, T.train_fwd_wide.launches)
    rgb, stash = T.train_fwd(fp, cfg, pts, dp, L)
    torch.cuda.synchronize()
    assert (T.train_fwd.launches, T.train_fwd_wide.launches) == (
        before[0], before[1] + 1)
    rgb_p, stash_p = T.train_fwd_ref(fp, cfg, pts, dp, L)
    mx, _ = _deltas(rgb, rgb_p)
    d = (stash.float() - stash_p.float()).abs().amax(dim=(1, 2))
    if wd == torch.float32:
        assert mx < TOL_F32 and float(d.max()) < TOL_F32, (mx, d)
    else:
        assert mx < TOL_BF16, mx
        scale = stash_p.float().abs().amax(dim=(1, 2)).clamp(min=1.0)
        assert float((d / scale).max()) < TOL_BF16, d


@pytest.mark.parametrize("name", sorted(WIDE_TRAIN_CASES) + ["w128_L128"])
@pytest.mark.parametrize("stash_q", [True, False])
def test_wide_train_fwd_int8_bit_for_bit(dev, name, stash_q):
    """K4's and K8's wide form keep every rounding of their plain version:
    rgb and every stash value bit for bit; at W128 with 2L+1 = 257 (over
    K4's head slice) the wrappers take the wide form too."""
    if name == "w128_L128":
        cfg, model, sampler, poses, pts, dp, _ = _train_case("w128_L4", dev)
        # points within +-1.5: the calibration's sin(p * 2^127) stays
        # finite in f32
        L, pts = 128, (pts * (1.5 / pts.abs().max())).contiguous()
        cfg = dataclasses.replace(cfg, input_dim=dp * (2 * L + 1))
        model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
        assert T.wide_train_form(128, True, L)
    else:
        cfg, model, sampler, poses, pts, dp, L = _wide_train_case(name, dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L, pts[:500],
                                 fold_requant=False, stage=False, pad=False)
    fp = F.stage_int8_train(fp, cfg, dp, L, stash_q)
    assert fp.staged_for == "wide"
    before = (T.train_fwd_int8_wide.launches,
              T.train_fwd_int8_wide.launches_bf16)
    rgb, stash = T.train_fwd_int8(fp, cfg, pts, dp, L, stash_q=stash_q)
    torch.cuda.synchronize()
    after = (T.train_fwd_int8_wide.launches,
             T.train_fwd_int8_wide.launches_bf16)
    assert after == (before[0] + stash_q, before[1] + (not stash_q))
    rgb_p, stash_p = T.train_fwd_int8_ref(fp, cfg, pts, dp, L,
                                          stash_q=stash_q)
    assert torch.equal(rgb, rgb_p)
    assert torch.equal(stash.view(torch.uint8), stash_p.view(torch.uint8))


@pytest.mark.parametrize("name", sorted(WIDE_TRAIN_CASES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "f32_bf16stash"])
def test_wide_bwd_group_kernel_matches_plain(dev, name, kind):
    """K5's wide form per stash kind: a group and the whole body, each run
    twice to the same bits and against the plain version."""
    cd = torch.float32 if kind.startswith("f32") else torch.bfloat16
    cfg, model, sampler, poses, pts, dp, L = _wide_train_case(name, dev, cd)
    nb, W = cfg.num_blocks, cfg.netwidth
    scale = None
    if kind in ("int8", "f32_bf16stash"):
        fp = F.calibrate_r2l_int8_pe(
            model, cfg, dp, L, _calibration_points(sampler, poses, dev),
            fold_requant=False, stage=False, pad=False)
        _, stash = T.train_fwd_int8_ref(fp, cfg, pts, dp, L,
                                        stash_q=kind == "int8")
        scale = 1.0 / fp.body_inv if kind == "int8" else None
    else:
        fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=cd,
                                       stage=False, pad=False)
        _, stash = T.train_fwd_ref(fp, cfg, pts, dp, L)
    body_w = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=cd,
                                       stage=False, pad=False).body_w
    dh = torch.randn((pts.shape[0], W), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    img = T.stage_bwd_weights(body_w)
    before = T.bwd_group.launches
    with pytest.raises(ValueError, match="staged"):
        T.bwd_group(body_w, stash, dh, cfg, 0, 1, body_scale=scale)
    for b0, cnt in ((1, 3), (0, nb)):
        w0 = T.bwd_group_wide.launches
        got = T.bwd_group(body_w, stash, dh, cfg, b0, cnt, body_scale=scale,
                          staged=img)
        again = T.bwd_group(body_w, stash, dh, cfg, b0, cnt, body_scale=scale,
                            staged=img)
        torch.cuda.synchronize()
        assert T.bwd_group_wide.launches == w0 + 2
        want = T.bwd_group_ref(body_w, stash, dh, cfg, b0, cnt,
                               body_scale=scale)
        for g, a, w, what in zip(got, again, want, ("dh", "dW", "db")):
            assert torch.equal(g, a), f"{what} differs between two runs"
            ok, err = _grad_close(g, w, kind.startswith("f32"))
            assert ok, (what, b0, cnt, err)
    assert T.bwd_group.launches == before


def test_wide_bwd_group_repeats_over_ray_ranges(dev):
    """At 25,000 rays K5's wide dW pass sums two ray ranges and adds them in
    order: a whole walk run twice gives the same bits, within the f32
    limit of the plain version."""
    cfg, model, _, _, _, dp, L = _wide_train_case("w384", dev,
                                                  torch.float32)
    assert T.dw_splits(25_000) == 2
    g = torch.Generator(device=dev).manual_seed(3)
    stash = torch.relu(torch.randn((2 * cfg.num_blocks + 1, 25_000, 384),
                                   generator=g, device=dev))
    dh = torch.randn((25_000, 384), generator=g, device=dev)
    body_w = F.prepare_fused_params_pe(model, cfg, dp, L,
                                       weight_dtype=torch.float32,
                                       stage=False, pad=False).body_w
    img = T.stage_bwd_weights(body_w)
    nb = cfg.num_blocks
    runs = [T.bwd_group(body_w, stash, dh, cfg, 0, nb, staged=img)
            for _ in range(2)]
    want = T.bwd_group_ref(body_w, stash, dh, cfg, 0, nb)
    for a, b, w in zip(*runs, want):
        assert torch.equal(a, b)
        ok, err = _grad_close(a, w, True)
        assert ok, err


# Teacher kernels (K6 f32/bf16, K7 int8): (D, W, skips, L_pts, L_views,
# viewdirs). A block holds 16 rays (bf16, int8) or 8 (f32), two blocks a
# cluster: 1003 rays fill no block, 48 leave the last bf16/int8 cluster half
# empty (an odd number of blocks), 24 the last f32 one, 1 ray the only one;
# S = 13 is not a multiple of the 8-sample group, 192 is the fine pass's.
NERF_CASES = {
    "canonical": (8, 256, (4,), 10, 4, True),
    "w128_noview": (4, 128, (1,), 6, 3, False),
    "w128_skip0": (3, 128, (0,), 6, 3, True),
    "w64_padded": (4, 64, (2,), 6, 3, True),   # packed at 128
    "d40": (40, 256, (4, 24), 10, 4, True),    # any depth: a flag a layer
}
# K6 f32: the same f32 chain, sums in another order (depth sums w*z over
# up to 6). K6 bf16: a flipped bf16 rounding propagates, as K1 bf16. K7: as
# K2.
TOL_NERF = {"f32": (1e-4, 1e-3), "bf16": (3e-2, 3e-2)}


def _nerf_case(name, dev, kind, n=1003, S=64):
    D, W, skips, Lp, Lv, vd = {**NERF_CASES, **WIDE_NERF_CASES}[name]
    cd = torch.bfloat16 if kind == "bf16" else torch.float32
    cfg = NeRFConfig(D=D, W=W, skips=skips, input_ch=3 + 6 * Lp,
                     input_ch_views=3 + 6 * Lv if vd else 0,
                     use_viewdirs=vd, compute_dtype=cd)
    model = init_nerf(cfg, torch.Generator().manual_seed(0), dev)
    if vd and name in WIDE_NERF_CASES:   # chip_smoke.py's density floor
        with torch.no_grad():
            model.alpha_linear.bias += 1.0
    g = torch.Generator(device=dev).manual_seed(1)
    o = torch.randn((n, 3), generator=g, device=dev)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.2 * torch.randn((n, 3), generator=g, device=dev)
    z = torch.sort(2.0 + 4.0 * torch.rand((n, S), generator=g, device=dev),
                   -1).values.contiguous()
    calib = None
    if kind == "int8":
        pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)[::7]
        vds = (d / d.norm(dim=-1, keepdim=True))[:, None].expand(
            n, S, 3).reshape(-1, 3)[::7]
        calib = (pts, vds if vd else None)
    return cfg, model, o, d, z, Lp, Lv, calib


@pytest.mark.parametrize("name", sorted(NERF_CASES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S,n", [(13, 1003), (64, 1003), (192, 1003),
                                 (13, 48), (64, 24), (24, 1)])
def test_nerf_render_kernel_matches_plain(dev, name, kind, S, n):
    cfg, model, o, d, z, Lp, Lv, calib = _nerf_case(name, dev, kind, n=n,
                                                     S=S)
    int8 = kind == "int8"
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv, calib=calib,
                               weight_dtype=cfg.compute_dtype,
                               fold_requant=int8)
    kw = dict(L_pts=Lp, L_views=Lv, white_bkgd=True)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(NR.fused_nerf_render, counter)
    got = NR.fused_nerf_render(fp, cfg, o, d, z, **kw)
    torch.cuda.synchronize()
    assert getattr(NR.fused_nerf_render, counter) == before + 1
    want = NR.fused_nerf_render_ref(fp, cfg, o, d, z, **kw)
    for what, g_, w_ in zip(("rgb", "acc", "depth", "weights"), got, want):
        mx, rms = _deltas(g_, w_)
        if int8:
            assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (what, mx, rms)
        else:
            tol, tol_depth = TOL_NERF[kind]
            assert mx < (tol_depth if what == "depth" else tol), (what, mx)


@pytest.mark.parametrize("fold", [False, True])
def test_nerf_render_int8_fold_and_unfolded_agree(dev, fold):
    """K7 with and without the folded requantize, each against its plain
    version (the JAX package found the two bit-identical on its TPU)."""
    cfg, model, o, d, z, Lp, Lv, calib = _nerf_case("canonical", dev, "int8",
                                                     n=517, S=24)
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv, calib=calib,
                               fold_requant=fold)
    assert fp.fold_requant == fold
    kw = dict(L_pts=Lp, L_views=Lv, white_bkgd=False)
    got = NR.fused_nerf_render(fp, cfg, o, d, z, **kw)
    want = NR.fused_nerf_render_ref(fp, cfg, o, d, z, **kw)
    for g_, w_ in zip(got, want):
        mx, rms = _deltas(g_, w_)
        assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (mx, rms)


@pytest.mark.parametrize("name,op", [("nerf_render", "HGMMA"),
                                     ("nerf_render_int8", "IGMMA")])
def test_nerf_kernels_run_on_wgmma(dev, name, op):
    """The SASS of K6 (bf16, and f32 as TF32) holds HGMMA and K7's IGMMA:
    the tensor cores' warpgroup products (wgmma), not mma.sync's HMMA/IMMA."""
    import subprocess
    from r2l_tpu_torch.kernels import _build
    _build.load(name)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._library_path(name))],
                          check=True, capture_output=True, text=True).stdout
    assert op in sass
    assert "HMMA" not in sass and "IMMA" not in sass


def test_nerf_render_raises_instead_of_falling_back(dev):
    cfg, model, o, d, z, Lp, Lv, _ = _nerf_case("w128_noview", dev, "f32")
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv,
                               weight_dtype=torch.float32)
    kw = dict(L_pts=Lp, L_views=Lv)
    with pytest.raises(TypeError):
        NR.fused_nerf_render(fp._replace(pts_w=fp.pts_w.half()), cfg, o, d,
                             z, **kw)
    with pytest.raises(ValueError):
        NR.fused_nerf_render(fp._replace(pts_b=fp.pts_b.cpu()), cfg, o, d,
                             z, **kw)
    last = dataclasses.replace(cfg, skips=(cfg.D - 1,))
    with pytest.raises(NotImplementedError):   # a skip no model builds
        NR.fused_nerf_render(fp, last, o, d, z, **kw)
    with pytest.raises(ValueError):   # W512 (the wide form), packed at 128
        NR.fused_nerf_render(fp, dataclasses.replace(cfg, W=512), o, d, z,
                             **kw)
    with pytest.raises(ValueError):   # no staged image, or a stale one
        NR.fused_nerf_render(fp._replace(staged=None), cfg, o, d, z, **kw)
    with pytest.raises(ValueError):
        NR.fused_nerf_render(fp._replace(staged=fp.staged[:-16]), cfg, o,
                             d, z, **kw)


# The teacher kernels' wide form (csrc/nerf_wide.cu): teachers wider than
# 256, at the next multiple of 128 (W300 at 384; the W384 view layer's 192
# outputs at 256). (D, W, skips, L_pts, L_views, viewdirs).
WIDE_NERF_CASES = {
    "w384": (4, 384, (2,), 10, 4, True),
    "w384_noview": (4, 384, (1,), 6, 3, False),
    "w300": (3, 300, (0,), 6, 3, True),
    "w512": (8, 512, (4,), 10, 4, True),
}
# chip_smoke.py's TOL_TEACHER: K6 f32 (3xTF32), bf16, K7 (the same exact
# sums and roundings as the plain version); ((max, RMS), depth's).
TOL_WIDE_NERF = {"f32": ((1e-5, 1e-6), (1e-4, 1e-5)),
                 "bf16": ((1e-4, 1e-5), (6e-4, 6e-5)),
                 "int8": ((5e-7, 5e-8), (3e-6, 3e-7))}


def _wide_nerf_counts():
    f = NR.fused_nerf_render
    return (f.launches, f.launches_int8, f.launches_wide,
            f.launches_wide_int8)


@pytest.mark.parametrize("name", sorted(WIDE_NERF_CASES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S,n", [(13, 1003), (192, 517), (24, 1)])
def test_wide_nerf_render_matches_plain(dev, name, kind, S, n):
    """One launch of the wide form (none of K6/K7), every output within
    K6/K7's limits of the plain version on the same packing."""
    cfg, model, o, d, z, Lp, Lv, calib = _nerf_case(name, dev, kind, n=n,
                                                     S=S)
    int8 = kind == "int8"
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv, calib=calib,
                               weight_dtype=cfg.compute_dtype,
                               fold_requant=int8)
    assert NR.teacher_wide_form(cfg.W) and fp.pts_b.shape[1] % 128 == 0
    kw = dict(L_pts=Lp, L_views=Lv, white_bkgd=True)
    before = _wide_nerf_counts()
    got = NR.fused_nerf_render(fp, cfg, o, d, z, **kw)
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(before, _wide_nerf_counts())]
    assert moved == ([0, 0, 0, 1] if int8 else [0, 0, 1, 0])
    want = NR.fused_nerf_render_ref(fp, cfg, o, d, z, **kw)
    (tol, tol_rms), (tol_d, tol_d_rms) = TOL_WIDE_NERF[kind]
    for what, g_, w_ in zip(("rgb", "acc", "depth", "weights"), got, want):
        mx, rms = _deltas(g_, w_)
        lim = (tol_d, tol_d_rms) if what == "depth" else (tol, tol_rms)
        assert mx <= lim[0] and rms <= lim[1], (what, mx, rms)


@pytest.mark.parametrize("fold", [False, True])
def test_wide_nerf_render_int8_fold_and_unfolded(dev, fold):
    """The wide form with and without the folded requantize, each within
    K7's limits of its plain version."""
    cfg, model, o, d, z, Lp, Lv, calib = _nerf_case("w384", dev, "int8",
                                                     n=517, S=24)
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv, calib=calib,
                               fold_requant=fold)
    assert fp.fold_requant == fold
    kw = dict(L_pts=Lp, L_views=Lv, white_bkgd=False)
    got = NR.fused_nerf_render(fp, cfg, o, d, z, **kw)
    want = NR.fused_nerf_render_ref(fp, cfg, o, d, z, **kw)
    (tol, tol_rms), (tol_d, tol_d_rms) = TOL_WIDE_NERF["int8"]
    for what, g_, w_ in zip(("rgb", "acc", "depth", "weights"), got, want):
        mx, rms = _deltas(g_, w_)
        lim = (tol_d, tol_d_rms) if what == "depth" else (tol, tol_rms)
        assert mx <= lim[0] and rms <= lim[1], (what, mx, rms)


def test_wide_nerf_library_is_built_from_csrc(dev):
    """The wide form is built from csrc/nerf_wide.cu into the build
    directory at its first use, and its SASS holds wgmma's tensor-core
    products for bf16 and TF32 (HGMMA) and for int8 (IGMMA), and no
    mma.sync product (HMMA, IMMA)."""
    import subprocess
    from r2l_tpu_torch.kernels import _build
    _build.load("nerf_wide")
    lib = _build._library_path("nerf_wide")
    assert lib.is_file() and lib.parent == _build.BUILD_DIR
    cmd = _build._compile_cmd("nerf_wide", lib)
    assert cmd[-1] == str(_build.CSRC / "nerf_wide.cu")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    assert "HGMMA" in sass and "IGMMA" in sass
    assert "HMMA" not in sass and "IMMA" not in sass


def test_wide_teacher_entry_points_run_on_the_wide_form(dev, tmp_path):
    """A W384 teacher: the frame function renders it on the wide form
    (kind 'fused', one launch a pass) within PSNR 100 dB of the plain f32
    frame, and int8 datagen (``quantize='int8'``) writes its pose through
    the int8 wide form, no launch of K6/K7."""
    from r2l_tpu_torch import datagen
    from r2l_tpu_torch.render import VolRenderConfig
    cfg = NeRFConfig(D=4, W=384, skips=(2,))
    mc, mf = (init_nerf(cfg, torch.Generator().manual_seed(s), dev)
              for s in (0, 1))
    with torch.no_grad():
        for m in (mc, mf):
            m.alpha_linear.bias += 1.0
    vcfg = VolRenderConfig(n_coarse=16, n_fine=16, white_bkgd=True)
    sampler = PointSampler(H=40, W=25, focal=30.0, n_sample=16, near=2.0,
                           far=6.0)
    pose = pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    fn = TE.make_nerf_frame_fn(mc, mf, cfg, vcfg, sampler, use_pallas=True,
                               device=dev)
    plain = TE.make_nerf_frame_fn(mc, mf, cfg, vcfg, sampler, device=dev)
    assert fn.kind == "fused"
    before = _wide_nerf_counts()
    got = fn(pose)
    torch.cuda.synchronize()
    chunks = -(-40 * 25 // vcfg.ray_chunk)
    moved = [b - a for a, b in zip(before, _wide_nerf_counts())]
    assert moved == [0, 0, 2 * chunks, 0]
    want = plain(pose)
    assert got.shape == want.shape and torch.isfinite(got).all()
    mse = float((got.double() - want.double()).pow(2).mean())
    assert mse == 0 or -10.0 * np.log10(mse) >= 100.0, mse
    gcfg = datagen.DataGenConfig(n_pose=1, H=8, W=8, focal=10.0,
                                 save_every=1, quantize="int8")
    before = _wide_nerf_counts()
    n_rays = datagen.generate_pseudo_data(mc, mf, cfg, vcfg, gcfg,
                                          str(tmp_path), device=dev)
    moved = [b - a for a, b in zip(before, _wide_nerf_counts())]
    assert n_rays == 64 and moved[:3] == [0, 0, 0] and moved[3] > 0
    recs = np.load(tmp_path / "pseudo_000000.npy")
    assert recs.shape == (64, 9) and np.isfinite(recs).all()


# The exp/ probe kernels (r2l_tpu_torch/exp): chain modes, bigN, the int8
# chain and the shape probe. 1000 rays or rows: not a multiple of a tile.
# bf16 chains: a flipped bf16 rounding propagates (K1 bf16's bound). The int8
# chain and the int8 shapes: exact int32 dots and the plain version's
# roundings, so bit for bit. bf16 shapes, relative to the largest output:
# free, f32 sums of the same exact products in another order; chained, a
# flipped bf16 rounding propagates as in the chains (first run: 3.4e-3 at 8
# layers).
TOL_PROBE_SHAPES_BF16, TOL_PROBE_SHAPES_BF16_RMS = 1e-5, 2e-6
# The bf16 ResMLP control at 4 blocks: RMS relative to the largest plain
# output. chip_smoke's input read 7.3e-5 on the card (H100, 700 W); a plain
# version that skips the bf16 rounding of each block's t reads 8.2e-4 on
# this test's input and 6.2e-4 on chip_smoke's (CPU), so the max-abs bound
# alone (7e-3 there) would not catch it.
TOL_PROBE_BF16_RMS = 2.5e-4


def _probe_x(dev, n=1000, seed=3):
    return torch.randn((n, 256), generator=torch.Generator().manual_seed(
        seed)).to(dev)


@pytest.mark.parametrize("mode", ["full", "lean", "none"])
def test_probe_chain_matches_plain_and_dual_equals_single(dev, mode):
    from r2l_tpu_torch.exp import probe_mxu as PM
    x = _probe_x(dev)
    w, b = PM.mk_weights(torch.Generator().manual_seed(4), 8, device=dev)
    before = PM.chain.launches
    got = PM.chain(x, w, b, mode)
    dual = PM.chain(x, w, b, mode, dual=True)
    torch.cuda.synchronize()
    assert PM.chain.launches == before + 2
    assert torch.equal(got, dual)
    mx, _ = _deltas(got, PM.chain_ref(x, w, b, mode))
    assert mx < TOL_BF16, mx


def test_probe_bign_matches_plain(dev):
    """bigN on its image staged once (and staged per call: the same bits);
    another weights' image raises before the launch."""
    from r2l_tpu_torch.exp import probe_mxu as PM
    x = _probe_x(dev)
    w1, w2 = PM.variant_weights("bigN", torch.Generator().manual_seed(5),
                                dev, n_layers=8)
    img = PM.stage_bign(w1, w2)
    before = PM.bign.launches
    got = PM.bign(x, w1, w2, staged=img)
    torch.cuda.synchronize()
    assert PM.bign.launches == before + 1
    mx, _ = _deltas(got, PM.bign_ref(x, w1, w2))
    assert mx < TOL_BF16, mx
    assert torch.equal(PM.bign(x, w1, w2), got)
    with pytest.raises(ValueError):
        PM.bign(x, w1, w2, staged=PM.stage_bign(w1, w2.clone()))
    assert PM.bign.launches == before + 2


@pytest.mark.parametrize("n_layers", [4, 8])
def test_probe_int8_chain_equals_plain(dev, n_layers):
    """The int8 chain on its image staged once, bit for bit; another
    weights' image raises before the launch."""
    from r2l_tpu_torch.exp import probe_mxu as PM
    x = _probe_x(dev)
    wq, s = PM.variant_weights("int8_static",
                               torch.Generator().manual_seed(6), dev,
                               n_layers=n_layers)
    img = PM.stage_int8_chain(wq, s)
    before = PM.int8_chain.launches
    got = PM.int8_chain(x, wq, s, staged=img)
    torch.cuda.synchronize()
    assert PM.int8_chain.launches == before + 1
    assert torch.equal(got, PM.int8_chain_ref(x, wq, s))
    assert float(got.abs().sum()) > 0
    with pytest.raises(ValueError):
        PM.int8_chain(x, wq, s, staged=PM.stage_int8_chain(wq.clone(), s))
    assert PM.int8_chain.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("K,N,chained", [(256, 256, False),
                                         (512, 256, False),
                                         (256, 512, False),
                                         (1024, 256, False),
                                         (256, 256, True), (512, 512, True)])
def test_probe_shapes_matches_plain(dev, dtype, K, N, chained):
    from r2l_tpu_torch.exp import probe_shapes as PS
    x, w = PS.shape_inputs(1000, K, N, dtype, torch.Generator().manual_seed(
        7), n_tiles=1, n_layers=8, device=dev)
    before = PS.unchained.launches
    got = PS.unchained(x, w, chained)
    torch.cuda.synchronize()
    assert PS.unchained.launches == before + 1
    want = PS.unchained_ref(x, w, chained)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        mx, _ = _deltas(got, want)
        tol = TOL_BF16 if chained else TOL_PROBE_SHAPES_BF16
        assert mx <= tol * float(want.abs().max()), mx


@pytest.mark.parametrize("k", [16, 32])
def test_one_mma_truncates_its_f32_sum(dev, k):
    """One mma.sync m16n8k16 (and two in turn) does not round its f32 sum to
    nearest: where it differs from the round-to-nearest of the exact sum
    (33% / 50% of rows, H100), it mostly has the smaller magnitude (96% /
    91%; an IEEE sum in any order lands on either side about equally, as
    the plain version on the CPU does): the products are aligned to the
    largest and truncated. This is why the chained bf16 shapes differ from
    every IEEE-ordered plain version in more rows than those differ among
    themselves (ROADMAP C). The result stays within k ulps of the largest
    product of the exact sum (7.25 / 9.89 measured; a kernel that returned
    zeros would read about 2^23), and the
    instrument equals the plain version at the probe's first bf16 shape
    within the free shapes' limits, so the reading is of a kernel that
    computes the function."""
    from r2l_tpu_torch.exp import probe_shapes as PS
    before = PS.mma_sync_sum.launches
    r = PS.mma_rounding(k, device=dev)
    assert PS.mma_sync_sum.launches == before + 1
    assert r["engine"] == "mma.sync"
    assert r["differ_share"] > 0.1, r
    assert r["smaller_magnitude_share"] > 0.8, r
    assert r["max_err_in_top_ulp"] <= k, r
    # the instrument computes the function: the probe's first shape in bf16
    # (one tile of rows) against the plain version, as the shape kernel
    M, K, N = PS.SHAPES[0]
    x, w = PS.shape_inputs(M, K, N, torch.bfloat16,
                           torch.Generator().manual_seed(7), n_tiles=1,
                           device=dev)
    want = PS.unchained_ref(x, w)
    mx, rms = _deltas(PS.mma_sync_sum(x, w), want)
    top = float(want.abs().max())
    assert mx <= TOL_PROBE_SHAPES_BF16 * top, mx
    assert rms <= TOL_PROBE_SHAPES_BF16_RMS * top, rms


@pytest.mark.parametrize("k", [16, 32])
def test_one_wgmma_truncates_its_f32_sum_as_mma_sync(dev, k):
    """One wgmma m64n128k16 (and two in turn), read through the redesigned
    shape kernel, rounds its f32 sum as one mma.sync does: not to nearest,
    the products aligned to the largest and truncated, in the same rows by
    the same amounts (H100: 33% / 50% of rows differ from the
    round-to-nearest of the exact sum, 96% / 91% of those toward zero;
    ROADMAP C)."""
    from r2l_tpu_torch.exp import probe_shapes as PS
    before = PS.unchained.launches
    r = PS.mma_rounding(k, device=dev, engine="wgmma")
    assert PS.unchained.launches == before + 1
    assert r["differ_share"] > 0.1, r
    assert r["smaller_magnitude_share"] > 0.8, r
    assert r == {**PS.mma_rounding(k, device=dev), "engine": "wgmma"}


def test_probe_shapes_runs_on_wgmma(dev):
    """The shape kernel's SASS holds HGMMA and IGMMA (wgmma bf16 and s8)
    and no mma.sync (HMMA, IMMA); the mma.sync instrument holds HMMA."""
    import subprocess
    from r2l_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = {}
    for name in ("probe_shapes", "probe_mma_sync"):
        _build.load(name)
        sass[name] = subprocess.run(
            [tool, "-sass", str(_build._library_path(name))], check=True,
            capture_output=True, text=True).stdout
    assert "HGMMA" in sass["probe_shapes"] and "IGMMA" in sass["probe_shapes"]
    assert "HMMA" not in sass["probe_shapes"]
    assert "IMMA" not in sass["probe_shapes"]
    assert "HMMA" in sass["probe_mma_sync"]


def test_probe_wrappers_raise_instead_of_falling_back(dev):
    from r2l_tpu_torch.exp import probe_mxu as PM
    from r2l_tpu_torch.exp import probe_shapes as PS
    x = _probe_x(dev, 128)
    w, b = PM.mk_weights(torch.Generator().manual_seed(8), 2, device=dev)
    with pytest.raises(TypeError):
        PM.chain(x.double(), w, b)
    with pytest.raises(ValueError):
        PM.chain(x, w, b.cpu())
    with pytest.raises(ValueError):
        PM.chain(x, w, b, mode="fast")
    with pytest.raises(TypeError):
        PM.int8_chain(x, w, b)
    xs, ws = PS.shape_inputs(64, 256, 512, torch.int8,
                             torch.Generator().manual_seed(9), n_tiles=1,
                             n_layers=2, device=dev)
    with pytest.raises(ValueError):   # chained needs a square shape
        PS.unchained(xs, ws, chained=True)
    with pytest.raises(TypeError):
        PS.unchained(xs.float(), ws)
    img = PS.stage_shape_weights(ws, False)
    for bad in (img._replace(data=img.data[:-16]),   # a short image
                PS.stage_shape_weights(ws, True),    # the other form's
                PS.stage_shape_weights(ws.clone(), False)):  # other weights
        with pytest.raises(ValueError):
            PS.unchained(xs, ws, staged=bad)
    with pytest.raises(TypeError):    # the mma.sync instrument is bf16
        PS.mma_sync_sum(xs, ws)


# K2's probes (r2l_tpu_torch/exp/probe_{int8,wall,pipe_lib,epi}.py): the
# int8 bodies, the wall's modes, the streams and the epilogues are exact
# int32 dots with the plain versions' roundings, so bit for bit (the
# streams and the epilogue v0 also equal K2); the bf16 control as the bf16
# chain.
def _int8_probe_case(dev, n_rays=1000):
    cfg = R2LConfig(input_dim=48 * 21, netdepth=8, netwidth=256,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(10), dev)
    sampler = PointSampler(H=40, W=25, focal=30.0, n_sample=16, near=2.0,
                           far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in (0.0, 120.0, 240.0)])
    calib = _calibration_points(sampler, poses, dev)
    pts = sampler.sample_test(torch.as_tensor(poses[1], device=dev))
    return cfg, model, calib, pts[:n_rays].contiguous()


@pytest.mark.parametrize("body", ["int8", "int8_fold", "bf16"])
def test_probe_resmlp_matches_plain_and_dual_equals_single(dev, body):
    from r2l_tpu_torch.exp import probe_int8 as PI
    x = _probe_x(dev)
    w = PI.variant_weights({"int8": "int8_resmlp",
                            "int8_fold": "int8_resmlp_fold",
                            "bf16": "bf16_resmlp"}[body], dev, n_blocks=4)
    before = PI.resmlp.launches
    got = PI.resmlp(x, *w, body=body)
    dual = PI.resmlp(x, *w, body=body, dual=True)
    torch.cuda.synchronize()
    assert PI.resmlp.launches == before + 2
    assert torch.equal(got, dual)
    want = PI.resmlp_ref(x, *w, body=body)
    if body == "bf16":   # the residual stream grows to ~5, where one bf16
        mx, rms = _deltas(got, want)    # step is 0.03: relative to its top,
        top = float(want.abs().max())   # as chip_smoke's 4-block check
        assert mx / top < TOL_BF16, mx
        assert rms / top < TOL_PROBE_BF16_RMS, rms
    else:
        assert torch.equal(got, want)
    assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("mode", ["mxu_only", "mincast", "realistic"])
def test_probe_wall_equals_plain(dev, mode):
    """Each mode on the image staged once for the three, bit for bit;
    another weights' image raises before the launch."""
    from r2l_tpu_torch.exp import probe_mxu as PM
    from r2l_tpu_torch.exp import probe_wall as PW
    x = _probe_x(dev)
    w, m = PW.make_weights(torch.Generator().manual_seed(11), 4, dev)
    img = PM.stage_int8_chain(w, m)
    before = PW.wall.launches
    got = PW.wall(x, w, m, mode, staged=img)
    torch.cuda.synchronize()
    assert PW.wall.launches == before + 1
    assert torch.equal(got, PW.wall_ref(x, w, m, mode))
    assert float(got.abs().sum()) > 0
    with pytest.raises(ValueError):
        PW.wall(x, w, m, mode, staged=PM.stage_int8_chain(w.clone(), m))
    assert PW.wall.launches == before + 1


def test_probe_wall_mincast_wraps_on_card(dev):
    """Saturated inputs and weights of 3: the shifted sums leave the int8
    range and wrap (381 -> 125), as the plain version and XLA wrap them."""
    from r2l_tpu_torch.exp import probe_wall as PW
    x = torch.full((1000, 256), 10.0, device=dev)
    w = torch.full((1, 256, 256), 3, dtype=torch.int8, device=dev)
    m = torch.full((1, 256), 1e-3, device=dev)
    got = PW.wall(x, w, m, "mincast")
    assert torch.equal(got, PW.wall_ref(x, w, m, "mincast"))
    assert bool((got == 125.0).all())


@pytest.mark.parametrize("streams", [1, 2, 4])
def test_probe_pipe_equals_k2(dev, streams):
    from r2l_tpu_torch.exp import probe_pipe_lib as PL
    cfg, model, calib, pts = _int8_probe_case(dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, calib)
    before = PL.apply_int8_pe_streams.launches
    got = PL.apply_int8_pe_streams(fp, cfg, pts, 48, 10, streams=streams)
    torch.cuda.synchronize()
    assert PL.apply_int8_pe_streams.launches == before + 1
    assert torch.equal(got, F.fused_r2l_apply_int8_pe(fp, cfg, pts, 48, 10))
    assert torch.equal(got, PL.apply_int8_pe_streams_ref(fp, cfg, pts, 48,
                                                         10))


@pytest.mark.parametrize("fold", [True, False])
def test_probe_epi_equals_plain(dev, fold):
    from r2l_tpu_torch.exp import probe_epi as PE
    cfg, model, calib, pts = _int8_probe_case(dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, calib,
                                 fold_requant=fold)
    before = PE.apply_variant.launches
    outs = [PE.apply_variant(fp, cfg, pts, 48, 10, v) for v in PE.VARIANTS]
    torch.cuda.synchronize()
    assert PE.apply_variant.launches == before + 3
    for v, got in zip(PE.VARIANTS, outs):
        assert torch.equal(got, PE.apply_variant_ref(fp, cfg, pts, 48, 10, v))
    assert torch.equal(outs[0], F.fused_r2l_apply_int8_pe(
        fp, cfg, pts, 48, 10, fold_requant=False, nobf16_inner=False))
    assert torch.equal(outs[2], outs[1])


def test_int8_probe_wrappers_raise_instead_of_falling_back(dev):
    from r2l_tpu_torch.exp import probe_epi as PE
    from r2l_tpu_torch.exp import probe_int8 as PI
    from r2l_tpu_torch.exp import probe_pipe_lib as PL
    from r2l_tpu_torch.exp import probe_wall as PW
    x = _probe_x(dev, 128)
    w, m, b = PI.variant_weights("int8_resmlp", dev, n_blocks=1)
    with pytest.raises(TypeError):     # int8 weights for the bf16 body
        PI.resmlp(x, w, m, b, body="bf16")
    with pytest.raises(ValueError):
        PI.resmlp(x, w[:1], m[:1], b[:1])
    with pytest.raises(ValueError):
        PW.wall(x, w, m, "fast")
    cfg, model, calib, pts = _int8_probe_case(dev, 128)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, calib)
    with pytest.raises(ValueError):
        PL.apply_int8_pe_streams(fp, cfg, pts, 48, 10, streams=8)
    with pytest.raises(ValueError):
        PE.apply_variant(fp, cfg, pts[:, :47], 48, 10, 1)
    # v1 runs on K2's Hopper kernel, which reads the staged s8 image only
    unstaged = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, calib,
                                       stage=False)
    before = PE.apply_variant.launches
    with pytest.raises(ValueError, match="staged"):
        PE.apply_variant(unstaged, cfg, pts, 48, 10, 1)
    assert PE.apply_variant.launches == before


# K5's outputs on fixed numpy inputs, as sha256 digests of (dh, dW, db), as
# its Hopper passes give them (r2l_bwd_hopper.cuh, f32 weights' dW as
# 3xTF32: NVIDIA H100 80GB HBM3, nvcc of CUDA 12.8; PERF.md section 6; the
# pre-Hopper kernel's differed: other sum orders). Every sum has a fixed
# order, so the same code gives the same bits.
K5_DIGESTS = {
    "f32": "48c15e99bae53214e613c64b401a7ed5f13e24143c5c9bd161a90408edc3f625",
    "bf16": "1b2d6ed6ebc8bd11e158ddcf059ad65cf2ecfff5aaa1b63b585f8c0f6d30e6fa",
    "int8": "9a3e973da431460fcca934604bb46e6c4022c87a1ce74ffbf579d79edcca80a2",
    "f32_bf16stash":
        "b9ca88b502ad2d55db9b532429f7cae0c448240c3378e3740dd06dfa0bf02e5f",
}


def _k5_fixed_inputs(kind, dev, n=1000, W=64, nb=3):
    """Numpy-seeded K5 inputs (no kernel or matmul makes them): body_w
    [2nb, W, W], a stash of the kind, body_scale (int8) and dh [n, W]."""
    rng = np.random.default_rng(17)
    cd = torch.float32 if kind.startswith("f32") else torch.bfloat16
    body_w = torch.from_numpy((rng.normal(size=(2 * nb, W, W)) / 8.0
                               ).astype(np.float32)).to(cd)
    scale = None
    if kind == "int8":
        stash = torch.from_numpy(rng.integers(
            -127, 128, (2 * nb + 1, n, W)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(
            0.005, 0.02, (2 * nb, W)).astype(np.float32)).to(dev)
    else:
        stash = torch.from_numpy(rng.normal(
            size=(2 * nb + 1, n, W)).astype(np.float32)).to(
            torch.bfloat16 if kind == "f32_bf16stash" else cd)
    dh = torch.from_numpy(rng.normal(size=(n, W)).astype(np.float32))
    cfg = R2LConfig(input_dim=48 * 21, netdepth=2 * nb + 2, netwidth=W,
                    compute_dtype=cd)
    return cfg, body_w.to(dev), stash.to(dev), scale, dh.to(dev)


def k5_digest(kind, dev):
    """sha256 of K5's (dh, dW, db) bytes on ``_k5_fixed_inputs``, the whole
    body in one call."""
    import hashlib
    cfg, body_w, stash, scale, dh = _k5_fixed_inputs(kind, dev)
    out = T.bwd_group(body_w, stash, dh, cfg, 0, cfg.num_blocks,
                      body_scale=scale, staged=T.stage_bwd_weights(body_w))
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def test_bwd_group_runs_on_wgmma(dev):
    """K5's library holds its Hopper passes only: the dh walk and both dW
    passes (bf16 weights', and f32 weights' as 3xTF32) are in its SASS, with
    HGMMA and no mma.sync (HMMA); the pre-Hopper scalar f32 pass is not."""
    import subprocess
    from r2l_tpu_torch.kernels import _build
    _build.load("r2l_bwd_group")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._library_path(
        "r2l_bwd_group"))], check=True, capture_output=True, text=True).stdout
    for fn in ("bwd_dh_hopper_kernel", "bwd_dw_wgmma_kernel",
               "bwd_dw_tf32_kernel"):
        assert fn in sass, fn
    assert "HGMMA" in sass and "HMMA" not in sass
    assert "bwd_dw_f32_kernel" not in sass


@pytest.mark.parametrize("lib,ops", [
    ("r2l_bwd_qdx", ("bwd_qdx_dh_kernel", "bwd_dw_wgmma_kernel", "IGMMA",
                     "HGMMA")),
    ("r2l_int8_hopper", ("r2l_int8_streams4_kernel", "IGMMA")),
    ("probe_resmlp", ("probe_s8_kernel", "probe_bf16_kernel", "IGMMA",
                      "HGMMA")),
    ("probe_chain", ("probe_bf16_kernel", "HGMMA")),
    ("probe_bign", ("probe_bign_kernel", "HGMMA")),
    ("probe_int8_chain", ("probe_int8_chain_kernel", "IGMMA"))])
def test_probe_kernels_run_on_wgmma(dev, lib, ops):
    """The int8-dL/dx probe's library (its dh walk and K5's dW pass), K2's,
    which holds the stream probe's forms, the ResMLP body probe's (int8
    bodies and the bf16 control), the chain probe's, bigN's and the int8
    chain's (make_int8 and the wall) are wgmma only: IGMMA (or HGMMA) in
    their SASS, no mma.sync (HMMA, IMMA)."""
    import subprocess
    from r2l_tpu_torch.kernels import _build
    _build.load(lib)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._library_path(lib))],
                          check=True, capture_output=True, text=True).stdout
    for op in ops:
        assert op in sass, op
    assert "HMMA" not in sass and "IMMA" not in sass


@pytest.mark.parametrize("kind", sorted(K5_DIGESTS))
def test_bwd_group_unchanged_by_the_header_split(dev, kind):
    """A regression pin: K5's (dh, dW, db) on fixed inputs equal the
    digests recorded for its Hopper passes (``K5_DIGESTS``)."""
    assert k5_digest(kind, dev) == K5_DIGESTS[kind]


# The int8-dL/dx probe (exp/probe_bwd_qdx.py): exact int32 dots, IEEE
# quotients and the one-FMA update on both sides, so dh and the dt scratch
# bit for bit; dW and db are K5's wgmma passes over the same scratch,
# against the plain version's matmuls in another order (norm-relative
# 1e-5), and the top layer's, whose dt2 is K5's, equal to K5's. At the
# probe's body_scale (1/body_inv) dx is far below dh (ROADMAP C), so the
# checks also run with a body_scale of order one, where dx moves dh.
TOL_QDX_DW = 1e-5


def _qdx_case(dev, n=1024, W=64):
    cfg = R2LConfig(input_dim=48 * 21, netdepth=10, netwidth=W,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(12), dev)
    sampler = PointSampler(H=32, W=32, focal=30.0, n_sample=16, near=2.0,
                           far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in (0.0, 120.0, 240.0)])
    calib = _calibration_points(sampler, poses, dev)
    pts = torch.rand((n, 48), generator=torch.Generator().manual_seed(13)
                     ).to(dev) * 2.0 - 1.0
    fp = F.stage_int8_train(F.calibrate_r2l_int8_pe(
        model, cfg, 48, 10, calib, fold_requant=False, stage=False),
        cfg, 48, 10, True)
    _, stash = T.train_fwd_int8(fp, cfg, pts, 48, 10, stash_q=True)
    body_w = F.prepare_fused_params_pe(model, cfg, 48, 10).body_w
    dh = torch.randn((n, W), generator=torch.Generator().manual_seed(14)
                     ).to(dev) * 1e-3
    unit = torch.rand(fp.body_inv.shape, generator=torch.Generator(
        ).manual_seed(15)).to(dev) * 1.5 + 0.5
    return cfg, fp, stash, body_w, dh, {"probe": 1.0 / fp.body_inv,
                                        "unit": unit}, T.stage_qdx_weights(
        fp.body_q)


def _rel_err(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


@pytest.mark.parametrize("kind", ["probe", "unit"])
@pytest.mark.parametrize("tile", [64, 128, 512])
def test_bwd_group_qdx_matches_plain(dev, tile, kind):
    from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
    cfg, fp, stash, body_w, dh, scales, img = _qdx_case(dev)
    sc = scales[kind]
    for b0, cnt in ((1, 3), (0, cfg.num_blocks)):
        dts, dts_p = (torch.empty((2 * cnt,) + dh.shape, dtype=torch.bfloat16,
                                  device=dev) for _ in range(2))
        before = PQ.bwd_group_qdx.launches
        got = PQ.bwd_group_qdx(body_w, fp.body_q, fp.body_m, stash, dh, cfg,
                               b0, cnt, tile, sc, dts, staged=img)
        again = PQ.bwd_group_qdx(body_w, fp.body_q, fp.body_m, stash, dh,
                                 cfg, b0, cnt, tile, sc, staged=img)
        torch.cuda.synchronize()
        assert PQ.bwd_group_qdx.launches == before + 2
        want = PQ.bwd_group_qdx_ref(body_w, fp.body_q, fp.body_m, stash, dh,
                                    cfg, b0, cnt, tile, sc, dts_p)
        for g, a in zip(got, again):
            assert torch.equal(g, a), "two runs differ"
        assert torch.equal(got[0], want[0])
        assert torch.equal(dts, dts_p)
        assert _rel_err(got[1], want[1]) <= TOL_QDX_DW
        assert _rel_err(got[2], want[2]) <= TOL_QDX_DW
        if kind == "unit":
            assert float((got[0] != dh).double().mean()) > 0.9


def test_bwd_group_qdx_shares_k5s_dw_pass(dev):
    """The top layer's dt2 is the same on both sides, and its dW and db come
    from K5's own wgmma passes: they equal K5's bit for bit."""
    from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
    cfg, fp, stash, body_w, dh, scales, img = _qdx_case(dev)
    nb = cfg.num_blocks
    _, dw, db = PQ.bwd_group_qdx(body_w, fp.body_q, fp.body_m, stash, dh,
                                 cfg, 0, nb, 512, scales["probe"],
                                 staged=img)
    _, dw5, db5 = T.bwd_group(body_w, stash, dh, cfg, 0, nb,
                              body_scale=scales["probe"],
                              staged=T.stage_bwd_weights(body_w))
    assert torch.equal(dw[-1], dw5[-1])
    assert torch.equal(db[-1], db5[-1])


def test_bwd_group_qdx_raises_instead_of_falling_back(dev):
    from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
    cfg, fp, stash, body_w, dh, scales, img = _qdx_case(dev)
    args = (body_w, fp.body_q, fp.body_m, stash, dh, cfg, 0, 2)
    with pytest.raises(ValueError):     # a tile the cluster cannot take
        PQ.bwd_group_qdx(*args, tile=1024, body_scale=scales["probe"])
    with pytest.raises(ValueError):
        PQ.bwd_group_qdx(*args, tile=32, body_scale=scales["probe"])
    with pytest.raises(TypeError):      # the bf16 stash is not this probe's
        PQ.bwd_group_qdx(body_w, fp.body_q, fp.body_m, stash.bfloat16(), dh,
                         cfg, 0, 2, 512, scales["probe"])
    with pytest.raises(ValueError):
        PQ.bwd_group_qdx(*args, tile=512, body_scale=scales["probe"].cpu())
    with pytest.raises(ValueError, match="staged"):   # no weight image
        PQ.bwd_group_qdx(*args, tile=512, body_scale=scales["probe"])
    with pytest.raises(ValueError):     # not a tile the kernel maps
        PQ.bwd_group_qdx(*args, tile=192, body_scale=scales["probe"],
                         staged=img)


# ---------------------------------------------------------------------------
# Checkpoints on the card (chip_smoke.py phase 16 at a small width)
# ---------------------------------------------------------------------------

def _ckpt_student(dev):
    cfg = R2LConfig(input_dim=48 * 21, netdepth=12, netwidth=128,
                    compute_dtype=torch.bfloat16)
    sampler = PointSampler(H=32, W=32, focal=40.0, n_sample=16, near=2.0,
                           far=6.0)
    return cfg, sampler, init_r2l(cfg, torch.Generator().manual_seed(0), dev)


def test_loaded_student_frames_equal_the_original(dev, tmp_path):
    """A student saved as a native .msgpack and exported from it as a
    reference .tar, each loaded into a new module on the card: its pe (K1)
    and int8 (K2) frames equal the original's bit for bit, through the
    kernels."""
    from r2l_tpu_torch import checkpoint as C
    from r2l_tpu_torch.evaluate import make_r2l_frame_fn
    from r2l_tpu_torch.models import params_to_jax
    from r2l_tpu_torch.tools.export_torch_ckpt import main as export_tar
    cfg, sampler, model = _ckpt_student(dev)
    native, tar = str(tmp_path / "s.msgpack"), str(tmp_path / "s.tar")
    C.save_checkpoint(native, {"params": params_to_jax(model, cfg)})
    assert export_tar(["--ckpt", native, "--out", tar]) == 0
    poses = np.stack([pose_spherical(th, -30.0, 4.0)[:3, :4]
                      for th in (0.0, 90.0)])
    F.fused_r2l_apply_pe.launches = F.fused_r2l_apply_int8_pe.launches = 0
    for path in (native, tar):
        loaded, lcfg, _ = C.load_r2l(path, dev,
                                     compute_dtype=torch.bfloat16)
        for kind, quantize in (("pe", ""), ("int8", "int8")):
            fns = [make_r2l_frame_fn(m, c, sampler, quantize=quantize,
                                     calib_poses=poses)
                   for m, c in ((model, cfg), (loaded, lcfg))]
            assert [f.kind for f in fns] == [kind, kind]
            for p in poses:
                assert torch.equal(fns[1](p), fns[0](p)), (path, kind)
    assert F.fused_r2l_apply_pe.launches > 0
    assert F.fused_r2l_apply_int8_pe.launches > 0


@pytest.mark.parametrize("kind", ["fused", "fused_int8"])
def test_resume_on_card_equals_continuous(dev, kind, tmp_path):
    """The fused steps (K3 + K5; K4 + K5 calibrated every step): 3 steps,
    save with the pool, restore into a state built afresh, 2 steps; params,
    Adam's moments and the pool equal 5 straight steps bit for bit."""
    from r2l_tpu_torch import checkpoint as C
    from r2l_tpu_torch.train import (DistillConfig, draw_step,
                                     fused_int8_calib_points,
                                     init_train_state, make_distill_step)
    cfg, sampler, _ = _ckpt_student(dev)
    dcfg = DistillConfig(batch_size=2048, n_hard_in=204, n_hard_out=409,
                         hard_mul=4.0, warmup_lr="0.0001,3", embed_L=10)
    kw = {"fused_vjp": True}
    if kind == "fused_int8":
        poses = np.stack([pose_spherical(th, -30.0, 4.0)[:3, :4]
                          for th in (0.0, 120.0, 240.0)])
        kw.update(fused_quantize="int8", fused_calib_every=1,
                  fused_calib_pts=fused_int8_calib_points(
                      32, 32, 40.0, 16, 2.0, 6.0, poses, dev))
    step = make_distill_step(cfg, dcfg, sampler, device=dev, **kw)
    g = torch.Generator(dev).manual_seed(1)
    batches = torch.rand((5, 2048 - 409, 9), generator=g, device=dev)
    draws = [draw_step(dcfg, 16, torch.Generator(dev).manual_seed(10 + i))
             for i in range(5)]

    def fresh(seed):
        return init_train_state(init_r2l(cfg, torch.Generator().manual_seed(
            seed), dev), dcfg, device=dev)

    def run(state, steps):
        for i in steps:
            state, _ = step(state, batches[i], draws=draws[i])
        return state

    def snapshot(state):
        out = [t for p in state.params.parameters() for t in (
            p.detach(), state.optimizer.state[p]["exp_avg"],
            state.optimizer.state[p]["exp_avg_sq"])]
        return out + list(state.pool)

    straight = run(fresh(0), range(5))
    half = run(fresh(0), range(3))
    C.save(str(tmp_path / "s.msgpack"), half, half.step, -1.0, -1,
           save_pool=True)
    resumed, _, _ = C.resume_distill(fresh(1), str(tmp_path / "s.msgpack"),
                                     log=lambda s: None)
    resumed = run(resumed, range(3, 5))
    assert (resumed.step, resumed.lr_count) == (5, 5)
    for a, b in zip(snapshot(resumed), snapshot(straight)):
        assert torch.equal(a, b)


def test_cli_render_only_on_card(dev, tmp_path):
    """main_cuda.py --render_only --render_test on the card, on the 32x32
    synthetic scene: as a subprocess of the entry (exit 0, a PSNR line), and
    in process, where K1's counter moves and the frames are bit for bit
    make_r2l_frame_fn's on the same checkpoint's weights."""
    import subprocess
    import sys

    from _torch_scene import write_scene
    from r2l_tpu_torch import app
    from r2l_tpu_torch import checkpoint as C
    from r2l_tpu_torch.configs import args_to_r2l_config, parse_args
    from r2l_tpu_torch.evaluate import make_r2l_frame_fn
    from r2l_tpu_torch.models import params_to_jax
    scene = write_scene(str(tmp_path / "scene"))
    flags = ("--model_name R2L --n_sample_per_ray 16 --netwidth 128 "
             "--netdepth 12 --use_residual --trial.ON --trial.body_arch "
             f"resmlp --compute_dtype bfloat16 --dataset_type blender "
             f"--datadir {scene} --white_bkgd --testskip 1 "
             f"--experiments_dir {tmp_path / 'exps'}").split()
    cfg = args_to_r2l_config(parse_args(flags))
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    path = str(tmp_path / "student.msgpack")
    C.save_checkpoint(path, {"params": params_to_jax(model, cfg)})
    argv = flags + ["--render_only", "--render_test", "--pretrained_ckpt",
                    path]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "main_cuda.py", *argv], cwd=repo,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr[-2000:]
    (psnr,) = [ln.split("PSNR ")[1].split()[0] for ln in
               out.stdout.splitlines() if "render_only: PSNR" in ln]
    F.fused_r2l_apply_pe.launches = 0
    res = app.train(parse_args(argv))
    assert F.fused_r2l_apply_pe.launches > 0
    assert f"{res.test_psnr:.4f}" == psnr
    ns = app.load_dataset(parse_args(argv), app.Logger(
        experiments_dir=str(tmp_path / "exps")))
    sampler = PointSampler(H=ns.H, W=ns.W, focal=ns.focal, n_sample=16,
                           near=ns.near, far=ns.far)
    frame_fn = make_r2l_frame_fn(model, cfg, sampler, calib_poses=ns.poses)
    assert frame_fn.kind == "pe"
    want = np.stack([frame_fn(p).cpu().numpy() for p in ns.poses[ns.i_test]])
    np.testing.assert_array_equal(res.frames, want)


def test_jpeg_fixtures_decode_to_their_digests(dev):
    """The JPEG decoder beside the card, with no image package: every
    fixture's array has the sha256 of imageio's (tests/fixtures/jpeg/)."""
    import hashlib
    import json

    from r2l_tpu_torch.data.imageio_ import read_image
    root = os.path.join(FIXTURES, "jpeg")
    with open(os.path.join(root, "digests.json")) as f:
        digests = json.load(f)
    for name, want in digests.items():
        a = read_image(os.path.join(root, name))
        assert list(a.shape) == want["shape"], name
        assert hashlib.sha256(a.tobytes()).hexdigest() == want["sha256"], name


def test_world1_sharded_frames_equal_unsharded(dev, tmp_path):
    """A one-rank NCCL group (mesh data:1, model:1): the pe (K1) and int8
    (K2) frames through ``mesh=`` split and all_gather their rays on the
    card, are bit for bit the unsharded ones, and each launches its
    kernel."""
    import torch.distributed as dist

    from _torch_mesh import counted_collectives
    from r2l_tpu_torch.evaluate import make_r2l_frame_fn
    from r2l_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", init_method="file://" + str(
        tmp_path / "rdv"), rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        cfg = R2LConfig(input_dim=48 * 21, netdepth=12, netwidth=256,
                        compute_dtype=torch.bfloat16)
        model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
        sampler = PointSampler(H=64, W=64, focal=80.0, n_sample=16,
                               near=2.0, far=6.0)
        poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                          for t in (0.0, 90.0)]).astype(np.float32)
        for kw, fn in (({}, F.fused_r2l_apply_pe),
                       ({"quantize": "int8"}, F.fused_r2l_apply_int8_pe)):
            one = make_r2l_frame_fn(model, cfg, sampler, calib_poses=poses,
                                    **kw)
            sh = make_r2l_frame_fn(model, cfg, sampler, calib_poses=poses,
                                   mesh=mesh, **kw)
            fn.launches = 0
            with counted_collectives() as calls:
                got = sh(poses[0])
            assert fn.launches > 0 and calls["all_gather"] > 0
            assert torch.equal(got, one(poses[0]))
    finally:
        dist.destroy_process_group()


def test_world1_sharded_distill_step_equals_unsharded(dev, tmp_path):
    """A one-rank NCCL group: two hard-mined distillation steps with
    ``mesh=`` all_reduce the gradients and the loss and all_gather the
    per-ray losses on the card, and are bit for bit the unsharded steps:
    losses, parameters and the hard pool."""
    import torch.distributed as dist

    from _torch_mesh import counted_collectives
    from r2l_tpu_torch import train as TR
    from r2l_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", init_method="file://" + str(
        tmp_path / "rdv"), rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        cfg = R2LConfig(input_dim=16 * 3 * 21, netdepth=8, netwidth=128,
                        compute_dtype=torch.bfloat16)
        dcfg = TR.DistillConfig(batch_size=1024, n_hard_in=64,
                                n_hard_out=128, hard_mul=2.0, embed_L=10)
        sampler = PointSampler(H=64, W=64, focal=80.0, n_sample=16,
                               near=2.0, far=6.0)
        fresh = torch.from_numpy(np.random.default_rng(1).normal(
            size=(896, 9)).astype(np.float32)).to(dev)

        def run(m):
            model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
            state = TR.init_train_state(model, dcfg, device=dev)
            step = TR.make_distill_step(cfg, dcfg, sampler, device=dev,
                                        mesh=m)
            g = torch.Generator(dev).manual_seed(3)
            losses = []
            for _ in range(2):
                state, ms = step(state, fresh, generator=g)
                losses.append(ms["loss"])
            return [*losses, *state.params.parameters(), *state.pool]

        want = run(None)
        with counted_collectives() as calls:
            got = run(mesh)
        torch.cuda.synchronize()
        assert calls["all_reduce"] > 0 and calls["all_gather"] > 0
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# Shapes off the kernels' native widths. A narrower student or teacher runs
# on the kernels padded (the cases above), a wider student's frame on the
# frame kernels' wide form; an lrelu student, and a W512 student's training
# step or teacher, make each wrapper raise NotImplementedError before any
# launch; the gates send a model that the JAX package renders plain to the
# plain path, and raise where the JAX package runs a kernel that the port's
# do not take, which the kernels' launch counters show untouched.

def _counters():
    return (F.fused_r2l_apply_pe.launches, F.fused_r2l_apply.launches,
            F.fused_r2l_apply_int8_pe.launches, T.train_fwd.launches,
            T.train_fwd_int8.launches, T.train_fwd_int8.launches_bf16,
            T.bwd_group.launches, NR.fused_nerf_render.launches,
            NR.fused_nerf_render.launches_int8,
            NR.fused_nerf_render.launches_wide,
            NR.fused_nerf_render.launches_wide_int8,
            F.fused_r2l_apply_pe_wide.launches,
            F.fused_r2l_apply_wide.launches,
            F.fused_r2l_apply_int8_pe_wide.launches,
            T.train_fwd_wide.launches, T.train_fwd_int8_wide.launches,
            T.train_fwd_int8_wide.launches_bf16, T.bwd_group_wide.launches)


def _student(dev, depth=6, **kw):
    """A student of W512 (or ``kw``) and ``depth``, 16 samples, L=10, its
    sampler, poses and a pose's points."""
    cfg = R2LConfig(netdepth=depth, **{"netwidth": 512, **kw})
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    sampler = PointSampler(H=40, W=25, focal=30.0, n_sample=16, near=2.0,
                           far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in (0.0, 120.0, 240.0)])
    pts = sampler.sample_test(torch.as_tensor(poses[1], device=dev))
    return cfg, model, sampler, poses, pts.contiguous()


@pytest.mark.parametrize("kw", [{}, {"netwidth": 256, "act": "lrelu"}],
                         ids=["w512", "lrelu"])
def test_wrappers_refuse_shapes_before_launching(dev, kw):
    cfg, model, _, _, pts = _student(dev, **kw)
    dp, L, nb, n = 48, 10, cfg.num_blocks, pts.shape[0]
    relu = dataclasses.replace(cfg, act="relu")   # the packers' own check
    fp = F.prepare_fused_params_pe(model, relu, dp, L, stage=False)
    fp8 = F.calibrate_r2l_int8_pe(model, relu, dp, L, pts, stage=False)
    W = cfg.netwidth
    stash = torch.zeros((2 * nb + 1, n, W), dtype=torch.bfloat16,
                        device=dev)
    dh = torch.zeros((n, W), dtype=torch.float32, device=dev)
    calls = [lambda: F.fused_r2l_apply_pe(fp, cfg, pts, dp, L),
             lambda: F.fused_r2l_apply(fp, cfg, r2l_embed(pts, L)),
             lambda: F.fused_r2l_apply_int8_pe(fp8, cfg, pts, dp, L),
             lambda: T.train_fwd(fp, cfg, pts, dp, L),
             lambda: T.train_fwd_int8(fp8, cfg, pts, dp, L, stash_q=True),
             lambda: T.train_fwd_int8(fp8, cfg, pts, dp, L, stash_q=False),
             lambda: T.bwd_group(fp.body_w, stash, dh, cfg, 0, 1)]
    before = _counters()
    for i, call in enumerate(calls):
        if not kw:   # every wrapper takes W512 on its wide form, which has
            with pytest.raises(ValueError, match="image of the wide form"):
                call()         # no image in an unstaged packing
            continue
        with pytest.raises(NotImplementedError, match="64, 128, 256"):
            call()
    torch.cuda.synchronize()
    assert _counters() == before


def test_teacher_wrapper_refuses_w512_before_launching(dev):
    """W512 runs on the wide form, whose wrapper refuses a packing of
    another width (here K6's at 128) before any launch."""
    cfg, model, o, d, z, Lp, Lv, _ = _nerf_case("w128_noview", dev, "bf16")
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv)
    before = _counters()
    with pytest.raises(ValueError, match="shape"):
        NR.fused_nerf_render(fp, dataclasses.replace(cfg, W=512), o, d, z,
                             L_pts=Lp, L_views=Lv)
    assert _counters() == before


@pytest.mark.parametrize("case", ["w96", "w512_d88", "lrelu"])
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_student_frames_off_the_native_widths(dev, case, quantize):
    """``use_pallas`` (and int8): a bf16 W96 student runs on K1/K2 at 128
    (one launch a frame; on the frame's points within K1 bf16's and K2's
    bounds of the kernel's plain version on the same packing); W512/D88
    and lrelu, which the JAX package renders plain, render plain (kind
    ``jnp``, the ``use_pallas=False`` frame bit for bit, no launch)."""
    kw = {"w96": dict(netwidth=96, compute_dtype=torch.bfloat16),
          "w512_d88": dict(depth=88),
          "lrelu": dict(netwidth=256, act="lrelu", inact="lrelu")}[case]
    cfg, model, sampler, poses, _ = _student(dev, **kw)
    before = _counters()
    fn = TE.make_r2l_frame_fn(model, cfg, sampler, quantize=quantize,
                              calib_poses=poses)
    plain = TE.make_r2l_frame_fn(model, cfg, sampler, use_pallas=False)
    got = fn(poses[0])
    torch.cuda.synchronize()
    assert got.shape == (40, 25, 3) and torch.isfinite(got).all()
    if case == "w96":
        assert fn.kind == (quantize or "pe")
        counter = (F.fused_r2l_apply_int8_pe if quantize
                   else F.fused_r2l_apply_pe)
        assert counter.launches == before[2 if quantize else 0] + 1
        prepared, _, dp = TE._prepare_r2l(model, cfg, sampler, 10, False,
                                          True, quantize, calib_poses=poses)
        assert prepared.tail_b.shape[0] == 3
        pts = sampler.sample_test(torch.as_tensor(poses[0], device=dev))
        if quantize:
            assert prepared.body_q.shape[-1] == 128
            mx, rms = _deltas(
                F.fused_r2l_apply_int8_pe(prepared, cfg, pts, dp, 10),
                F.fused_r2l_apply_int8_pe_ref(prepared, cfg, pts, dp, 10))
            assert mx < TOL_INT8_MAX and rms < TOL_INT8_RMS, (mx, rms)
        else:
            assert prepared.body_w.shape[-1] == 128
            mx, _ = _deltas(
                F.fused_r2l_apply_pe(prepared, cfg, pts, dp, 10),
                F.fused_r2l_apply_pe_ref(prepared, cfg, pts, dp, 10))
            assert mx < TOL_BF16, mx
    else:
        assert fn.kind == "jnp"
        assert _counters() == before
        assert torch.equal(got, plain(poses[0]))


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_wide_student_that_jax_runs_on_its_kernel_runs_on_the_wide_form(
        dev, quantize):
    """A W512/D6 student, which the JAX package renders on its kernels:
    the frame function's kind is JAX's, and a frame is one launch of the
    wide form (K1's or K2's), within the bounds of its plain version on the
    same packing, and no launch of K1 or K2 themselves."""
    cfg, model, sampler, poses, pts = _student(dev)
    fn = TE.make_r2l_frame_fn(model, cfg, sampler, quantize=quantize,
                              calib_poses=poses)
    assert fn.kind == (quantize or "pe")
    before = _counters()
    got = fn(poses[0])
    torch.cuda.synchronize()
    assert got.shape == (40, 25, 3) and torch.isfinite(got).all()
    moved = [b - a for a, b in zip(before, _counters())]
    assert moved == [0] * 11 + ([0, 0, 1] if quantize else [1, 0, 0]) + [0] * 4
    prepared, _, dp = TE._prepare_r2l(model, cfg, sampler, 10, False, True,
                                      quantize, calib_poses=poses)
    if quantize:
        mx, rms = _deltas(
            F.fused_r2l_apply_int8_pe(prepared, cfg, pts, dp, 10),
            F.fused_r2l_apply_int8_pe_ref(prepared, cfg, pts, dp, 10))
        assert mx == 0.0, mx
    else:
        mx, _ = _deltas(F.fused_r2l_apply_pe(prepared, cfg, pts, dp, 10),
                        F.fused_r2l_apply_pe_ref(prepared, cfg, pts, dp, 10))
        assert mx < TOL_BF16, mx


@pytest.mark.parametrize("kw", [{}, {"netwidth": 256, "act": "lrelu",
                                     "inact": "lrelu"}],
                         ids=["w512", "lrelu"])
def test_fused_step_off_the_training_kernels(dev, kw):
    """--fused_train_vjp: W512 passes JAX's gate and its fused step runs on
    the training kernels' wide form (one K3 launch and one K5 launch a
    4-block group, none of the chain kernels; its loss within the fused
    step's bound of the plain step's); lrelu takes the plain step with the
    gate's warning, and the fused step raises; the plain step runs no
    kernel."""
    cfg, model, sampler, _, _ = _student(dev, **kw)
    dcfg = TR.DistillConfig(batch_size=1024)
    logs = []
    assert TR.fused_vjp_gate(True, cfg, False, log=logs.append) == (
        "act" not in kw)
    assert len(logs) == ("act" in kw)
    rng = np.random.default_rng(0)
    o = rng.normal(size=(1024, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    dirs = -o / 4.0 + 0.3 * rng.uniform(-1.0, 1.0, size=(1024, 3))
    fresh = np.concatenate([o, dirs / np.linalg.norm(dirs, axis=1,
                                                     keepdims=True),
                            rng.uniform(size=(1024, 3))], 1)
    fresh = fresh.astype(np.float32)
    if "act" in kw:
        with pytest.raises(NotImplementedError):
            TR.make_distill_step(cfg, dcfg, sampler, fused_vjp=True,
                                 device=dev)
    else:
        before = _counters()
        fused = TR.make_distill_step(cfg, dcfg, sampler, fused_vjp=True,
                                     device=dev)
        state = TR.clone_train_state(TR.init_train_state(model, dcfg,
                                                         device=dev))
        _, m_fused = fused(state, fresh,
                           generator=torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        moved = [b - a for a, b in zip(before, _counters())]
        assert moved == [0] * 14 + [1, 0, 0, -(-cfg.num_blocks // 4)]
    before = _counters()
    state = TR.init_train_state(model, dcfg, device=dev)
    step = TR.make_distill_step(cfg, dcfg, sampler, device=dev)
    state, m = step(state, fresh,
                    generator=torch.Generator(dev).manual_seed(0))
    assert np.isfinite(float(m["loss"]))
    torch.cuda.synchronize()
    assert _counters() == before
    if "act" not in kw:
        rel = abs(float(m_fused["loss"]) - float(m["loss"])) / float(m["loss"])
        assert rel < 2e-2, rel


def test_w64_teacher_runs_on_the_kernels(dev):
    """A W64 teacher: the frame function packs it at 128 and renders it
    through K6 (kind 'fused', one launch a pass: the coarse and the fine
    one of a chunk), within chip_smoke.py's bound of the plain frame (f32,
    PSNR >= 100 dB; the density floor of its teachers, without which a ray
    whose last sample has no density flips its last alpha at any rounding:
    4.7e-4 on one value of this frame); datagen's gate takes it; a teacher
    with a skip at its last layer raises before packing."""
    from r2l_tpu_torch import datagen
    from r2l_tpu_torch.render import VolRenderConfig
    cfg = NeRFConfig(D=4, W=64, skips=(2,))
    mc, mf = (init_nerf(cfg, torch.Generator().manual_seed(s), dev)
              for s in (0, 1))
    with torch.no_grad():
        for m in (mc, mf):
            m.alpha_linear.bias += 1.0
    vcfg = VolRenderConfig(n_coarse=16, n_fine=16, white_bkgd=True)
    sampler = PointSampler(H=40, W=25, focal=30.0, n_sample=16, near=2.0,
                           far=6.0)
    pose = pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    fn = TE.make_nerf_frame_fn(mc, mf, cfg, vcfg, sampler, use_pallas=True,
                               device=dev)
    plain = TE.make_nerf_frame_fn(mc, mf, cfg, vcfg, sampler, device=dev)
    assert fn.kind == "fused" and plain.kind == "plain"
    before = NR.fused_nerf_render.launches
    got = fn(pose)
    torch.cuda.synchronize()
    chunks = -(-40 * 25 // vcfg.ray_chunk)
    assert NR.fused_nerf_render.launches == before + 2 * chunks
    want = plain(pose)
    assert got.shape == want.shape and torch.isfinite(got).all()
    mse = float((got.double() - want.double()).pow(2).mean())
    assert mse == 0 or -10.0 * np.log10(mse) >= 100.0, mse
    gcfg = datagen.DataGenConfig(n_pose=1, H=4, W=4, focal=5.0)
    assert datagen._fused_refusal(gcfg, vcfg, dev) is None
    last = dataclasses.replace(cfg, skips=(cfg.D - 1,))
    with pytest.raises(NotImplementedError,
                       match="every skip before the last layer"):
        TE.make_nerf_frame_fn(mc, mf, last, vcfg, sampler, use_pallas=True,
                              device=dev)


# ---------------------------------------------------------------------------
# The kernels' number-changing forms (the Pallas flags bf16_resid,
# pe_ladder=False and bf16_requant), narrow and wide
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES) + sorted(WIDE_CASES))
@pytest.mark.parametrize("fold_requant,nobf16_inner",
                         [(True, True), (True, False), (False, False)])
def test_int8_bf16_resid_forms_bit_for_bit(dev, name, fold_requant,
                                           nobf16_inner):
    """K2 and its wide form with bf16_resid, in each of the three forms:
    one launch of the kernel and of the form's count, bit for bit the plain
    version on 1,000 rays and on a ragged 129; apart from the parent form
    where the global residual is on."""
    cases = {**CASES, **WIDE_CASES}
    cfg, model, sampler, poses, pts, dp, L = _case(name, dev, cases=cases)
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L,
                                 _calibration_points(sampler, poses, dev),
                                 fold_requant=fold_requant)
    kw = dict(fold_requant=fold_requant, nobf16_inner=nobf16_inner)
    wrapper = (F.fused_r2l_apply_int8_pe_wide if name in WIDE_CASES
               else F.fused_r2l_apply_int8_pe)
    for q in (pts, pts[:129].contiguous()):
        before = (wrapper.launches, wrapper.launches_bf16_resid)
        got = F.fused_r2l_apply_int8_pe(fp, cfg, q, dp, L, bf16_resid=True,
                                        **kw)
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.launches_bf16_resid) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got, F.fused_r2l_apply_int8_pe_ref(
            fp, cfg, q, dp, L, bf16_resid=True, **kw))
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, L, bf16_resid=True,
                                    **kw)
    parent = F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, L, **kw)
    assert torch.equal(got, parent) != cfg.use_residual


# (label, kind, pe_ladder, bf16_requant, fold_requant)
NERF_FORMS = (("pe_sin", "f32", False, False, False),
              ("pe_sin", "bf16", False, False, False),
              ("pe_sin", "int8", False, False, True),
              ("bf16_requant", "int8", True, True, True),
              ("bf16_requant_unfolded", "int8", True, True, False))


@pytest.mark.parametrize("name", ["canonical", "w128_noview", "w384",
                                  "w384_noview"])
@pytest.mark.parametrize("form", NERF_FORMS,
                         ids=[f"{f[0]}_{f[1]}" for f in NERF_FORMS])
def test_nerf_render_forms_match_plain(dev, name, form):
    """K6/K7 and their wide form with pe_ladder=False, and K7's with
    bf16_requant: one launch of the kernel and of the form's count, every
    output within the teacher kernels' limits (TOL_WIDE_NERF) of the plain
    version on the same packing; K7's bf16_requant apart from the f32
    dequantize."""
    _, kind, ladder, brq, fold = form
    cfg, model, o, d, z, Lp, Lv, calib = _nerf_case(name, dev, kind, n=517,
                                                     S=64)
    fp = NR.prepare_fused_nerf(model, cfg, Lp, Lv, calib=calib,
                               weight_dtype=cfg.compute_dtype,
                               fold_requant=fold)
    kw = dict(L_pts=Lp, L_views=Lv, white_bkgd=True, pe_ladder=ladder,
              bf16_requant=brq)
    f = NR.fused_nerf_render
    counts = ("launches_pe_sin", "launches_bf16_requant")
    before = [getattr(f, c) for c in counts] + list(_wide_nerf_counts())
    got = f(fp, cfg, o, d, z, **kw)
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(before, [getattr(f, c) for c in counts]
                                   + list(_wide_nerf_counts()))]
    slot = 2 + (2 if NR.teacher_wide_form(cfg.W) else 0) + (kind == "int8")
    assert moved == [int(not ladder), int(brq)] + [
        int(i == slot) for i in range(2, 6)]
    want = NR.fused_nerf_render_ref(fp, cfg, o, d, z, **kw)
    (tol, tol_rms), (tol_d, tol_d_rms) = TOL_WIDE_NERF[kind]
    for what, g_, w_ in zip(("rgb", "acc", "depth", "weights"), got, want):
        mx, rms = _deltas(g_, w_)
        lim = (tol_d, tol_d_rms) if what == "depth" else (tol, tol_rms)
        assert mx <= lim[0] and rms <= lim[1], (what, mx, rms)
    if brq:
        parent = f(fp, cfg, o, d, z, L_pts=Lp, L_views=Lv, white_bkgd=True)
        assert not torch.equal(got[0], parent[0])
