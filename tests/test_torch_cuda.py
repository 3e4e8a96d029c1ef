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
# canonical layout, then the other widths and depths the kernels take.
CASES = {
    "w256_canonical": (256, 2, 16, 10, {}),
    "w128_nl3_dim6": (128, 3, 2, 10, {"res_scale": 0.5}),
    "w64_nl1_linear": (64, 1, 16, 4, {"use_residual": False,
                                      "linear_tail": True}),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(name, dev, compute_dtype=torch.bfloat16, n_rays=1000):
    W, nl, n_sample, L, kw = CASES[name]
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
    with pytest.raises(ValueError):
        F.fused_r2l_apply_pe(fp, wide, pts, dp, L)


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


def _train_case(name, dev, compute_dtype=torch.bfloat16, n_rays=1000):
    W, n_sample, L, kw = TRAIN_CASES[name]
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
                                     ("r2l_train_fwd_int8", "IGMMA")])
def test_train_kernels_run_on_wgmma(dev, name, op):
    """The SASS of K3 (bf16, and f32 as TF32) holds HGMMA and K4/K8's
    IGMMA: wgmma, not mma.sync's HMMA/IMMA."""
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


# Teacher kernels (K6 f32/bf16, K7 int8): (D, W, skips, L_pts, L_views,
# viewdirs). A block holds 16 rays (bf16, int8) or 8 (f32), two blocks a
# cluster: 1003 rays fill no block, 48 leave the last bf16/int8 cluster half
# empty (an odd number of blocks), 24 the last f32 one, 1 ray the only one;
# S = 13 is not a multiple of the 8-sample group, 192 is the fine pass's.
NERF_CASES = {
    "canonical": (8, 256, (4,), 10, 4, True),
    "w128_noview": (4, 128, (1,), 6, 3, False),
    "w128_skip0": (3, 128, (0,), 6, 3, True),
}
# K6 f32: the same f32 chain, sums in another order (depth sums w*z over
# up to 6). K6 bf16: a flipped bf16 rounding propagates, as K1 bf16. K7: as
# K2.
TOL_NERF = {"f32": (1e-4, 1e-3), "bf16": (3e-2, 3e-2)}


def _nerf_case(name, dev, kind, n=1003, S=64):
    D, W, skips, Lp, Lv, vd = NERF_CASES[name]
    cd = torch.bfloat16 if kind == "bf16" else torch.float32
    cfg = NeRFConfig(D=D, W=W, skips=skips, input_ch=3 + 6 * Lp,
                     input_ch_views=3 + 6 * Lv if vd else 0,
                     use_viewdirs=vd, compute_dtype=cd)
    model = init_nerf(cfg, torch.Generator().manual_seed(0), dev)
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
    narrow = dataclasses.replace(cfg, W=64)
    with pytest.raises(ValueError):
        NR.fused_nerf_render(fp, narrow, o, d, z, **kw)
    with pytest.raises(ValueError):   # no staged image, or a stale one
        NR.fused_nerf_render(fp._replace(staged=None), cfg, o, d, z, **kw)
    with pytest.raises(ValueError):
        NR.fused_nerf_render(fp._replace(staged=fp.staged[:-16]), cfg, o,
                             d, z, **kw)


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
