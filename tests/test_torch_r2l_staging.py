"""The staged weight image of the student's Hopper chain (K1, K9) and the
3xTF32 products of its f32 instance, on the CPU.

``stage_chain_weights`` packs the head and every body layer once per model
into the stages K1/K9 bulk-copy (wgmma's core-matrix order); here the image
is unpacked again and held to the packed fields bit for bit. K1/K9 f32
multiply as 3xTF32 (a_hi w_lo + a_lo w_hi + a_hi w_hi): an emulation of
that split through K1's plain version, at the canonical f32 student on
1,000 rays of ``chip_smoke.py``'s frame, is held to the f32 limit
``chip_smoke.py`` holds K1 f32 to (``TOL_PE_F32``) against true f32. The
card's own sums (truncating, ROADMAP C) are held there by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.kernels.staging import tf32_split
from r2l_tpu_torch.models import R2LConfig, init_r2l

CPU = torch.device("cpu")
DP, L = 12, 10   # 252 input columns, padded to 256: two slices at W64


def _model(W, wd):
    cd = torch.float32 if wd == torch.float32 else torch.bfloat16
    cfg = R2LConfig(input_dim=DP * (2 * L + 1), netdepth=8, netwidth=W,
                    compute_dtype=cd)
    return cfg, init_r2l(cfg, torch.Generator().manual_seed(W), CPU)


def _pack(kind, model, cfg, wd):
    if kind == "pe":   # K1: the head's rows freq-major
        return F.prepare_fused_params_pe(model, cfg, DP, L, weight_dtype=wd)
    return F.prepare_fused_params(model, cfg, weight_dtype=wd)


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("kind", ["pe", "api"])
@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_chain_image_unpacks_bit_for_bit(kind, W, wd):
    """The image holds the head (K1's permuted rows or K9's) and every body
    layer of the packed fields: bf16 bit for bit; f32 as its TF32 high and
    low parts, each the split of the packed weight bit for bit. Its size is
    ``chain_stage_plan``'s, a multiple of 16 bytes."""
    cfg, model = _model(W, wd)
    fp = _pack(kind, model, cfg, wd)
    plan = F.chain_stage_plan(cfg, wd)
    assert fp.staged.dtype == torch.uint8
    assert fp.staged.numel() == plan["nbytes"] and plan["nbytes"] % 16 == 0
    assert plan["stages"] == (256 + 6 * W) // F.CHAIN_STAGE_K[wd]
    got = F.unstage_chain_weights(fp.staged, cfg, wd)
    names = ["head_w", "body_w"]
    assert sorted(got) == sorted(
        names + ([n + "_lo" for n in names] if wd == torch.float32 else []))
    for name in names:
        want = getattr(fp, name)
        assert got[name].dtype == wd and got[name].shape == want.shape
        if wd == torch.float32:
            hi, lo = tf32_split(want)
            assert torch.equal(_bytes(got[name]), _bytes(hi)), name
            assert torch.equal(_bytes(got[name + "_lo"]), _bytes(lo)), name
        else:
            assert torch.equal(_bytes(got[name]), _bytes(want)), name


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_chain_stages_are_wgmma_core_matrices(wd):
    """Stage s of a layer: byte b of output row n at ((n//8) * (B//16) +
    b//16) * 128 + (n%8) * 16 + b%16, B = 128 bytes per row (f32: 64, the
    high part first, then the low part); the head's stages first, then the
    body's, layer by layer."""
    cfg, model = _model(128, wd)
    fp = _pack("pe", model, cfg, wd)
    plan = F.chain_stage_plan(cfg, wd)
    k, sb = plan["stage_k"], plan["stage_bytes"]
    head_stages = plan["kpad"] // k
    for start, w, st in ((0, fp.head_w, 0), (0, fp.head_w, 3),
                         (head_stages * sb, fp.body_w[0], 1),
                         ((head_stages + 2 * (128 // k)) * sb, fp.body_w[2],
                          128 // k - 1)):
        chunk = w[:, st * k:(st + 1) * k]
        parts = tf32_split(chunk) if wd == torch.float32 else (chunk,)
        for p, part in enumerate(parts):
            rows = _bytes(part).reshape(128, -1)
            B = rows.shape[1]
            assert B == (64 if wd == torch.float32 else 128)
            base = start + st * sb + p * 128 * B
            for n_, b in [(0, 0), (5, 17), (9, 100 % B), (127, B - 1),
                          (64, 33)]:
                off = base + ((n_ // 8) * (B // 16) + b // 16) * 128 + \
                    (n_ % 8) * 16 + b % 16
                assert fp.staged[off] == rows[n_, b], (st, p, n_, b)


def _mm_3xtf32(x, w):
    """K1/K9 f32's product: a_hi w_lo + a_lo w_hi + a_hi w_hi, each product
    of TF32 values exact in f32, summed in f32."""
    w = w[:, :x.shape[1]]
    xh, xl = tf32_split(x.float())
    wh, wl = tf32_split(w.float())
    return xh @ wl.T + xl @ wh.T + xh @ wh.T


def test_3xtf32_emulation_keeps_the_k1_f32_limit():
    """K1's plain version at the canonical f32 student (W256, D88, 16
    samples, L=10, ``init_r2l`` seed 0) with its head and body products as
    3xTF32 (the tail stays f32, as in the kernels), on 1,000 rays of
    ``chip_smoke.py``'s frame (every 160th), against the true-f32 plain
    version: within ``TOL_PE_F32``, and not equal to it. The share of the
    limit used is printed."""
    cfg = R2LConfig()   # the CLI default compute dtype, f32
    assert cfg.compute_dtype == torch.float32
    model = init_r2l(cfg, torch.Generator().manual_seed(cs.SEED), CPU)
    from r2l_tpu_torch.sampler import PointSampler
    sampler = PointSampler(H=cs.H, W=cs.W, focal=cs.FOCAL,
                           n_sample=cs.N_SAMPLE, near=2.0, far=6.0)
    pose = torch.as_tensor(cs.lego_poses(cs.K)[3])
    pts = sampler.sample_test(pose)[::160][:1000].contiguous()
    assert pts.shape == (1000, 3 * cs.N_SAMPLE)
    dp = 3 * cs.N_SAMPLE
    fp = F.prepare_fused_params_pe(model, cfg, dp, cs.EMBED_L,
                                   weight_dtype=torch.float32, stage=False)
    want = F.fused_r2l_apply_pe_ref(fp, cfg, pts, dp, cs.EMBED_L)
    got = F.fused_r2l_apply_pe_ref(fp, cfg, pts, dp, cs.EMBED_L,
                                   mm=_mm_3xtf32)
    d = (got.double() - want.double())
    mx, rms = float(d.abs().max()), float(d.pow(2).mean().sqrt())
    print(f"3xTF32 emulation of K1 f32: max-abs {mx:.3e} "
          f"({mx / cs.TOL_PE_F32:.2%} of {cs.TOL_PE_F32:.0e}), RMS {rms:.3e}")
    assert torch.isfinite(got).all()
    assert mx <= cs.TOL_PE_F32, mx
    assert mx > 0, "the emulation changed nothing"


def _mm_3xtf32_stages(x, w, k=16):
    """K3 f32's product (``csrc/hopper_ring.cuh``, mm_rs with ``kSplit``):
    3xTF32 over each weight stage of k input channels, summed apart from
    zero, the stages' sums added in order in f32."""
    w = w[:, :x.shape[1]]
    xh, xl = tf32_split(x.float())
    wh, wl = tf32_split(w.float())
    acc = None
    for s in range(0, x.shape[1], k):
        a, b, c, d = xh[:, s:s + k], xl[:, s:s + k], wh[:, s:s + k], \
            wl[:, s:s + k]
        part = a @ d.T + b @ c.T + a @ c.T
        acc = part if acc is None else acc + part
    return acc


def test_3xtf32_stage_sums_keep_the_k3_f32_limit():
    """K3's plain version at the canonical f32 student (W256, D88, 16
    samples, L=10, ``init_r2l`` seed 0) with its head and body products as
    K3 f32 computes them (3xTF32, each 16-channel weight stage summed
    apart and added in f32), on 1,024 of a step's rays (every 80th of
    ``chip_smoke.train_points``), against the true-f32 plain version: rgb
    and every one of the 87 stash rows within ``TOL_TRAIN_F32``, and not
    equal to it. The emulation rounds where the tensor cores truncate, so
    it checks the sums' order, not the card's margin (``chip_smoke.py``'s
    ``[margin]`` lines)."""
    from r2l_tpu_torch.sampler import PointSampler
    cfg = R2LConfig()   # the CLI default compute dtype, f32
    model = init_r2l(cfg, torch.Generator().manual_seed(cs.SEED), CPU)
    sampler = PointSampler(H=cs.H, W=cs.W, focal=cs.FOCAL,
                           n_sample=cs.N_SAMPLE, near=2.0, far=6.0)
    pts = cs.train_points(cfg, sampler, CPU)[::80].contiguous()
    assert pts.shape == (1024, 3 * cs.N_SAMPLE)
    dp = 3 * cs.N_SAMPLE
    fp = F.prepare_fused_params_pe(model, cfg, dp, cs.EMBED_L,
                                   weight_dtype=torch.float32, stage=False)
    rgb, stash = T.train_fwd_ref(fp, cfg, pts, dp, cs.EMBED_L)
    rgb_e, stash_e = T.train_fwd_ref(fp, cfg, pts, dp, cs.EMBED_L,
                                     mm=_mm_3xtf32_stages)
    e_rgb = float((rgb_e.double() - rgb.double()).abs().max())
    rows = (stash_e.double() - stash.double()).abs().amax(dim=(1, 2))
    worst = float(rows.max())
    print(f"K3 f32 stage sums (CPU emulation): rgb {e_rgb:.3e}, stash worst "
          f"{worst:.3e} at row {int(rows.argmax())} "
          f"({worst / cs.TOL_TRAIN_F32:.0%} of {cs.TOL_TRAIN_F32:.0e})")
    assert rows.numel() == 2 * cfg.num_blocks + 1 == 87
    assert e_rgb <= cs.TOL_TRAIN_F32 and worst <= cs.TOL_TRAIN_F32
    assert worst > 0, "the emulation changed nothing"


def test_chain_l2_bytes_and_scratch_follow_the_clusters():
    """A launch reads the staged image once per 2-block cluster: a 400x400
    frame's 160,000 rays are 625 clusters in bf16 (1,250 blocks of 128
    rays) and 1,250 in f32 (2,500 blocks of 64); a half-empty last cluster
    counts whole. The h0 scratch holds a [rows x W] tile per block of the
    padded grid, none without the global residual."""
    bf, f32 = torch.bfloat16, torch.float32
    for wd, clusters in ((bf, 625), (f32, 1250)):
        cfg, _ = _model(256, wd)
        img = F.chain_stage_plan(cfg, wd)["nbytes"]
        assert F.chain_l2_bytes(cfg, wd, 160_000) == clusters * img
        assert F.chain_l2_bytes(cfg, wd, 1) == img
    cfg, _ = _model(256, bf)
    img = F.chain_stage_plan(cfg, bf)["nbytes"]
    assert F.chain_l2_bytes(cfg, bf, 129) == img
    assert F.chain_l2_bytes(cfg, bf, 257) == 2 * img
    cfg32, _ = _model(256, f32)
    img32 = F.chain_stage_plan(cfg32, f32)["nbytes"]
    assert F.chain_l2_bytes(cfg32, f32, 257) == 3 * img32
    # the canonical student: 11.8 MB bf16, 47.2 MB of f32 hi/lo
    canon = R2LConfig(compute_dtype=bf)
    assert F.chain_stage_plan(canon, bf)["nbytes"] == \
        (1024 + 86 * 256) * 256 * 2
    assert F.chain_stage_plan(canon, f32)["nbytes"] == \
        (1024 + 86 * 256) * 256 * 8
    for wd, n, blocks in ((bf, 1, 2), (bf, 257, 4), (f32, 1, 2),
                          (f32, 257, 6)):
        rows = F.CHAIN_BLOCK_RAYS[wd]
        h0 = F._chain_scratch(cfg, wd, n, CPU)
        assert h0.dtype == wd and h0.numel() == blocks * rows * 256
    flat = R2LConfig(input_dim=DP * (2 * L + 1), netdepth=8, netwidth=256,
                     use_residual=False)
    assert F._chain_scratch(flat, bf, 1000, CPU).numel() == 0


def test_fields_stay_jax_and_the_image_stays_beside_them():
    """``FusedParams``' fields are the JAX package's six; the staged image
    is not among them, ``_replace`` keeps it unless given ``staged=``."""
    cfg, model = _model(64, torch.bfloat16)
    fp = _pack("pe", model, cfg, torch.bfloat16)
    assert fp._fields == ("head_w", "head_b", "body_w", "body_b", "tail_w",
                          "tail_b")
    assert len(tuple(fp)) == 6
    assert fp._replace(head_b=fp.head_b.clone()).staged is fp.staged
    assert fp._replace(staged=None).staged is None
    assert torch.equal(fp.staged, F.stage_chain_weights(fp))


def test_the_training_packing_does_not_stage(monkeypatch):
    """The distillation step's packing for K3 stages K1's image of the live
    weights, once per step (``r2l_train._run_fwd``), as K5's image is
    staged once per step (``stage_bwd_weights``); and K3 on a tensor that
    is not on the CPU (here the meta device, which no kernel runs on)
    raises without that image, before it builds or launches anything."""
    cfg, model = _model(64, torch.bfloat16)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = F.stage_chain_weights, T.stage_bwd_weights

    def fwd(fp):
        calls["fwd"] += 1
        return real_fwd(fp)

    def bwd(w):
        calls["bwd"] += 1
        return real_bwd(w)
    monkeypatch.setattr(F, "stage_chain_weights", fwd)
    monkeypatch.setattr(T, "stage_bwd_weights", bwd)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(
        -2, 2, (32, DP)).astype(np.float32))
    apply = T.make_fused_train_apply(cfg, DP, L, group_blocks=2)
    for step in (1, 2):
        rgb = apply(model, pts)
        rgb.square().mean().backward()
        assert calls == {"fwd": step, "bwd": step}
    spec = T._Spec(cfg, DP, L, 2, torch.bfloat16, False, False)
    _, _, body_w, scales = T._run_fwd(spec, model, None, pts)
    assert calls["fwd"] == 3 and scales is None
    fp = F.prepare_fused_params_pe(model, cfg, DP, L)
    assert torch.equal(fp.staged, real_fwd(fp))
    meta = torch.device("meta")
    bare = F.FusedParams(*(t.to(meta) for t in fp))
    assert bare.staged is None
    with pytest.raises(ValueError, match="image"):
        T.train_fwd(bare, cfg, pts.to(meta), DP, L)
    short = bare._replace(staged=torch.zeros(16, dtype=torch.uint8,
                                             device=meta))
    with pytest.raises(ValueError, match="staged"):
        T.train_fwd(short, cfg, pts.to(meta), DP, L)
