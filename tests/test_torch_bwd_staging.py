"""K5's staged weight image (``stage_bwd_weights``) and an emulation of its
Hopper passes' arithmetic, on the CPU.

The dh walk of K5 on Hopper (``csrc/r2l_bwd_hopper.cuh``) reads every body
layer's transpose from one image made once per training step: here it is
unpacked again and held to ``body_w`` bit for bit (f32: its TF32 high and
low parts), and ``_bwd_core`` is held to staging once per step for all its
groups. The kernel's sums differ from the plain version's in order only:
dW over ray ranges added in order; db the same for bf16 weights (a product
against ones in the dW pass), for f32 weights pass 1's column sums (two
rows a thread, a butterfly over the warp's eight row pairs, the four warps,
then the 64-ray tiles, in order); and, for f32 weights, the dh products
and dW as 3xTF32 (dW 32 rays a stage, the stages' sums added in order). An
emulation of those orders and splits through the plain version is held to
a small share of ``chip_smoke.py``'s K5 limits (``TOL_GRAD_F32``,
``TOL_GRAD_BF16``, ``MAX_BAD_BF16``) against ``bwd_group_ref``. It sums in
round-to-nearest f32, where the tensor cores truncate, so it checks the
design's arithmetic, not the card's margin: that is ``chip_smoke.py``'s
``[margin]`` reading (K5 f32's walk against float64 and over seeds)."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.kernels.staging import tf32_split
from r2l_tpu_torch.models import R2LConfig, init_r2l

CPU = torch.device("cpu")
DP, L = 12, 4


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_bwd_image_unpacks_to_the_weights(W, wd):
    """The image holds every layer's W^T in ``CHAIN_STAGE_K`` stages:
    unpacked, bf16 equals body_w bit for bit; f32 gives the TF32 split of
    body_w (high, low), each bit for bit."""
    g = torch.Generator().manual_seed(W)
    body_w = torch.randn((6, W, W), generator=g).to(wd)
    img = T.stage_bwd_weights(body_w)
    parts = 2 if wd == torch.float32 else 1
    assert img.dtype == torch.uint8
    assert img.numel() == 6 * W * W * body_w.element_size() * parts
    got = T.unstage_bwd_weights(img, tuple(body_w.shape), wd)
    want = tf32_split(body_w) if wd == torch.float32 else (body_w,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == body_w.shape
        assert torch.equal(_bytes(a), _bytes(b))


def test_bwd_stages_are_wgmma_core_matrices():
    """Layer l's stage s holds input channels [s*64, (s+1)*64) of W^T's
    rows (body_w's columns) for all W outputs of the product dt W^T: byte b
    of row i at ((i//8) * 8 + b//16) * 128 + (i%8) * 16 + b%16."""
    W = 128
    body_w = torch.randn((4, W, W), generator=torch.Generator().manual_seed(
        3)).to(torch.bfloat16)
    img = T.stage_bwd_weights(body_w)
    k, B = F.CHAIN_STAGE_K[torch.bfloat16], 128
    layer = W * W * 2
    for l_, st in ((0, 0), (1, 1), (3, 0)):
        rows = _bytes(body_w[l_].T[:, st * k:(st + 1) * k]).reshape(W, B)
        base = l_ * layer + st * W * B
        for i, b in [(0, 0), (5, 17), (9, 100), (127, 127), (64, 33)]:
            off = base + ((i // 8) * (B // 16) + b // 16) * 128 + \
                (i % 8) * 16 + b % 16
            assert img[off] == rows[i, b], (l_, st, i, b)


def test_the_step_stages_once_for_all_groups(monkeypatch):
    """``_bwd_core`` makes K5's image once per step and hands the same one
    to every group's call (here 3 groups of at most 2 blocks)."""
    cfg = R2LConfig(input_dim=DP * (2 * L + 1), netdepth=12, netwidth=64,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), CPU)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(
        -2, 2, (40, DP)).astype(np.float32))
    spec = T._Spec(cfg, DP, L, 2, torch.bfloat16, False, False)
    rgb, stash, body_w, scales = T._run_fwd(spec, model, None, pts)
    made, seen = [], []
    real_stage, real_group = T.stage_bwd_weights, T.bwd_group

    def stage(w):
        made.append(real_stage(w))
        return made[-1]

    def group(*args, staged=None, **kw):
        seen.append(staged)
        return real_group(*args, staged=staged, **kw)
    monkeypatch.setattr(T, "stage_bwd_weights", stage)
    monkeypatch.setattr(T, "bwd_group", group)
    grads = T._bwd_core(spec, model, pts, stash, rgb, body_w, scales,
                        torch.ones_like(rgb))
    assert len(made) == 1 and len(seen) == 3
    assert all(s is made[0] for s in seen)
    assert all(torch.isfinite(g).all() for g in grads)


def _db_kernel_order(dt: torch.Tensor) -> torch.Tensor:
    """Column sums of dt [n, W] in pass 1's order (f32 weights): per 64-ray
    tile, rows r and r + 8 of each warp's 16 summed, then the warp's eight
    pairs by a butterfly (lane bits 4, 8, 16: g bits 0, 1, 2), then the four
    warps in order; then the tiles in order (pass 3)."""
    n, W = dt.shape
    tiles = -(-n // 64)
    x = torch.zeros((tiles * 64, W), dtype=torch.float32)
    x[:n] = dt.float()
    x = x.view(tiles, 4, 2, 8, W)            # tile, warp, h, g, column
    s = x[:, :, 0] + x[:, :, 1]              # [tiles, 4, 8, W]
    for bit in (1, 2, 4):                    # xor over g's bits
        idx = torch.arange(8) ^ bit
        s = s + s[:, :, idx]
    s = s[:, :, 0]                           # [tiles, 4, W]
    w = s[:, 0]
    for k in range(1, 4):
        w = w + s[:, k]
    out = torch.zeros(W, dtype=torch.float32)
    for t in range(tiles):
        out = out + w[t]
    return out


def _mm(cd):
    """dt [n, W] times w [out, in] -> dt w: f32 sums of exact bf16
    products, or 3xTF32 for f32 weights (dt split as the kernel splits its
    A fragments, w as the image holds it)."""
    def mm(a, w):
        if cd == torch.bfloat16:
            return a.float() @ w.float()
        ah, al = tf32_split(a.float())
        wh, wl = tf32_split(w.float())
        return ah @ wl + al @ wh + ah @ wh
    return mm


def _emulate(body_w, stash, dh, cfg, b_start, b_count, body_scale, splits):
    """``bwd_group_ref`` with K5's orders: the dh products through ``_mm``,
    dh + (dt1 W1^T) as the kernel adds it, dW (and bf16's db) as the
    ranges' partials added in order (f32 weights: each range's dW as
    3xTF32 products of 32-ray stages added in order), f32's db in pass 1's
    order."""
    cd, nb, rs = body_w.dtype, cfg.num_blocks, cfg.res_scale
    W, n = cfg.netwidth, dh.shape[0]
    mm = _mm(cd)
    per = -(-n // splits)
    dw = torch.empty((2 * b_count, W, W))
    db = torch.empty((2 * b_count, W))

    def dw_of(g, a):
        out = torch.zeros((W, W))
        for s in range(splits):
            gs, as_ = g[s * per:(s + 1) * per], a[s * per:(s + 1) * per]
            if cd == torch.bfloat16:
                out = out + gs.float().T @ as_.float()
                continue
            part = torch.zeros((W, W))
            for r in range(0, gs.shape[0], 32):
                part = part + mm(gs[r:r + 32].float().T,
                                 as_[r:r + 32].float())
            out = out + part
        return out

    def db_of(g):
        if cd == torch.float32:
            return _db_kernel_order(g)
        out = torch.zeros(W)
        for s in range(splits):
            out = out + g[s * per:(s + 1) * per].float().sum(0)
        return out
    for k in range(b_count - 1, -1, -1):
        b = b_start + k
        h_in, t1r, mask = T._group_inputs(stash, nb, b, cd, body_scale)
        dt2 = (dh * rs).to(cd)
        dw[2 * k + 1], db[2 * k + 1] = dw_of(dt2, t1r), db_of(dt2)
        dt1 = torch.where(mask, mm(dt2, body_w[2 * b + 1]), 0.0).to(cd)
        dw[2 * k], db[2 * k] = dw_of(dt1, h_in), db_of(dt1)
        dh = dh + mm(dt1, body_w[2 * b])
    return dh, dw, db


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32", "f32_bf16stash"])
def test_kernel_order_emulation_stays_far_inside_the_limits(kind):
    """K5's orders (and 3xTF32 for f32 weights) through the plain version,
    at W128, 8 blocks in groups of 4, 1,000 rays, against
    ``bwd_group_ref``: the worst norm-relative error uses under a tenth of
    the card's limit, the share of entries off by more than 5e-2 of the
    largest under a tenth of ``MAX_BAD_BF16``. The shares are printed. The
    emulation rounds to nearest where the tensor cores truncate: it holds
    the design's orders and splits, not the card's reading."""
    W, nb, n = 128, 8, 1000
    cd = torch.float32 if kind.startswith("f32") else torch.bfloat16
    cfg = R2LConfig(input_dim=DP * (2 * L + 1), netdepth=2 * nb + 2,
                    netwidth=W, compute_dtype=cd)
    model = init_r2l(cfg, torch.Generator().manual_seed(1), CPU)
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.uniform(-2, 2, (n, DP)).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((n, W)).astype(np.float32))
    scale = None
    if kind == "int8" or kind == "f32_bf16stash":
        fp8 = F.calibrate_r2l_int8_pe(model, cfg, DP, L, pts[:256],
                                      fold_requant=False, stage=False)
        _, stash = T.train_fwd_int8_ref(fp8, cfg, pts, DP, L,
                                        stash_q=kind == "int8")
        scale = 1.0 / fp8.body_inv if kind == "int8" else None
    else:
        fp = F.prepare_fused_params_pe(model, cfg, DP, L, weight_dtype=cd,
                                       stage=False)
        _, stash = T.train_fwd_ref(fp, cfg, pts, DP, L)
    body_w = torch.stack([m.weight.detach() for m in model.linears()[1]]
                         ).to(cd)
    splits = 3
    worst = [0.0, 0.0]
    g = dh
    for b0 in (4, 0):
        want = T.bwd_group_ref(body_w, stash, g, cfg, b0, 4, scale)
        got = _emulate(body_w, stash, g, cfg, b0, 4, scale, splits)
        for a, b in zip(got, want):
            rel, bad = cs.grad_err(a, b)
            worst = [max(worst[0], rel), max(worst[1], bad)]
        g = want[0]
    f32 = cd == torch.float32
    tol = cs.TOL_GRAD_F32 if f32 else cs.TOL_GRAD_BF16
    print(f"K5 order emulation, {kind}: norm-relative {worst[0]:.3e} "
          f"({worst[0] / tol:.2%} of {tol:.0e}), share off {worst[1]:.2e}")
    assert worst[0] <= 0.1 * tol, worst
    assert f32 or worst[1] <= 0.1 * cs.MAX_BAD_BF16, worst


@pytest.mark.parametrize("stash_dtype", [torch.float32, torch.bfloat16])
def test_the_float64_walk_is_the_plain_walk(stash_dtype):
    """``chip_smoke.k5_walk_f64``, the exact reference of K5 f32's margin
    on the card, is the plain walk (``bwd_group_ref`` group by group) in
    float64: its (dh, dW, db) in the plain version's layer order and
    shapes, within f32 rounding of the plain walk but not equal to it."""
    W, nb, n = 64, 4, 300
    cfg = R2LConfig(input_dim=DP * (2 * L + 1), netdepth=2 * nb + 2,
                    netwidth=W, compute_dtype=torch.float32)
    rng = np.random.default_rng(5)
    body_w = torch.from_numpy((rng.standard_normal((2 * nb, W, W)) / 8
                               ).astype(np.float32))
    stash = torch.from_numpy(rng.standard_normal((2 * nb + 1, n, W)).astype(
        np.float32)).to(stash_dtype)
    dh = torch.from_numpy(rng.standard_normal((n, W)).astype(np.float32))
    exact = cs.k5_walk_f64(body_w, stash, dh, cfg)
    g, dws, dbs = dh, [], []
    for b0 in (2, 0):
        g, dw, db = T.bwd_group_ref(body_w, stash, g, cfg, b0, 2)
        dws.insert(0, dw)
        dbs.insert(0, db)
    plain = (g, torch.cat(dws), torch.cat(dbs))
    for e, p in zip(exact, plain):
        assert e.dtype == torch.float64 and e.shape == p.shape
        assert 0 < cs.grad_err(p, e)[0] < 1e-6
