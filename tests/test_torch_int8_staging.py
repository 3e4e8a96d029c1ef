"""K2's staged s8 weight image (``stage_int8_chain``), on the CPU.

K2 on Hopper (``csrc/r2l_int8_hopper.cuh``) reads ``head_q`` and ``body_q``
from an image staged once per model where the frames calibrate: each
layer in stages of 128 input channels (64 at W64) for all its outputs,
laid out as wgmma reads an s8 B operand (K-major 8-row x 16-byte core
matrices). Here the image is unpacked again and held to the packed fields
bit for bit, the layout to the core-matrix formula, the JAX fields to
their own twelve, and the per-step calibration of the int8 training kinds
(for K4/K8, which read the fields) to making no image."""
import numpy as np
import pytest
import torch

from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.models import R2LConfig, init_r2l

CPU = torch.device("cpu")
DP, L = 12, 10   # 252 input columns, padded to 256


def _calibrated(W, fold_requant=True, stage=True, nl=2, netdepth=8):
    cfg = R2LConfig(input_dim=DP * (2 * L + 1), netdepth=netdepth,
                    netwidth=W, n_learnable=nl, compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(W), CPU)
    calib = torch.from_numpy(np.random.default_rng(W).uniform(
        -2, 2, (256, DP)).astype(np.float32))
    fp = F.calibrate_r2l_int8_pe(model, cfg, DP, L, calib,
                                 fold_requant=fold_requant, stage=stage)
    return cfg, model, calib, fp


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("fold_requant", [True, False])
def test_int8_image_unpacks_bit_for_bit(W, fold_requant):
    """The image holds ``head_q`` (freq-major rows, zero-padded columns)
    and every body layer's ``body_q``, then the epilogue table of the
    head's and the body's (m, b), each bit for bit; its size and stage
    count are ``int8_chain_stage_plan``'s, the weights a multiple of 16
    bytes (the table starts aligned)."""
    cfg, _, _, fp = _calibrated(W, fold_requant)
    plan = F.int8_chain_stage_plan(cfg, DP, L)
    assert plan["stage_k"] == (64 if W == 64 else 128)
    assert plan["kpad"] == 256
    assert fp.staged.dtype == torch.uint8
    assert fp.staged.numel() == plan["nbytes"]
    assert plan["weights_bytes"] % 16 == 0
    assert plan["stages"] == (256 + 6 * W) // plan["stage_k"]
    assert plan["table_bytes"] == 7 * W * 8
    got = F.unstage_int8_chain(fp.staged, cfg, DP, L)
    assert sorted(got) == ["body_b", "body_m", "body_q", "head_b", "head_m",
                           "head_q"]
    for name in got:
        want = getattr(fp, name)
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        assert torch.equal(got[name], want), name


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("stash_q", [True, False])
def test_int8_train_image_unpacks_bit_for_bit(W, stash_q):
    """K4's and K8's image (``stage_int8_train``, after each calibration of
    the int8 training kinds) holds K2's fields at the kind's stage width (64
    input channels for K4 at W256, whose f32 residual stream leaves a 64 KB
    ring; K2's elsewhere), then every body layer's inverse input scale,
    each bit for bit; its size is ``int8_train_stage_plan``'s, it is marked
    for its kernel, and the calibration's fields are untouched."""
    cfg, _, _, bare = _calibrated(W, fold_requant=False, stage=False)
    fp = F.stage_int8_train(bare, cfg, DP, L, stash_q)
    plan = F.int8_train_stage_plan(cfg, DP, L, stash_q)
    k = 64 if W == 64 or (W == 256 and stash_q) else 128
    assert plan["stage_k"] == k and plan["stage_bytes"] == W * k
    assert plan["stages"] == (256 + 6 * W) // k
    assert fp.staged_for == ("K4" if stash_q else "K8")
    assert fp.staged.dtype == torch.uint8
    assert fp.staged.numel() == plan["nbytes"] == (
        F.int8_chain_stage_plan(cfg, DP, L)["nbytes"] + 6 * W * 4)
    got = F.unstage_int8_train(fp.staged, cfg, DP, L, stash_q)
    assert sorted(got) == ["body_b", "body_inv", "body_m", "body_q",
                           "head_b", "head_m", "head_q"]
    for name in got:
        want = getattr(fp, name)
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        assert torch.equal(got[name], want), name
    for a, b in zip(fp, bare):
        assert a is b


def _fma32(x, m, b):
    """f32 x * m + b as the card's ``__fmaf_rn`` (x * m exact in float64;
    one rounding of the sum to float64, then to f32, as ``_dequant``)."""
    return (x.astype(np.float64) * m + b).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def test_training_tails_equal_the_plain_version():
    """K4's and K8's block tails and K4's inner requantize as the kernel
    computes them (``csrc/r2l_int8_hopper.cuh``, kTrainQ / kTrainB: the
    int32 sum back by an add of 1.5 * 2^23, the one-FMA dequantize, q8b's
    clip-then-add), emulated in f32, equal ``train_fwd_int8_ref``'s
    arithmetic bit for bit: K8 h = bf16(t2 + float(h)) rounded once from
    the f32 t2; K4 h = t2 + h in f32 and the next input q8(h * inv); K4's
    inner q8(relu(t) * inv), no bf16. K2's tail (t2 rounded to bf16, then
    one bf16 add) is another function: it differs from K8's on some of
    these inputs, so K8 cannot reuse it."""
    rng = np.random.default_rng(2)
    n, lim = 200_000, 256 * 127 * 127
    acc = rng.integers(-lim, lim + 1, n).astype(np.int32)
    m = (rng.uniform(0.5, 2.0, n) * 2e-5).astype(np.float32)
    b = rng.normal(0.0, 0.5, n).astype(np.float32)
    inv = rng.uniform(2.0, 60.0, n).astype(np.float32)
    h_bf = _bf16(rng.normal(0.0, 3.0, n).astype(np.float32))
    h32 = rng.normal(0.0, 3.0, n).astype(np.float32)
    magic = np.float32(12582912.0)
    i2f = (np.int32(0x4B400000) + acc).view(np.float32) - magic
    t2 = _fma32(i2f, m, b)                       # the kernel's t2 (f32)

    def q8b(y):
        bits = (np.clip(y, -127, 127).astype(np.float32) + magic).view(
            np.int32)
        return (bits & 0xFF).astype(np.uint8).view(np.int8)

    # the plain version's pieces (r2l_train.train_fwd_int8_ref)
    acc_t = torch.from_numpy(acc.astype(np.float32))
    t2_p = F._dequant(acc_t, torch.from_numpy(m), torch.from_numpy(b))
    assert np.array_equal(t2, t2_p.numpy())
    # K8: one rounding of the f32 sum
    k8 = _bf16((t2 + h_bf.float().numpy()).astype(np.float32))
    assert torch.equal(k8, (t2_p + h_bf.float()).to(torch.bfloat16))
    # K2's tail on the same inputs: another value on some of them
    k2 = (torch.from_numpy(t2).to(torch.bfloat16).float()
          + h_bf.float()).to(torch.bfloat16)
    assert not torch.equal(k2, k8)
    # K4: h in f32, then the next block's input
    h4 = (t2 + h32).astype(np.float32)
    h4_p = t2_p + torch.from_numpy(h32)
    assert np.array_equal(h4, h4_p.numpy())
    q4 = q8b((h4 * inv).astype(np.float32))
    assert np.array_equal(q4, F._q8(h4_p, torch.from_numpy(inv)).to(
        torch.int8).numpy())
    # K4's inner layer: relu, the f32 multiply, no bf16
    qi = q8b((np.maximum(t2, 0) * inv).astype(np.float32))
    want = F._q8(torch.relu(t2_p), torch.from_numpy(inv)).to(torch.int8)
    assert np.array_equal(qi, want.numpy())


@pytest.mark.parametrize("W", [64, 256])
def test_int8_stages_are_s8_core_matrices(W):
    """Stage s of a layer: byte b of output row n at ((n//8) * (B//16) +
    b//16) * 128 + (n%8) * 16 + b%16, B = the stage's input channels (one
    byte each); the head's stages first (its columns in
    ``int8_head_columns``' order), then the body's, layer by layer."""
    cfg, _, _, fp = _calibrated(W)
    plan = F.int8_chain_stage_plan(cfg, DP, L)
    cols = F.int8_head_columns(cfg, DP, L)
    head = torch.zeros((W, plan["kpad"]), dtype=torch.int8)
    head[:, cols >= 0] = fp.head_q[:, cols[cols >= 0]]
    k, sb = plan["stage_k"], plan["stage_bytes"]
    assert sb == W * k
    head_stages = plan["kpad"] // k
    per_layer = W // k
    for start, w, st in ((0, head, 0), (0, head, head_stages - 1),
                         (head_stages * sb, fp.body_q[0], 0),
                         ((head_stages + 3 * per_layer) * sb, fp.body_q[3],
                          per_layer - 1)):
        rows = _bytes(w[:, st * k:(st + 1) * k]).reshape(W, k)
        base = start + st * sb
        for n_, b in [(0, 0), (5, 17), (9, 100 % k), (W - 1, k - 1),
                      (W // 2, 33)]:
            off = base + ((n_ // 8) * (k // 16) + b // 16) * 128 + \
                (n_ % 8) * 16 + b % 16
            assert fp.staged[off] == rows[n_, b], (st, n_, b)


def test_int8_fields_stay_jax_and_the_image_stays_beside_them():
    """``FusedParamsInt8PE``'s fields are the JAX package's twelve (the
    parity tests compare them field by field, and the probes' launcher
    passes them in order); the image is not among them, and ``_replace``
    keeps it unless given ``staged=``."""
    cfg, _, _, fp = _calibrated(64)
    assert fp._fields == ("head_q", "head_m", "head_b", "head_inv",
                          "body_q", "body_m", "body_b", "body_inv",
                          "tail_q", "tail_m", "tail_b", "tail_inv")
    assert len(tuple(fp)) == 12
    assert all(isinstance(x, torch.Tensor) for x in fp)
    assert fp._replace(head_b=fp.head_b.clone()).staged is fp.staged
    assert fp._replace(staged=None).staged is None
    assert torch.equal(fp.staged, F.stage_int8_chain(fp, cfg, DP, L))
    # an unstaged calibration has the same fields, bit for bit
    _, _, _, bare = _calibrated(64, stage=False)
    assert bare.staged is None
    for a, b in zip(fp, bare):
        assert torch.equal(a, b)


def test_k2_without_its_image_raises():
    """K2's launcher refuses a calibration without the s8 image before it
    builds or launches anything (on the card, a frame from an unstaged
    ``fp`` raises; there is no fallback)."""
    cfg, _, _, fp = _calibrated(64, stage=False)
    pts = torch.zeros((4, DP), dtype=torch.float32)
    with pytest.raises(ValueError, match="staged"):
        F._launch_int8_hopper(fp, cfg, pts, DP, L, F.EPILOGUES["deployed"])
    with pytest.raises(ValueError, match="staged"):
        F._launch_int8_hopper(fp._replace(staged=torch.zeros(
            16, dtype=torch.uint8)), cfg, pts, DP, L, 0)


def test_the_frame_calibration_stages_and_training_does_not(monkeypatch):
    """The int8 frame's packing (``evaluate._prepare_r2l``, once per model)
    stages K2's image; the int8 training kinds' calibration, every step,
    stages K4's or K8's own instead (``stage_int8_train``, once per
    calibration, marked for its kernel). K4/K8 on a tensor that is not on
    the CPU (the meta device) raise without their image, or with K2's or
    the other kind's, before they build or launch anything."""
    from r2l_tpu_torch.evaluate import _prepare_r2l
    from r2l_tpu_torch.sampler import PointSampler
    cfg = R2LConfig(input_dim=DP * (2 * L + 1), netdepth=8, netwidth=256,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), CPU)
    sampler = PointSampler(H=16, W=16, focal=20.0, n_sample=DP // 3,
                           near=2.0, far=6.0)
    prepared, kind, _ = _prepare_r2l(model, cfg, sampler, L, False, True,
                                     "int8")
    assert kind == "int8" and prepared.staged_for == "K2"
    assert torch.equal(prepared.staged,
                       F.stage_int8_chain(prepared, cfg, DP, L))

    calls = []
    real = F.stage_int8_train

    def count(fp, cfg, dp, L, stash_q):
        calls.append(stash_q)
        return real(fp, cfg, dp, L, stash_q)
    monkeypatch.setattr(T, "stage_int8_train", count)
    calib = torch.from_numpy(np.random.default_rng(1).uniform(
        -2, 2, (64, DP)).astype(np.float32))
    meta = torch.device("meta")
    pts = torch.zeros((4, DP), dtype=torch.float32, device=meta)
    fps = {}
    for stash_q in (True, False):
        _, calibrate = T.make_fused_train_apply(
            cfg, DP, L, quantize="int8", calib_pts=calib,
            stash_q=stash_q, external_calib=True)
        fp = fps[stash_q] = calibrate(model)
        assert calls[-1] is stash_q
        assert fp.staged_for == ("K4" if stash_q else "K8")
        assert torch.equal(fp.staged, real(fp, cfg, DP, L, stash_q).staged)
    assert calls == [True, False]
    # at W256 the two kinds' images differ (64- and 128-channel stages)
    assert not torch.equal(fps[True].staged, fps[False].staged)

    def on_meta(fp, **kw):
        moved = F.FusedParamsInt8PE(*(t.to(meta) for t in fp))
        return moved._replace(**kw) if kw else moved
    for stash_q in (True, False):
        fp = fps[stash_q]
        for bad in (on_meta(fp), on_meta(fp, staged=fp.staged.to(meta),
                                         staged_for="K2"),
                    on_meta(fp, staged=fp.staged.to(meta),
                            staged_for="K8" if stash_q else "K4")):
            with pytest.raises(ValueError, match="image"):
                T.train_fwd_int8(bad, cfg, pts, DP, L, stash_q=stash_q)


@pytest.mark.parametrize("W,dp,L,kpad", [(256, 48, 10, 1024),
                                         (128, 48, 10, 1024),
                                         (64, 48, 10, 1024),
                                         (64, 6, 4, 64), (256, 12, 10, 256),
                                         (64, 12, 10, 256)])
def test_head_columns_hold_whole_scalars(W, dp, L, kpad):
    """K2's head is staged in slices of 2W columns, each holding whole
    scalars' P = 2L+1 parts (so each scalar's ladder runs in one slice):
    every freq-major column appears once, at p*ns + sl of its slice (ns
    the slice's scalars), the rest are zero columns; the last slice is rounded up to whole stages
    (128 columns, 64 at W64), so the canonical student's head keeps its
    1,024 columns at every width."""
    cfg = R2LConfig(input_dim=dp * (2 * L + 1), netwidth=W)
    cols = F.int8_head_columns(cfg, dp, L)
    P, sw = 2 * L + 1, 2 * W
    sps = sw // P
    assert cols.numel() == kpad
    assert sorted(cols[cols >= 0].tolist()) == list(range(dp * P))
    for j in torch.nonzero(cols >= 0).flatten().tolist():
        i, within = divmod(j, sw)
        ns = min(sps, dp - i * sps)
        p, sl = divmod(within, ns)
        assert cols[j] == p * dp + i * sps + sl


def test_int8_l2_bytes_follow_the_clusters():
    """A K2 launch reads the s8 image once per 2-block cluster of 128-ray
    blocks: a 400x400 frame's 160,000 rays are 625 clusters, 3.69 GB of the
    canonical student's 5.9 MB image (the old chain read it once per 64
    rays: 14.7 GB)."""
    canon = R2LConfig(compute_dtype=torch.bfloat16)
    img = F.int8_chain_stage_plan(canon, 48, 10)["weights_bytes"]
    assert img == (1024 + 86 * 256) * 256
    assert F.int8_chain_l2_bytes(canon, 48, 10, 160_000) == 625 * img
    assert F.int8_chain_l2_bytes(canon, 48, 10, 1) == img
    assert F.int8_chain_l2_bytes(canon, 48, 10, 257) == 2 * img
    assert 625 * img == 3_686_400_000
    assert 2500 * img == 14_745_600_000


def test_epilogue_adds_equal_the_conversions():
    """K2's epilogue rounds by adds of 1.5 * 2^23 (``i2f``, ``q8b``,
    ``q8b_relu`` in ``csrc/r2l_int8_hopper.cuh``), emulated here in f32:
    a body layer's int32 sum (|acc| <= 256 * 127 * 127 < 2^22) comes back
    exactly as its f32 value, and clip-then-add gives the integer of
    round-half-even-then-clip (``_q8``) in the low byte, ties included."""
    rng = np.random.default_rng(0)
    lim = 256 * 127 * 127
    acc = np.concatenate([rng.integers(-lim, lim + 1, 200_000),
                          [-lim, lim, 0, 1, -1]]).astype(np.int32)
    magic = np.float32(12582912.0)
    back = (np.int32(0x4B400000) + acc).view(np.float32) - magic
    assert np.array_equal(back, acc.astype(np.float32))
    y = np.concatenate([rng.uniform(-300, 300, 200_000),
                        np.arange(-130, 131) + 0.5,
                        np.arange(-130, 131).astype(np.float64)]
                       ).astype(np.float32)
    want = np.clip(np.rint(y), -127, 127).astype(np.int32)
    bits = (np.clip(y, -127, 127).astype(np.float32) + magic).view(np.int32)
    assert np.array_equal((bits & 0xFF).astype(np.uint8).view(np.int8),
                          want.astype(np.int8))
    relu = (np.minimum(np.maximum(y, 0), 127).astype(np.float32)
            + magic).view(np.int32)
    assert np.array_equal((relu & 0xFF).astype(np.uint8).view(np.int8),
                          np.clip(np.rint(np.maximum(y, 0)), -127,
                                  127).astype(np.int8))
    assert torch.equal(F._q8(torch.from_numpy(y)).to(torch.int32),
                       torch.from_numpy(want))


def _bf16_rne(x: float) -> float:
    """x (exact in float64) rounded once to bf16, ties to even."""
    import math
    if x == 0.0:
        return 0.0
    m, e = math.frexp(x)            # x = m * 2^e, 0.5 <= |m| < 1
    return round(m * 256.0) * 2.0 ** (e - 8)


def test_bf16_add_rounds_once():
    """K2's block tail adds two bf16 values with one bf16 add (``__hadd2``:
    the exact sum rounded once); the plain version adds them in f32 and
    rounds to bf16. The two agree on every pair: an f32 rounding of such a
    sum never lands on a bf16 tie. Checked on 100,000 pairs whose exponents
    lie up to 40 apart (their sums exact in float64), ties included."""
    rng = np.random.default_rng(1)
    n = 100_000
    a = torch.from_numpy(rng.standard_normal(n) * 2.0 ** rng.integers(
        -20, 20, n)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(n) * 2.0 ** rng.integers(
        -20, 20, n)).to(torch.bfloat16)
    b[:64] = a[:64] * 2.0 ** -8              # sums on a bf16 tie
    f32 = (a.float() + b.float()).to(torch.bfloat16).float().numpy()
    once = np.array([_bf16_rne(float(x) + float(y))
                     for x, y in zip(a.double().numpy(),
                                     b.double().numpy())])
    assert np.array_equal(f32.astype(np.float64), once)
