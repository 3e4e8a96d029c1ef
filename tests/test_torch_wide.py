"""The wide form of the student's frame kernels (K1, K9 and K2 above
netwidth 256: r2l_tpu_torch/kernels/csrc/r2l_wide.cu) on the CPU.

The grid: every (W, D, L, dtype) at which the JAX package renders a student
on its PE-fused or int8 kernel (its ``_pe_kernel_tile_fit`` > 0) is one the
port's frame kernels take, and the port's copy of that rule
(``evaluate._reference_fits``) is JAX's. The gate at the corner shapes
picks JAX's kind and packs for the wide form (the model's device read as
CUDA, nothing launched). On the CPU the wrappers run their plain versions:
those, on the wide packing, against JAX's kernels in interpret mode; a W300
student packed at 384 against its unpadded packing; the wide image's round
trip. tests/test_torch_cuda.py holds the CUDA kernels to the plain versions
on the card.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.evaluate as JE
from _torch_parity import int8_case, models, n, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu_torch import evaluate as TE
from r2l_tpu_torch.encoding import r2l_embed
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.models import R2L, R2LConfig
from r2l_tpu_torch.sampler import PointSampler
from test_torch_gates import TOL_KERNEL

DIM_PTS = 48   # 16 samples a ray
# (JAX compute dtype, the port's, the int8 kernel)
DTYPES = {"f32": (jnp.float32, torch.float32, False),
          "bf16": (jnp.bfloat16, torch.bfloat16, False),
          "int8": (jnp.bfloat16, torch.bfloat16, True)}
WIDTHS = range(257, 2201)
DEPTHS = range(4, 121, 2)
# The deepest student JAX renders on a kernel at L=10 (its tile fit):
# width -> (f32, bf16, int8); None where no depth fits.
DEEPEST = {384: (20, 44, 90), 512: (12, 24, 50), 1024: (None, 6, 12)}
# The widest JAX renders on a kernel at D4, L=10.
WIDEST_D4 = {"f32": 1015, "bf16": 1514, "int8": 2180}


@functools.lru_cache(maxsize=None)
def _grid(L: int, dtype: str) -> tuple:
    """Over W 257-2200 and even D 4-120: (W, D, JAX's tile fit > 0, the
    port's ``_reference_fits``, ``fused_frame_supported``)."""
    jd, td, q = DTYPES[dtype]
    in_dim = DIM_PTS * (2 * L + 1)
    rows = []
    for W in WIDTHS:
        for D in DEPTHS:
            jcfg = JaxR2LConfig(input_dim=in_dim, netdepth=D, netwidth=W,
                                compute_dtype=jd)
            cfg = R2LConfig(input_dim=in_dim, netdepth=D, netwidth=W,
                            compute_dtype=td)
            rows.append((W, D,
                         JE._pe_kernel_tile_fit(jcfg, DIM_PTS, 128,
                                                quantized=q) > 0,
                         TE._reference_fits(cfg, DIM_PTS, q),
                         F.fused_frame_supported(cfg, q, L)))
    return tuple(rows)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L", [4, 10])
def test_frame_kernels_take_every_shape_jax_renders_on_its_kernels(L, dtype):
    grid = _grid(L, dtype)
    on_kernel = [(W, D) for W, D, jax_fits, _, _ in grid if jax_fits]
    missing = [(W, D) for W, D, jax_fits, _, ours in grid
               if jax_fits and not ours]
    assert on_kernel and not missing, missing[:10]
    if L == 10:
        for W, deepest in DEEPEST.items():
            depths = [D for w, D in on_kernel if w == W]
            want = deepest[("f32", "bf16", "int8").index(dtype)]
            assert (max(depths) if depths else None) == want, W
        assert max(W for W, D in on_kernel if D == 4) == WIDEST_D4[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L", [4, 10])
def test_reference_fits_is_jaxs_rule(L, dtype):
    differ = [(W, D) for W, D, jax_fits, ref, _ in _grid(L, dtype)
              if jax_fits != ref]
    assert not differ, differ[:10]


# ---------------------------------------------------------------------------
# The gate at the corner shapes
# ---------------------------------------------------------------------------

CORNERS = [(384, 44, "bf16"), (512, 24, "bf16"), (512, 12, "f32"),
           (512, 50, "int8"), (1024, 6, "bf16"), (1024, 12, "int8"),
           (1514, 4, "bf16"), (2180, 4, "int8")]


def _jax_kind(jcfg, quantize: str) -> str:
    """JAX's ``_prepare_r2l`` kind for ``use_pallas`` (and int8), by its
    tile-fit rule: int8 where its int8 kernel fits, else pe where its
    PE-fused kernel fits, else the plain forward."""
    if quantize and JE._pe_kernel_tile_fit(jcfg, DIM_PTS, 512,
                                           quantized=True):
        return "int8"
    return "pe" if JE._pe_kernel_tile_fit(jcfg, DIM_PTS, 512) else "jnp"


@pytest.mark.parametrize("W,D,dtype", CORNERS)
def test_gate_sends_the_corner_shapes_to_the_wide_form(W, D, dtype,
                                                       monkeypatch, capsys):
    """``_prepare_r2l`` as on the card (the model's device read as CUDA,
    the calibration points and the packers stood in for: nothing is
    built): JAX's kind, no warning, and the packer reached with a student
    the frame kernels take on their wide form at the next multiple of
    128."""
    jd, td, q = DTYPES[dtype]
    quantize = "int8" if q else ""
    jcfg = JaxR2LConfig(netdepth=D, netwidth=W, compute_dtype=jd)
    cfg = R2LConfig(netdepth=D, netwidth=W, compute_dtype=td)
    want = _jax_kind(jcfg, quantize)
    assert want == ("int8" if q else "pe")
    packed = []
    monkeypatch.setattr(TE, "_model_device", lambda m: torch.device("cuda"))
    monkeypatch.setattr(TE, "_calibration_points",
                        lambda s, p, d: torch.zeros((8, DIM_PTS)))
    for name in ("calibrate_r2l_int8_pe", "prepare_fused_params_pe"):
        monkeypatch.setattr(TE, name, lambda m, c, *a, _n=name, **k:
                            packed.append((_n, c, a, k)) or _n)
    sampler = PointSampler(H=8, W=8, focal=10.0, n_sample=DIM_PTS // 3,
                           near=2.0, far=6.0)
    capsys.readouterr()
    prepared, kind, dim_pts = TE._prepare_r2l(object(), cfg, sampler, 10,
                                              False, True, quantize)
    assert kind == want and dim_pts == DIM_PTS
    assert "WARNING" not in capsys.readouterr().err
    assert [p[0] for p in packed] == [prepared]
    assert packed[0][1] is cfg
    assert F.fused_frame_supported(cfg, q, 10)
    assert F.wide_form(W, q, 10)
    assert F.kernel_width(W, q, 10) == -(-W // 128) * 128
    if kind == "pe":
        wd = packed[0][3]["weight_dtype"]
        assert wd == (torch.float32 if dtype == "f32" else torch.bfloat16)


# ---------------------------------------------------------------------------
# The plain versions on the wide packing against JAX's kernels
# ---------------------------------------------------------------------------

WIDE_WIDTHS = [384, 512, 1024]


def _wide_case(W, compute_dtype, rows=192, depth=4, seed=7):
    jcfg = JaxR2LConfig(input_dim=DIM_PTS * 21, netwidth=W, netdepth=depth,
                        compute_dtype=compute_dtype, precision="highest")
    params, cfg, model = models(jcfg, seed=seed)
    pts = (np.random.default_rng(seed).normal(size=(rows, DIM_PTS)) * 0.5
           ).astype(np.float32)
    return jcfg, params, cfg, model, pts


def _within(got, want, bounds):
    tol_max, tol_rms = bounds
    d = got - want
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.max(np.abs(d)) < tol_max, np.max(np.abs(d))
    if tol_rms is not None:
        assert np.sqrt(np.mean(d * d)) < tol_rms


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("W", WIDE_WIDTHS)
def test_wide_pe_plain_matches_jaxs_kernel(W, dtype):
    """K1's wide form on its packing (``pad=True``, staged for the wide
    form) through the wrapper's CPU path, against JAX's PE-fused kernel in
    interpret mode, within K1's frame bound (TOL_KERNEL)."""
    jd, td, _ = DTYPES[dtype]
    jcfg, params, cfg, model, pts = _wide_case(W, jd)
    jfp = JP.prepare_fused_params_pe(params, jcfg, DIM_PTS, 10,
                                     weight_dtype=jd)
    want = np.asarray(JP.fused_r2l_apply_pe(jfp, jcfg, jnp.asarray(pts),
                                            DIM_PTS, 10, tile=64,
                                            interpret=True))
    fp = F.prepare_fused_params_pe(model, cfg, DIM_PTS, 10, weight_dtype=td,
                                   pad=True)
    assert fp.staged.numel() == F.wide_stage_plan(cfg, td)["nbytes"]
    got = n(F.fused_r2l_apply_pe(fp, cfg, t(pts), DIM_PTS, 10))
    _within(got, want, TOL_KERNEL[("pe", dtype)])
    np.testing.assert_array_equal(
        got, n(F.fused_r2l_apply_pe_wide(fp, cfg, t(pts), DIM_PTS, 10)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("W", WIDE_WIDTHS)
def test_wide_api_plain_matches_jaxs_kernel(W, dtype):
    """K9's wide form (``prepare_fused_params``, r2l_embed's order) on the
    encoded rays against JAX's ``fused_r2l_apply`` in interpret mode, within
    K1's bound (the same chain on the same encoding)."""
    jd, td, _ = DTYPES[dtype]
    jcfg, params, cfg, model, pts = _wide_case(W, jd)
    from r2l_tpu.encoding import r2l_embed as jax_r2l_embed
    x = np.asarray(jax_r2l_embed(jnp.asarray(pts), 10))
    jfp = JP.prepare_fused_params(params, jcfg, weight_dtype=jd)
    want = np.asarray(JP.fused_r2l_apply(jfp, jcfg, jnp.asarray(x), tile=64,
                                         interpret=True))
    fp = F.prepare_fused_params(model, cfg, td, pad=True)
    assert fp.staged.numel() == F.wide_stage_plan(cfg, td)["nbytes"]
    got = n(F.fused_r2l_apply(fp, cfg, r2l_embed(t(pts), 10)))
    _within(got, want, TOL_KERNEL[("pe", dtype)])
    np.testing.assert_array_equal(
        got, n(F.fused_r2l_apply_wide(fp, cfg, r2l_embed(t(pts), 10))))


@pytest.mark.parametrize("fold_requant,nobf16_inner",
                         [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("W", WIDE_WIDTHS)
def test_wide_int8_forms_match_jaxs_kernel(W, fold_requant, nobf16_inner):
    """K2's three forms (``int8_epilogue``) on the wide packing, each
    calibrated with its ``fold_requant`` on the same points as JAX's,
    against JAX's int8 kernel in interpret mode with the same flags, within
    K2's bounds (TOL_KERNEL)."""
    jcfg, params, cfg, model, calib, pts = int8_case(DIM_PTS, 10, W, 4, 8,
                                                     seed=3)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM_PTS, 10,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=fold_requant)
    want = np.asarray(JP.fused_r2l_apply_int8_pe(
        jfp, jcfg, jnp.asarray(pts), DIM_PTS, 10, tile=64, interpret=True,
        fold_requant=fold_requant, nobf16_inner=nobf16_inner))
    fp = F.calibrate_r2l_int8_pe(model, cfg, DIM_PTS, 10, t(calib),
                                 fold_requant=fold_requant, pad=True)
    assert fp.staged_for == "wide"
    got = n(F.fused_r2l_apply_int8_pe(fp, cfg, t(pts), DIM_PTS, 10,
                                      fold_requant, nobf16_inner))
    _within(got, want, TOL_KERNEL[("int8", "bf16")])
    np.testing.assert_array_equal(got, n(F.fused_r2l_apply_int8_pe_wide(
        fp, cfg, t(pts), DIM_PTS, 10, fold_requant, nobf16_inner)))


# ---------------------------------------------------------------------------
# Padding and staging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["K1", "K9", "K2"])
def test_w300_packed_at_384_computes_the_network(kernel):
    """A W300 student packed at the wide form's width (384, zero channels)
    gives its unpadded packing's outputs: f32 within 1e-6 (sums with zeros
    added), int8 bit for bit (the same codes and scales)."""
    jcfg, params, cfg, model, pts = _wide_case(300, jnp.float32, rows=64)
    assert F.kernel_width(300) == F.kernel_width(300, True) == 384
    pts = t(pts)
    if kernel == "K2":
        fps = [F.calibrate_r2l_int8_pe(model, cfg, DIM_PTS, 10, pts, pad=p)
               for p in (False, True)]
        outs = [F.fused_r2l_apply_int8_pe(fp, cfg, pts, DIM_PTS, 10)
                for fp in fps]
        widths = [fp.body_q.shape[-1] for fp in fps]
        assert torch.equal(fps[1].body_q[:, :300, :300], fps[0].body_q)
        assert not fps[1].body_q[:, 300:].any()
        assert fps[1].staged_for == "wide" and fps[0].staged is None
        tol = 0.0
    else:
        if kernel == "K1":
            fps = [F.prepare_fused_params_pe(model, cfg, DIM_PTS, 10,
                                             weight_dtype=torch.float32,
                                             pad=p) for p in (False, True)]
            outs = [F.fused_r2l_apply_pe(fp, cfg, pts, DIM_PTS, 10)
                    for fp in fps]
        else:
            fps = [F.prepare_fused_params(model, cfg, torch.float32, pad=p)
                   for p in (False, True)]
            outs = [F.fused_r2l_apply(fp, cfg, r2l_embed(pts, 10))
                    for fp in fps]
        widths = [fp.body_w.shape[-1] for fp in fps]
        assert not fps[1].body_w[:, 300:].any()
        assert not fps[1].tail_w[:, 300:].any()
        assert fps[1].staged is not None and fps[0].staged is None
        tol = 1e-6
    assert widths == [300, 384]
    np.testing.assert_allclose(n(outs[1]), n(outs[0]), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_wide_staging_round_trip(dtype):
    """``stage_wide_chain`` then ``unstage_wide_chain`` gives the fields
    back; the image is the plan's size, and byte (o, b) of a layer (output
    o, byte b of its row of K bytes) lies in tile (o // 128, b // 128) at
    row o % 128, byte b % 128."""
    W, D, L = 384, 6, 4
    cfg = R2LConfig(input_dim=12 * (2 * L + 1), netdepth=D, netwidth=W,
                    compute_dtype=torch.bfloat16)
    model = R2L(cfg, device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    pts = torch.from_numpy(rng.uniform(-1, 1, (64, 12)).astype(np.float32))
    if dtype == torch.int8:
        fp = F.calibrate_r2l_int8_pe(model, cfg, 12, L, pts, pad=True)
        names = ("head_q", "body_q", "head_m", "head_b", "body_m", "body_b")
    else:
        fp = F.prepare_fused_params_pe(model, cfg, 12, L, weight_dtype=dtype,
                                       pad=True)
        names = ("head_w", "body_w")
    plan = F.wide_stage_plan(cfg, dtype)
    assert fp.staged.dtype == torch.uint8
    assert fp.staged.numel() == plan["nbytes"]
    back = F.unstage_wide_chain(fp.staged, cfg, dtype)
    assert sorted(back) == sorted(names)
    for name in names:
        assert torch.equal(back[name], getattr(fp, name)), name
    # one layer's byte placement, by the formula
    w = (fp.body_q if dtype == torch.int8 else fp.body_w)[1]
    b = w.contiguous().view(torch.uint8)
    kb = b.shape[1]
    start = plan["head_bytes"] + plan["layer_bytes"]
    for o, c in ((0, 0), (5, 130), (200, kb - 1), (383, 257 % kb)):
        at = ((o // 128) * (kb // 128) + c // 128) * 128 * 128 \
            + (o % 128) * 128 + c % 128
        assert fp.staged[start + at] == b[o, c]


def test_wide_scratch_is_the_kernels():
    """The scratch the wrapper allocates: bf16/f32 two h, min(nl-1, 2) t
    and h0; int8 two code buffers, two bf16 h and an f32 h0; 256-byte
    aligned, as csrc/r2l_wide.cuh's scratch_bytes."""
    e = 1000 * 384
    assert F.wide_scratch_bytes(1000, 384, torch.bfloat16, 2, True) == \
        4 * e * 2
    assert F.wide_scratch_bytes(1000, 384, torch.float32, 3, False) == \
        4 * e * 4
    assert F.wide_scratch_bytes(1000, 384, torch.float32, 1, True) == \
        3 * e * 4
    assert F.wide_scratch_bytes(1000, 384, torch.int8, 2, True) == \
        2 * e + 2 * 2 * e + 4 * e
    assert F.wide_scratch_bytes(3, 128, torch.int8, 2, False) == \
        2 * 512 + 2 * 768


@pytest.mark.parametrize("W,dtype,passes", [
    (512, torch.bfloat16, 1), (2304, torch.int8, 1), (1024, torch.float32, 1),
    (2304, torch.float32, 2)])
def test_a_frame_is_one_wide_pass(W, dtype, passes):
    """A 400x400 frame (160,000 rays) runs in one pass of the wide form up
    to W2304 in int8 and W1024 in f32; a wider f32 one in passes whose
    scratch stays within ``WIDE_SCRATCH_BYTES``."""
    n = 160_000
    rows = F.wide_rows(n, W, dtype, 2, True)
    assert -(-n // rows) == passes
    assert F.wide_scratch_bytes(rows, W, dtype, 2, True) <= \
        F.WIDE_SCRATCH_BYTES
