"""The wide form of the student's frame kernels (K1, K9 and K2 above
netwidth 256: r2l_tpu_torch/kernels/csrc/r2l_wide.cu) on the CPU.

The grid: every (W, D, L, dtype) at which the JAX package renders a student
on its PE-fused or int8 kernel (its ``_pe_kernel_tile_fit`` > 0) is one the
port's frame kernels take, and the port's copy of that rule
(``evaluate._reference_fits``) is JAX's. The gate at the corner shapes
picks JAX's kind and packs for the wide form (the model's device read as
CUDA, nothing launched). On the CPU the wrappers run their plain versions:
those, on the wide packing, against JAX's kernels in interpret mode; a W300
student packed at 384 against its unpadded packing; the wide forms' one
image (``stage_wide_train``): its round trip, and each head's columns in
its input's order (K1 the encoding twin's, K9 the cast twin's); the cast
twin; the scratch a call takes and the passes a frame runs in.
tests/test_torch_cuda.py holds the CUDA kernels to the plain versions on
the card.
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
from r2l_tpu_torch.kernels import _build
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.kernels.staging import tf32_split
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


def _wide_model(W: int = 384, D: int = 6, L: int = 4, seed: int = 1):
    """A seeded W-wide student of 12 scalars a ray and 64 seeded points."""
    cfg = R2LConfig(input_dim=12 * (2 * L + 1), netdepth=D, netwidth=W,
                    compute_dtype=torch.bfloat16)
    model = R2L(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    pts = torch.from_numpy(rng.uniform(-1, 1, (64, 12)).astype(np.float32))
    return cfg, model, pts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_wide_staging_round_trip(dtype):
    """The frame's packing stages the wide forms' one image
    (``stage_wide_train``, staged for "wide"), which gives the fields back
    (f32 as its TF32 high and low parts); the image is the plan's size, and
    byte b of output o of a layer's row (K bytes) lies at the layer's start
    + o * K + b (f32: the high parts' rows, then the low parts')."""
    L = 4
    cfg, model, pts = _wide_model(L=L)
    if dtype == torch.int8:
        fp = F.calibrate_r2l_int8_pe(model, cfg, 12, L, pts, pad=True)
        names = ("head_q", "body_q", "head_m", "head_b", "body_m", "body_b")
    else:
        fp = F.prepare_fused_params_pe(model, cfg, 12, L, weight_dtype=dtype,
                                       pad=True)
        names = ("head_w", "body_w")
    plan = F.wide_stage_plan(cfg, dtype)
    assert fp.staged.dtype == torch.uint8 and fp.staged_for == "wide"
    assert fp.staged.numel() == plan["nbytes"]
    back = F.unstage_wide_train(fp.staged, cfg, dtype)
    for name in names:
        want = getattr(fp, name)
        if dtype == torch.float32:
            hi, lo = tf32_split(want)
            assert torch.equal(back[name + "_lo"], lo), name
            want = hi
        assert torch.equal(back[name], want), name
    # one layer's byte placement, by the formula
    w = (fp.body_q if dtype == torch.int8 else fp.body_w)[1]
    parts = tf32_split(w) if dtype == torch.float32 else (w,)
    kb = w.shape[1] * w.element_size()
    start = plan["head_bytes"] + plan["layer_bytes"]
    for i, part in enumerate(parts):
        b = part.contiguous().view(torch.uint8)
        for o, c in ((0, 0), (5, 130), (200, kb - 1), (383, 257 % kb)):
            assert fp.staged[start + (i * 384 + o) * kb + c] == b[o, c]


@pytest.mark.parametrize("kernel", ["K1", "K9"])
def test_wide_head_reads_its_input_in_the_fields_order(kernel):
    """The chain on the image's weights (its round trip) and on the head's
    input as the wide form writes it (K1: the encoding twin
    ``train_encoding_ref``, freq-major; K9: the cast twin ``wide_cast_ref``
    of ``r2l_embed``'s rays), its first in_dim columns (the rest zero), is
    the plain version's frame bit for bit: each head's columns lie in its
    input's order."""
    L = 4
    cfg, model, pts = _wide_model(L=L)
    in_dim, kp = cfg.input_dim, F._padded_in(cfg.input_dim)
    cd = torch.bfloat16
    if kernel == "K1":
        fp = F.prepare_fused_params_pe(model, cfg, 12, L, weight_dtype=cd,
                                       pad=True)
        inp = T.train_encoding_ref(pts, 12, L, cd)
        want = F.fused_r2l_apply_pe_ref(fp, cfg, pts, 12, L)
        other = F.prepare_fused_params(model, cfg, cd, pad=True)
    else:
        fp = F.prepare_fused_params(model, cfg, cd, pad=True)
        x = r2l_embed(pts, L)
        inp = F.wide_cast_ref(x, cd)
        want = F.fused_r2l_apply_ref(fp, cfg, x)
        other = F.prepare_fused_params_pe(model, cfg, 12, L, weight_dtype=cd,
                                          pad=True)
    assert inp.shape == (64, kp) and not inp[:, in_dim:].any()
    back = F.unstage_wide_train(fp.staged, cfg, cd)
    got = F._chain_ref(fp._replace(**back), cfg, inp[:, :in_dim], cd)
    assert torch.equal(got, want)
    # the other head's image on this input is another network
    wrong = F.unstage_wide_train(other.staged, cfg, cd)
    assert not torch.equal(F._chain_ref(fp._replace(**wrong), cfg,
                                        inp[:, :in_dim], cd), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k9_cast_twin_is_the_head_input(dtype):
    """K9's wide head input (``wide_cast_ref``, the twin of the kernel's
    cast) is ``fused_r2l_apply_ref``'s rounding of x to the compute dtype,
    bit for bit, zero-padded to 128 columns; and in f32 at L=10 (in_dim
    1008, rows of 4032 bytes) the kernel maps x itself
    (``wide_maps_x``), whose columns past in_dim TMA reads as zeros."""
    x = r2l_embed(t(np.random.default_rng(5).uniform(-2, 2, (33, DIM_PTS))),
                  10)
    in_dim = x.shape[1]
    got = F.wide_cast_ref(x, dtype)
    assert got.dtype == dtype and got.shape == (33, 1024)
    assert torch.equal(got[:, :in_dim].view(torch.uint8),
                       x.to(dtype).view(torch.uint8))
    assert not got[:, in_dim:].any()
    assert F.wide_maps_x(dtype, False, in_dim) == (dtype == torch.float32)
    assert not F.wide_maps_x(torch.float32, False, 63)
    assert not F.wide_maps_x(torch.float32, True, in_dim)


def test_wide_scratch_is_the_kernels():
    """The scratch the wrapper allocates: the head's input [rows, kp] of
    the compute type (int8 its codes; none where K9 f32 maps x); bf16/f32
    then h0, two h and min(nl-1, 2) t; int8 two code buffers, the bf16
    residual stream and an f32 h0; 256-byte aligned, as
    csrc/r2l_wide.cu's frame_scratch."""
    e, kp = 1000 * 384, 1024
    assert F.wide_scratch_bytes(1000, 384, torch.bfloat16, 2, True, kp) == \
        1000 * kp * 2 + 4 * e * 2
    assert F.wide_scratch_bytes(1000, 384, torch.float32, 3, False, kp) == \
        1000 * kp * 4 + 4 * e * 4
    assert F.wide_scratch_bytes(1000, 384, torch.float32, 1, True, 0) == \
        3 * e * 4
    assert F.wide_scratch_bytes(1000, 384, torch.int8, 2, True, kp) == \
        1000 * kp + 2 * e + 2 * e + 4 * e
    assert F.wide_scratch_bytes(3, 128, torch.int8, 2, False, 128) == \
        512 + 2 * 512 + 768


_WIDE_SRC = (_build.CSRC / "r2l_wide.cu").read_text()


@pytest.mark.parametrize("rows", [1, 127, 160_000])
@pytest.mark.parametrize("dtype,pe", [(torch.bfloat16, True),
                                      (torch.float32, True),
                                      (torch.bfloat16, False),
                                      (torch.float32, False),
                                      (torch.int8, True)])
def test_wide_scratch_layout_is_the_entry_points(rows, dtype, pe):
    """The scratch of W512 at L=10 (in_dim 1008, the head's input padded to
    1024 columns; none where K9 f32 maps x), one to three layers a block,
    with and without the global residual, every buffer 256-byte aligned,
    as the entry point's frame_scratch counts it (its formula read from
    the source) and checks it; and as run_float and run_k2 cut it."""
    W, in_dim = 512, DIM_PTS * 21
    es = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1}[dtype]
    maps_x = F.wide_maps_x(dtype, pe, in_dim)
    assert maps_x == (dtype == torch.float32 and not pe)
    kp = 0 if maps_x else 1024

    def al(b):
        return -(-b // 256) * 256
    e = rows * W
    for nl in (1, 2, 3):
        for res in (True, False):
            want = al(rows * kp * es)
            if dtype == torch.int8:
                want += 2 * al(e) + al(2 * e) + (al(4 * e) if res else 0)
            else:
                want += (2 + min(nl - 1, 2) + int(res)) * al(e * es)
            assert F.wide_scratch_bytes(rows, W, dtype, nl, res, kp) == \
                want, (nl, res)
    for text in (
            "aligned(rows * r2l::round_up(in_dim, r2l::kKAlign) * es)",
            "return enc + 2 * aligned(e) + aligned(2 * e) +\n"
            "           (use_residual ? aligned(4 * e) : 0);",
            "const int bufs = 2 + (nl - 1 < 2 ? nl - 1 : 2) + "
            "(use_residual ? 1 : 0);",
            "return enc + bufs * aligned(e * es);",
            "return !pe && dtype == kF32 && in_dim % 4 == 0;",
            "if (!direct) s += aligned((long long)rows * kp * es);",
            "for (int i = 0; i < 2; ++i, s += aligned(e)) X[i] = s;",
            "frame_scratch(rows, W, in_dim, dtype, pe, nl, use_residual)"):
        assert text in _WIDE_SRC, text


@pytest.mark.parametrize("W,dtype,passes", [
    (512, torch.bfloat16, 1), (2304, torch.int8, 1), (1024, torch.float32, 1),
    (2304, torch.float32, 2)])
def test_a_frame_is_one_wide_pass(W, dtype, passes):
    """A 400x400 frame (160,000 rays) at L=10 runs in one pass of the wide
    form up to W2304 in int8 and W1024 in f32, the head's input written
    once (kp 1024) beside the layers' buffers; a wider f32 one in passes
    whose scratch stays within ``WIDE_SCRATCH_BYTES``."""
    n, kp = 160_000, F._padded_in(DIM_PTS * 21)
    rows = F.wide_rows(n, W, dtype, 2, True, kp)
    assert -(-n // rows) == passes
    assert F.wide_scratch_bytes(rows, W, dtype, 2, True, kp) <= \
        F.WIDE_SCRATCH_BYTES
