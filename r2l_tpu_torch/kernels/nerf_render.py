"""The fused volumetric NeRF pass: wrappers, plain version and packing.

Counterpart of ``r2l_tpu/kernels/nerf_render_pallas.py`` (``prepare_fused_
nerf_t`` :160, ``fused_nerf_render_t`` :336). For each ray, walking its S
samples in order: the point o + d*z, its NeRF positional encoding by the
sin/cos double-angle ladder, the teacher MLP (skip concats, sigma, feature,
view and rgb heads, or ``output_linear``), and the alpha compositing, which
gives rgb [N, 3], acc [N], depth [N] and the weights [N, S]. Two kernels:

* K6 ``csrc/nerf_render.cu``: f32 or bf16 weights. bf16: the encoding is
  cast to bf16, each layer is an f32 dot plus the f32 bias, ReLU, cast to
  bf16; sigma and rgb stay f32. f32: each GEMM layer's product as 3xTF32
  on the tensor cores (a_hi w_lo + a_lo w_hi + a_hi w_hi, about 21
  mantissa bits), held to the plain version's true f32 at the f32 limits;
  the heads in f32.
* K7 ``csrc/nerf_render_int8.cu``: static-scale int8 (the R2L recipe): the
  point encoding is quantized with ``pe_inv``, every product is an exact
  int32 sum, dequantized as acc*m + b in one FMA, and requantized with the
  next layer's inverse scale, or (``fold_requant``) by round+clip alone
  with the scales folded into the producer's m and b.

Two flags of the Pallas kernel change its numbers and are forms of both
kernels and of their wide form: ``pe_ladder=False`` encodes with one sin a
value (``pe_sin``: sin(2^j p) and sin(2^j p + pi/2)) in place of the ladder,
and ``bf16_requant`` (int8) dequantizes every layer but the heads in bf16
(``dequant_bf16``: the product rounded to bf16, then the sum).

Both take any depth: the skip set travels in the staged image as one flag
a layer. They are built for the widths of ``NERF_KERNEL_WIDTHS``;
``prepare_fused_nerf`` pads a narrower teacher with zero channels to the
next of them (``teacher_kernel_width``). A wider teacher
(``teacher_wide_form``) runs on their wide form, ``csrc/nerf_wide.cu``: one
pass a layer over activations in device memory, the heads as reductions
and the compositing one thread a ray; the teacher packed at the next
multiple of ``WIDE_CHANNELS`` and staged by ``stage_wide_teacher``. f32,
bf16 and int8 run each layer on ``wgmma`` fed by TMA
(``csrc/wide_hopper.cuh``; int8 s8 x s8 -> s32), the point and view
encodings written once a pass by a kernel of their own, int8's as their
codes (``wide_encodings_ref`` is its plain twin). Every teacher the JAX
package's model builds is taken (``fused_teacher_supported``: a skip
before the last layer); ``check_teacher_supported`` raises
NotImplementedError for the rest before anything is packed.

``fused_nerf_render`` runs the plain version ``fused_nerf_render_ref`` for a
tensor on the CPU only; for a CUDA tensor it launches K6, K7 or their wide
form, or raises. The plain version is the wide form's too.

Port layout (not the TPU's transposed ``[feature, ray]`` one): weights
``[out, in]``; the point encoding in ``nerf_embed``'s own order
``[p, sin f0 p, cos f0 p, ...]`` zero-padded to ``kp`` columns (a multiple
of 64); the skip layer's input is
``[encoding (kp) | h (W)]``; the view layer's is ``[feature (W) | view
encoding]`` zero-padded to ``kv``, a multiple of 64. In int8 the padding
columns have scale 1, as the JAX package's.

K6/K7 read the GEMM weights from a staged image (``stage_weights``,
made once per model by ``prepare_fused_nerf``): each layer cut into stages
of ``STAGE_K`` input channels for all its outputs, each stage laid out as
Hopper's ``wgmma`` reads B from shared memory (K-major 8-row x 16-byte core
matrices, no swizzle), so one bulk copy moves it; f32 weights as their TF32
high and low parts (3xTF32); the head weights (alpha, rgb or output_linear)
after the layers, then (int8) the epilogue table and the skip flags.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import torch

from .. import trace
from ..models.nerf import NeRF, NeRFConfig
from ..volume import fma, ray_points
from .r2l_fused import (_WIDE_TYPES, WIDE_CHANNELS, WIDE_SCRATCH_BYTES,
                        _act_scale, _aligned, _check, _dequant, _mm_int,
                        _ptr, _q8, _raise_on_error, pads)
from .staging import STAGE_K, stage_matrices, tf32_split  # noqa: F401

K_STAGE = 64     # every packed weight's input axis is a multiple of this
ROWS = 1 << 18   # points per slice of the plain version's MLP
# Points per block of the kernels (one cluster is two blocks); their weight
# stages' input channels are staging.STAGE_K.
BLOCK_POINTS = {torch.bfloat16: 128, torch.int8: 128, torch.float32: 64}
SAMPLES_PER_GROUP = 8
# The teacher widths K6/K7 are built for: the ``case`` labels of the launch
# switches in csrc/nerf_render.cu and csrc/nerf_render_int8.cu; any other
# returns cudaErrorInvalidValue. A narrower teacher is packed at the next
# width, a wider one at the next multiple of WIDE_CHANNELS for the wide
# form (``teacher_kernel_width``). tests/test_torch_gates.py reads them
# there.
NERF_KERNEL_WIDTHS = (128, 256)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def layout(cfg: NeRFConfig, L_pts: int, L_views: int
           ) -> tuple[int, int, list[int]]:
    """(kp, kv, K of each pts layer): the padded point-encoding width, the
    padded view-layer input width (0 without viewdirs) and each layer's
    padded input width."""
    kp = _round_up(3 + 6 * L_pts, K_STAGE)
    kv = (_round_up(cfg.W + 3 + 6 * L_views, K_STAGE)
          if cfg.use_viewdirs else 0)
    ks = [kp] + [kp + cfg.W if (i - 1) in cfg.skips else cfg.W
                 for i in range(1, cfg.D)]
    return kp, kv, ks


class FusedNeRFParams(NamedTuple):
    """Kernel-layout teacher parameters. Fields a mode does not use are
    empty tensors: the int8 multipliers and inverse scales in f32/bf16, the
    view heads without viewdirs, ``out_*`` with them."""
    pts_w: torch.Tensor    # flat: layer i's [W, K_i] rows, one layer after
    #                        another; f32, bf16 or int8
    pts_m: torch.Tensor    # [D, W] f32 dequant multipliers (int8)
    pts_b: torch.Tensor    # [D, W] f32
    pe_inv: torch.Tensor   # [kp] inverse scale of the point encoding (int8)
    pts_inv: torch.Tensor  # [D, W] row i: inverse scale of layer i's h
    #                        input; row 0 is ones (int8)
    alpha_w: torch.Tensor  # [W]
    alpha_m: torch.Tensor  # [1]
    alpha_b: torch.Tensor  # [1]
    feat_w: torch.Tensor   # [W, W]
    feat_m: torch.Tensor   # [W]
    feat_b: torch.Tensor   # [W]
    h_inv: torch.Tensor    # [W] inverse scale of the heads' input (int8)
    views_w: torch.Tensor  # [W // 2, kv]
    views_m: torch.Tensor  # [W // 2]
    views_b: torch.Tensor  # [W // 2]
    hv_inv: torch.Tensor   # [kv] inverse scale of the view layer's input
    rgb_w: torch.Tensor    # [3, W // 2]
    rgb_m: torch.Tensor    # [3]
    rgb_b: torch.Tensor    # [3]
    hr_inv: torch.Tensor   # [W // 2] inverse scale of the rgb head's input
    out_w: torch.Tensor    # [4, W] rgb logits then sigma (no viewdirs)
    out_m: torch.Tensor    # [4]
    out_b: torch.Tensor    # [4]
    staged: torch.Tensor | None = None  # uint8: the kernels' weight image
    #                                     (stage_weights)
    fold_requant: bool = False  # int8: the scales are folded into the
    #                             producers, requantize is round+clip


def _pad_cols(w: torch.Tensor, cols: int, fill: float = 0.0) -> torch.Tensor:
    """w [..., c] padded to [..., cols] with ``fill``."""
    out = w.new_full((*w.shape[:-1], cols), fill)
    out[..., :w.shape[-1]] = w
    return out


def teacher_wide_form(W: int) -> bool:
    """Whether a W-wide teacher runs on the wide form of K6/K7
    (``csrc/nerf_wide.cu``): wider than the widest of
    ``NERF_KERNEL_WIDTHS``."""
    return W > NERF_KERNEL_WIDTHS[-1]


def teacher_kernel_width(W: int) -> int:
    """The width K6/K7 run a W-wide teacher at: the narrowest of
    ``NERF_KERNEL_WIDTHS`` that holds it, or on the wide form
    (``teacher_wide_form``) the next multiple of ``WIDE_CHANNELS``.
    ``prepare_fused_nerf`` pads the network with zero channels (the view
    layer to half that width), which ReLU keeps at zero and every later
    layer and head reads through zero weights, so the padded pass computes
    the W-wide teacher."""
    if teacher_wide_form(W):
        return _round_up(W, WIDE_CHANNELS)
    return next(k for k in NERF_KERNEL_WIDTHS if k >= W)


def teacher_kernel_cfg(cfg: NeRFConfig) -> NeRFConfig:
    """``cfg`` at its kernel width."""
    Wk = teacher_kernel_width(cfg.W)
    return cfg if Wk == cfg.W else dataclasses.replace(cfg, W=Wk)


@torch.no_grad()
def _padded_teacher(model: NeRF, cfg: NeRFConfig, pad: bool | None
                    ) -> tuple[NeRF, NeRFConfig]:
    """With ``pad`` (``r2l_fused.pads``: by default where the model lies on
    the card), ``model`` at its ``teacher_kernel_width``: a ``NeRF`` of that
    width holding the weights and biases in its leading channels, zeros
    elsewhere (``model`` itself where it is already there)."""
    weight = model.pts_linears[0].weight
    kcfg = teacher_kernel_cfg(cfg) if pads(pad, weight) else cfg
    if kcfg is cfg:
        return model, cfg
    W, Wk, c = cfg.W, kcfg.W, cfg.input_ch
    out = NeRF(kcfg, device=weight.device)
    for m in out.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.zero_()
            m.bias.zero_()

    def put(dst, src, rows: int, cols: list[tuple[int, int, int]]):
        """dst's first ``rows`` outputs from src: each (dst column, src
        column, count) range of the inputs."""
        dst.bias[:rows] = src.bias
        for d0, s0, k in cols:
            dst.weight[:rows, d0:d0 + k] = src.weight[:, s0:s0 + k]

    for i, (d, m) in enumerate(zip(out.pts_linears, model.pts_linears)):
        if i == 0:
            put(d, m, W, [(0, 0, c)])
        elif (i - 1) in cfg.skips:      # [encoding | h]
            put(d, m, W, [(0, 0, c), (c, c, W)])
        else:
            put(d, m, W, [(0, 0, W)])
    if cfg.use_viewdirs:
        put(out.alpha_linear, model.alpha_linear, 1, [(0, 0, W)])
        put(out.feature_linear, model.feature_linear, W, [(0, 0, W)])
        put(out.views_linears[0], model.views_linears[0], W // 2,
            [(0, 0, W), (Wk, W, cfg.input_ch_views)])   # [feature | views]
        put(out.rgb_linear, model.rgb_linear, 3, [(0, 0, W // 2)])
    else:
        put(out.output_linear, model.output_linear, cfg.output_ch,
            [(0, 0, W)])
    return out, kcfg


def _quant_rows_scaled(wt: torch.Tensor, s_in: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """wt [out, in] f32, s_in [in] -> (int8 [out, in], per-row multiplier
    [out]) (``_quant_rows_scaled_t``)."""
    w_eff = wt.float() * s_in[None, :]
    ws = torch.clamp(w_eff.abs().amax(dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w_eff / ws[:, None]), -127, 127)
    return q.to(torch.int8), ws


def _calib_forward(model: NeRF, cfg: NeRFConfig, L_pts: int, L_views: int,
                   calib: tuple, margin: float) -> dict:
    """The f32 calibration forward (direct sin/cos, original layout) and
    the per-channel input scales it gives: {'x': point encoding scale,
    'h': [D] each layer's h-input scale (None for layer 0), 'head': the
    heads' input scale, 'feat', 'vd', 'hv'}."""
    from ..encoding import nerf_embed
    c_pts, c_vd = calib
    x = nerf_embed(c_pts.float(), L_pts)
    s = {"x": _act_scale(x, margin), "h": [None]}
    h = x
    for i, m in enumerate(model.pts_linears):
        if i > 0:
            s["h"].append(_act_scale(h, margin))
        inp = torch.cat([x, h], -1) if (i - 1) in cfg.skips else h
        h = torch.relu(inp @ m.weight.float().T + m.bias.float())
    s["head"] = _act_scale(h, margin)
    if cfg.use_viewdirs:
        feat = h @ model.feature_linear.weight.float().T \
            + model.feature_linear.bias.float()
        vd_e = nerf_embed(c_vd.float(), L_views)
        v = model.views_linears[0]
        hv = torch.relu(torch.cat([feat, vd_e], -1) @ v.weight.float().T
                        + v.bias.float())
        s.update(feat=_act_scale(feat, margin), vd=_act_scale(vd_e, margin),
                 hv=_act_scale(hv, margin))
    return s


@torch.no_grad()
def prepare_fused_nerf(model: NeRF, cfg: NeRFConfig, L_pts: int = 10,
                       L_views: int = 4, calib: tuple | None = None,
                       weight_dtype: torch.dtype = torch.bfloat16,
                       margin: float = 1.1, fold_requant: bool = False,
                       pad: bool | None = None) -> FusedNeRFParams:
    """Pack a ``NeRF`` for the fused pass (``prepare_fused_nerf_t``).

    ``calib = (pts [n, 3], viewdirs [n, 3] | None)`` switches to
    static-scale int8: an f32 forward over those points records each
    layer's input max-abs, the scale is max-abs * ``margin`` / 127, and
    each weight row is quantized with its inputs' scales absorbed. Without
    it the weights are cast to ``weight_dtype`` (f32 or bf16).
    ``fold_requant`` (int8 only) pre-multiplies each consumer's inverse
    input scale into its producer's multiplier and bias (the feature head's
    into ``feat_*``, the rgb head's into ``views_*``), so the kernel's
    requantizes are round+clip only; the view encoding's scale is not
    folded (it has no producer). The result records it, and the weights'
    dtype records int8, so the render takes neither as an argument. TF32
    is switched off for the calibration. ``pad`` (by default where the
    model lies on the card) packs the teacher at its
    ``teacher_kernel_width``. The weight image is K6/K7's
    (``stage_weights``), or above their widths the wide form's
    (``stage_wide_teacher``).
    """
    model, cfg = _padded_teacher(model, cfg, pad)
    W, D = cfg.W, cfg.D
    kp, kv, ks = layout(cfg, L_pts, L_views)
    dev = model.pts_linears[0].weight.device
    int8 = calib is not None
    f32 = torch.float32
    empty = torch.empty(0, dtype=f32, device=dev)
    n_in, n_v = 3 + 6 * L_pts, 3 + 6 * L_views
    if cfg.input_ch != n_in or (cfg.use_viewdirs
                                and cfg.input_ch_views != n_v):
        raise ValueError(f"input_ch {cfg.input_ch} / input_ch_views "
                         f"{cfg.input_ch_views} do not match L_pts {L_pts} "
                         f"/ L_views {L_views}")
    if int8:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            s = _calib_forward(model, cfg, L_pts, L_views, calib, margin)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        s_pe = _pad_cols(s["x"], kp, fill=1.0)

    def wt_of(m: torch.nn.Linear) -> torch.Tensor:
        return m.weight.detach().float()

    def pack(wt: torch.Tensor, s_in: torch.Tensor | None):
        """-> (weights in the mode's dtype, multiplier or empty)"""
        if int8:
            return _quant_rows_scaled(wt, s_in)
        return wt.to(weight_dtype), empty

    ws, ms, bs, invs = [], [], [], []
    for i, m in enumerate(model.pts_linears):
        w = wt_of(m)
        if i == 0:
            wt, s_in = _pad_cols(w, kp), (s_pe if int8 else None)
        elif (i - 1) in cfg.skips:
            wt = torch.cat([_pad_cols(w[:, :cfg.input_ch], kp),
                            w[:, cfg.input_ch:]], 1)
            s_in = torch.cat([s_pe, s["h"][i]]) if int8 else None
        else:
            wt, s_in = w, (s["h"][i] if int8 else None)
        q, mult = pack(wt, s_in)
        ws.append(q.reshape(-1))
        ms.append(mult)
        bs.append(m.bias.detach().float())
        if int8:
            invs.append(torch.ones(W, dtype=f32, device=dev) if i == 0
                        else 1.0 / s["h"][i])
    pts_m = torch.stack(ms) if int8 else empty
    pts_b = torch.stack(bs)
    pts_inv = torch.stack(invs) if int8 else empty
    h_inv = 1.0 / s["head"] if int8 else empty
    if int8 and fold_requant:
        nxt = torch.cat([pts_inv[1:], h_inv[None]])
        pts_m, pts_b = pts_m * nxt, pts_b * nxt

    e = (empty,) * 3
    alpha = feat = views = rgb = hv_inv = hr_inv = None
    out = e
    if cfg.use_viewdirs:
        head = s["head"] if int8 else None
        aw, am = pack(wt_of(model.alpha_linear), head)
        alpha = (aw[0], am, model.alpha_linear.bias.detach().float())
        fw, fm = pack(wt_of(model.feature_linear), head)
        fb = model.feature_linear.bias.detach().float()
        v = model.views_linears[0]
        vw = wt_of(v)
        vwt = torch.cat([vw[:, :W], _pad_cols(vw[:, W:], kv - W)], 1)
        if int8:
            s_hv = torch.cat([s["feat"], _pad_cols(s["vd"], kv - W,
                                                   fill=1.0)])
            hv_inv, hr_inv = 1.0 / s_hv, 1.0 / s["hv"]
        vq, vm = pack(vwt, s_hv if int8 else None)
        vb = v.bias.detach().float()
        rw, rm = pack(wt_of(model.rgb_linear), s["hv"] if int8 else None)
        if int8 and fold_requant:
            fm, fb = fm * hv_inv[:W], fb * hv_inv[:W]
            vm, vb = vm * hr_inv, vb * hr_inv
        feat, views = (fw, fm, fb), (vq, vm, vb)
        rgb = (rw, rm, model.rgb_linear.bias.detach().float())
    else:
        if cfg.output_ch < 4:
            raise ValueError(f"output_ch {cfg.output_ch} < 4")
        ow, om = pack(wt_of(model.output_linear)[:4],
                      s["head"] if int8 else None)
        out = (ow, om, model.output_linear.bias.detach().float()[:4])
    alpha, feat, views, rgb = (x or e for x in (alpha, feat, views, rgb))
    c = lambda t: t.contiguous()  # noqa: E731
    fp = FusedNeRFParams(
        c(torch.cat(ws)), c(pts_m), c(pts_b),
        c(1.0 / s_pe) if int8 else empty, c(pts_inv),
        *map(c, alpha), *map(c, feat), c(h_inv), *map(c, views),
        c(hv_inv) if hv_inv is not None else empty, *map(c, rgb),
        c(hr_inv) if hr_inv is not None else empty, *map(c, out),
        fold_requant=bool(int8 and fold_requant))
    stage = stage_wide_teacher if teacher_wide_form(W) else stage_weights
    return fp._replace(staged=stage(fp, cfg, L_pts, L_views))


def stage_plan(cfg: NeRFConfig, dtype: torch.dtype, L_pts: int = 10,
               L_views: int = 4) -> dict:
    """The staged image's shape: 'layers', each GEMM layer's (outputs,
    staged input width) in order (the D point layers, then with viewdirs
    the feature and the view layer); the point and view encodings' widths
    as staged ('kpe', 'kve', a multiple of ``STAGE_K``) and as packed
    ('kp', 'kvw' = kv - W); 'gemm_bytes', the layers' bytes (the heads
    follow them); 'epi_off', int8's epilogue table after them; 'flags_off',
    the skip flags after that (int32, one a point layer: layer i + 1 reads
    [encoding | h] where flag i is set)."""
    W = cfg.W
    kp, kv, ks = layout(cfg, L_pts, L_views)
    k = STAGE_K[dtype]
    kpe = _round_up(kp, k)
    kvw = kv - W if cfg.use_viewdirs else 0
    kve = _round_up(kvw, k)
    layers = [(W, kpe if i == 0 else (kpe + W if K != W else W))
              for i, K in enumerate(ks)]
    if cfg.use_viewdirs:
        layers += [(W, W), (W // 2, W + kve)]
    parts = 2 if dtype == torch.float32 else 1
    es = torch.empty(0, dtype=dtype).element_size()
    gemm = sum(n * kk for n, kk in layers) * es * parts
    heads = (W + 3 * (W // 2) if cfg.use_viewdirs else 4 * W) * es
    epi = _round_up(gemm + heads, 16)
    table = len(layers) * (W // 2) * 16 if dtype == torch.int8 else 0
    flags = epi + table
    return {"layers": layers, "kp": kp, "kpe": kpe, "kvw": kvw, "kve": kve,
            "gemm_bytes": gemm, "epi_off": epi, "flags_off": flags,
            "nbytes": flags + _round_up(4 * cfg.D, 16)}


def _gemm_mats(fp: FusedNeRFParams, cfg: NeRFConfig, L_pts: int,
               L_views: int) -> tuple[list, list]:
    """([N, K staged] weights of each GEMM layer, the head weights): the
    encoding's columns padded from kp to kpe, the view encoding's from kvw
    to kve, with zeros."""
    W = cfg.W
    plan = stage_plan(cfg, fp.pts_w.dtype, L_pts, L_views)
    kp, kpe, kve = plan["kp"], plan["kpe"], plan["kve"]
    _, _, ks = layout(cfg, L_pts, L_views)
    mats, off = [], 0
    for i, K in enumerate(ks):
        w = fp.pts_w[off:off + W * K].view(W, K)
        off += W * K
        if i == 0:
            w = _pad_cols(w, kpe)
        elif K != W:
            w = torch.cat([_pad_cols(w[:, :kp], kpe), w[:, kp:]], 1)
        mats.append(w)
    if not cfg.use_viewdirs:
        return mats, [fp.out_w]
    vw = fp.views_w
    mats += [fp.feat_w, torch.cat([vw[:, :W], _pad_cols(vw[:, W:], kve)], 1)]
    return mats, [fp.alpha_w, fp.rgb_w]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], -1) \
        if t.dim() == 2 else t.contiguous().reshape(-1).view(torch.uint8)


def stage_weights(fp: FusedNeRFParams, cfg: NeRFConfig, L_pts: int = 10,
                  L_views: int = 4) -> torch.Tensor:
    """The kernels' weight image (uint8, a multiple of 16 bytes): each GEMM
    layer's stages in order, each stage [N outputs x STAGE_K channels] in
    wgmma's core-matrix order (``staging.stage_matrices``; f32: the TF32
    high part's stage, then the low part's), then the head weights in the
    weights' dtype, whole; int8 then ``_epi_table`` from a 16-byte
    boundary; then the skip flags (``stage_plan``)."""
    wd = fp.pts_w.dtype
    k = STAGE_K[wd]
    mats, heads = _gemm_mats(fp, cfg, L_pts, L_views)
    parts = [stage_matrices(w, k) for w in mats]
    parts += [_bytes(h).reshape(-1) for h in heads]
    out = torch.cat(parts)
    out = torch.nn.functional.pad(out, (0, -out.numel() % 16))
    if wd == torch.int8:
        out = torch.cat([out, _bytes(_epi_table(fp, cfg)).reshape(-1)])
    flags = _pad_cols(_skip_flags(cfg, out.device), _round_up(cfg.D, 4))
    return torch.cat([out, _bytes(flags)]).contiguous()


def _skip_flags(cfg: NeRFConfig, device) -> torch.Tensor:
    """int32 [D]: 1 where layer i's output is concatenated with the
    encoding (layer i + 1 reads [encoding | h])."""
    return torch.tensor([int(i in cfg.skips) for i in range(cfg.D)],
                        dtype=torch.int32, device=device)


def _epi_table(fp: FusedNeRFParams, cfg: NeRFConfig) -> torch.Tensor:
    """int8: each GEMM layer's dequantize constants by column pair, [layers,
    W/2, 4] f32 rows (m[c], b[c], m[c+1], b[c+1]); the view layer's W/2
    columns padded with zeros."""
    W = cfg.W
    mbs = [(fp.pts_m[i], fp.pts_b[i]) for i in range(cfg.D)]
    if cfg.use_viewdirs:
        mbs += [(fp.feat_m, fp.feat_b), (fp.views_m, fp.views_b)]
    rows = []
    for m, b in mbs:
        m, b = (torch.nn.functional.pad(x.float(), (0, W - x.numel()))
                for x in (m, b))
        rows.append(torch.stack([m[0::2], b[0::2], m[1::2], b[1::2]], -1))
    return torch.stack(rows).contiguous()


def unstage_weights(staged: torch.Tensor, cfg: NeRFConfig,
                    dtype: torch.dtype, L_pts: int = 10, L_views: int = 4
                    ) -> dict[str, torch.Tensor]:
    """The packed fields back from a staged image: 'pts_w' (flat),
    'feat_w', 'views_w' and the heads ('alpha_w', 'rgb_w' or 'out_w'); for
    f32 the GEMM fields are the TF32 high parts, and '<field>_lo' the low
    parts; for int8 also the dequantize constants ('pts_m', 'pts_b',
    'feat_m', ...) from the column-pair table."""
    W = cfg.W
    plan = stage_plan(cfg, dtype, L_pts, L_views)
    kp, kpe, kvw = plan["kp"], plan["kpe"], plan["kvw"]
    k = STAGE_K[dtype]
    es = torch.empty(0, dtype=dtype).element_size()
    n_parts = 2 if dtype == torch.float32 else 1
    pos = 0

    def take(nbytes):
        nonlocal pos
        pos += nbytes
        return staged[pos - nbytes:pos]

    mats = []   # [(hi, lo)] or [(w,)]
    for n, kk in plan["layers"]:
        cols = [[] for _ in range(n_parts)]
        for _ in range(kk // k):
            for p in range(n_parts):
                x = take(n * k * es).reshape(n // 8, k * es // 16, 8, 16)
                cols[p].append(x.permute(0, 2, 1, 3).reshape(n, k * es)
                               .contiguous().view(dtype))
        mats.append([torch.cat(c, 1) for c in cols])

    def unpad(w, i, cat):
        if i == 0:
            return w[:, :kp]
        return torch.cat([w[:, :kp], w[:, kpe:]], 1) if cat else w

    _, _, ks = layout(cfg, L_pts, L_views)
    out = {}
    for p, suffix in enumerate(("", "_lo")[:n_parts]):
        out["pts_w" + suffix] = torch.cat([
            unpad(m[p], i, ks[i] != W).reshape(-1)
            for i, m in enumerate(mats[:cfg.D])])
        if cfg.use_viewdirs:
            out["feat_w" + suffix] = mats[cfg.D][p]
            vw = mats[cfg.D + 1][p]
            out["views_w" + suffix] = torch.cat([vw[:, :W],
                                                 vw[:, W:W + kvw]], 1)
    heads = ([("alpha_w", (W,)), ("rgb_w", (3, W // 2))]
             if cfg.use_viewdirs else [("out_w", (4, W))])
    for name, shape in heads:
        nb = math.prod(shape) * es
        out[name] = take(nb).clone().view(dtype).reshape(shape)
    if dtype == torch.int8:   # the (m, b) column-pair table
        t = staged[plan["epi_off"]:plan["flags_off"]].clone().view(
            torch.float32).view(len(plan["layers"]), W // 2, 4)
        m, b = (torch.stack([t[..., k], t[..., k + 2]], -1).reshape(
            len(plan["layers"]), W) for k in (0, 1))
        out["pts_m"], out["pts_b"] = m[:cfg.D], b[:cfg.D]
        if cfg.use_viewdirs:
            out["feat_m"], out["feat_b"] = m[cfg.D], b[cfg.D]
            out["views_m"], out["views_b"] = (x[cfg.D + 1, :W // 2]
                                              for x in (m, b))
    return out


def kernel_smem(cfg: NeRFConfig, dtype: torch.dtype, L_pts: int = 10,
                L_views: int = 4) -> int:
    """The dynamic shared memory one block of K6 (f32, bf16) or K7 (int8)
    takes at this shape, in bytes, from the kernel's own plan (builds the
    library)."""
    from . import _build
    skips = _n_skips(cfg)
    vd = int(cfg.use_viewdirs)
    if dtype == torch.int8:
        fn = _build.load("nerf_render_int8").nerf_render_int8_smem
        args = (cfg.W, cfg.D, skips, L_pts, L_views, vd)
    else:
        fn = _build.load("nerf_render").nerf_render_smem
        args = (cfg.W, int(dtype == torch.float32), cfg.D, skips, L_pts,
                L_views, vd)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    return int(fn(*args))


def staged_l2_bytes(cfg: NeRFConfig, dtype: torch.dtype, n: int, S: int,
                    L_pts: int = 10, L_views: int = 4) -> int:
    """The weight bytes one launch reads from L2 by design: the GEMM layers'
    stages once per 2-block cluster and group of 8 samples."""
    per_block = BLOCK_POINTS[dtype] // SAMPLES_PER_GROUP
    clusters = -(-(-(-n // per_block)) // 2)
    groups = -(-S // SAMPLES_PER_GROUP)
    return clusters * groups * stage_plan(cfg, dtype, L_pts,
                                          L_views)["gemm_bytes"]


# cos(x) as sin(x + b): Pallas _pe_matrix's bias on the cos rows, pi/2
# rounded to f32.
HALF_PI_F32 = 1.5707963705062866


def pe_ladder(p: torch.Tensor, L: int, width: int) -> torch.Tensor:
    """[..., 3] -> [..., width]: [p, sin f0 p, cos f0 p, sin f1 p, ...] by
    the teacher kernel's double-angle ladder (sin 2x = (2 sin x) cos x,
    cos 2x = (cos x - sin x)(cos x + sin x), each product rounded on its
    own, as the CUDA kernels compute it), zero-padded."""
    s, c = torch.sin(p), torch.cos(p)
    parts = [p]
    for j in range(L):
        parts += [s, c]
        if j + 1 < L:
            s, c = 2.0 * s * c, (c - s) * (c + s)
    x = torch.cat(parts, -1)
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def pe_sin(p: torch.Tensor, L: int, width: int) -> torch.Tensor:
    """``pe_ladder``'s layout without the ladder (Pallas
    ``fused_nerf_render_t(pe_ladder=False)``, ``_pe_matrix``): for each
    octave j, sin(y) and sin(y + ``HALF_PI_F32``) of y = 2^j p (exact), the
    sum rounded once in f32, each sin of its own value."""
    parts = [p]
    for j in range(L):
        y = p * float(2 ** j)
        parts += [torch.sin(y), torch.sin(y + HALF_PI_F32)]
    x = torch.cat(parts, -1)
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def pe_encoding(p: torch.Tensor, L: int, width: int,
                ladder: bool = True) -> torch.Tensor:
    """The teacher's encoding of p [..., 3]: ``pe_ladder`` (the default,
    Pallas ``pe_ladder=True``) or ``pe_sin``."""
    return (pe_ladder if ladder else pe_sin)(p, L, width)


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """|d| = sqrt(fma(z, z, fma(y, y, x*x))), as XLA contracts the sum of
    squares and as the kernels compute it."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.sqrt(fma(z, z, fma(y, y, x * x)))


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float().T


def _heads_dense(fp: FusedNeRFParams, cfg: NeRFConfig, h: torch.Tensor,
                 vpe: torch.Tensor | None, cd: torch.dtype, mm=_mm_f32):
    """f32/bf16 heads: h [m, W] in cd -> (sigma [m], rgb logits [m, 3]).
    ``mm`` computes the feature and view layers' products."""
    def lin(x, w, b, prod=_mm_f32):
        return prod(x, w) + b
    if cfg.use_viewdirs:
        sigma = lin(h, fp.alpha_w[None], fp.alpha_b)[:, 0]
        feat = lin(h, fp.feat_w, fp.feat_b, mm).to(cd)
        hv = torch.relu(lin(torch.cat([feat, vpe.to(cd)], -1), fp.views_w,
                            fp.views_b, mm)).to(cd)
        return sigma, lin(hv, fp.rgb_w, fp.rgb_b)
    out = lin(h, fp.out_w, fp.out_b)
    return out[:, 3], out[:, :3]


def _mlp_dense(fp: FusedNeRFParams, cfg: NeRFConfig, pe: torch.Tensor,
               vpe: torch.Tensor | None, ks: list[int], mm=_mm_f32):
    """f32/bf16 chain on the points' encoding pe [m, kp] (and their rays'
    view encoding vpe [m, kv - W]) -> (sigma [m], rgb logits [m, 3]).
    ``mm(x, w)`` computes the GEMM layers' products x w^T."""
    cd = fp.pts_w.dtype
    W = cfg.W
    x = pe.to(cd)
    off, h = 0, None
    for i, K in enumerate(ks):
        w = fp.pts_w[off:off + W * K].view(W, K)
        off += W * K
        inp = x if i == 0 else (torch.cat([x, h], -1)
                                if (i - 1) in cfg.skips else h)
        h = torch.relu(mm(inp, w) + fp.pts_b[i]).to(cd)
    return _heads_dense(fp, cfg, h, vpe, cd, mm)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as f32."""
    return x.to(torch.bfloat16).float()


def dequant_bf16(acc: torch.Tensor, m: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Pallas ``fused_nerf_render_t``'s ``bf16_requant`` dequantize, as XLA
    computes it without excess precision: the exact int32 sum acc (f32) to
    bf16, m and b rounded to bf16, the product rounded to bf16, then the
    sum: two roundings, never one fused multiply-add (the bf16 product of
    two bf16 values is exact in f32)."""
    return _bf16(_bf16(_bf16(acc) * _bf16(m)) + _bf16(b))


def _mlp_int8(fp: FusedNeRFParams, cfg: NeRFConfig, pe: torch.Tensor,
              vpe: torch.Tensor | None, ks: list[int],
              bf16_requant: bool = False):
    """The int8 chain (exact float64 integer dots, one-FMA dequantize; with
    ``bf16_requant`` every dequantize but the heads' in bf16,
    ``dequant_bf16``)."""
    W, D = cfg.W, cfg.D
    xq = _q8(pe, fp.pe_inv)
    off, hq = 0, None
    inner = dequant_bf16 if bf16_requant else _dequant

    def requant(v, inv):
        return _q8(v) if fp.fold_requant else _q8(v, inv)

    for i, K in enumerate(ks):
        w = fp.pts_w[off:off + W * K].view(W, K)
        off += W * K
        inp = xq if i == 0 else (torch.cat([xq, hq], -1)
                                 if (i - 1) in cfg.skips else hq)
        v = torch.relu(inner(_mm_int(inp, w), fp.pts_m[i], fp.pts_b[i]))
        hq = requant(v, fp.pts_inv[i + 1] if i + 1 < D else fp.h_inv)
    if cfg.use_viewdirs:
        sigma = _dequant(_mm_int(hq, fp.alpha_w[None]), fp.alpha_m,
                         fp.alpha_b)[:, 0]
        feat = inner(_mm_int(hq, fp.feat_w), fp.feat_m, fp.feat_b)
        fq = requant(feat, fp.hv_inv[:W])
        vq = _q8(vpe, fp.hv_inv[W:])
        hv = torch.relu(inner(_mm_int(torch.cat([fq, vq], -1),
                                      fp.views_w), fp.views_m, fp.views_b))
        hvq = requant(hv, fp.hr_inv)
        return sigma, _dequant(_mm_int(hvq, fp.rgb_w), fp.rgb_m, fp.rgb_b)
    out = _dequant(_mm_int(hq, fp.out_w), fp.out_m, fp.out_b)
    return out[:, 3], out[:, :3]


def fused_nerf_render_ref(fp: FusedNeRFParams, cfg: NeRFConfig,
                          rays_o: torch.Tensor, rays_d: torch.Tensor,
                          z_vals: torch.Tensor, L_pts: int = 10,
                          L_views: int = 4, white_bkgd: bool = False,
                          mm=_mm_f32, pe_ladder: bool = True,
                          bf16_requant: bool = False):
    """Plain version of the fused pass (the arithmetic of K6/K7 step for
    step): rays_o/d [N, 3], z_vals [N, S] sorted -> (rgb [N, 3], acc [N],
    depth [N], weights [N, S]), all f32. ``mm(x, w)``: the f32/bf16 GEMM
    layers' product x w^T (f32 by default; a test passes an emulation of
    K6 f32's 3xTF32). ``pe_ladder`` and ``bf16_requant`` are Pallas
    ``fused_nerf_render_t``'s: the encodings by the ladder or ``pe_sin``;
    int8's inner dequantize in bf16 (ignored for f32 and bf16 weights)."""
    cfg = _packed_cfg(fp, cfg)
    int8 = fp.pts_w.dtype == torch.int8
    n, S = z_vals.shape
    kp, kv, ks = layout(cfg, L_pts, L_views)
    o, d, z = rays_o.float(), rays_d.float(), z_vals.float()
    dn = _norm3(d)
    pe = pe_encoding(ray_points(o, d, z), L_pts, kp,
                     pe_ladder).reshape(n * S, kp)
    vpe = None
    if cfg.use_viewdirs:
        vpe = pe_encoding(d / dn.clamp(min=1e-12)[:, None], L_views,
                          kv - cfg.W, pe_ladder)
    sig, raw = [], []
    for r0 in range(0, n * S, ROWS):
        rows = slice(r0, min(r0 + ROWS, n * S))
        v = (vpe[torch.arange(rows.start, rows.stop, device=z.device) // S]
             if vpe is not None else None)
        s_, r_ = (_mlp_int8(fp, cfg, pe[rows], v, ks, bf16_requant)
                  if int8 else _mlp_dense(fp, cfg, pe[rows], v, ks, mm))
        sig.append(s_)
        raw.append(r_)
    sig = torch.cat(sig).view(n, S)
    raw = torch.cat(raw).view(n, S, 3)
    z_next = torch.cat([z[:, 1:], z[:, -1:] + 1e10], 1)
    dist = (z_next - z) * dn[:, None]
    trans = torch.ones_like(dn)
    rgb, acc, depth = torch.zeros_like(o), torch.zeros_like(dn), \
        torch.zeros_like(dn)
    weights = torch.empty_like(z)
    for s in range(S):
        alpha = 1.0 - torch.exp(-torch.relu(sig[:, s]) * dist[:, s])
        w = alpha * trans
        weights[:, s] = w
        rgb = fma(w[:, None], torch.sigmoid(raw[:, s]), rgb)
        acc = acc + w
        depth = fma(w, z[:, s], depth)
        trans = trans * (1.0 - alpha + 1e-10)
    if white_bkgd:
        rgb = rgb + (1.0 - acc)[:, None]
    return rgb, acc, depth, weights


def _packed_cfg(fp: FusedNeRFParams, cfg: NeRFConfig) -> NeRFConfig:
    """``cfg`` at the width ``fp`` was packed at (``prepare_fused_nerf``'s
    ``pad``)."""
    W = fp.pts_b.shape[-1]
    return cfg if W == cfg.W else dataclasses.replace(cfg, W=W)


def fused_teacher_supported(cfg: NeRFConfig) -> bool:
    """Whether K6/K7 (or their wide form) take the teacher network
    ``cfg``: any W >= 1 and D >= 1 with every skip before the last layer,
    which is every teacher the JAX package's model builds (a skip at the
    last layer would feed the heads W + input_ch channels where
    ``init_nerf`` gives them W)."""
    return (cfg.W >= 1 and cfg.D >= 1
            and all(0 <= s < cfg.D - 1 for s in cfg.skips))


def _n_skips(cfg: NeRFConfig) -> int:
    """The number of point layers whose output is concatenated."""
    return len(set(cfg.skips))


def check_teacher_supported(*cfgs: NeRFConfig | None) -> None:
    """Raise NotImplementedError, before anything is packed or launched,
    where the kernels do not take one of the teacher networks ``cfgs``
    (None skipped: a teacher without a fine network)."""
    for cfg in cfgs:
        if cfg is not None and not fused_teacher_supported(cfg):
            raise NotImplementedError(
                f"the fused NeRF kernels (K6/K7 up to W"
                f"{NERF_KERNEL_WIDTHS[-1]}, their wide form above) take any "
                f"W and D with every skip before the last layer (the JAX "
                f"package's model builds no other); got W={cfg.W} "
                f"D={cfg.D} skips={cfg.skips}")


def _field_shapes(cfg: NeRFConfig, L_pts: int, L_views: int, int8: bool
                  ) -> dict[str, tuple]:
    """Each field's shape for the kernel (() for an empty field)."""
    W, D = cfg.W, cfg.D
    kp, kv, ks = layout(cfg, L_pts, L_views)
    e = (0,)
    v = cfg.use_viewdirs
    q = lambda shape: shape if int8 else e  # noqa: E731
    return {
        "pts_w": (W * sum(ks),), "pts_m": q((D, W)), "pts_b": (D, W),
        "pe_inv": q((kp,)), "pts_inv": q((D, W)),
        "alpha_w": (W,) if v else e, "alpha_m": q((1,)) if v else e,
        "alpha_b": (1,) if v else e,
        "feat_w": (W, W) if v else e, "feat_m": q((W,)) if v else e,
        "feat_b": (W,) if v else e, "h_inv": q((W,)),
        "views_w": (W // 2, kv) if v else e,
        "views_m": q((W // 2,)) if v else e,
        "views_b": (W // 2,) if v else e, "hv_inv": q((kv,)) if v else e,
        "rgb_w": (3, W // 2) if v else e, "rgb_m": q((3,)) if v else e,
        "rgb_b": (3,) if v else e, "hr_inv": q((W // 2,)) if v else e,
        "out_w": e if v else (4, W), "out_m": e if v else q((4,)),
        "out_b": e if v else (4,)}


# ---------------------------------------------------------------------------
# The wide form of K6/K7 (csrc/nerf_wide.cu), above NERF_KERNEL_WIDTHS
# ---------------------------------------------------------------------------

def wide_teacher_plan(cfg: NeRFConfig, dtype: torch.dtype, L_pts: int = 10,
                      L_views: int = 4) -> dict:
    """The wide form's image of ``cfg`` in ``dtype``, every width at the
    next multiple of ``WIDE_CHANNELS`` ('Wp'; the view layer's W/2 outputs
    at 'Vp'): 'layers', each GEMM layer's (outputs, input channels) as
    staged (the D point layers, then with viewdirs the feature and the view
    layer); 'ke', 'kve' the point and view encodings' channels as staged
    (their packed columns padded to 128 bytes); 'parts', the weights'
    parts (f32: the TF32 high and low parts, each a matrix of its own);
    'heads_off' (alpha [Wp] and rgb [3, Vp], or output_linear [4, Wp], in
    ``dtype``), 'table_off' (each layer's (m, b, inv, 0) f32 a channel)
    and 'nbytes'."""
    W = cfg.W
    kp, kv, _ = layout(cfg, L_pts, L_views)
    es = torch.empty(0, dtype=dtype).element_size()
    Wp, Vp = _round_up(W, WIDE_CHANNELS), _round_up(W // 2, WIDE_CHANNELS)
    ke = _round_up(kp * es, 128) // es
    kve = _round_up((kv - W) * es, 128) // es if cfg.use_viewdirs else 0
    layers = [(Wp, ke)] + [(Wp, ke + Wp if (i - 1) in cfg.skips else Wp)
                           for i in range(1, cfg.D)]
    if cfg.use_viewdirs:
        layers += [(Wp, Wp), (Vp, Wp + kve)]
    parts = 2 if dtype == torch.float32 else 1
    heads_off = sum(n * k for n, k in layers) * es * parts
    heads = (Wp + 3 * Vp if cfg.use_viewdirs else 4 * Wp) * es
    table_off = heads_off + heads
    return {"layers": layers, "Wp": Wp, "Vp": Vp, "kp": kp, "ke": ke,
            "kvw": kv - W if cfg.use_viewdirs else 0, "kve": kve,
            "parts": parts, "heads_off": heads_off, "table_off": table_off,
            "nbytes": table_off + 16 * sum(n for n, _ in layers)}


def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """w [r, c] zero-padded to [rows, cols]."""
    return torch.nn.functional.pad(w, (0, cols - w.shape[1],
                                       0, rows - w.shape[0]))


def _wide_mats(fp: FusedNeRFParams, cfg: NeRFConfig, plan: dict) -> list:
    """Each GEMM layer's weights [N, K] as the wide image stages them: the
    encodings' columns padded to 'ke' / 'kve', the widths to 'Wp' / 'Vp'."""
    W, Wp, Vp, kp = cfg.W, plan["Wp"], plan["Vp"], plan["kp"]
    ke, kve = plan["ke"], plan["kve"]
    mats, off = [], 0
    for i, (_, K) in enumerate(plan["layers"][:cfg.D]):
        k_in = kp if i == 0 else (kp + W if K != Wp else W)
        w = fp.pts_w[off:off + W * k_in].view(W, k_in)
        off += W * k_in
        if i == 0:
            w = _pad2(w, Wp, ke)
        elif K != Wp:   # [encoding | h]
            w = torch.cat([_pad2(w[:, :kp], Wp, ke),
                           _pad2(w[:, kp:], Wp, Wp)], 1)
        else:
            w = _pad2(w, Wp, Wp)
        mats.append(w)
    if cfg.use_viewdirs:
        vw = fp.views_w
        mats += [_pad2(fp.feat_w, Wp, Wp),
                 torch.cat([_pad2(vw[:, :W], Vp, Wp),
                            _pad2(vw[:, W:], Vp, kve)], 1)]
    return mats


def _wide_table(fp: FusedNeRFParams, cfg: NeRFConfig, plan: dict
                ) -> torch.Tensor:
    """f32 [sum N, 4]: each GEMM layer's (m, b, inv, 0) a channel: int8's
    dequantize multiplier and bias and the inverse scale its consumer's
    requantize multiplies by (1 where folded, and for f32/bf16, whose
    epilogue reads the bias alone); padded channels (0, 0, 1, 0)."""
    W, D = cfg.W, cfg.D
    int8 = fp.pts_w.dtype == torch.int8
    unfolded = int8 and not fp.fold_requant
    ms = ([fp.pts_m[i] for i in range(D)] + [fp.feat_m, fp.views_m]
          if int8 else [])
    bs = [fp.pts_b[i] for i in range(D)] + [fp.feat_b, fp.views_b]
    invs = ([fp.pts_inv[i] for i in range(1, D)]
            + [fp.h_inv, fp.hv_inv[:W], fp.hr_inv] if unfolded else [])
    rows = []
    for i, (n, _) in enumerate(plan["layers"]):
        t = torch.zeros((n, 4), dtype=torch.float32, device=fp.pts_b.device)
        t[:, 2] = 1.0
        t[:bs[i].numel(), 1] = bs[i].float()
        if ms:
            t[:ms[i].numel(), 0] = ms[i].float()
        if invs:
            t[:invs[i].numel(), 2] = invs[i].float()
        rows.append(t)
    return torch.cat(rows)


def _wide_layer_bytes(w: torch.Tensor) -> torch.Tensor:
    """A GEMM layer's weights [N, K] as the wide image holds them: bf16 and
    int8 row-major, which the TMA pass reads in boxes; f32 its TF32 high
    parts [N, K], then its low parts (``tf32_split``)."""
    parts = tf32_split(w) if w.dtype == torch.float32 else (w,)
    return torch.cat([p.contiguous().view(torch.uint8).reshape(-1)
                      for p in parts])


def stage_wide_teacher(fp: FusedNeRFParams, cfg: NeRFConfig,
                       L_pts: int = 10, L_views: int = 4) -> torch.Tensor:
    """The wide form's image (uint8, ``wide_teacher_plan``): each GEMM
    layer's weights (``_wide_layer_bytes``), the head weights padded (in
    their own dtype, f32 whole), then the epilogue table
    (``_wide_table``)."""
    plan = wide_teacher_plan(cfg, fp.pts_w.dtype, L_pts, L_views)
    Wp, Vp = plan["Wp"], plan["Vp"]
    parts = [_wide_layer_bytes(w) for w in _wide_mats(fp, cfg, plan)]
    if cfg.use_viewdirs:
        heads = [_pad2(fp.alpha_w[None], 1, Wp), _pad2(fp.rgb_w, 3, Vp)]
    else:
        heads = [_pad2(fp.out_w, 4, Wp)]
    parts += [_bytes(h).reshape(-1) for h in heads]
    parts.append(_bytes(_wide_table(fp, cfg, plan)).reshape(-1))
    return torch.cat(parts).contiguous()


def unstage_wide_teacher(staged: torch.Tensor, cfg: NeRFConfig,
                         dtype: torch.dtype, L_pts: int = 10,
                         L_views: int = 4) -> dict[str, torch.Tensor]:
    """The packed fields back from a wide image: 'pts_w' (flat), 'feat_w',
    'views_w' [W/2, kv], the heads ('alpha_w', 'rgb_w' or 'out_w') at the
    packed shapes, with 'padding' the largest |value| of the image's
    padded rows and columns; and 'table', the epilogue table [sum N, 4].
    f32: the GEMM fields are the weights' TF32 high parts, and 'pts_w_lo',
    'feat_w_lo', 'views_w_lo' their low parts."""
    plan = wide_teacher_plan(cfg, dtype, L_pts, L_views)
    W, Wp, Vp, kp, ke = cfg.W, plan["Wp"], plan["Vp"], plan["kp"], plan["ke"]
    es = torch.empty(0, dtype=dtype).element_size()
    pos, pad = 0, 0.0

    def take(nbytes):
        nonlocal pos
        pos += nbytes
        return staged[pos - nbytes:pos]

    def cut(w, rows, cols):
        """w's leading [rows, cols]; the rest is padding."""
        nonlocal pad
        rest = w.clone()
        rest[:rows, :cols] = 0
        pad = max(pad, float(rest.float().abs().max()) if rest.numel()
                  else 0.0)
        return w[:rows, :cols]

    def layer(n, k):   # _wide_layer_bytes' inverse: its parts
        return list(take(n * k * es * plan["parts"]).clone().view(
            dtype).view(plan["parts"], n, k))

    out = {}
    mats = [layer(n, k) for n, k in plan["layers"]]
    for p, suffix in enumerate(["", "_lo"][:plan["parts"]]):
        pts = []
        for i, w in enumerate(m[p] for m in mats[:cfg.D]):
            if i == 0:
                pts.append(cut(w, W, kp))
            elif w.shape[1] != Wp:
                pts.append(torch.cat([cut(w[:, :ke], W, kp),
                                      cut(w[:, ke:], W, W)], 1))
            else:
                pts.append(cut(w, W, W))
        out["pts_w" + suffix] = torch.cat([w.reshape(-1) for w in pts])
        if cfg.use_viewdirs:
            vw = mats[cfg.D + 1][p]
            out["feat_w" + suffix] = cut(mats[cfg.D][p], W, W)
            out["views_w" + suffix] = torch.cat(
                [cut(vw[:, :Wp], W // 2, W),
                 cut(vw[:, Wp:], W // 2, plan["kvw"])], 1)
    if cfg.use_viewdirs:
        out["alpha_w"] = cut(take(Wp * es).clone().view(dtype)[None], 1,
                             W)[0]
        out["rgb_w"] = cut(take(3 * Vp * es).clone().view(dtype).view(
            3, Vp), 3, W // 2)
    else:
        out["out_w"] = cut(take(4 * Wp * es).clone().view(dtype).view(
            4, Wp), 4, W)
    out["table"] = take(plan["nbytes"] - plan["table_off"]).clone().view(
        torch.float32).view(-1, 4)
    out["padding"] = torch.tensor(pad)
    return out


def teacher_wide_scratch_bytes(rows: int, W: int, dtype: torch.dtype,
                               ke: int = 0, kve: int = 0) -> int:
    """The scratch one wide call needs for passes of ``rows`` points
    (``csrc/nerf_wide.cu``, scratch_bytes): two activation buffers [rows,
    Wp] of the compute type (int8: the codes), sigma [rows] and the rgb
    logits [rows, 4] f32, then the point and view encodings [rows, ke] and
    [rows, kve] (``wide_teacher_plan``'s; int8: their codes), each 256-byte
    aligned."""
    es = torch.empty(0, dtype=dtype).element_size()
    Wp = _round_up(W, WIDE_CHANNELS)
    return 2 * _aligned(rows * Wp * es) + _aligned(4 * rows) \
        + _aligned(16 * rows) + _aligned(rows * ke * es) \
        + _aligned(rows * kve * es)


def teacher_wide_rays(n: int, S: int, W: int, dtype: torch.dtype,
                      ke: int = 0, kve: int = 0) -> int:
    """Rays a pass of a wide call on n rays of S samples: all of them, or
    as many as keep the scratch within ``WIDE_SCRATCH_BYTES`` (a pass
    holds whole rays, whose samples the compositing walks in order)."""
    es = torch.empty(0, dtype=dtype).element_size()
    per_ray = S * ((2 * _round_up(W, WIDE_CHANNELS) + ke + kve) * es + 20)
    return max(1, min(n, WIDE_SCRATCH_BYTES // per_ray))


def wide_encodings_ref(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       z_vals: torch.Tensor, L_pts: int, L_views: int,
                       ke: int, kve: int, dtype: torch.dtype,
                       pe_inv: torch.Tensor | None = None,
                       hv_inv: torch.Tensor | None = None,
                       pe_ladder: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain twin of the wide form's encoding kernel (``csrc/nerf_wide.cu``,
    wide_encode): for the n * S points of rays_o/d [n, 3], z_vals [n, S],
    the point encoding E [n * S, ke] and (``kve`` > 0) the view encoding V
    [n * S, kve], each row its ray's, in ``dtype``. Each coordinate runs
    the kernel's ladder on its own (``nerf::encode``: the value, then sin,
    cos of it and their double-angle steps into columns 3 + 6j + k and 6 +
    6j + k: ``pe_ladder``'s columns), zeros past the used columns; without
    ``pe_ladder`` ``pe_sin``'s (the kernel's nerf::sin_rows). int8: the
    codes, round-half-even of x * inv clipped to +-127, ``pe_inv`` the
    point encoding's inverse scales and ``hv_inv`` the view encoding's (the
    int8 teacher's ``hv_inv[W:]``)."""
    def encode(v: torch.Tensor, L: int, width: int, inv) -> torch.Tensor:
        out = pe_encoding(v, L, width, pe_ladder)
        if dtype != torch.int8:
            return out.to(dtype)
        used = 3 + 6 * L
        q = torch.zeros((v.shape[0], width), dtype=torch.int8,
                        device=v.device)
        q[:, :used] = _q8(out[:, :used], inv[:used].float()).to(torch.int8)
        return q
    n, S = z_vals.shape
    o, d = rays_o.float(), rays_d.float()
    E = encode(fma(d[:, None], z_vals.float()[..., None],
                   o[:, None]).reshape(n * S, 3), L_pts, ke, pe_inv)
    if not kve:
        return E, None
    v = d / torch.clamp(_norm3(d), min=1e-12)[:, None]
    return E, encode(v, L_views, kve, hv_inv).repeat_interleave(S, 0)


def _launch_teacher_wide(fp: FusedNeRFParams, cfg: NeRFConfig,
                         rays_o: torch.Tensor, rays_d: torch.Tensor,
                         z_vals: torch.Tensor, L_pts: int, L_views: int,
                         white_bkgd: bool, outs: list, forms: list) -> None:
    """One call of the wide form (every layer a pass, the heads, the
    compositing, over the rays in ``teacher_wide_rays`` passes), ``cfg`` at
    its kernel width, ``forms`` the entry point's [ladder, brq]; counted in
    ``fused_nerf_render.launches_wide`` (f32, bf16) or
    ``launches_wide_int8`` (and ``_count_forms``)."""
    from . import _build
    n, S = z_vals.shape
    wd, dev = fp.pts_w.dtype, z_vals.device
    int8 = wd == torch.int8
    plan = wide_teacher_plan(cfg, wd, L_pts, L_views)
    enc = (plan["ke"], plan["kve"])
    rays = teacher_wide_rays(n, S, cfg.W, wd, *enc)
    scratch = torch.empty(
        (teacher_wide_scratch_bytes(rays * S, cfg.W, wd, *enc),),
        dtype=torch.uint8, device=dev)
    skips = (ctypes.c_int * cfg.D)(*[int(i in cfg.skips)
                                     for i in range(cfg.D)])

    def q(t):   # int8's scales and multipliers
        return _ptr(t) if int8 and t.numel() else None

    def b(t):
        return _ptr(t) if t.numel() else None
    lib = _build.load("nerf_wide")
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if int8:
            fused_nerf_render.launches_wide_int8 += 1
        else:
            fused_nerf_render.launches_wide += 1
        _count_forms(*forms)
        rc = lib.nerf_wide_launch(
            _ptr(rays_o), _ptr(rays_d), _ptr(z_vals), n, S, _ptr(fp.staged),
            skips, cfg.D, cfg.W, _WIDE_TYPES[wd], q(fp.pe_inv), q(fp.hv_inv),
            q(fp.alpha_m), b(fp.alpha_b), q(fp.rgb_m), b(fp.rgb_b),
            q(fp.out_m), b(fp.out_b), L_pts, L_views,
            int(cfg.use_viewdirs), int(white_bkgd), *forms, *outs,
            _ptr(scratch), scratch.numel(), rays, stream)
    _raise_on_error(rc, "nerf_wide")


def _count_forms(ladder: int, brq: int) -> None:
    """Count a launch's number-changing forms: ``launches_pe_sin``
    (``pe_ladder=False``), ``launches_bf16_requant``."""
    fused_nerf_render.launches_pe_sin += 1 - ladder
    fused_nerf_render.launches_bf16_requant += brq


def fused_nerf_render(fp: FusedNeRFParams, cfg: NeRFConfig,
                      rays_o: torch.Tensor, rays_d: torch.Tensor,
                      z_vals: torch.Tensor, L_pts: int = 10,
                      L_views: int = 4, white_bkgd: bool = False,
                      pe_ladder: bool = True, bf16_requant: bool = False):
    """The fused volumetric pass: rays_o/d [N, 3] f32, z_vals [N, S] f32
    sorted -> (rgb [N, 3], acc [N], depth [N], weights [N, S]). ``fp`` comes
    from ``prepare_fused_nerf``, whose weights' dtype picks the mode and
    whose ``fold_requant`` the int8 requantize. ``pe_ladder`` and
    ``bf16_requant`` are Pallas ``fused_nerf_render_t``'s, with its
    defaults: the encodings by the double-angle ladder, or one sin a value
    (``pe_sin``); int8's inner dequantize in bf16 (``dequant_bf16``;
    ignored for f32 and bf16 weights). CPU tensors take the plain version;
    CUDA tensors launch K6 (f32/bf16 weights) or K7 (int8), or above their
    widths (``teacher_wide_form``) their wide form."""
    if z_vals.device.type == "cpu":
        return fused_nerf_render_ref(fp, cfg, rays_o, rays_d, z_vals, L_pts,
                                     L_views, white_bkgd,
                                     pe_ladder=pe_ladder,
                                     bf16_requant=bf16_requant)
    return _launch_teacher(fp, cfg, rays_o, rays_d, z_vals, L_pts, L_views,
                           white_bkgd, pe_ladder, bf16_requant)


@trace.spanned("kernel.launch")
def _launch_teacher(fp: FusedNeRFParams, cfg: NeRFConfig,
                    rays_o: torch.Tensor, rays_d: torch.Tensor,
                    z_vals: torch.Tensor, L_pts: int, L_views: int,
                    white_bkgd: bool, pe_ladder: bool, bf16_requant: bool):
    """``fused_nerf_render`` on CUDA tensors: checked here, one launch of
    K6, K7 or their wide form; counted in ``fused_nerf_render``'s
    counters."""
    from . import _build
    check_teacher_supported(cfg)
    if getattr(fp, "staged", None) is None:
        raise ValueError("fp has no staged weight image: pack it with "
                         "prepare_fused_nerf")
    cfg, dev = teacher_kernel_cfg(cfg), z_vals.device
    n, S = z_vals.shape
    f32, wd = torch.float32, fp.pts_w.dtype
    int8 = wd == torch.int8
    if not int8 and wd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be f32, bf16 or int8, got {wd}")
    _check(rays_o, "rays_o", f32, (n, 3), dev)
    _check(rays_d, "rays_d", f32, (n, 3), dev)
    _check(z_vals, "z_vals", f32, (n, S), dev)
    for name, shape in _field_shapes(cfg, L_pts, L_views, int8).items():
        t = getattr(fp, name)
        dt = wd if name.endswith("_w") and shape != (0,) else f32
        _check(t, name, dt, shape, dev)
    wide = teacher_wide_form(cfg.W)
    plan = (wide_teacher_plan if wide else stage_plan)(cfg, wd, L_pts,
                                                       L_views)
    _check(fp.staged, "staged", torch.uint8, (plan["nbytes"],), dev)
    rgb = torch.empty((n, 3), dtype=f32, device=dev)
    acc = torch.empty((n,), dtype=f32, device=dev)
    depth = torch.empty((n,), dtype=f32, device=dev)
    weights = torch.empty((n, S), dtype=f32, device=dev)
    if n == 0 or S == 0:
        return rgb, acc, depth, weights
    P = _ptr
    flags = [L_pts, L_views, int(cfg.use_viewdirs), int(white_bkgd)]
    outs = [P(rgb), P(acc), P(depth), P(weights)]
    forms = [int(pe_ladder), int(int8 and bf16_requant)]
    if wide:
        _launch_teacher_wide(fp, cfg, rays_o, rays_d, z_vals, L_pts,
                             L_views, white_bkgd, outs, forms)
        return rgb, acc, depth, weights
    skips = _n_skips(cfg)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if int8:
            lib = _build.load("nerf_render_int8")
            fused_nerf_render.launches_int8 += 1
            _count_forms(*forms)
            rc = lib.nerf_render_int8_launch(
                P(rays_o), P(rays_d), P(z_vals), n, S,
                P(fp.staged), P(fp.pts_m), P(fp.pts_b), P(fp.pe_inv),
                P(fp.pts_inv), cfg.D, skips, cfg.W,
                P(fp.alpha_m), P(fp.alpha_b), P(fp.feat_m), P(fp.feat_b),
                P(fp.h_inv), P(fp.views_m), P(fp.views_b), P(fp.hv_inv),
                P(fp.rgb_m), P(fp.rgb_b), P(fp.hr_inv), P(fp.out_m),
                P(fp.out_b), *flags, int(fp.fold_requant), *forms, *outs,
                stream)
            _raise_on_error(rc, "nerf_render_int8")
        else:
            lib = _build.load("nerf_render")
            fused_nerf_render.launches += 1
            _count_forms(*forms)
            rc = lib.nerf_render_launch(
                P(rays_o), P(rays_d), P(z_vals), n, S,
                P(fp.staged), P(fp.pts_b), cfg.D, skips, cfg.W,
                P(fp.alpha_b), P(fp.feat_b), P(fp.views_b), P(fp.rgb_b),
                P(fp.out_b), *flags, forms[0], int(wd == f32), *outs,
                stream)
            _raise_on_error(rc, "nerf_render")
    return rgb, acc, depth, weights


fused_nerf_render.launches = 0        # K6 launches
fused_nerf_render.launches_int8 = 0   # K7 launches
fused_nerf_render.launches_wide = 0        # K6's wide form (f32, bf16)
fused_nerf_render.launches_wide_int8 = 0   # K7's wide form
# of all of those, the launches with pe_ladder=False, and K7's (and its
# wide form's) with bf16_requant
fused_nerf_render.launches_pe_sin = 0
fused_nerf_render.launches_bf16_requant = 0
