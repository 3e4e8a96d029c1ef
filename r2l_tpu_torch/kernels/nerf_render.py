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

``fused_nerf_render`` runs the plain version ``fused_nerf_render_ref`` for a
tensor on the CPU only; for a CUDA tensor it launches K6 or K7, or raises.

Port layout (not the TPU's transposed ``[feature, ray]`` one): weights
``[out, in]``; the point encoding in ``nerf_embed``'s own order
``[p, sin f0 p, cos f0 p, ...]`` zero-padded to ``kp`` columns (a multiple
of 64); the skip layer's input is
``[encoding (kp) | h (W)]``; the view layer's is ``[feature (W) | view
encoding]`` zero-padded to ``kv``, a multiple of 64. In int8 the padding
columns have scale 1, as the JAX package's.

The kernels read the GEMM weights from a staged image (``stage_weights``,
made once per model by ``prepare_fused_nerf``): each layer cut into stages
of ``STAGE_K`` input channels for all its outputs, each stage laid out as
Hopper's ``wgmma`` reads B from shared memory (K-major 8-row x 16-byte core
matrices, no swizzle), so one bulk copy moves it; f32 weights as their TF32
high and low parts (3xTF32); the head weights (alpha, rgb or output_linear)
after the layers.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..models.nerf import NeRF, NeRFConfig
from ..volume import fma, ray_points
from .r2l_fused import (_act_scale, _check, _dequant, _mm_int, _ptr, _q8,
                        _raise_on_error)
from .staging import STAGE_K, stage_matrices, tf32_split  # noqa: F401

K_STAGE = 64     # every packed weight's input axis is a multiple of this
ROWS = 1 << 18   # points per slice of the plain version's MLP
# Points per block of the kernels (one cluster is two blocks); their weight
# stages' input channels are staging.STAGE_K.
BLOCK_POINTS = {torch.bfloat16: 128, torch.int8: 128, torch.float32: 64}
SAMPLES_PER_GROUP = 8


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
                       margin: float = 1.1, fold_requant: bool = False
                       ) -> FusedNeRFParams:
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
    is switched off for the calibration.
    """
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
    return fp._replace(staged=stage_weights(fp, cfg, L_pts, L_views))


def stage_plan(cfg: NeRFConfig, dtype: torch.dtype, L_pts: int = 10,
               L_views: int = 4) -> dict:
    """The staged image's shape: 'layers', each GEMM layer's (outputs,
    staged input width) in order (the D point layers, then with viewdirs
    the feature and the view layer); the point and view encodings' widths
    as staged ('kpe', 'kve', a multiple of ``STAGE_K``) and as packed
    ('kp', 'kvw' = kv - W); 'gemm_bytes', the layers' bytes (the heads
    follow them)."""
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
    return {"layers": layers, "kp": kp, "kpe": kpe, "kvw": kvw, "kve": kve,
            "gemm_bytes": gemm, "epi_off": epi, "nbytes": epi + table}


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
    boundary."""
    wd = fp.pts_w.dtype
    k = STAGE_K[wd]
    mats, heads = _gemm_mats(fp, cfg, L_pts, L_views)
    parts = [stage_matrices(w, k) for w in mats]
    parts += [_bytes(h).reshape(-1) for h in heads]
    out = torch.cat(parts)
    out = torch.nn.functional.pad(out, (0, -out.numel() % 16))
    if wd == torch.int8:
        out = torch.cat([out, _bytes(_epi_table(fp, cfg)).reshape(-1)])
    return out.contiguous()


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
        t = staged[plan["epi_off"]:].clone().view(torch.float32).view(
            len(plan["layers"]), W // 2, 4)
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
    skips = sum(1 << s for s in cfg.skips)
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


def _mlp_int8(fp: FusedNeRFParams, cfg: NeRFConfig, pe: torch.Tensor,
              vpe: torch.Tensor | None, ks: list[int]):
    """The int8 chain (exact float64 integer dots, one-FMA dequantize)."""
    W, D = cfg.W, cfg.D
    xq = _q8(pe, fp.pe_inv)
    off, hq = 0, None

    def requant(v, inv):
        return _q8(v) if fp.fold_requant else _q8(v, inv)

    for i, K in enumerate(ks):
        w = fp.pts_w[off:off + W * K].view(W, K)
        off += W * K
        inp = xq if i == 0 else (torch.cat([xq, hq], -1)
                                 if (i - 1) in cfg.skips else hq)
        v = torch.relu(_dequant(_mm_int(inp, w), fp.pts_m[i], fp.pts_b[i]))
        hq = requant(v, fp.pts_inv[i + 1] if i + 1 < D else fp.h_inv)
    if cfg.use_viewdirs:
        sigma = _dequant(_mm_int(hq, fp.alpha_w[None]), fp.alpha_m,
                         fp.alpha_b)[:, 0]
        feat = _dequant(_mm_int(hq, fp.feat_w), fp.feat_m, fp.feat_b)
        fq = requant(feat, fp.hv_inv[:W])
        vq = _q8(vpe, fp.hv_inv[W:])
        hv = torch.relu(_dequant(_mm_int(torch.cat([fq, vq], -1),
                                         fp.views_w), fp.views_m,
                                 fp.views_b))
        hvq = requant(hv, fp.hr_inv)
        return sigma, _dequant(_mm_int(hvq, fp.rgb_w), fp.rgb_m, fp.rgb_b)
    out = _dequant(_mm_int(hq, fp.out_w), fp.out_m, fp.out_b)
    return out[:, 3], out[:, :3]


def fused_nerf_render_ref(fp: FusedNeRFParams, cfg: NeRFConfig,
                          rays_o: torch.Tensor, rays_d: torch.Tensor,
                          z_vals: torch.Tensor, L_pts: int = 10,
                          L_views: int = 4, white_bkgd: bool = False,
                          mm=_mm_f32):
    """Plain version of the fused pass (the arithmetic of K6/K7 step for
    step): rays_o/d [N, 3], z_vals [N, S] sorted -> (rgb [N, 3], acc [N],
    depth [N], weights [N, S]), all f32. ``mm(x, w)``: the f32/bf16 GEMM
    layers' product x w^T (f32 by default; a test passes an emulation of
    K6 f32's 3xTF32)."""
    int8 = fp.pts_w.dtype == torch.int8
    n, S = z_vals.shape
    kp, kv, ks = layout(cfg, L_pts, L_views)
    o, d, z = rays_o.float(), rays_d.float(), z_vals.float()
    dn = _norm3(d)
    pe = pe_ladder(ray_points(o, d, z), L_pts, kp).reshape(n * S, kp)
    vpe = None
    if cfg.use_viewdirs:
        vpe = pe_ladder(d / dn.clamp(min=1e-12)[:, None], L_views,
                        kv - cfg.W)
    sig, raw = [], []
    for r0 in range(0, n * S, ROWS):
        rows = slice(r0, min(r0 + ROWS, n * S))
        v = (vpe[torch.arange(rows.start, rows.stop, device=z.device) // S]
             if vpe is not None else None)
        s_, r_ = (_mlp_int8(fp, cfg, pe[rows], v, ks) if int8
                  else _mlp_dense(fp, cfg, pe[rows], v, ks, mm))
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


def _check_supported(cfg: NeRFConfig) -> None:
    if cfg.W not in (128, 256):
        raise ValueError(f"the fused NeRF kernels take W 128 or 256, got "
                         f"{cfg.W}")
    if cfg.D > 31 or any(not 0 <= s < cfg.D - 1 for s in cfg.skips):
        raise ValueError(f"the fused NeRF kernels take D <= 31 and skips "
                         f"before the last layer; got D={cfg.D} skips="
                         f"{cfg.skips}")


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


def fused_nerf_render(fp: FusedNeRFParams, cfg: NeRFConfig,
                      rays_o: torch.Tensor, rays_d: torch.Tensor,
                      z_vals: torch.Tensor, L_pts: int = 10,
                      L_views: int = 4, white_bkgd: bool = False):
    """The fused volumetric pass: rays_o/d [N, 3] f32, z_vals [N, S] f32
    sorted -> (rgb [N, 3], acc [N], depth [N], weights [N, S]). ``fp`` comes
    from ``prepare_fused_nerf``, whose weights' dtype picks the mode and
    whose ``fold_requant`` the int8 requantize. CPU tensors take the plain
    version; CUDA tensors launch K6 (f32/bf16 weights) or K7 (int8)."""
    if z_vals.device.type == "cpu":
        return fused_nerf_render_ref(fp, cfg, rays_o, rays_d, z_vals, L_pts,
                                     L_views, white_bkgd)
    from . import _build
    _check_supported(cfg)
    dev = z_vals.device
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
    if fp.staged is None:
        raise ValueError("fp has no staged weight image: pack it with "
                         "prepare_fused_nerf")
    _check(fp.staged, "staged", torch.uint8,
           (stage_plan(cfg, wd, L_pts, L_views)["nbytes"],), dev)
    rgb = torch.empty((n, 3), dtype=f32, device=dev)
    acc = torch.empty((n,), dtype=f32, device=dev)
    depth = torch.empty((n,), dtype=f32, device=dev)
    weights = torch.empty((n, S), dtype=f32, device=dev)
    if n == 0 or S == 0:
        return rgb, acc, depth, weights
    skips = sum(1 << s for s in cfg.skips)
    P = _ptr
    flags = [L_pts, L_views, int(cfg.use_viewdirs), int(white_bkgd)]
    outs = [P(rgb), P(acc), P(depth), P(weights)]
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if int8:
            lib = _build.load("nerf_render_int8")
            fused_nerf_render.launches_int8 += 1
            rc = lib.nerf_render_int8_launch(
                P(rays_o), P(rays_d), P(z_vals), n, S,
                P(fp.staged), P(fp.pts_m), P(fp.pts_b), P(fp.pe_inv),
                P(fp.pts_inv), cfg.D, skips, cfg.W,
                P(fp.alpha_m), P(fp.alpha_b), P(fp.feat_m), P(fp.feat_b),
                P(fp.h_inv), P(fp.views_m), P(fp.views_b), P(fp.hv_inv),
                P(fp.rgb_m), P(fp.rgb_b), P(fp.hr_inv), P(fp.out_m),
                P(fp.out_b), *flags, int(fp.fold_requant), *outs, stream)
            _raise_on_error(rc, "nerf_render_int8")
        else:
            lib = _build.load("nerf_render")
            fused_nerf_render.launches += 1
            rc = lib.nerf_render_launch(
                P(rays_o), P(rays_d), P(z_vals), n, S,
                P(fp.staged), P(fp.pts_b), cfg.D, skips, cfg.W,
                P(fp.alpha_b), P(fp.feat_b), P(fp.views_b), P(fp.rgb_b),
                P(fp.out_b), *flags, int(wd == f32), *outs, stream)
            _raise_on_error(rc, "nerf_render")
    return rgb, acc, depth, weights


fused_nerf_render.launches = 0        # K6 launches
fused_nerf_render.launches_int8 = 0   # K7 launches
