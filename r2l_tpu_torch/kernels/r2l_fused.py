"""PE-fused R2L forward kernels: wrappers, plain versions and packing.

Counterpart of ``r2l_tpu/kernels/r2l_pallas.py`` (:37-233 and :338-664).
Two kernels carry the student frame:

* ``fused_r2l_apply_pe`` (``csrc/r2l_pe_fused.cu``): positional encoding by
  the double-angle ladder, head Linear+ReLU, the ResMLP blocks, the global
  residual and the Linear+sigmoid tail in one kernel. Weights bf16 (or f32),
  biases f32, activations rounded to the compute dtype between layers, f32
  accumulation. Its plain version follows the Pallas ``_kernel_body``
  rounding points (bias added in f32 before the cast), not ``apply_r2l``'s.
* ``fused_r2l_apply_int8_pe`` (``csrc/r2l_int8_pe_fused.cu``): the same
  chain in static-scale int8 (``fold_requant=True, nobf16_inner=True`` of
  ``_int8_pe_chain``), with parameters from ``calibrate_r2l_int8_pe``.

Each public wrapper runs its plain PyTorch version for a tensor on the CPU
only. For a CUDA tensor it launches the kernel or raises.

Kernel layout: weights are packed ``[out, in]`` (``nn.Linear``'s layout,
the transpose of JAX's), so that a kernel copies each output channel's
slice of a weight stage as contiguous 16-byte pieces; the head's input
columns are zero-padded to a multiple of ``K_ALIGN`` for the same reason.
The TPU kernels' 128-lane padding and ray ``tile`` are not ported: each
CUDA kernel picks its own ray tile.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models.r2l import R2L, R2LConfig

K_ALIGN = 128  # head input columns are padded to a multiple of this


def _padded_in(in_dim: int) -> int:
    return -(-in_dim // K_ALIGN) * K_ALIGN


class FusedParamsPE(NamedTuple):
    """Kernel-layout parameters of ``fused_r2l_apply_pe`` (weights
    [out, in], head columns freq-major and zero-padded)."""
    head_w: torch.Tensor   # [W, in_pad]    weight dtype (bf16 or f32)
    head_b: torch.Tensor   # [W]            f32
    body_w: torch.Tensor   # [nb*nl, W, W]  weight dtype, [out, in]
    body_b: torch.Tensor   # [nb*nl, W]     f32
    tail_w: torch.Tensor   # [out_dim, W]   weight dtype
    tail_b: torch.Tensor   # [out_dim]      f32


class FusedParamsInt8PE(NamedTuple):
    """Static-scale int8 parameters (all scales folded, PE freq-major,
    weights [out, in])."""
    head_q: torch.Tensor    # [W, in_pad] int8 (input scales absorbed)
    head_m: torch.Tensor    # [W] f32 dequant multiplier
    head_b: torch.Tensor    # [W] f32
    head_inv: torch.Tensor  # [in_dim] f32 inverse input scale per column
    body_q: torch.Tensor    # [nb*nl, W, W] int8, [out, in]
    body_m: torch.Tensor    # [nb*nl, W] f32 (res_scale folded into tails)
    body_b: torch.Tensor    # [nb*nl, W] f32 (res_scale folded into tails)
    body_inv: torch.Tensor  # [nb*nl, W] f32 inverse input scale
    tail_q: torch.Tensor    # [out_dim, W] int8
    tail_m: torch.Tensor    # [out_dim] f32
    tail_b: torch.Tensor    # [out_dim] f32
    tail_inv: torch.Tensor  # [W] f32


def fused_kernel_supported(cfg: R2LConfig) -> bool:
    """The kernels hardcode the canonical activations (ReLU head and
    in-block, no block out-activation, ResMLP body)."""
    return (cfg.act == "relu" and cfg.inact == "relu"
            and cfg.outact == "none" and cfg.body_arch == "resmlp")


def _assert_fused_supported(cfg: R2LConfig) -> None:
    if not fused_kernel_supported(cfg):
        raise NotImplementedError(
            f"fused kernel supports act/inact='relu', outact='none', "
            f"body_arch='resmlp'; got act={cfg.act!r} inact={cfg.inact!r} "
            f"outact={cfg.outact!r} body_arch={cfg.body_arch!r}")


def _pe_sin_cos_ladder(p: torch.Tensor, L: int
                       ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """sin/cos of p * 2^j for j in [0, L) by the double-angle recurrence
    (sin 2x = 2 sin x cos x, cos 2x = 1 - 2 sin^2 x): two transcendentals
    per scalar, about 6e-5 from direct sin at L=10. Each product is rounded
    on its own, as the CUDA kernels compute it."""
    s, c = torch.sin(p), torch.cos(p)
    sins, coss = [s], [c]
    for _ in range(1, L):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        sins.append(s)
        coss.append(c)
    return sins, coss


def _pe_row_permutation(dim_pts: int, L: int) -> np.ndarray:
    """Freq-major feature (p, s) <- per-scalar feature s*(2L+1) + p."""
    per = 2 * L + 1
    perm = np.empty(dim_pts * per, dtype=np.int64)
    for p in range(per):
        for s in range(dim_pts):
            perm[p * dim_pts + s] = s * per + p
    return perm


def _pack(w_in_out: torch.Tensor, dtype: torch.dtype,
          pad_in: bool = False) -> torch.Tensor:
    """[in, out] (or [nbl, in, out]) -> contiguous [out, in] in ``dtype``,
    the in axis zero-padded to ``K_ALIGN`` when ``pad_in``."""
    w = w_in_out.transpose(-1, -2).to(dtype)
    if pad_in:
        w = torch.nn.functional.pad(w, (0, _padded_in(w.shape[-1]) -
                                        w.shape[-1]))
    return w.contiguous()


def _stacked_weights(model: R2L) -> tuple[torch.Tensor, ...]:
    """(head_w [in, W], head_b, body_w [nb*nl, W, W], body_b,
    tail_w [W, out], tail_b), f32, weights [in, out] as in JAX."""
    head, body, tail = model.linears()
    body_w = torch.stack([m.weight.detach().T for m in body]).float()
    body_b = torch.stack([m.bias.detach() for m in body]).float()
    return (head.weight.detach().T.float(), head.bias.detach().float(),
            body_w, body_b, tail.weight.detach().T.float(),
            tail.bias.detach().float())


@torch.no_grad()
def prepare_fused_params_pe(model: R2L, cfg: R2LConfig, dim_pts: int,
                            L: int = 10,
                            weight_dtype: torch.dtype = torch.bfloat16
                            ) -> FusedParamsPE:
    """Pack the model for the PE-fused kernel (freq-major head rows)."""
    _assert_fused_supported(cfg)
    if cfg.input_dim != dim_pts * (2 * L + 1):
        raise ValueError(f"input_dim {cfg.input_dim} != dim_pts*(2L+1) = "
                         f"{dim_pts * (2 * L + 1)}")
    hw, hb, bw, bb, tw, tb = _stacked_weights(model)
    perm = torch.from_numpy(_pe_row_permutation(dim_pts, L)).to(hw.device)
    wd = weight_dtype
    return FusedParamsPE(
        head_w=_pack(hw[perm], wd, pad_in=True), head_b=hb.contiguous(),
        body_w=_pack(bw, wd), body_b=bb.contiguous(),
        tail_w=_pack(tw, wd), tail_b=tb.contiguous())


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [N, K] times packed w [out, >=K]: a dot with f32 accumulation of
    the exact products (bf16 x bf16 fits an f32 mantissa), as
    ``preferred_element_type=f32``. Full f32 needs TF32 off on the GPU,
    which is PyTorch's default for matmul."""
    return a.float() @ w[:, :a.shape[1]].float().T


def fused_r2l_apply_pe_ref(fp: FusedParamsPE, cfg: R2LConfig,
                           pts: torch.Tensor, dim_pts: int,
                           L: int = 10) -> torch.Tensor:
    """Plain version of ``fused_r2l_apply_pe`` (Pallas ``_kernel_body``
    with the PE kernel's input): pts [N, dim_pts] -> [N, out_dim] f32."""
    cd = (torch.float32 if fp.head_w.dtype == torch.float32
          else cfg.compute_dtype)
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, L)
    x = torch.cat([s.to(cd) for s in sins] + [c.to(cd) for c in coss]
                  + [p.to(cd)], dim=1)
    h0 = torch.relu(_mm_f32(x, fp.head_w) + fp.head_b).to(cd)
    h = h0
    nl = cfg.n_learnable
    for i in range(cfg.num_blocks):
        acc = h
        for j in range(nl):
            acc_f = _mm_f32(acc, fp.body_w[i * nl + j]) + fp.body_b[i * nl + j]
            if j < nl - 1:
                acc_f = torch.relu(acc_f)
            acc = acc_f.to(cd)
        h = (acc.float() * cfg.res_scale + h.float()).to(cd)
    if cfg.use_residual:
        h = (h.float() + h0.float()).to(cd)
    out = _mm_f32(h, fp.tail_w) + fp.tail_b
    return out if cfg.linear_tail else torch.sigmoid(out)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def fused_r2l_apply_pe(fp: FusedParamsPE, cfg: R2LConfig,
                       pts: torch.Tensor, dim_pts: int,
                       L: int = 10) -> torch.Tensor:
    """pts [N, dim_pts] raw sample points -> RGB [N, out_dim] f32.

    Positional encoding runs inside the kernel; ``fp`` comes from
    ``prepare_fused_params_pe``. CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return fused_r2l_apply_pe_ref(fp, cfg, pts, dim_pts, L)
    from . import _build
    _assert_fused_supported(cfg)
    dev, W, wd = pts.device, cfg.netwidth, fp.head_w.dtype
    nbl = cfg.num_blocks * cfg.n_learnable
    in_dim, out_dim = dim_pts * (2 * L + 1), fp.tail_w.shape[0]
    if wd not in (torch.bfloat16, torch.float32):
        raise TypeError(f"weights must be bf16 or f32, got {wd}")
    if wd == torch.bfloat16 and cfg.compute_dtype != torch.bfloat16:
        raise TypeError("bf16 weights need compute_dtype=torch.bfloat16")
    _check(pts, "pts", torch.float32, (pts.shape[0], dim_pts), dev)
    for name, t, dt, shape in (
            ("head_w", fp.head_w, wd, (W, _padded_in(in_dim))),
            ("head_b", fp.head_b, torch.float32, (W,)),
            ("body_w", fp.body_w, wd, (nbl, W, W)),
            ("body_b", fp.body_b, torch.float32, (nbl, W)),
            ("tail_w", fp.tail_w, wd, (out_dim, W)),
            ("tail_b", fp.tail_b, torch.float32, (out_dim,))):
        _check(t, name, dt, shape, dev)
    out = torch.empty((pts.shape[0], out_dim), dtype=torch.float32,
                      device=dev)
    if pts.shape[0] == 0:
        return out
    lib = _build.load("r2l_pe_fused")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fused_r2l_apply_pe.launches += 1
        rc = lib.r2l_pe_fused_launch(
            _ptr(pts), pts.shape[0], dim_pts, L,
            _ptr(fp.head_w), _ptr(fp.head_b), _ptr(fp.body_w),
            _ptr(fp.body_b), _ptr(fp.tail_w), _ptr(fp.tail_b), _ptr(out),
            W, cfg.num_blocks, cfg.n_learnable, out_dim,
            float(cfg.res_scale), int(cfg.use_residual),
            int(cfg.linear_tail), int(wd == torch.float32),
            ctypes.c_void_p(stream))
    _raise_on_error(rc, "r2l_pe_fused")
    return out


fused_r2l_apply_pe.launches = 0


# ---------------------------------------------------------------------------
# Static-scale int8 (r2l_pallas.py:338-664)
# ---------------------------------------------------------------------------

def _quant_cols_scaled(w: torch.Tensor, s_in: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absorb per-input-channel scales, then quantize per out column:
    w [in, out], s_in [in] -> (int8 [in, out], dequant multiplier [out])."""
    w_eff = w.float() * s_in[:, None]
    ws = torch.clamp(w_eff.abs().amax(dim=0), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w_eff / ws), -127, 127).to(torch.int8)
    return q, ws


def _act_scale(x: torch.Tensor, margin: float) -> torch.Tensor:
    """Per-channel activation scale max|x| * margin / 127."""
    return torch.clamp(x.abs().amax(dim=0), min=1e-6) * (margin / 127.0)


@torch.no_grad()
def calibrate_r2l_int8_pe(model: R2L, cfg: R2LConfig, dim_pts: int, L: int,
                          calib_pts: torch.Tensor, margin: float = 1.1,
                          fold_requant: bool = True) -> FusedParamsInt8PE:
    """Calibrate per-(layer, channel) activation ranges on sample points and
    pack the int8 kernel parameters (a plain function, not a kernel).

    An f32 forward over ``calib_pts`` [n, dim_pts] (direct sin/cos, not
    the ladder) records each layer's input max-abs; scales are
    max-abs * ``margin`` / 127. ``fold_requant`` pre-multiplies the next
    inner layer's inverse input scale into this layer's multiplier and
    bias, so the kernel's inner requantize is round+clip only. TF32 is
    switched off for the duration: it would move every scale.
    """
    _assert_fused_supported(cfg)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _calibrate(model, cfg, dim_pts, L, calib_pts, margin,
                          fold_requant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _calibrate(model: R2L, cfg: R2LConfig, dim_pts: int, L: int,
               calib_pts: torch.Tensor, margin: float,
               fold_requant: bool) -> FusedParamsInt8PE:
    nb, nl = cfg.num_blocks, cfg.n_learnable
    rs = float(cfg.res_scale)
    head_w, head_b, body_w, body_b, tail_w, tail_b = _stacked_weights(model)
    perm = torch.from_numpy(_pe_row_permutation(dim_pts, L)).to(
        head_w.device)
    head_w = head_w[perm]

    p = calib_pts.float()
    x = torch.cat([torch.sin(p * (2.0 ** j)) for j in range(L)]
                  + [torch.cos(p * (2.0 ** j)) for j in range(L)] + [p],
                  dim=1)
    s_x = _act_scale(x, margin)
    h = torch.relu(x @ head_w + head_b)
    h0 = h
    s_body = []
    for i in range(nb):
        h_in = h
        for j in range(nl):
            idx = i * nl + j
            s_body.append(_act_scale(h, margin))
            t = h @ body_w[idx] + body_b[idx]
            if j < nl - 1:
                t = torch.relu(t)
            h = t
        h = h * rs + h_in
    if cfg.use_residual:
        h = h + h0
    s_tail = _act_scale(h, margin)

    head_q, head_m = _quant_cols_scaled(head_w, s_x)
    qs, ms, bs = [], [], []
    for idx in range(nb * nl):
        q, m = _quant_cols_scaled(body_w[idx], s_body[idx])
        b = body_b[idx]
        if idx % nl == nl - 1:                 # block tail: fold res_scale
            m, b = m * rs, b * rs
        elif fold_requant:                     # fold the next inverse scale
            inv_next = 1.0 / s_body[idx + 1]
            m, b = m * inv_next, b * inv_next
        qs.append(q)
        ms.append(m)
        bs.append(b)
    tail_q, tail_m = _quant_cols_scaled(tail_w, s_tail)
    i8 = torch.int8
    return FusedParamsInt8PE(
        head_q=_pack(head_q, i8, pad_in=True), head_m=head_m.contiguous(),
        head_b=head_b.contiguous(), head_inv=(1.0 / s_x).contiguous(),
        body_q=_pack(torch.stack(qs), i8),
        body_m=torch.stack(ms).contiguous(),
        body_b=torch.stack(bs).contiguous(),
        body_inv=(1.0 / torch.stack(s_body)).contiguous(),
        tail_q=_pack(tail_q, i8), tail_m=tail_m.contiguous(),
        tail_b=tail_b.contiguous(), tail_inv=(1.0 / s_tail).contiguous())


def _q8(x: torch.Tensor, inv: torch.Tensor | None = None) -> torch.Tensor:
    """round-half-even(x * inv) clipped to ±127, kept as float64 (exact
    integers, so the plain matmuls below accumulate exactly)."""
    y = x if inv is None else x * inv
    return torch.clamp(torch.round(y), -127.0, 127.0).double()


def _mm_int(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """q [N, K] times packed int8 w_q [out, >=K]: the int32 dot, returned
    as f32. float64 products and sums of these integers are exact, and
    every accumulator is below 2^24, so the f32 conversion is exact too."""
    return (q @ w_q[:, :q.shape[1]].double().T).float()


def fused_r2l_apply_int8_pe_ref(fp: FusedParamsInt8PE, cfg: R2LConfig,
                                pts: torch.Tensor, dim_pts: int,
                                L: int = 10) -> torch.Tensor:
    """Plain version of ``fused_r2l_apply_int8_pe`` (Pallas
    ``_int8_pe_chain`` with ``fold_requant=True, nobf16_inner=True``):
    pts [N, dim_pts] -> [N, out_dim] f32."""
    nb, nl, dp = cfg.num_blocks, cfg.n_learnable, dim_pts
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, L)
    feats = sins + coss + [p]
    xq = torch.cat([_q8(f, fp.head_inv[k * dp:(k + 1) * dp])
                    for k, f in enumerate(feats)], dim=1)
    h0 = torch.relu(_mm_int(xq, fp.head_q) * fp.head_m + fp.head_b)
    h = h0.to(torch.bfloat16)
    for i in range(nb):
        t = h
        for j in range(nl):
            idx = i * nl + j
            q = (_q8(t.float(), fp.body_inv[idx]) if j == 0
                 else _q8(t))                  # folded: round + clip only
            tf = _mm_int(q, fp.body_q[idx]) * fp.body_m[idx] + fp.body_b[idx]
            t = torch.relu(tf) if j < nl - 1 else tf.to(torch.bfloat16)
        h = (t.float() + h.float()).to(torch.bfloat16)
    hf = h.float()
    if cfg.use_residual:
        hf = hf + h0
    out = _mm_int(_q8(hf, fp.tail_inv), fp.tail_q) * fp.tail_m + fp.tail_b
    return out if cfg.linear_tail else torch.sigmoid(out)


def fused_r2l_apply_int8_pe(fp: FusedParamsInt8PE, cfg: R2LConfig,
                            pts: torch.Tensor, dim_pts: int,
                            L: int = 10) -> torch.Tensor:
    """pts [N, dim_pts] raw sample points -> RGB [N, out_dim] f32 through
    the static-scale int8 kernel; ``fp`` comes from
    ``calibrate_r2l_int8_pe(..., fold_requant=True)``. CPU tensors take the
    plain version."""
    if pts.device.type == "cpu":
        return fused_r2l_apply_int8_pe_ref(fp, cfg, pts, dim_pts, L)
    from . import _build
    _assert_fused_supported(cfg)
    dev, W = pts.device, cfg.netwidth
    nbl = cfg.num_blocks * cfg.n_learnable
    in_dim, out_dim = dim_pts * (2 * L + 1), fp.tail_q.shape[0]
    f32, i8 = torch.float32, torch.int8
    _check(pts, "pts", f32, (pts.shape[0], dim_pts), dev)
    for name, t, dt, shape in (
            ("head_q", fp.head_q, i8, (W, _padded_in(in_dim))),
            ("head_m", fp.head_m, f32, (W,)),
            ("head_b", fp.head_b, f32, (W,)),
            ("head_inv", fp.head_inv, f32, (in_dim,)),
            ("body_q", fp.body_q, i8, (nbl, W, W)),
            ("body_m", fp.body_m, f32, (nbl, W)),
            ("body_b", fp.body_b, f32, (nbl, W)),
            ("body_inv", fp.body_inv, f32, (nbl, W)),
            ("tail_q", fp.tail_q, i8, (out_dim, W)),
            ("tail_m", fp.tail_m, f32, (out_dim,)),
            ("tail_b", fp.tail_b, f32, (out_dim,)),
            ("tail_inv", fp.tail_inv, f32, (W,))):
        _check(t, name, dt, shape, dev)
    out = torch.empty((pts.shape[0], out_dim), dtype=f32, device=dev)
    if pts.shape[0] == 0:
        return out
    lib = _build.load("r2l_int8_pe_fused")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fused_r2l_apply_int8_pe.launches += 1
        rc = lib.r2l_int8_pe_fused_launch(
            _ptr(pts), pts.shape[0], dim_pts, L,
            _ptr(fp.head_q), _ptr(fp.head_m), _ptr(fp.head_b),
            _ptr(fp.head_inv), _ptr(fp.body_q), _ptr(fp.body_m),
            _ptr(fp.body_b), _ptr(fp.body_inv), _ptr(fp.tail_q),
            _ptr(fp.tail_m), _ptr(fp.tail_b), _ptr(fp.tail_inv), _ptr(out),
            W, cfg.num_blocks, cfg.n_learnable, out_dim,
            int(cfg.use_residual), int(cfg.linear_tail),
            ctypes.c_void_p(stream))
    _raise_on_error(rc, "r2l_int8_pe_fused")
    return out


fused_r2l_apply_int8_pe.launches = 0
