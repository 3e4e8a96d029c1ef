"""Fused R2L training forward/backward: wrappers, plain versions, and the
autograd Function of the distillation step.

Counterpart of ``r2l_tpu/kernels/r2l_train_pallas.py``. Three kernels:

* ``train_fwd`` (``csrc/r2l_train_fwd.cu`` over K1's ``r2l_hopper.cuh``,
  K3): K1's PE-fused chain that also writes the activation stash
  ``[2nb+1, N, W]`` in the compute dtype (rows 0..nb the block inputs
  h_0..h_nb, row nb+1+b block b's post-ReLU inner activation). It reads
  K1's weight image (``stage_chain_weights``), staged every step.
* ``train_fwd_int8`` (``csrc/r2l_train_fwd_int8.cu`` over K2's
  ``r2l_int8_hopper.cuh``): the static-scale int8 chain. K4
  (``stash_q=True``): an f32 residual stream, and an int8 stash of the
  q-values the matmuls consume (row nb: the tail input with the global
  residual folded in). K8 (``stash_q=False``, the function's default):
  ``train_fwd``'s stash contract in bf16, the residual stream rounded to
  bf16 each block. Each reads its own s8 image (``stage_int8_train``),
  staged after every calibration.
* ``bwd_group`` (``csrc/r2l_bwd_group.cu`` over ``r2l_bwd_hopper.cuh``,
  K5): the backward through a group of blocks: dh, and dW/db summed over
  all rays in a fixed order. It walks a stash in the weights' dtype, K8's
  bf16 stash under f32 weights, or K4's int8 stash, and reads the body
  weights transposed from an image staged once per step
  (``stage_bwd_weights``).

The chain kernels are built for the widths of ``R2L_KERNEL_WIDTHS``. Every
other multiple of ``WIDE_CHANNELS`` (and an int8 student whose 2L+1
encoding parts overflow K4's head slice) runs on the wide form of the same
three (``wide_train_form``), every layer a pass of the Hopper pass
skeleton ``csrc/wide_hopper.cuh`` (``wgmma`` fed by TMA):
``csrc/r2l_wide_train.cu`` (the head's input encoded once by a kernel of
its own, ``train_encoding_ref`` its plain twin, then a pass a layer, then
the tail's reduction) and ``csrc/r2l_wide_bwd.cu`` (its dh walk on the
skeleton, its dW pass on ``wgmma``): ``train_fwd_wide``,
``train_fwd_int8_wide`` and ``bwd_group_wide``, each with its own launch
counter, to which the three wrappers send such a student. They read the
wide form's images: K3 ``stage_wide_train``'s of the live weights (staged
every step by ``prepare_train_params``), K4/K8 the calibration's
(``stage_int8_train``, the same layout in int8 with its epilogue table),
every layer [out, in] row-major; K5 the step's ``stage_bwd_weights``,
every layer [in, out] row-major.

Each public wrapper runs its plain PyTorch version (``*_ref``, the Pallas
kernel body written out) for tensors on the CPU only. For a CUDA tensor it
launches the kernel or raises; a shape the kernels do not take
(``fused_train_supported``) raises NotImplementedError before any launch.
``make_fused_train_apply`` wraps them in a ``torch.autograd.Function``:
the forward is K3 (or K4 after a calibration), the backward walks the body
top-down through K5 in groups of ``group_blocks`` blocks, and the head,
tail and positional-encoding edges are plain torch, as the JAX package
leaves them to XLA. Gradients land in the ``R2L`` module's parameters
(``nn.Linear``'s ``[out, in]`` layout).

The TPU's 128-lane padding, ray ``tile`` and stash DMA ring are not
ported.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.r2l import R2L, R2LConfig
from .r2l_fused import (CHAIN_STAGE_K, INT8_BLOCK_RAYS, WIDE_CHANNELS,
                        _WIDE_TYPES, FusedParams, FusedParamsInt8PE,
                        _aligned, _chain_scratch, _check,
                        _check_chain_params, _check_int8_params,
                        _dequant, _mm_f32,
                        _mm_int, _need_wide_image, _padded_in,
                        _pe_row_permutation_on,
                        _pe_sin_cos_ladder, _ptr, _q8, _raise_on_error,
                        _CANONICAL, R2L_KERNEL_WIDTHS, _refuse,
                        calibrate_r2l_int8_pe, chain_stage_plan,
                        fused_kernel_supported, int8_train_stage_plan,
                        prepare_fused_params_pe, stage_int8_train,
                        stage_wide_train, wide_stage_plan,
                        wide_train_form)
from .staging import stage_matrices, tf32_split, unstage_matrices


def fused_train_supported(cfg: R2LConfig, int8: bool = False,
                          L: int = 10) -> bool:
    """Whether the training kernels (K3, K4/K8 with ``int8``, K5) take
    ``cfg``: the canonical activations and body (``fused_kernel_supported``)
    with two layers per block and one frequency or more, at a width of
    ``R2L_KERNEL_WIDTHS`` on the chain kernels (for int8 with 2L+1 <= 2W,
    K4's head slice; the launch switches of csrc/) or at any multiple of
    ``WIDE_CHANNELS`` on their wide form (``wide_train_form``). The step's
    gradients are the model's, so nothing is padded: with ReLU bodies this
    admits every width JAX's ``--fused_train_vjp`` gate does (netwidth %
    128 == 0), and W64."""
    return (fused_kernel_supported(cfg) and cfg.n_learnable == 2 and L >= 1
            and (not wide_train_form(cfg.netwidth, int8, L)
                 or cfg.netwidth % WIDE_CHANNELS == 0))


def train_shapes_text() -> str:
    """The shapes ``fused_train_supported`` admits, for messages."""
    return (f"netwidth {', '.join(map(str, R2L_KERNEL_WIDTHS))} on the chain "
            f"kernels (int8: 2L+1 <= 2 * netwidth), else any multiple of "
            f"{WIDE_CHANNELS} on their wide form; {_CANONICAL} of two layers "
            "per block and L >= 1")


def check_train_supported(cfg: R2LConfig, kernel: str, int8: bool = False,
                          L: int = 10) -> None:
    """Raise NotImplementedError, before anything of ``kernel`` is packed
    or launched on the card, where ``fused_train_supported`` refuses."""
    _refuse(fused_train_supported(cfg, int8, L), kernel, train_shapes_text(),
            cfg, L)


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# K3: train_fwd (r2l_train_pallas.py:54-177)
# ---------------------------------------------------------------------------

def train_fwd_ref(fp: FusedParams, cfg: R2LConfig, pts: torch.Tensor,
                  dim_pts: int, L: int = 10, mm=_mm_f32
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``train_fwd``: pts [N, dim_pts] -> (rgb [N, out]
    f32, stash [2nb+1, N, W] in the weights' dtype). ``mm`` replaces the
    head's and the body's product (default: f32 sums of the exact
    products; the tail's stays ``_mm_f32``), as in
    ``fused_r2l_apply_pe_ref``."""
    cd = fp.head_w.dtype
    nb, n = cfg.num_blocks, pts.shape[0]
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, L)
    x = torch.cat([s.to(cd) for s in sins] + [c.to(cd) for c in coss]
                  + [p.to(cd)], dim=1)
    stash = torch.empty((2 * nb + 1, n, cfg.netwidth), dtype=cd,
                        device=pts.device)
    h0 = torch.relu(mm(x, fp.head_w) + fp.head_b).to(cd)
    stash[0] = h0
    h = h0
    for b in range(nb):
        t1r = torch.relu(mm(h, fp.body_w[2 * b])
                         + fp.body_b[2 * b]).to(cd)
        stash[nb + 1 + b] = t1r
        t2 = mm(t1r, fp.body_w[2 * b + 1]) + fp.body_b[2 * b + 1]
        h = (t2 * cfg.res_scale + h.float()).to(cd)
        stash[b + 1] = h
    hf = h.float()
    if cfg.use_residual:
        hf = hf + h0.float()
    out = _mm_f32(hf.to(cd), fp.tail_w) + fp.tail_b
    return (out if cfg.linear_tail else torch.sigmoid(out)), stash


def train_fwd(fp: FusedParams, cfg: R2LConfig, pts: torch.Tensor,
              dim_pts: int, L: int = 10
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """PE-fused forward with the activation stash (K3): pts [N, dim_pts]
    -> (rgb [N, out_dim] f32, stash [2nb+1, N, W] in the weights' dtype).
    ``fp`` comes from ``prepare_fused_params_pe``, staged: on the card K3
    reads K1's weight image (``fp.staged``) and raises without it (the
    training step stages it every step). A ``wide_train_form`` student runs
    on ``train_fwd_wide``. CPU tensors take the plain version, which reads
    the fields."""
    if pts.device.type == "cpu":
        return train_fwd_ref(fp, cfg, pts, dim_pts, L)
    from . import _build
    check_train_supported(cfg, "K3 (train_fwd)", L=L)
    if wide_train_form(cfg.netwidth):
        return train_fwd_wide(fp, cfg, pts, dim_pts, L)
    dev, W, wd = pts.device, cfg.netwidth, fp.head_w.dtype
    nb, n = cfg.num_blocks, pts.shape[0]
    in_dim, out_dim = dim_pts * (2 * L + 1), fp.tail_w.shape[0]
    if wd not in (torch.bfloat16, torch.float32):
        raise TypeError(f"weights must be bf16 or f32, got {wd}")
    _check(pts, "pts", torch.float32, (n, dim_pts), dev)
    for name, t, dt, shape in (
            ("head_w", fp.head_w, wd, (W, _padded_in(in_dim))),
            ("head_b", fp.head_b, torch.float32, (W,)),
            ("body_w", fp.body_w, wd, (2 * nb, W, W)),
            ("body_b", fp.body_b, torch.float32, (2 * nb, W)),
            ("tail_w", fp.tail_w, wd, (out_dim, W)),
            ("tail_b", fp.tail_b, torch.float32, (out_dim,))):
        _check(t, name, dt, shape, dev)
    if fp.staged is None:
        raise ValueError("K3 reads its weights from K1's image: pack them "
                         "with prepare_fused_params_pe(..., stage=True)")
    _check(fp.staged, "staged", torch.uint8,
           (chain_stage_plan(cfg, wd)["nbytes"],), dev)
    out = torch.empty((n, out_dim), dtype=torch.float32, device=dev)
    stash = torch.empty((2 * nb + 1, n, W), dtype=wd, device=dev)
    if n == 0:
        return out, stash
    h0 = _chain_scratch(cfg, wd, n, dev)
    lib = _build.load("r2l_train_fwd")
    with torch.cuda.device(dev):
        train_fwd.launches += 1
        rc = lib.r2l_train_fwd_launch(
            _ptr(pts), n, dim_pts, L, _ptr(fp.staged), _ptr(fp.head_b),
            _ptr(fp.body_b), _ptr(fp.tail_w), _ptr(fp.tail_b), _ptr(out),
            _ptr(h0), h0.numel(), _ptr(stash), W, nb, out_dim,
            float(cfg.res_scale),
            int(cfg.use_residual), int(cfg.linear_tail),
            int(wd == torch.float32), _stream(dev))
    _raise_on_error(rc, "r2l_train_fwd")
    return out, stash


train_fwd.launches = 0


# ---------------------------------------------------------------------------
# K4 and K8: train_fwd_int8 (r2l_train_pallas.py:182-351)
# ---------------------------------------------------------------------------

def train_fwd_int8_ref(fp: FusedParamsInt8PE, cfg: R2LConfig,
                       pts: torch.Tensor, dim_pts: int, L: int = 10,
                       stash_q: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``train_fwd_int8``; ``fp`` from
    ``calibrate_r2l_int8_pe(..., fold_requant=False)``. pts [N, dim_pts] ->
    (rgb [N, out] f32, stash [2nb+1, N, W]): int8 q-values with
    ``stash_q``, else bf16 activations (``train_fwd``'s rows)."""
    nb, dp, n = cfg.num_blocks, dim_pts, pts.shape[0]
    bf = torch.bfloat16
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, L)
    xq = torch.cat([_q8(f, fp.head_inv[k * dp:(k + 1) * dp])
                    for k, f in enumerate(sins + coss + [p])], dim=1)
    stash = torch.empty((2 * nb + 1, n, cfg.netwidth),
                        dtype=torch.int8 if stash_q else bf,
                        device=pts.device)
    h0 = torch.relu(_dequant(_mm_int(xq, fp.head_q), fp.head_m, fp.head_b))
    if stash_q:
        h = h0
    else:
        h = h0.to(bf)                     # the chain runs on the bf16 h0
        stash[0] = h
    for b in range(nb):
        l1, l2 = 2 * b, 2 * b + 1
        q = _q8(h.float(), fp.body_inv[l1])
        if stash_q:
            stash[b] = q.to(torch.int8)
        t1r = torch.relu(_dequant(_mm_int(q, fp.body_q[l1]), fp.body_m[l1],
                                  fp.body_b[l1]))
        if not stash_q:
            t1r = t1r.to(bf)               # rounded before it is quantized
        q = _q8(t1r.float(), fp.body_inv[l2])
        stash[nb + 1 + b] = q.to(torch.int8) if stash_q else t1r
        t2 = _dequant(_mm_int(q, fp.body_q[l2]), fp.body_m[l2],
                      fp.body_b[l2])
        if stash_q:
            h = t2 + h
        else:
            h = (t2 + h.float()).to(bf)
            stash[b + 1] = h
    hf = h.float() + h0 if cfg.use_residual else h.float()   # the f32 h0
    q = _q8(hf, fp.tail_inv)
    if stash_q:
        stash[nb] = q.to(torch.int8)
    out = _dequant(_mm_int(q, fp.tail_q), fp.tail_m, fp.tail_b)
    return (out if cfg.linear_tail else torch.sigmoid(out)), stash


def train_fwd_int8(fp: FusedParamsInt8PE, cfg: R2LConfig, pts: torch.Tensor,
                   dim_pts: int, L: int = 10, stash_q: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Static-scale int8 training forward: pts [N, dim_pts] -> (rgb [N,
    out_dim] f32, stash [2nb+1, N, W]). ``stash_q`` (K4): the int8 q-values;
    otherwise (K8) the bf16 activations. On the card the kernel reads the
    kind's image (``stage_int8_train(fp, ..., stash_q)``) and raises
    without it; a ``wide_train_form`` student runs on
    ``train_fwd_int8_wide``. CPU tensors take the plain version, which reads
    the fields."""
    if pts.device.type == "cpu":
        return train_fwd_int8_ref(fp, cfg, pts, dim_pts, L, stash_q)
    from . import _build
    check_train_supported(cfg, "K4/K8 (train_fwd_int8)", int8=True, L=L)
    if wide_train_form(cfg.netwidth, True, L):
        return train_fwd_int8_wide(fp, cfg, pts, dim_pts, L, stash_q)
    dev, W = pts.device, cfg.netwidth
    nb, n = cfg.num_blocks, pts.shape[0]
    in_dim, out_dim = dim_pts * (2 * L + 1), fp.tail_q.shape[0]
    f32, i8 = torch.float32, torch.int8
    _check(pts, "pts", f32, (n, dim_pts), dev)
    for name, t, dt, shape in (
            ("head_q", fp.head_q, i8, (W, _padded_in(in_dim))),
            ("head_m", fp.head_m, f32, (W,)),
            ("head_b", fp.head_b, f32, (W,)),
            ("head_inv", fp.head_inv, f32, (in_dim,)),
            ("body_q", fp.body_q, i8, (2 * nb, W, W)),
            ("body_m", fp.body_m, f32, (2 * nb, W)),
            ("body_b", fp.body_b, f32, (2 * nb, W)),
            ("body_inv", fp.body_inv, f32, (2 * nb, W)),
            ("tail_q", fp.tail_q, i8, (out_dim, W)),
            ("tail_m", fp.tail_m, f32, (out_dim,)),
            ("tail_b", fp.tail_b, f32, (out_dim,)),
            ("tail_inv", fp.tail_inv, f32, (W,))):
        _check(t, name, dt, shape, dev)
    form = "K4" if stash_q else "K8"
    if fp.staged is None or fp.staged_for != form:
        raise ValueError(f"{form} reads its weights from its own image: "
                         f"stage it with stage_int8_train(fp, ..., "
                         f"stash_q={stash_q})")
    _check(fp.staged, "staged", torch.uint8, (int8_train_stage_plan(
        cfg, dim_pts, L, stash_q)["nbytes"],), dev)
    out = torch.empty((n, out_dim), dtype=f32, device=dev)
    stash = torch.empty((2 * nb + 1, n, W),
                        dtype=i8 if stash_q else torch.bfloat16, device=dev)
    if n == 0:
        return out, stash
    blocks = -(-(-(-n // INT8_BLOCK_RAYS)) // 2) * 2
    h0 = torch.empty((blocks * INT8_BLOCK_RAYS * W
                      if cfg.use_residual else 0,), dtype=f32, device=dev)
    lib = _build.load("r2l_train_fwd_int8")
    with torch.cuda.device(dev):
        if stash_q:
            train_fwd_int8.launches += 1
        else:
            train_fwd_int8.launches_bf16 += 1
        rc = lib.r2l_train_fwd_int8_launch(
            _ptr(pts), n, dim_pts, L, _ptr(fp.staged), _ptr(fp.head_inv),
            _ptr(fp.tail_q), _ptr(fp.tail_m), _ptr(fp.tail_b),
            _ptr(fp.tail_inv), _ptr(out), _ptr(h0), h0.numel(),
            _ptr(stash), W, nb, out_dim, int(cfg.use_residual),
            int(cfg.linear_tail), int(stash_q), _stream(dev))
    _raise_on_error(rc, "r2l_train_fwd_int8")
    return out, stash


train_fwd_int8.launches = 0        # K4, stash_q=True
train_fwd_int8.launches_bf16 = 0   # K8, stash_q=False


# ---------------------------------------------------------------------------
# K5: bwd_group (r2l_train_pallas.py:356-480)
# ---------------------------------------------------------------------------

def _group_inputs(stash: torch.Tensor, nb: int, b: int, cd: torch.dtype,
                  body_scale: torch.Tensor | None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block b's (h_in, t1r in cd, ReLU mask) from the stash."""
    if body_scale is None:
        t1r = stash[nb + 1 + b]
        return stash[b], t1r, t1r.float() > 0.0
    h_in = (stash[b].float() * body_scale[2 * b]).to(cd)
    t1f = stash[nb + 1 + b].float() * body_scale[2 * b + 1]
    return h_in, t1f.to(cd), t1f > 0.0


def bwd_group_ref(body_w: torch.Tensor, stash: torch.Tensor,
                  dh: torch.Tensor, cfg: R2LConfig, b_start: int,
                  b_count: int, body_scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``bwd_group``: body_w [2nb, W, W] ``[out, in]`` in
    the compute dtype, stash in it (or bf16), dh [N, W] f32 (the gradient at block
    b_start+b_count-1's output) -> (dh at block b_start's input [N, W] f32,
    dW [2b_count, W, W] ``[out, in]`` f32, db [2b_count, W] f32)."""
    cd, nb, rs = body_w.dtype, cfg.num_blocks, cfg.res_scale
    W = cfg.netwidth
    dw = torch.empty((2 * b_count, W, W), dtype=torch.float32,
                     device=dh.device)
    db = torch.empty((2 * b_count, W), dtype=torch.float32, device=dh.device)
    for k in range(b_count - 1, -1, -1):
        b = b_start + k
        h_in, t1r, mask = _group_inputs(stash, nb, b, cd, body_scale)
        dt2 = (dh * rs).to(cd)
        dw[2 * k + 1] = dt2.float().T @ t1r.float()
        db[2 * k + 1] = dt2.float().sum(0)
        dt1r = dt2.float() @ body_w[2 * b + 1].float()
        dt1 = torch.where(mask, dt1r, 0.0).to(cd)
        dw[2 * k] = dt1.float().T @ h_in.float()
        db[2 * k] = dt1.float().sum(0)
        dh = dh + dt1.float() @ body_w[2 * b].float()
    return dh, dw, db


def dw_splits(n: int) -> int:
    """How many ray ranges K5's dW pass sums separately (then adds in
    order): one wave of two blocks per SM at the canonical step (8 ranges x
    8 layers x 4 tiles), and a function of the ray count alone, so the sums'
    order is too."""
    return max(1, min(16, n // 10240))


def stage_bwd_weights(body_w: torch.Tensor) -> torch.Tensor:
    """K5's weight image (uint8) of body_w [L, W, W] ``[out, in]`` in the
    compute dtype: every layer's transpose [in, out], in stages of
    ``CHAIN_STAGE_K`` input channels as wgmma reads B
    (``staging.stage_matrices``; f32 as TF32 high and low parts), layer by
    layer, so that the dh walk's dt W^T is the chain's A B^T; on the wide
    form (``wide_train_form``, a multiple of ``WIDE_CHANNELS``) every
    layer's transpose [in, out] row-major, the pass skeleton's B [N, K]
    (``csrc/wide_hopper.cuh``; f32 its TF32 high parts [in, out], then its
    low parts, a layer at a time). Made once per training step (the
    weights change every step) for all the groups."""
    W = body_w.shape[-1]
    wt = body_w.transpose(1, 2).contiguous()
    if wide_train_form(W) and W % WIDE_CHANNELS == 0:
        if wt.dtype == torch.float32:
            wt = torch.stack(tf32_split(wt), 1)
        return wt.contiguous().view(torch.uint8).reshape(-1)
    return stage_matrices(wt, CHAIN_STAGE_K[body_w.dtype])


def unstage_bwd_weights(staged: torch.Tensor, shape: tuple,
                        dtype: torch.dtype) -> list[torch.Tensor]:
    """``stage_bwd_weights``' inverse: [body_w] (f32: the TF32 high and low
    parts) of ``shape`` [L, W, W] ``[out, in]``."""
    L, W, _ = shape
    if wide_train_form(W) and W % WIDE_CHANNELS == 0:
        parts = staged.view(dtype).view(L, -1, W, W).unbind(1)
    else:
        parts = unstage_matrices(staged, (L, W, W), CHAIN_STAGE_K[dtype],
                                 dtype)
    return [p.transpose(1, 2).contiguous() for p in parts]


def qdx_stage_k(W: int) -> int:
    """Output channels per stage of ``stage_qdx_weights``' image: 128, or
    64 at W64 (the int8-dL/dx probe's ring, ``csrc/r2l_bwd_qdx.cu``)."""
    return 128 if W >= 128 else 64


def stage_qdx_weights(body_q: torch.Tensor) -> torch.Tensor:
    """The int8-dL/dx probe's weight image (uint8) of body_q [L, W, W]
    ``[out, in]`` int8, as its dx products' wgmma reads B: every layer's
    transpose [in, out], in stages of ``qdx_stage_k(W)`` output channels
    (``staging.stage_matrices``), layer by layer, so that u_q q^T is the
    chain's A B^T. Made once per calibration, for all the groups."""
    k = qdx_stage_k(body_q.shape[-1])
    return stage_matrices(body_q.transpose(1, 2).contiguous(), k)


def unstage_qdx_weights(staged: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``stage_qdx_weights``' inverse: body_q of ``shape`` [L, W, W]
    ``[out, in]``."""
    L, W, _ = shape
    return unstage_matrices(staged, (L, W, W), qdx_stage_k(W),
                            torch.int8)[0].transpose(1, 2).contiguous()


def _check_bwd(body_w: torch.Tensor, stash: torch.Tensor, dh: torch.Tensor,
               cfg: R2LConfig, b_start: int, b_count: int,
               body_scale: torch.Tensor | None
               ) -> tuple[torch.dtype, bool]:
    """Check K5's arguments (either form) on the card; -> (the weights'
    dtype, whether the stash is K8's bf16 one under f32 weights)."""
    dev, W, nb, n = dh.device, cfg.netwidth, cfg.num_blocks, dh.shape[0]
    cd = body_w.dtype
    if cd not in (torch.bfloat16, torch.float32):
        raise TypeError(f"weights must be bf16 or f32, got {cd}")
    if not (0 <= b_start and b_count >= 1 and b_start + b_count <= nb):
        raise ValueError(f"blocks [{b_start}, {b_start + b_count}) outside "
                         f"[0, {nb})")
    quant = body_scale is not None
    if quant and cd != torch.bfloat16:
        raise TypeError("the int8 stash backward takes bf16 weights")
    _check(dh, "dh", torch.float32, (n, W), dev)
    _check(body_w, "body_w", cd, (2 * nb, W, W), dev)
    stash_bf16 = (not quant and cd == torch.float32
                  and stash.dtype == torch.bfloat16)
    _check(stash, "stash", torch.int8 if quant else
           (torch.bfloat16 if stash_bf16 else cd), (2 * nb + 1, n, W), dev)
    if quant:
        _check(body_scale, "body_scale", torch.float32, (2 * nb, W), dev)
    return cd, stash_bf16


def bwd_group(body_w: torch.Tensor, stash: torch.Tensor, dh: torch.Tensor,
              cfg: R2LConfig, b_start: int, b_count: int,
              body_scale: torch.Tensor | None = None,
              staged: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward through blocks [b_start, b_start+b_count) (K5); shapes as
    ``bwd_group_ref``. The stash is in the weights' dtype, or bf16 under f32
    weights (``train_fwd_int8``'s bf16 stash); ``body_scale`` [2nb, W] f32
    (1/body_inv of the int8 calibration) reads the int8 stash of
    ``train_fwd_int8(stash_q=True)`` and dequantizes it. ``staged`` is
    ``stage_bwd_weights(body_w)``, made once per step by the caller that
    walks every group; on the card it is required (a call without it
    raises). Deterministic: the same inputs give bit-identical outputs. A
    ``wide_train_form`` student runs on ``bwd_group_wide``. CPU tensors
    take the plain version, which ignores ``staged``."""
    if dh.device.type == "cpu":
        return bwd_group_ref(body_w, stash, dh, cfg, b_start, b_count,
                             body_scale)
    from . import _build
    check_train_supported(cfg, "K5 (bwd_group)")
    if wide_train_form(cfg.netwidth):
        return bwd_group_wide(body_w, stash, dh, cfg, b_start, b_count,
                              body_scale, staged)
    dev, W, nb, n = dh.device, cfg.netwidth, cfg.num_blocks, dh.shape[0]
    cd, stash_bf16 = _check_bwd(body_w, stash, dh, cfg, b_start, b_count,
                                body_scale)
    quant = body_scale is not None
    lo, hi = 2 * b_start, 2 * (b_start + b_count)
    layer_bytes = W * W * body_w.element_size() * (
        2 if cd == torch.float32 else 1)
    if staged is None:
        raise ValueError("K5 reads its weights from the step's image: pass "
                         "staged=stage_bwd_weights(body_w)")
    _check(staged, "staged", torch.uint8, (2 * nb * layer_bytes,), dev)
    first = lo * layer_bytes
    if quant:
        scale = body_scale[lo:hi].contiguous()
    f32 = torch.float32
    dts = torch.empty((hi - lo, n, W), dtype=cd, device=dev)
    splits = dw_splits(n)
    dbp = torch.empty((max(-(-n // 64), splits), hi - lo, W), dtype=f32,
                      device=dev)
    part = torch.empty((splits, hi - lo, W, W), dtype=f32, device=dev)
    dh_out = torch.empty((n, W), dtype=f32, device=dev)
    dw = torch.empty((hi - lo, W, W), dtype=f32, device=dev)
    db = torch.empty((hi - lo, W), dtype=f32, device=dev)
    lib = _build.load("r2l_bwd_group")
    with torch.cuda.device(dev):
        bwd_group.launches += 1
        rc = lib.r2l_bwd_group_launch(
            ctypes.c_void_p(staged.data_ptr() + first), _ptr(stash[b_start]),
            _ptr(stash[nb + 1 + b_start]),
            _ptr(scale) if quant else None, _ptr(dh), _ptr(dh_out),
            _ptr(dts), _ptr(dbp), _ptr(part), _ptr(dw), _ptr(db), n, W,
            b_count, float(cfg.res_scale), int(cd == f32), int(stash_bf16),
            splits, _stream(dev))
    _raise_on_error(rc, "r2l_bwd_group")
    return dh_out, dw, db


bwd_group.launches = 0


# ---------------------------------------------------------------------------
# The wide form of K3, K4/K8 and K5 (csrc/r2l_wide_train.cu, r2l_wide_bwd.cu)
# ---------------------------------------------------------------------------

def _refuse_wide(cfg: R2LConfig, kernel: str, int8: bool = False,
                 L: int = 10) -> None:
    """Raise NotImplementedError, before any launch, where the training
    kernels refuse ``cfg`` or its width is not one the wide form takes."""
    _refuse(fused_train_supported(cfg, int8, L)
            and cfg.netwidth % WIDE_CHANNELS == 0, kernel,
            f"a multiple of {WIDE_CHANNELS} as netwidth, {_CANONICAL} of two "
            "layers per block and L >= 1", cfg, L)


def wide_train_scratch_bytes(n: int, W: int, dtype: torch.dtype,
                             in_dim: int, stash_q: bool = False,
                             use_residual: bool = True) -> int:
    """The scratch one wide training forward on n rays needs
    (``csrc/r2l_wide_train.cu``, train_scratch): the head's input [n,
    in_dim padded to 128] in ``dtype`` (bf16, f32; int8 its codes); for
    int8 then K4's f32 residual stream or K8's two code buffers, and with
    the global residual an f32 h0, each [n, W]; each 256-byte aligned."""
    es = torch.empty(0, dtype=dtype).element_size()
    enc = _aligned(n * _padded_in(in_dim) * es)
    if dtype != torch.int8:
        return enc
    e = n * W
    return (enc + (_aligned(4 * e) if stash_q else 2 * _aligned(e))
            + (_aligned(4 * e) if use_residual else 0))


def train_encoding_ref(pts: torch.Tensor, dim_pts: int, L: int,
                       dtype: torch.dtype,
                       head_inv: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of the wide forward's encoding kernel
    (``csrc/r2l_wide_train.cu``, train_encode): pts [n, dim_pts] -> the
    head's input [n, in_dim padded to 128] in the head's freq-major column
    order (``_pe_sin_cos_ladder``'s sines by octave, then its cosines, then
    the points), zero-padded; in ``dtype`` (bf16, f32), or for int8 (with
    ``head_inv`` [in_dim]) the codes round-half-even(x * inv) clipped to
    +-127. Bit for bit ``train_fwd_ref``'s and ``train_fwd_int8_ref``'s
    head input."""
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, L)
    x = torch.cat(sins + coss + [p], dim=1)
    x = (_q8(x, head_inv) if dtype == torch.int8 else x).to(dtype)
    return torch.nn.functional.pad(x, (0, _padded_in(x.shape[1])
                                       - x.shape[1]))


def prepare_train_params(model: R2L, cfg: R2LConfig, dim_pts: int, L: int,
                         weight_dtype: torch.dtype) -> FusedParams:
    """K3's packing of the live weights (``prepare_fused_params_pe``,
    unpadded: the gradients are the model's), staged for the kernel the
    step runs: K1's chain image, or on the wide form
    (``wide_train_form``, at a multiple of ``WIDE_CHANNELS``) the training
    image (``stage_wide_train``, staged for "wide", the frame's wide form's
    too)."""
    W = cfg.netwidth
    wide = wide_train_form(W)
    fp = prepare_fused_params_pe(model, cfg, dim_pts, L,
                                 weight_dtype=weight_dtype, stage=not wide,
                                 pad=False)
    if wide and W % WIDE_CHANNELS == 0:
        fp = fp._replace(staged=stage_wide_train(fp), staged_for="wide")
    return fp


def _launch_train_wide(wrapper, fp, cfg: R2LConfig, pts: torch.Tensor,
                       dim_pts: int, L: int, stash_q: bool,
                       counter: str = "launches"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the wide training forward (``csrc/r2l_wide_train.cu``)
    on the CUDA tensor ``pts``, the parameters and the image checked by the
    caller; counted in ``wrapper.<counter>``."""
    from . import _build
    int8 = isinstance(fp, FusedParamsInt8PE)
    dev, W, nb, n = pts.device, cfg.netwidth, cfg.num_blocks, pts.shape[0]
    wd = torch.int8 if int8 else fp.head_w.dtype
    tail_w = fp.tail_q if int8 else fp.tail_w
    out = torch.empty((n, tail_w.shape[0]), dtype=torch.float32, device=dev)
    stash = torch.empty((2 * nb + 1, n, W), dtype=(
        (torch.int8 if stash_q else torch.bfloat16) if int8 else wd),
        device=dev)
    if n == 0:
        return out, stash
    scratch = torch.empty((wide_train_scratch_bytes(
        n, W, wd, dim_pts * (2 * L + 1), stash_q, cfg.use_residual),),
        dtype=torch.uint8, device=dev)

    def field(name, use):
        return _ptr(getattr(fp, name)) if use else None
    lib = _build.load("r2l_wide_train")
    with torch.cuda.device(dev):
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)
        rc = lib.r2l_wide_train_fwd_launch(
            _ptr(pts), n, dim_pts, L, _WIDE_TYPES[wd], int(stash_q),
            _ptr(fp.staged), field("head_b", not int8),
            field("body_b", not int8), field("head_inv", int8),
            field("body_inv", int8), _ptr(tail_w), field("tail_m", int8),
            _ptr(fp.tail_b), field("tail_inv", int8), _ptr(out),
            _ptr(stash), _ptr(scratch), scratch.numel(), W, nb,
            out.shape[1], float(cfg.res_scale), int(cfg.use_residual),
            int(cfg.linear_tail), _stream(dev))
    _raise_on_error(rc, "r2l_wide_train")
    return out, stash


def train_fwd_wide(fp: FusedParams, cfg: R2LConfig, pts: torch.Tensor,
                   dim_pts: int, L: int = 10
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's wide form: pts [N, dim_pts] -> (rgb [N, out_dim] f32, stash
    [2nb+1, N, W] in the weights' dtype): the head's input encoded once,
    then a pass of the pass skeleton a layer (f32: each k8 step's products
    summed apart), each storing its output to its stash row, then the
    tail. ``fp`` from ``prepare_train_params`` (the training image,
    ``stage_wide_train``); with another image or none it raises.
    ``train_fwd`` sends every ``wide_train_form`` student here. CPU tensors
    take the plain version."""
    if pts.device.type == "cpu":
        return train_fwd_ref(fp, cfg, pts, dim_pts, L)
    _refuse_wide(cfg, "K3's wide form (train_fwd_wide)", L=L)
    _need_wide_image(fp)
    dev, in_dim = pts.device, dim_pts * (2 * L + 1)
    _check(pts, "pts", torch.float32, (pts.shape[0], dim_pts), dev)
    wd = _check_chain_params(fp, cfg, in_dim, dev)
    _check(fp.staged, "staged", torch.uint8,
           (wide_stage_plan(cfg, wd, in_dim)["nbytes"],), dev)
    return _launch_train_wide(train_fwd_wide, fp, cfg, pts, dim_pts, L,
                              False)


train_fwd_wide.launches = 0


def train_fwd_int8_wide(fp: FusedParamsInt8PE, cfg: R2LConfig,
                        pts: torch.Tensor, dim_pts: int, L: int = 10,
                        stash_q: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's (``stash_q``) and K8's wide form: ``train_fwd_int8``'s contract
    and its plain version's roundings bit for bit, the head's codes encoded
    once, then a pass of the pass skeleton a layer (K4: the codes stored
    to the stash rows and an f32 residual stream in a scratch; K8: the
    bf16 rows to the stash, the codes to a scratch). ``fp`` from
    ``calibrate_r2l_int8_pe(..., fold_requant=False)`` with the training
    image (``stage_int8_train``, staged for "wide"); with another or
    none it raises. ``train_fwd_int8`` sends every ``wide_train_form``
    student here. CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return train_fwd_int8_ref(fp, cfg, pts, dim_pts, L, stash_q)
    _refuse_wide(cfg, "K4/K8's wide form (train_fwd_int8_wide)", True, L)
    _need_wide_image(fp)
    dev = pts.device
    _check(pts, "pts", torch.float32, (pts.shape[0], dim_pts), dev)
    _check_int8_params(fp, cfg, dim_pts, L, dev)
    _check(fp.staged, "staged", torch.uint8, (wide_stage_plan(
        cfg, torch.int8, dim_pts * (2 * L + 1))["nbytes"],), dev)
    return _launch_train_wide(train_fwd_int8_wide, fp, cfg, pts, dim_pts, L,
                              stash_q,
                              "launches" if stash_q else "launches_bf16")


train_fwd_int8_wide.launches = 0        # K4, stash_q=True
train_fwd_int8_wide.launches_bf16 = 0   # K8, stash_q=False


def bwd_group_wide(body_w: torch.Tensor, stash: torch.Tensor,
                   dh: torch.Tensor, cfg: R2LConfig, b_start: int,
                   b_count: int, body_scale: torch.Tensor | None = None,
                   staged: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's wide form: ``bwd_group``'s signature and contract (the same
    inputs give bit-identical outputs), two passes a block for dh on the
    pass skeleton (``csrc/wide_hopper.cuh``) against the transposed
    weights, then dW and db summed over ``dw_splits(n)`` ranges of rays on
    ``wgmma`` and the ranges added in order. ``staged`` is
    ``stage_bwd_weights(body_w)`` (the wide form's image); without it it
    raises, and where the card cannot take a call it raises as well.
    ``bwd_group`` sends every ``wide_train_form`` student here. CPU tensors
    take the plain version."""
    if dh.device.type == "cpu":
        return bwd_group_ref(body_w, stash, dh, cfg, b_start, b_count,
                             body_scale)
    from . import _build
    _refuse_wide(cfg, "K5's wide form (bwd_group_wide)")
    if staged is None:
        raise ValueError("K5's wide form reads its weights from the step's "
                         "image of the wide form: pass "
                         "staged=stage_bwd_weights(body_w)")
    dev, W, nb, n = dh.device, cfg.netwidth, cfg.num_blocks, dh.shape[0]
    cd, _ = _check_bwd(body_w, stash, dh, cfg, b_start, b_count, body_scale)
    quant, f32 = body_scale is not None, torch.float32
    layer_bytes = W * W * body_w.element_size() * (2 if cd == f32 else 1)
    _check(staged, "staged", torch.uint8, (2 * nb * layer_bytes,), dev)
    lo, hi = 2 * b_start, 2 * (b_start + b_count)
    if quant:
        scale = body_scale[lo:hi].contiguous()
    splits = dw_splits(n)
    dts = torch.empty((hi - lo, n, W), dtype=cd, device=dev)
    part = torch.empty((splits, hi - lo, W, W), dtype=f32, device=dev)
    dbp = torch.empty((splits, hi - lo, W), dtype=f32, device=dev)
    dh_out = torch.empty((n, W), dtype=f32, device=dev)
    dw = torch.empty((hi - lo, W, W), dtype=f32, device=dev)
    db = torch.empty((hi - lo, W), dtype=f32, device=dev)
    lib = _build.load("r2l_wide_bwd")
    with torch.cuda.device(dev):
        bwd_group_wide.launches += 1
        rc = lib.r2l_wide_bwd_launch(
            ctypes.c_void_p(staged.data_ptr() + lo * layer_bytes),
            _ptr(stash[b_start]), _ptr(stash[nb + 1 + b_start]),
            _ptr(scale) if quant else None, _ptr(dh), _ptr(dh_out),
            _ptr(dts), _ptr(part), _ptr(dbp), _ptr(dw), _ptr(db), n, W,
            b_count, float(cfg.res_scale), int(cd == f32),
            _WIDE_TYPES[stash.dtype], splits, _stream(dev))
    _raise_on_error(rc, "r2l_wide_bwd")
    return dh_out, dw, db


bwd_group_wide.launches = 0


# ---------------------------------------------------------------------------
# The autograd Function (make_fused_train_apply, r2l_train_pallas.py:483)
# ---------------------------------------------------------------------------

def _params(model: R2L) -> list[torch.nn.Parameter]:
    """The trained parameters in the Function's order: head w, b; every
    body weight, then every body bias (forward order); tail w, b."""
    head, body, tail = model.linears()
    return ([head.weight, head.bias] + [m.weight for m in body]
            + [m.bias for m in body] + [tail.weight, tail.bias])


class _Spec(NamedTuple):
    cfg: R2LConfig
    dim_pts: int
    L: int
    group_blocks: int
    cd: torch.dtype
    int8: bool
    stash_q: bool


def _run_fwd(spec: _Spec, model: R2L, fp, pts: torch.Tensor):
    """-> (rgb, stash, body weights in cd [2nb, W, W], scales): scales are
    the int8 stash's (body [2nb, W], tail [W]) dequant multipliers, or None
    for a bf16 or compute-dtype stash."""
    cfg = spec.cfg
    if spec.int8:
        rgb, stash = train_fwd_int8(fp, cfg, pts, spec.dim_pts, spec.L,
                                    stash_q=spec.stash_q)
        _, body, _ = model.linears()
        body_w = torch.stack([m.weight.detach() for m in body]).to(spec.cd)
        scales = ((1.0 / fp.body_inv, 1.0 / fp.tail_inv) if spec.stash_q
                  else None)
        return rgb, stash, body_w, scales
    # K3's image of the live weights, once per step
    fp = prepare_train_params(model, cfg, spec.dim_pts, spec.L, spec.cd)
    rgb, stash = train_fwd(fp, cfg, pts, spec.dim_pts, spec.L)
    return rgb, stash, fp.body_w, None


def _bwd_core(spec: _Spec, model: R2L, pts, stash, rgb, body_w, scales,
              d_rgb) -> list[torch.Tensor]:
    """The cotangent walk: tail edge (torch), body groups (K5), head and PE
    edge (torch). Returns the gradients in ``_params`` order."""
    cfg, cd = spec.cfg, spec.cd
    nb = cfg.num_blocks
    head, body, tail = model.linears()
    if scales is not None:   # int8 stash: row nb is the quantized tail input
        body_scale, tail_scale = scales
        hf = stash[nb].float() * tail_scale
    else:
        # rebuilt from the stashed rows, as JAX does, also for the int8
        # forward's bf16 stash (whose forward added the f32 h0): a
        # straight-through tail edge
        body_scale = None
        hf = stash[nb].float()
        if cfg.use_residual:
            hf = hf + stash[0].float()
    d_out = d_rgb.float()
    if not cfg.linear_tail:
        d_out = d_out * rgb * (1.0 - rgb)       # sigmoid'
    d_out_c = d_out.to(cd).float()
    d_tw = d_out_c.T @ hf.to(cd).float()        # [out, W]
    d_tb = d_out.sum(0)
    dh = d_out_c @ tail.weight.detach().to(cd).float()   # [N, W]
    dh0_extra = dh if cfg.use_residual else None

    dws, dbs = [None] * nb, [None] * nb
    staged = stage_bwd_weights(body_w)   # K5's image, once per step
    b = nb
    while b > 0:
        cnt = min(spec.group_blocks, b)
        b -= cnt
        dh, dw_g, db_g = bwd_group(body_w, stash, dh.contiguous(), cfg, b,
                                   cnt, body_scale=body_scale, staged=staged)
        for k in range(cnt):
            dws[b + k] = dw_g[2 * k:2 * k + 2]
            dbs[b + k] = db_g[2 * k:2 * k + 2]

    if dh0_extra is not None:
        dh = dh + dh0_extra
    d_pre = torch.where(stash[0] > 0, dh, 0.0)     # relu'
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, spec.L)
    x_fm = torch.cat(sins + coss + [p], dim=1).to(cd).float()
    d_hw_fm = d_pre.to(cd).float().T @ x_fm        # [W, in_dim] freq-major
    d_hw = torch.empty_like(d_hw_fm)   # back to the module's column order
    d_hw[:, _pe_row_permutation_on(pts.device, spec.dim_pts, spec.L)] = \
        d_hw_fm
    d_hb = d_pre.sum(0)
    d_body_w = torch.cat(dws)                      # [2nb, W, W]
    d_body_b = torch.cat(dbs)
    return ([d_hw, d_hb] + list(d_body_w.unbind(0))
            + list(d_body_b.unbind(0)) + [d_tw, d_tb])


class _FusedTrainFn(torch.autograd.Function):
    """(spec, model, fp, pts, *params) -> rgb. ``params`` are the model's
    ``_params``: they carry autograd; the forward reads their values
    through ``model``. ``fp`` is the int8 calibration (None for bf16)."""

    @staticmethod
    def forward(ctx, spec, model, fp, pts, *params):
        rgb, stash, body_w, scales = _run_fwd(spec, model, fp, pts)
        ctx.spec, ctx.model, ctx.scales = spec, model, scales
        ctx.save_for_backward(pts, stash, rgb, body_w)
        return rgb

    @staticmethod
    def backward(ctx, d_rgb):
        pts, stash, rgb, body_w = ctx.saved_tensors
        grads = _bwd_core(ctx.spec, ctx.model, pts, stash, rgb, body_w,
                          ctx.scales, d_rgb)
        params = _params(ctx.model)
        return (None, None, None, None,
                *[g.to(p.dtype) for g, p in zip(grads, params)])


def make_fused_train_apply(cfg: R2LConfig, dim_pts: int, L: int = 10,
                           group_blocks: int = 4,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           quantize: str = "",
                           calib_pts: torch.Tensor | None = None,
                           stash_q: bool = True,
                           external_calib: bool = False):
    """Build ``apply(model, pts) -> rgb`` whose backward is the fused
    kernels' (``pts`` are data: no gradient).

    ``quantize='int8'`` (needs ``calib_pts`` [n, dim_pts] on the model's
    device): the forward runs in int8, with the static scales recalibrated
    from the live parameters at every call (``calibrate_r2l_int8_pe``,
    ``fold_requant=False``), and the backward walks its stash with the
    weights in ``compute_dtype`` (a straight-through gradient):
    ``stash_q=True`` (the default, as in JAX) is K4's int8 q-value stash,
    dequantized with the same scales; ``stash_q=False`` K8's bf16 stash.
    ``external_calib`` (int8 only) returns ``(apply_fp, calibrate)``
    instead: ``apply_fp(model, pts, fp)`` takes a calibration made by
    ``calibrate(model)``, so that the caller decides how often to
    recalibrate. Each calibration stages the kind's image for K4/K8
    (``stage_int8_train``); the bf16/f32 kind stages K3's every step
    (``prepare_train_params``).
    """
    _refuse(fused_kernel_supported(cfg) and cfg.n_learnable == 2,
            "the fused training step", f"{_CANONICAL} of two layers per "
            "block (on the CPU at any width)", cfg)
    int8 = quantize == "int8"
    if int8 and calib_pts is None:
        raise ValueError("int8 training needs calib_pts")
    if external_calib and not int8:
        raise ValueError("external_calib requires quantize='int8'")
    spec = _Spec(cfg, dim_pts, L, group_blocks, compute_dtype, int8,
                 bool(int8 and stash_q))

    def calibrate(model: R2L) -> FusedParamsInt8PE:
        fp = calibrate_r2l_int8_pe(model, cfg, dim_pts, L, calib_pts,
                                   fold_requant=False, stage=False,
                                   pad=False)
        return stage_int8_train(fp, cfg, dim_pts, L, spec.stash_q)

    def apply_fp(model: R2L, pts: torch.Tensor, fp) -> torch.Tensor:
        return _FusedTrainFn.apply(spec, model, fp, pts, *_params(model))

    if external_calib:
        return apply_fp, calibrate

    def apply(model: R2L, pts: torch.Tensor) -> torch.Tensor:
        return apply_fp(model, pts, calibrate(model) if int8 else None)

    return apply

