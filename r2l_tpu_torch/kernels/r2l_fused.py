"""R2L forward kernels: wrappers, plain versions and packing.

Counterpart of ``r2l_tpu/kernels/r2l_pallas.py``. Two kernels carry the
student frame, and a third is the JAX package's exported kernel API:

* ``fused_r2l_apply_pe`` (``csrc/r2l_pe_fused.cu``): positional encoding by
  the double-angle ladder, head Linear+ReLU, the ResMLP blocks, the global
  residual and the Linear+sigmoid tail in one kernel. Weights bf16 (or f32),
  biases f32, activations rounded to the compute dtype between layers, f32
  accumulation. Its plain version follows the Pallas ``_kernel_body``
  rounding points (bias added in f32 before the cast), not ``apply_r2l``'s.
* ``fused_r2l_apply_int8_pe`` (``csrc/r2l_int8_hopper.cu``): the same
  chain in static-scale int8 on wgmma s8, in ``_int8_pe_chain``'s three
  forms (``fold_requant``, ``nobf16_inner``; by default the deployed
  ``True, True``), each also with ``bf16_resid`` (the global residual in
  bf16), with parameters from ``calibrate_r2l_int8_pe``. The
  training forward K4/K8 (``r2l_train.train_fwd_int8``), the epilogue
  probe (``exp/probe_epi.py``) and the stream probe
  (``exp/probe_pipe_lib.py``) run on its template.
* ``fused_r2l_apply`` (``csrc/r2l_fused.cu``): K1's chain on an input
  encoded outside (``r2l_embed``'s per-scalar order, parameters from
  ``prepare_fused_params``), read unpadded and rounded once to the compute
  dtype.

Each public wrapper runs its plain PyTorch version for a tensor on the CPU
only. For a CUDA tensor it launches the kernel or raises. The kernels are
built for the widths of ``R2L_KERNEL_WIDTHS``; the frame packers pad a
narrower student with zero channels to the next of them
(``kernel_width``). A wider student runs on the wide form of the same
three kernels (``csrc/r2l_wide.cu``: one pass of the Hopper pass skeleton
``csrc/wide_hopper.cuh`` a layer over activations in device memory,
``fused_r2l_apply_pe_wide``, ``fused_r2l_apply_wide``,
``fused_r2l_apply_int8_pe_wide``), packed at the next multiple of
``WIDE_CHANNELS`` and staged by ``stage_wide_train``; so does an int8
student whose 2L+1 encoding parts overflow the head slice of every K2
width (K2 takes a narrower one at the first width whose slice holds
them). A shape they do not take (``fused_frame_supported``: other
activations, no layer in a block, no frequency) raises
NotImplementedError before any launch.

Kernel layout: weights are packed ``[out, in]`` (``nn.Linear``'s layout,
the transpose of JAX's), so that a kernel copies each output channel's
slice of a weight stage as contiguous 16-byte pieces; the head's input
columns are zero-padded to a multiple of ``K_ALIGN`` for the same reason.
K1 and K9 (``csrc/r2l_hopper.cuh``) read the head and body weights from a
staged image instead (``stage_chain_weights``, made once per model by the
frame entry points: ``prepare_fused_params``, and
``prepare_fused_params_pe`` unless ``stage=False``; the training step
packs and stages every step for K3): each layer in stages laid
out as Hopper's ``wgmma`` reads them (``staging.stage_matrices``), f32 as
TF32 high and low parts; K3, the training forward on K1's chain, reads the
same image, staged every training step (the weights change); on the
wide forms K1, K9, K2, K3, K4 and K8 read one image (``stage_wide_train``:
each layer [out, in] row-major, the pass skeleton's B). K2 reads
``head_q`` and ``body_q`` from an s8 image staged the same way
(``stage_int8_chain``, by ``calibrate_r2l_int8_pe`` unless
``stage=False``); K4/K8 from their own (``stage_int8_train``: their stage
width, and the body's inverse scales beside the epilogue table), staged
after each of the int8 training kinds' per-step calibrations. The TPU
kernels' 128-lane padding and ray ``tile`` are not ported: each CUDA kernel
picks its own ray tile.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..models.r2l import R2L, R2LConfig
from .staging import stage_matrices, tf32_split, unstage_matrices

K_ALIGN = 128  # head input columns are padded to a multiple of this
# K1/K9/K3's shape by weight dtype (csrc/r2l_hopper.cuh, Chain): input
# channels per weight stage, rays per block, blocks per cluster (a cluster
# reads each weight stage from L2 once for all its blocks).
CHAIN_STAGE_K = {torch.bfloat16: 64, torch.float32: 16}
CHAIN_BLOCK_RAYS = {torch.bfloat16: 128, torch.float32: 64}
CHAIN_CLUSTER = {torch.bfloat16: 2, torch.float32: 2}
INT8_BLOCK_RAYS = 128  # K2 (csrc/r2l_int8_hopper.cuh): rays per block
# rays per block of K2's forms (Epi codes) that differ: the stream probe's
# S = 4 (kStreams4), four 64-ray warpgroups, whose head parks half of h0 in
# the scratch with or without the global residual
INT8_FORM_BLOCK_RAYS = {8: 256}


def _padded_in(in_dim: int) -> int:
    return -(-in_dim // K_ALIGN) * K_ALIGN


class _ChainFields(NamedTuple):
    head_w: torch.Tensor   # [W, in_pad]    weight dtype (bf16 or f32)
    head_b: torch.Tensor   # [W]            f32
    body_w: torch.Tensor   # [nb*nl, W, W]  weight dtype, [out, in]
    body_b: torch.Tensor   # [nb*nl, W]     f32
    tail_w: torch.Tensor   # [out_dim, W]   weight dtype
    tail_b: torch.Tensor   # [out_dim]      f32


class FusedParams(_ChainFields):
    """Kernel-layout parameters of ``fused_r2l_apply`` and
    ``fused_r2l_apply_pe`` (weights [out, in], head columns zero-padded; in
    ``r2l_embed``'s order from ``prepare_fused_params``, freq-major from
    ``prepare_fused_params_pe``); the fields are the JAX package's.

    Beside them, not among them, ``staged``: a weight image, or None where
    the packing did not stage; and ``staged_for``, the kernels it was
    staged for: "K1" (K1/K9/K3, ``stage_chain_weights``) or "wide" (the
    wide forms of the frame and of the training forward,
    ``stage_wide_train``). ``_replace`` keeps both
    unless given ``staged=`` (and ``staged_for=``)."""
    staged: torch.Tensor | None = None
    staged_for: str | None = None

    def _replace(self, **kw) -> "FusedParams":
        staged = kw.pop("staged", self.staged)
        staged_for = kw.pop("staged_for", self.staged_for
                            if staged is self.staged else None)
        out = super()._replace(**kw)
        out.staged, out.staged_for = staged, staged_for
        return out


class _Int8Fields(NamedTuple):
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


class FusedParamsInt8PE(_Int8Fields):
    """Static-scale int8 parameters (all scales folded, PE freq-major,
    weights [out, in]); the fields are the JAX package's.

    Beside them, not among them, ``staged``: an s8 weight image with its
    epilogue table, or None where the calibration did not stage; and
    ``staged_for``, the kernel it was staged for: "K2" (the frame,
    ``stage_int8_chain``), "K4" or "K8" (the training forward,
    ``stage_int8_train``), or "wide" (the wide forms of K2 and of K4/K8,
    ``stage_wide_train``).
    ``_replace`` keeps both unless given ``staged=`` (and
    ``staged_for=``)."""
    staged: torch.Tensor | None = None
    staged_for: str | None = None

    def _replace(self, **kw) -> "FusedParamsInt8PE":
        staged = kw.pop("staged", self.staged)
        staged_for = kw.pop("staged_for", self.staged_for
                            if staged is self.staged else None)
        out = super()._replace(**kw)
        out.staged, out.staged_for = staged, staged_for
        return out


# The widths the chain kernels are built for: the ``case`` labels of the
# launch switches of K1/K9/K3 (csrc/r2l_hopper.cuh, ``launch``) and of
# K2/K4/K8 (csrc/r2l_int8_hopper.cuh, ``launch_width``); any other width
# returns cudaErrorInvalidValue. tests/test_torch_gates.py reads them there.
R2L_KERNEL_WIDTHS = (64, 128, 256)
# The wide form (csrc/r2l_wide.cuh, kWideChannels) runs at multiples of
# this; tests/test_torch_gates.py reads it there.
WIDE_CHANNELS = 128
# What the chain kernels hardcode, for messages.
_CANONICAL = ("ReLU head and in-block activations, no block "
              "out-activation, a resmlp body")


def _chain_width(W: int, int8: bool, L: int) -> int | None:
    """The narrowest of ``R2L_KERNEL_WIDTHS`` that holds W (for K2 also one
    scalar's 2L+1 encoding parts in its head slice of twice that width),
    or None."""
    return next((k for k in R2L_KERNEL_WIDTHS
                 if k >= W and (not int8 or 2 * L + 1 <= 2 * k)), None)


def wide_form(W: int, int8: bool = False, L: int = 10) -> bool:
    """Whether the frame kernels run a W-wide student (K2 with ``int8``, at
    ``L`` frequencies) on their wide form (``csrc/r2l_wide.cu``): wider than
    the widest of ``R2L_KERNEL_WIDTHS``, or in int8 where no K2 width's
    head slice holds one scalar's 2L+1 encoding parts."""
    return _chain_width(W, int8, L) is None


def wide_train_form(W: int, int8: bool = False, L: int = 10) -> bool:
    """Whether the training kernels run a W-wide student (K4/K8 with
    ``int8``, at ``L`` frequencies) on their wide form
    (``csrc/r2l_wide_train.cu``, ``csrc/r2l_wide_bwd.cu``): a width other
    than ``R2L_KERNEL_WIDTHS`` (training pads nothing: the gradients are the
    model's), or in int8 one whose 2L+1 encoding parts overflow K4's head
    slice of twice the width. The wide form itself takes multiples of
    ``WIDE_CHANNELS``; K5 depends on the width alone (``int8=False``)."""
    return not (W in R2L_KERNEL_WIDTHS and (not int8 or 2 * L + 1 <= 2 * W))


def kernel_width(W: int, int8: bool = False, L: int = 10) -> int:
    """The width the frame kernels (K1/K9/K2) run a W-wide student at: the
    narrowest of ``R2L_KERNEL_WIDTHS`` that takes it, or on the wide form
    (``wide_form``) the next multiple of ``WIDE_CHANNELS``. The frame
    packers pad the weights with zero channels, which ReLU keeps at zero
    and every later layer reads through zero weights, so the padded chain
    computes the W-wide network."""
    Wk = _chain_width(W, int8, L)
    return -(-W // WIDE_CHANNELS) * WIDE_CHANNELS if Wk is None else Wk


def kernel_cfg(cfg: R2LConfig, int8: bool = False, L: int = 10
               ) -> R2LConfig:
    """``cfg`` at its ``kernel_width``."""
    Wk = kernel_width(cfg.netwidth, int8, L)
    return (cfg if Wk == cfg.netwidth
            else dataclasses.replace(cfg, netwidth=Wk))


def pads(pad: bool | None, weight: torch.Tensor) -> bool:
    """A packer's ``pad``: None pads for the kernels, where the model's
    ``weight`` lies on the card; on the CPU the plain versions take the
    student's own width."""
    return weight.device.type == "cuda" if pad is None else pad


def fused_kernel_supported(cfg: R2LConfig) -> bool:
    """The kernels hardcode the canonical activations (ReLU head and
    in-block, no block out-activation, ResMLP body)."""
    return (cfg.act == "relu" and cfg.inact == "relu"
            and cfg.outact == "none" and cfg.body_arch == "resmlp")


def fused_frame_supported(cfg: R2LConfig, int8: bool = False,
                          L: int = 10) -> bool:
    """Whether the student's frame kernels (K1/K9, or K2 with ``int8``)
    take ``cfg`` with an ``L``-frequency encoding: the canonical activations
    and body (``fused_kernel_supported``), at least one layer per block and
    one frequency (csrc/r2l_hopper.cuh ``launch``, csrc/r2l_pe_fused.cu,
    csrc/r2l_wide.cu), at any width: ``kernel_width`` names the kernel
    width or the wide form's."""
    return fused_kernel_supported(cfg) and cfg.n_learnable >= 1 and L >= 1


def frame_shapes_text(int8: bool = False) -> str:
    """The shapes ``fused_frame_supported`` admits, for messages."""
    return (f"any netwidth: up to {R2L_KERNEL_WIDTHS[-1]} at "
            f"{', '.join(map(str, R2L_KERNEL_WIDTHS))} with zero channels"
            + (" (K2: the first whose 2L+1 <= 2 * width)" if int8 else "")
            + f", else on the wide form at the next multiple of "
            f"{WIDE_CHANNELS}; {_CANONICAL} of one or more layers per block "
            "and L >= 1")


def _refuse(ok: bool, kernel: str, shapes: str, cfg: R2LConfig,
            L: int | None = None) -> None:
    """Raise NotImplementedError, before anything of ``kernel`` is packed
    or launched, where its predicate ``ok`` refuses ``cfg``; ``shapes``
    says what it takes."""
    if not ok:
        raise NotImplementedError(
            f"{kernel} takes {shapes}; got netwidth {cfg.netwidth}, "
            f"act={cfg.act!r} inact={cfg.inact!r} outact={cfg.outact!r} "
            f"body_arch={cfg.body_arch!r} n_learnable={cfg.n_learnable}"
            + (f", L={L}" if L is not None else ""))


def _refuse_frame(cfg: R2LConfig, kernel: str, int8: bool = False,
                  L: int = 10) -> None:
    _refuse(fused_frame_supported(cfg, int8, L), kernel,
            frame_shapes_text(int8), cfg, L)


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


@functools.lru_cache(maxsize=None)
def _pe_row_permutation_on(device: torch.device, dim_pts: int, L: int
                           ) -> torch.Tensor:
    """``_pe_row_permutation`` as an index tensor on ``device``, made once
    (a copy to the card per call would wait for the card)."""
    return torch.from_numpy(_pe_row_permutation(dim_pts, L)).to(device)


def _pack(w_in_out: torch.Tensor, dtype: torch.dtype,
          pad_in: bool = False) -> torch.Tensor:
    """[in, out] (or [nbl, in, out]) -> contiguous [out, in] in ``dtype``,
    the in axis zero-padded to ``K_ALIGN`` when ``pad_in``."""
    w = w_in_out.transpose(-1, -2).to(dtype)
    if pad_in:
        w = torch.nn.functional.pad(w, (0, _padded_in(w.shape[-1]) -
                                        w.shape[-1]))
    return w.contiguous()


def _stacked_weights(model: R2L, width: int | None = None
                     ) -> tuple[torch.Tensor, ...]:
    """(head_w [in, W], head_b, body_w [nb*nl, W, W], body_b,
    tail_w [W, out], tail_b), f32, weights [in, out] as in JAX; with
    ``width``, every W axis zero-padded to it (``kernel_width``)."""
    head, body, tail = model.linears()
    body_w = torch.stack([m.weight.detach().T for m in body]).float()
    body_b = torch.stack([m.bias.detach() for m in body]).float()
    out = (head.weight.detach().T.float(), head.bias.detach().float(),
           body_w, body_b, tail.weight.detach().T.float(),
           tail.bias.detach().float())
    pad = (width or body_b.shape[-1]) - body_b.shape[-1]
    if pad == 0:
        return out
    F_ = torch.nn.functional
    hw, hb, bw, bb, tw, tb = out
    return (F_.pad(hw, (0, pad)), F_.pad(hb, (0, pad)),
            F_.pad(bw, (0, pad, 0, pad)), F_.pad(bb, (0, pad)),
            F_.pad(tw, (0, 0, 0, pad)), tb)


@torch.no_grad()
def _prepare(model: R2L, cfg: R2LConfig, weight_dtype: torch.dtype,
             head_perm: torch.Tensor | None, stage: bool,
             pad: bool | None) -> FusedParams:
    """The packing: weights [out, in] in ``weight_dtype``, the head's input
    columns (taken in the order ``head_perm`` when given) zero-padded to
    ``K_ALIGN``, a no-op on the product: the kernels pad their input with
    zeros; with ``pad`` (``pads``), the width zero-padded to
    ``kernel_width``; with ``stage``, K1/K9's weight image beside them, or
    the wide form's (``stage_wide_train``) for a student wider than their
    widths, at a width it takes."""
    _refuse(fused_kernel_supported(cfg), "the fused kernels' packing",
            _CANONICAL, cfg)
    pad = pads(pad, model.linears()[0].weight)
    hw, hb, bw, bb, tw, tb = _stacked_weights(
        model, kernel_cfg(cfg).netwidth if pad else None)
    if head_perm is not None:
        hw = hw[head_perm]
    wd = weight_dtype
    fp = FusedParams(
        head_w=_pack(hw, wd, pad_in=True), head_b=hb.contiguous(),
        body_w=_pack(bw, wd), body_b=bb.contiguous(),
        tail_w=_pack(tw, wd), tail_b=tb.contiguous())
    if stage:
        W = fp.body_b.shape[-1]
        if not wide_form(W):
            fp.staged, fp.staged_for = stage_chain_weights(fp), "K1"
        elif W % WIDE_CHANNELS == 0:
            fp.staged, fp.staged_for = stage_wide_train(fp), "wide"
    return fp


def prepare_fused_params(model: R2L, cfg: R2LConfig,
                         weight_dtype: torch.dtype = torch.bfloat16,
                         pad: bool | None = None) -> FusedParams:
    """Pack the model for ``fused_r2l_apply`` (head rows in
    ``r2l_embed``'s per-scalar order), staged for K9; with ``pad``
    (``pads``: on the card by default) at its ``kernel_width``."""
    return _prepare(model, cfg, weight_dtype, None, stage=True, pad=pad)


def prepare_fused_params_pe(model: R2L, cfg: R2LConfig, dim_pts: int,
                            L: int = 10,
                            weight_dtype: torch.dtype = torch.bfloat16,
                            stage: bool = True,
                            pad: bool | None = None) -> FusedParams:
    """Pack the model for the PE-fused kernels (freq-major head rows),
    staged for K1 and K3 unless ``stage=False`` (the plain versions read
    the fields alone); with ``pad`` (``pads``: on the card by default) at
    its ``kernel_width`` (the training step passes False: its gradients
    are the model's own shapes)."""
    if cfg.input_dim != dim_pts * (2 * L + 1):
        raise ValueError(f"input_dim {cfg.input_dim} != dim_pts*(2L+1) = "
                         f"{dim_pts * (2 * L + 1)}")
    perm = _pe_row_permutation_on(model.linears()[0].weight.device, dim_pts,
                                  L)
    return _prepare(model, cfg, weight_dtype, perm, stage, pad)


def chain_stage_plan(cfg: R2LConfig, dtype: torch.dtype) -> dict:
    """K1/K9's staged image: 'kpad' (the head's input as staged), 'stage_k'
    (input channels per stage), 'stage_bytes', 'stages' (the head's, then
    each body layer's, in order) and 'nbytes'."""
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    kpad, k = _padded_in(cfg.input_dim), CHAIN_STAGE_K[dtype]
    es = torch.empty(0, dtype=dtype).element_size()
    stage_bytes = W * k * es * (2 if dtype == torch.float32 else 1)
    stages = (kpad + nbl * W) // k
    return {"kpad": kpad, "stage_k": k, "stage_bytes": stage_bytes,
            "stages": stages, "nbytes": stages * stage_bytes}


def stage_chain_weights(fp: FusedParams) -> torch.Tensor:
    """K1/K9's weight image (uint8): the head's stages, then each body
    layer's, in ``staging.stage_matrices`` order (f32: TF32 high and low);
    the head's rows in ``fp``'s order (freq-major for K1)."""
    k = CHAIN_STAGE_K[fp.head_w.dtype]
    return torch.cat([stage_matrices(fp.head_w, k),
                      stage_matrices(fp.body_w, k)])


def unstage_chain_weights(staged: torch.Tensor, cfg: R2LConfig,
                          dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """'head_w' [W, kpad] and 'body_w' [nb*nl, W, W] back from a staged
    image; for f32 the TF32 high parts, and 'head_w_lo', 'body_w_lo' the
    low parts."""
    plan = chain_stage_plan(cfg, dtype)
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    k = plan["stage_k"]
    cut = (plan["kpad"] // k) * plan["stage_bytes"]
    out = {}
    for name, img, shape in (("head_w", staged[:cut], (W, plan["kpad"])),
                             ("body_w", staged[cut:], (nbl, W, W))):
        for w, suffix in zip(unstage_matrices(img, shape, k, dtype),
                             ("", "_lo")):
            out[name + suffix] = w
    return out


def chain_l2_bytes(cfg: R2LConfig, dtype: torch.dtype, n: int) -> int:
    """The weight bytes one K1/K9 launch on n rays reads from L2 by design:
    the staged image once per cluster."""
    blocks = -(-n // CHAIN_BLOCK_RAYS[dtype])
    clusters = -(-blocks // CHAIN_CLUSTER[dtype])
    return clusters * chain_stage_plan(cfg, dtype)["nbytes"]


def _chain_scratch(cfg: R2LConfig, dtype: torch.dtype, n: int,
                   dev: torch.device) -> torch.Tensor:
    """K1/K9's h0 scratch for n rays: a [rows x W] tile of the weight dtype
    for each block of the padded grid (none without the global
    residual)."""
    if not cfg.use_residual:
        return torch.empty((0,), dtype=dtype, device=dev)
    rows, c = CHAIN_BLOCK_RAYS[dtype], CHAIN_CLUSTER[dtype]
    blocks = -(-(-(-n // rows)) // c) * c
    return torch.empty((blocks * rows * cfg.netwidth,), dtype=dtype,
                       device=dev)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [N, K] times packed w [out, >=K]: a dot with f32 accumulation of
    the exact products (bf16 x bf16 fits an f32 mantissa), as
    ``preferred_element_type=f32``. Full f32 needs TF32 off on the GPU,
    which is PyTorch's default for matmul."""
    return a.float() @ w[:, :a.shape[1]].float().T


def _compute_dtype(fp: FusedParams, cfg: R2LConfig) -> torch.dtype:
    """f32 with f32 weights, else the config's compute dtype."""
    return (torch.float32 if fp.head_w.dtype == torch.float32
            else cfg.compute_dtype)


def _chain_ref(fp: FusedParams, cfg: R2LConfig, x: torch.Tensor,
               cd: torch.dtype, mm=_mm_f32) -> torch.Tensor:
    """Pallas ``_kernel_body`` on x [N, in_dim] in ``cd``; ``mm`` is the
    head's and the body's product (the tail's is ``_mm_f32``)."""
    h0 = torch.relu(mm(x, fp.head_w) + fp.head_b).to(cd)
    h = h0
    nl = cfg.n_learnable
    for i in range(cfg.num_blocks):
        acc = h
        for j in range(nl):
            acc_f = mm(acc, fp.body_w[i * nl + j]) + fp.body_b[i * nl + j]
            if j < nl - 1:
                acc_f = torch.relu(acc_f)
            acc = acc_f.to(cd)
        h = (acc.float() * cfg.res_scale + h.float()).to(cd)
    if cfg.use_residual:
        h = (h.float() + h0.float()).to(cd)
    out = _mm_f32(h, fp.tail_w) + fp.tail_b
    return out if cfg.linear_tail else torch.sigmoid(out)


def fused_r2l_apply_pe_ref(fp: FusedParams, cfg: R2LConfig,
                           pts: torch.Tensor, dim_pts: int,
                           L: int = 10, mm=_mm_f32) -> torch.Tensor:
    """Plain version of ``fused_r2l_apply_pe`` (Pallas ``_kernel_body``
    with the PE kernel's input): pts [N, dim_pts] -> [N, out_dim] f32.
    ``mm`` replaces the head's and the body's product (default: f32 sums of
    the exact products)."""
    cd = _compute_dtype(fp, cfg)
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, L)
    x = torch.cat([s.to(cd) for s in sins] + [c.to(cd) for c in coss]
                  + [p.to(cd)], dim=1)
    return _chain_ref(fp, cfg, x, cd, mm)


def fused_r2l_apply_ref(fp: FusedParams, cfg: R2LConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_r2l_apply`` (Pallas ``_kernel`` +
    ``_kernel_body``): x [N, input_dim] of any float dtype, rounded once to
    the compute dtype -> [N, out_dim] f32."""
    cd = _compute_dtype(fp, cfg)
    return _chain_ref(fp, cfg, x.to(cd), cd)


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


@trace.spanned("kernel.launch")
def _launch_chain(wrapper, lib_name: str, fp: FusedParams, cfg: R2LConfig,
                  inp: torch.Tensor, front: tuple, wd: torch.dtype
                  ) -> torch.Tensor:
    """One launch of K1 or K9 (``csrc/r2l_hopper.cuh``) on the CUDA tensor
    ``inp`` (points or encoded rays), the staged image checked here and a
    fresh h0 scratch; ``front`` is the entry point's front-end arguments
    (K1: dim_pts, L; K9: in_dim); counted in ``wrapper.launches``."""
    from . import _build
    dev, n, W = inp.device, inp.shape[0], cfg.netwidth
    if fp.staged is None:
        raise ValueError("fp has no staged weight image: pack it with "
                         "prepare_fused_params or prepare_fused_params_pe "
                         "(stage=True)")
    _check(fp.staged, "staged", torch.uint8,
           (chain_stage_plan(cfg, wd)["nbytes"],), dev)
    out_dim = fp.tail_w.shape[0]
    out = torch.empty((n, out_dim), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    h0 = _chain_scratch(cfg, wd, n, dev)
    lib = _build.load(lib_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        wrapper.launches += 1
        rc = getattr(lib, lib_name + "_launch")(
            _ptr(inp), n, *front, _ptr(fp.staged), _ptr(fp.head_b),
            _ptr(fp.body_b), _ptr(fp.tail_w), _ptr(fp.tail_b), _ptr(out),
            _ptr(h0), h0.numel(), W, cfg.num_blocks, cfg.n_learnable,
            out_dim, float(cfg.res_scale), int(cfg.use_residual),
            int(cfg.linear_tail), int(wd == torch.float32),
            ctypes.c_void_p(stream))
    _raise_on_error(rc, lib_name)
    return out


def fused_r2l_apply_pe(fp: FusedParams, cfg: R2LConfig,
                       pts: torch.Tensor, dim_pts: int,
                       L: int = 10) -> torch.Tensor:
    """pts [N, dim_pts] raw sample points -> RGB [N, out_dim] f32.

    Positional encoding runs inside the kernel; ``fp`` comes from
    ``prepare_fused_params_pe`` (staged). A student wider than
    ``R2L_KERNEL_WIDTHS`` runs on the wide form
    (``fused_r2l_apply_pe_wide``). CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return fused_r2l_apply_pe_ref(fp, cfg, pts, dim_pts, L)
    _refuse_frame(cfg, "K1 (fused_r2l_apply_pe)", L=L)
    if wide_form(cfg.netwidth):
        return fused_r2l_apply_pe_wide(fp, cfg, pts, dim_pts, L)
    cfg, dev = kernel_cfg(cfg), pts.device
    _check(pts, "pts", torch.float32, (pts.shape[0], dim_pts), dev)
    wd = _check_chain_params(fp, cfg, dim_pts * (2 * L + 1), dev)
    return _launch_chain(fused_r2l_apply_pe, "r2l_pe_fused", fp, cfg, pts,
                         (dim_pts, L), wd)


fused_r2l_apply_pe.launches = 0


def _check_chain_params(fp: FusedParams, cfg: R2LConfig, in_dim: int,
                        dev: torch.device) -> torch.dtype:
    """Check the packed parameters the chain kernels take; -> their dtype."""
    W, wd = cfg.netwidth, fp.head_w.dtype
    nbl = cfg.num_blocks * cfg.n_learnable
    if wd not in (torch.bfloat16, torch.float32):
        raise TypeError(f"weights must be bf16 or f32, got {wd}")
    if wd == torch.bfloat16 and cfg.compute_dtype != torch.bfloat16:
        raise TypeError("bf16 weights need compute_dtype=torch.bfloat16")
    out_dim = fp.tail_w.shape[0]
    for name, t, dt, shape in (
            ("head_w", fp.head_w, wd, (W, _padded_in(in_dim))),
            ("head_b", fp.head_b, torch.float32, (W,)),
            ("body_w", fp.body_w, wd, (nbl, W, W)),
            ("body_b", fp.body_b, torch.float32, (nbl, W)),
            ("tail_w", fp.tail_w, wd, (out_dim, W)),
            ("tail_b", fp.tail_b, torch.float32, (out_dim,))):
        _check(t, name, dt, shape, dev)
    return wd


def fused_r2l_apply(fp: FusedParams, cfg: R2LConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """x [N, input_dim] (encoded rays, any float dtype) -> RGB [N, out_dim]
    f32 through K9; ``fp`` comes from ``prepare_fused_params``. x is rounded
    once to the compute dtype (f32 with f32 weights). A student wider than
    ``R2L_KERNEL_WIDTHS`` runs on the wide form (``fused_r2l_apply_wide``).
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return fused_r2l_apply_ref(fp, cfg, x)
    _refuse_frame(cfg, "K9 (fused_r2l_apply)")
    if wide_form(cfg.netwidth):
        return fused_r2l_apply_wide(fp, cfg, x)
    cfg = kernel_cfg(cfg)
    dev, n, in_dim = x.device, x.shape[0], cfg.input_dim
    if not x.is_floating_point():
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    wd = _check_chain_params(fp, cfg, in_dim, dev)
    if x.dtype != torch.float32:
        # the kernel reads f32: the compute dtype's value, exactly
        x = x.to(_compute_dtype(fp, cfg)).float()
    _check(x, "x", torch.float32, (n, in_dim), dev)
    return _launch_chain(fused_r2l_apply, "r2l_fused", fp, cfg, x,
                         (in_dim,), wd)


fused_r2l_apply.launches = 0


# ---------------------------------------------------------------------------
# Static-scale int8 (r2l_pallas.py:338-664)
# ---------------------------------------------------------------------------

def _quant_cols_scaled(w: torch.Tensor, s_in: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absorb per-input-channel scales, then quantize per out column:
    w [..., in, out], s_in [..., in] -> (int8 [..., in, out], dequant
    multiplier [..., out]); a leading axis quantizes a stack of layers at
    once, each as on its own."""
    w_eff = w.float() * s_in[..., :, None]
    ws = torch.clamp(w_eff.abs().amax(dim=-2), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w_eff / ws[..., None, :]), -127,
                    127).to(torch.int8)
    return q, ws


def _act_scale(x: torch.Tensor, margin: float) -> torch.Tensor:
    """Per-channel activation scale max|x| * margin / 127."""
    return torch.clamp(x.abs().amax(dim=0), min=1e-6) * (margin / 127.0)


@torch.no_grad()
def calibrate_r2l_int8_pe(model: R2L, cfg: R2LConfig, dim_pts: int, L: int,
                          calib_pts: torch.Tensor, margin: float = 1.1,
                          fold_requant: bool = True,
                          stage: bool = True,
                          pad: bool | None = None) -> FusedParamsInt8PE:
    """Calibrate per-(layer, channel) activation ranges on sample points and
    pack the int8 kernel parameters (a plain function, not a kernel).

    An f32 forward over ``calib_pts`` [n, dim_pts] (direct sin/cos, not
    the ladder) records each layer's input max-abs; scales are
    max-abs * ``margin`` / 127. ``fold_requant`` pre-multiplies the next
    inner layer's inverse input scale into this layer's multiplier and
    bias, so the kernel's inner requantize is round+clip only. With
    ``stage``, K2's s8 image is staged beside the fields (the int8 training
    kinds pass ``stage=False`` and stage K4/K8's own, ``stage_int8_train``);
    on the wide form (``wide_form``) the image is ``stage_wide_train``'s.
    ``pad`` packs at the ``kernel_width`` (a zero channel's scales are the
    floor's, its codes 0), as ``prepare_fused_params_pe``. TF32 is switched
    off for the duration: it would move every scale.
    """
    _refuse(fused_kernel_supported(cfg), "the fused kernels' packing",
            _CANONICAL, cfg)
    if pads(pad, model.linears()[0].weight):
        cfg = kernel_cfg(cfg, int8=True, L=L)
    width = cfg.netwidth
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fp = _calibrate(model, cfg, dim_pts, L, calib_pts, margin,
                        fold_requant, width)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    if not stage:
        return fp
    if not wide_form(width, True, L):
        fp.staged, fp.staged_for = stage_int8_chain(fp, cfg, dim_pts, L), "K2"
    elif width % WIDE_CHANNELS == 0:
        fp.staged, fp.staged_for = stage_wide_train(fp), "wide"
    return fp


def int8_head_columns(cfg: R2LConfig, dim_pts: int, L: int) -> torch.Tensor:
    """The head's columns in K2's image: slices of 2W columns, slice i
    holding the ns scalars [i*sps, i*sps + ns) (sps = 2W // P, P = 2L+1
    parts) freq-major, its column p*ns + sl part p of scalar i*sps + sl;
    the last slice rounded up to whole stages. -> [kpad] int64 (CPU, made
    once per shape): each column's index in the fields' freq-major order
    (p * dim_pts + s), or -1 for a zero column."""
    return _int8_head_columns(cfg.netwidth, dim_pts, L)


@functools.lru_cache(maxsize=None)
def _int8_head_columns(W: int, dim_pts: int, L: int) -> torch.Tensor:
    P, sw, k = 2 * L + 1, 2 * W, (128 if W >= 128 else 64)
    sps = sw // P
    if sps < 1:
        raise ValueError(f"{P} encoding parts do not fit a {sw}-column slice")
    nsl = -(-dim_pts // sps)
    last = dim_pts - (nsl - 1) * sps
    cols = np.full((nsl - 1) * sw + -(-(last * P) // k) * k, -1, np.int64)
    for i in range(nsl):
        ns = min(sps, dim_pts - i * sps)
        p, sl = np.divmod(np.arange(P * ns), ns)
        cols[i * sw:i * sw + P * ns] = p * dim_pts + i * sps + sl
    return torch.from_numpy(cols)


def int8_chain_stage_plan(cfg: R2LConfig, dim_pts: int, L: int) -> dict:
    """K2's staged image: 'kpad' (the head's input as staged,
    ``int8_head_columns``), 'stage_k' (input channels per stage: 128, or 64
    at W64), 'stage_bytes', 'stages' (the head's, then each body layer's,
    in order), 'weights_bytes', then the epilogue table's 'table_bytes'
    (the head's and each body layer's (m[c], b[c], m[c+1], b[c+1]) per
    column pair, f32) and 'nbytes'."""
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    kpad = int8_head_columns(cfg, dim_pts, L).numel()
    k = 128 if W >= 128 else 64
    stages = (kpad + nbl * W) // k
    table = (1 + nbl) * W * 8
    return {"kpad": kpad, "stage_k": k, "stage_bytes": W * k,
            "stages": stages, "weights_bytes": stages * W * k,
            "table_bytes": table, "nbytes": stages * W * k + table}


def stage_int8_chain(fp: FusedParamsInt8PE, cfg: R2LConfig, dim_pts: int,
                     L: int, k: int | None = None) -> torch.Tensor:
    """K2's image (uint8): the head's stages (``head_q``'s columns in
    ``int8_head_columns``' order), then each body layer's, in
    ``staging.stage_matrices`` order (wgmma's K-major core matrices, ``k``
    input channels per stage, by default ``int8_chain_stage_plan``'s); then
    the epilogue table, (m, b) interleaved per column, the head's row
    first."""
    k = k or (128 if cfg.netwidth >= 128 else 64)
    cols = int8_head_columns(cfg, dim_pts, L).to(fp.head_q.device)
    head = torch.where(cols >= 0, fp.head_q[:, cols.clamp(min=0)],
                       torch.zeros((), dtype=torch.int8,
                                   device=fp.head_q.device))
    table = torch.cat([torch.stack([fp.head_m, fp.head_b], -1).reshape(-1),
                       torch.stack([fp.body_m, fp.body_b], -1).reshape(-1)])
    return torch.cat([stage_matrices(head.contiguous(), k),
                      stage_matrices(fp.body_q, k),
                      table.float().contiguous().view(torch.uint8)])


def unstage_int8_chain(staged: torch.Tensor, cfg: R2LConfig, dim_pts: int,
                       L: int, k: int | None = None
                       ) -> dict[str, torch.Tensor]:
    """'head_q' [W, in_pad] (the fields' freq-major order, zero-padded),
    'body_q' [nb*nl, W, W], 'head_m', 'head_b' [W] and 'body_m', 'body_b'
    [nb*nl, W] back from K2's image (staged ``k`` input channels per
    stage, by default ``int8_chain_stage_plan``'s)."""
    plan = int8_chain_stage_plan(cfg, dim_pts, L)
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    k = k or plan["stage_k"]
    cut = (plan["kpad"] // k) * W * k
    end = plan["weights_bytes"]
    mb = staged[end:end + plan["table_bytes"]].clone().view(
        torch.float32).view(1 + nbl, W, 2)
    staged_head = unstage_matrices(staged[:cut], (W, plan["kpad"]), k,
                                   torch.int8)[0]
    cols = int8_head_columns(cfg, dim_pts, L).to(staged.device)
    head = torch.zeros((W, _padded_in(dim_pts * (2 * L + 1))),
                       dtype=torch.int8, device=staged.device)
    head[:, cols[cols >= 0]] = staged_head[:, cols >= 0]
    return {"head_q": head,
            "body_q": unstage_matrices(staged[cut:end], (nbl, W, W), k,
                                       torch.int8)[0],
            "head_m": mb[0, :, 0], "head_b": mb[0, :, 1],
            "body_m": mb[1:, :, 0], "body_b": mb[1:, :, 1]}


def int8_train_stage_k(W: int, stash_q: bool) -> int:
    """K4/K8's input channels per weight stage (``csrc/r2l_int8_hopper.cuh``,
    ``Chain8``): K2's (128, 64 at W64), but 64 for K4 at W256, whose f32
    residual stream leaves room for a 64 KB ring only."""
    return 64 if W < 128 or (W == 256 and stash_q) else 128


def int8_train_stage_plan(cfg: R2LConfig, dim_pts: int, L: int,
                          stash_q: bool) -> dict:
    """K4/K8's staged image (``stage_int8_train``): K2's plan at the kind's
    stage width, then the body's inverse input scales ('inv_bytes',
    [nb*nl, W] f32)."""
    plan = dict(int8_chain_stage_plan(cfg, dim_pts, L))
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    k = int8_train_stage_k(W, stash_q)
    plan.update(stage_k=k, stage_bytes=W * k,
                stages=(plan["kpad"] + nbl * W) // k, inv_bytes=nbl * W * 4)
    plan["nbytes"] += plan["inv_bytes"]
    return plan


def stage_int8_train(fp: FusedParamsInt8PE, cfg: R2LConfig, dim_pts: int,
                     L: int, stash_q: bool) -> FusedParamsInt8PE:
    """``fp`` (from ``calibrate_r2l_int8_pe(..., fold_requant=False)``)
    with K4's (``stash_q``) or K8's image beside it: K2's image at the
    kind's stage width (``int8_train_stage_k``), then ``body_inv`` [nb*nl,
    W] f32, the inverse input scale of every body layer. Made after each
    calibration (the int8 training kinds: every step). A student on the
    training kernels' wide form (``wide_train_form``, at a multiple of
    ``WIDE_CHANNELS``) gets the wide forms' image instead
    (``stage_wide_train``, staged for "wide"; both kinds read it)."""
    W = cfg.netwidth
    if wide_train_form(W, True, L) and W % WIDE_CHANNELS == 0:
        return fp._replace(staged=stage_wide_train(fp), staged_for="wide")
    k = int8_train_stage_k(W, stash_q)
    img = torch.cat([stage_int8_chain(fp, cfg, dim_pts, L, k),
                     fp.body_inv.float().contiguous().view(torch.uint8)
                     .reshape(-1)])
    return fp._replace(staged=img, staged_for="K4" if stash_q else "K8")


def unstage_int8_train(staged: torch.Tensor, cfg: R2LConfig, dim_pts: int,
                       L: int, stash_q: bool) -> dict[str, torch.Tensor]:
    """``unstage_int8_chain``'s fields back from K4's or K8's image, and
    'body_inv' [nb*nl, W]."""
    plan = int8_train_stage_plan(cfg, dim_pts, L, stash_q)
    out = unstage_int8_chain(staged, cfg, dim_pts, L, plan["stage_k"])
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    start = plan["weights_bytes"] + plan["table_bytes"]
    out["body_inv"] = staged[start:start + plan["inv_bytes"]].clone().view(
        torch.float32).view(nbl, W)
    return out


def int8_chain_l2_bytes(cfg: R2LConfig, dim_pts: int, L: int,
                        n: int) -> int:
    """The weight bytes one K2 launch on n rays reads from L2 by design: the
    s8 weights of the image once per two-block cluster of 128-ray blocks."""
    clusters = -(-(-(-n // INT8_BLOCK_RAYS)) // 2)
    return clusters * int8_chain_stage_plan(cfg, dim_pts, L)["weights_bytes"]


def _calibrate(model: R2L, cfg: R2LConfig, dim_pts: int, L: int,
               calib_pts: torch.Tensor, margin: float,
               fold_requant: bool, width: int | None = None
               ) -> FusedParamsInt8PE:
    nb, nl = cfg.num_blocks, cfg.n_learnable
    rs = float(cfg.res_scale)
    head_w, head_b, body_w, body_b, tail_w, tail_b = _stacked_weights(
        model, width)
    head_w = head_w[_pe_row_permutation_on(head_w.device, dim_pts, L)]

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
    s_b = torch.stack(s_body)                      # [nb*nl, W]
    body_q, m = _quant_cols_scaled(body_w, s_b)    # all layers at once
    W = s_b.shape[1]
    m = m.view(nb, nl, W)
    b = body_b.clone().view(nb, nl, W)
    m[:, nl - 1] *= rs                             # block tail: res_scale
    b[:, nl - 1] *= rs
    if fold_requant and nl > 1:                    # the next inverse scale
        inv_next = 1.0 / s_b.view(nb, nl, W)[:, 1:]
        m[:, :nl - 1] *= inv_next
        b[:, :nl - 1] *= inv_next
    tail_q, tail_m = _quant_cols_scaled(tail_w, s_tail)
    i8 = torch.int8
    return FusedParamsInt8PE(
        head_q=_pack(head_q, i8, pad_in=True), head_m=head_m.contiguous(),
        head_b=head_b.contiguous(), head_inv=(1.0 / s_x).contiguous(),
        body_q=_pack(body_q, i8),
        body_m=m.reshape(nb * nl, W).contiguous(),
        body_b=b.reshape(nb * nl, W).contiguous(),
        body_inv=(1.0 / s_b).contiguous(),
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


def _dequant(acc: torch.Tensor, m: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """acc*m + b as one fused multiply-add rounded once to f32, as the CUDA
    epilogues compute it (``__fmaf_rn``) and as XLA on the CPU contracts it:
    the product of two f32 values is exact in float64, so only the sum is
    rounded before the final rounding to f32 (a double rounding that can
    differ from a true FMA only when the float64 sum lands exactly on an
    f32 midpoint)."""
    return (acc.double() * m.double() + b.double()).float()


# K2's requantize epilogues by (fold_requant, nobf16_inner), each with its
# code in csrc/r2l_int8_hopper.cuh's Epi (which also holds the epilogue and
# stream probes' forms, exp/probe_epi.py, exp/probe_pipe_lib.py).
EPILOGUES = {"deployed": 0, "fold": 1, "unfolded": 2}
# The flag added to an epilogue's code for ``bf16_resid`` (the global
# residual in bf16), in K2 and in its wide form alike.
BF16_RESID = 16


def int8_form_code(fold_requant: bool, nobf16_inner: bool,
                   bf16_resid: bool) -> int:
    """K2's form as its kernels take it: the epilogue's code, plus
    ``BF16_RESID`` with ``bf16_resid``."""
    return (EPILOGUES[int8_epilogue(fold_requant, nobf16_inner)]
            + (BF16_RESID if bf16_resid else 0))


def int8_epilogue(fold_requant: bool, nobf16_inner: bool) -> str:
    """K2's epilogue for Pallas ``_int8_pe_chain``'s flags (``nobf16_inner``
    acts only with ``fold_requant``)."""
    if not fold_requant:
        return "unfolded"
    return "deployed" if nobf16_inner else "fold"


def int8_pe_chain_ref(fp: FusedParamsInt8PE, cfg: R2LConfig,
                      pts: torch.Tensor, dim_pts: int, L: int = 10,
                      epilogue: str = "deployed",
                      quantize=None, bf16_resid: bool = False
                      ) -> torch.Tensor:
    """Plain version of the int8 chain (Pallas ``_int8_pe_chain``) with one
    of the ``EPILOGUES``: pts [N, dim_pts] -> [N, out_dim] f32.

    ``bf16_resid`` (any epilogue): the global residual's copy h0 is the
    head's output rounded to bf16, and the tail's input is h + h0 added in
    bf16 (rounded once) where it was the bf16 h plus the f32 h0 in f32. A
    block's add is the same bf16 add either way: the sum of two bf16 values
    rounded once to bf16.

    ``quantize(t, inv, j) -> q`` (a probe's hook) replaces how layer j of a
    block quantizes its input: t is that input in bf16 before any inner
    ReLU (the residual stream for j = 0, else the previous layer's
    dequantized output), inv the layer's inverse input scale, and q the
    int8 codes as ``_q8`` gives them; the chain then applies no inner ReLU
    itself, and ``epilogue`` must be ``"unfolded"``."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {tuple(EPILOGUES)}, got "
                         f"{epilogue!r}")
    if quantize is not None and epilogue != "unfolded":
        raise ValueError("a quantize hook runs on the unfolded chain")
    nb, nl, dp = cfg.num_blocks, cfg.n_learnable, dim_pts
    folded = epilogue in ("deployed", "fold")
    p = pts.float()
    sins, coss = _pe_sin_cos_ladder(p, L)
    feats = sins + coss + [p]
    xq = torch.cat([_q8(f, fp.head_inv[k * dp:(k + 1) * dp])
                    for k, f in enumerate(feats)], dim=1)
    h0 = torch.relu(_dequant(_mm_int(xq, fp.head_q), fp.head_m, fp.head_b))
    h = h0.to(torch.bfloat16)
    if bf16_resid:
        h0 = h.float()
    for i in range(nb):
        t = h
        for j in range(nl):
            idx = i * nl + j
            if quantize is not None:
                q = quantize(t, fp.body_inv[idx], j)
            elif folded and j > 0:           # round + clip only
                q = _q8(t.float())
            else:
                q = _q8(t.float(), fp.body_inv[idx])
            tf = _dequant(_mm_int(q, fp.body_q[idx]), fp.body_m[idx],
                          fp.body_b[idx])
            if j < nl - 1 and quantize is None:
                tf = torch.relu(tf)
            t = (tf if epilogue == "deployed" and j < nl - 1
                 else tf.to(torch.bfloat16))
        h = (t.float() + h.float()).to(torch.bfloat16)
    hf = h.float()
    if cfg.use_residual:
        hf = hf + h0
        if bf16_resid:
            hf = hf.to(torch.bfloat16).float()
    out = _dequant(_mm_int(_q8(hf, fp.tail_inv), fp.tail_q), fp.tail_m,
                   fp.tail_b)
    return out if cfg.linear_tail else torch.sigmoid(out)


def fused_r2l_apply_int8_pe_ref(fp: FusedParamsInt8PE, cfg: R2LConfig,
                                pts: torch.Tensor, dim_pts: int,
                                L: int = 10, fold_requant: bool = True,
                                nobf16_inner: bool = True,
                                bf16_resid: bool = False) -> torch.Tensor:
    """Plain version of ``fused_r2l_apply_int8_pe`` (Pallas
    ``_int8_pe_chain`` with the same flags): pts [N, dim_pts] ->
    [N, out_dim] f32."""
    return int8_pe_chain_ref(fp, cfg, pts, dim_pts, L,
                             int8_epilogue(fold_requant, nobf16_inner),
                             bf16_resid=bf16_resid)


def _check_int8_params(fp: FusedParamsInt8PE, cfg: R2LConfig,
                       dim_pts: int, L: int, dev: torch.device) -> None:
    """Check the packed int8 parameters the int8 chain kernels take."""
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    in_dim, out_dim = dim_pts * (2 * L + 1), fp.tail_q.shape[0]
    f32, i8 = torch.float32, torch.int8
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


@trace.spanned("kernel.launch")
def _launch_int8_hopper(fp: FusedParamsInt8PE, cfg: R2LConfig,
                        pts: torch.Tensor, dim_pts: int, L: int,
                        epilogue: int, wrapper=None) -> torch.Tensor:
    """One launch of K2 (``csrc/r2l_int8_hopper.cu``) on CUDA tensors in
    the form ``epilogue`` (its Epi code, plus ``BF16_RESID`` for that
    form), checked here, with a fresh f32 h0 scratch; counted in
    ``wrapper.launches`` (``fused_r2l_apply_int8_pe`` by default), a
    ``bf16_resid`` form also in ``launches_bf16_resid``."""
    wrapper = wrapper or fused_r2l_apply_int8_pe
    from . import _build
    _refuse_frame(cfg, "K2 (fused_r2l_apply_int8_pe)", int8=True, L=L)
    _refuse(not wide_form(cfg.netwidth, True, L), "K2",
            f"netwidth up to {R2L_KERNEL_WIDTHS[-1]} with 2L+1 <= 2 * its "
            "kernel width (fused_r2l_apply_int8_pe_wide takes the rest)",
            cfg, L)
    cfg = kernel_cfg(cfg, int8=True, L=L)
    dev, n, W = pts.device, pts.shape[0], cfg.netwidth
    _check(pts, "pts", torch.float32, (n, dim_pts), dev)
    _check_int8_params(fp, cfg, dim_pts, L, dev)
    if fp.staged is None or fp.staged_for != "K2":
        raise ValueError("fp has no staged s8 image for K2: calibrate it with "
                         "calibrate_r2l_int8_pe(..., stage=True)")
    _check(fp.staged, "staged", torch.uint8,
           (int8_chain_stage_plan(cfg, dim_pts, L)["nbytes"],), dev)
    out = torch.empty((n, fp.tail_q.shape[0]), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    rays = INT8_FORM_BLOCK_RAYS.get(epilogue, INT8_BLOCK_RAYS)
    blocks = -(-(-(-n // rays)) // 2) * 2
    h0 = torch.empty((blocks * rays * W if cfg.use_residual
                      or epilogue in INT8_FORM_BLOCK_RAYS else 0,),
                     dtype=torch.float32, device=dev)
    lib = _build.load("r2l_int8_hopper")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        wrapper.launches += 1
        if epilogue & BF16_RESID:
            wrapper.launches_bf16_resid += 1
        rc = lib.r2l_int8_hopper_launch(
            _ptr(pts), n, dim_pts, L, _ptr(fp.staged), _ptr(fp.head_inv),
            _ptr(fp.body_inv), _ptr(fp.tail_q), _ptr(fp.tail_m),
            _ptr(fp.tail_b), _ptr(fp.tail_inv), _ptr(out),
            _ptr(h0), h0.numel(), W, cfg.num_blocks, cfg.n_learnable,
            out.shape[1], int(cfg.use_residual), int(cfg.linear_tail),
            epilogue, ctypes.c_void_p(stream))
    _raise_on_error(rc, "r2l_int8_hopper")
    return out


def fused_r2l_apply_int8_pe(fp: FusedParamsInt8PE, cfg: R2LConfig,
                            pts: torch.Tensor, dim_pts: int,
                            L: int = 10, fold_requant: bool = True,
                            nobf16_inner: bool = True,
                            bf16_resid: bool = False) -> torch.Tensor:
    """pts [N, dim_pts] raw sample points -> RGB [N, out_dim] f32 through
    the static-scale int8 kernel. The flags are Pallas ``_int8_pe_chain``'s
    (``bf16_resid``: the global residual in bf16, in any of the three
    forms); the default is the deployed form, with ``fp`` from
    ``calibrate_r2l_int8_pe(..., fold_requant=True)`` (``fold_requant``
    here must match the calibration's; the calibration stages K2's s8
    image, without which the kernel raises). The wide form
    (``fused_r2l_apply_int8_pe_wide``) takes a student wider than
    ``R2L_KERNEL_WIDTHS``, or whose 2L+1 encoding parts overflow every K2
    width's head slice (``wide_form``). CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return fused_r2l_apply_int8_pe_ref(fp, cfg, pts, dim_pts, L,
                                           fold_requant, nobf16_inner,
                                           bf16_resid)
    if wide_form(cfg.netwidth, True, L):
        return fused_r2l_apply_int8_pe_wide(fp, cfg, pts, dim_pts, L,
                                            fold_requant, nobf16_inner,
                                            bf16_resid)
    return _launch_int8_hopper(
        fp, cfg, pts, dim_pts, L,
        int8_form_code(fold_requant, nobf16_inner, bf16_resid))


fused_r2l_apply_int8_pe.launches = 0
fused_r2l_apply_int8_pe.launches_bf16_resid = 0   # of them, bf16_resid


# ---------------------------------------------------------------------------
# The wide form of K1, K9 and K2 (csrc/r2l_wide.cu)
# ---------------------------------------------------------------------------

_WIDE_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
# The most scratch one wide call takes: more rays than fit run in passes
# (a 400x400 frame is one pass up to W2304 in int8, W1024 in f32).
WIDE_SCRATCH_BYTES = 4 << 30


def wide_stage_plan(cfg: R2LConfig, dtype: torch.dtype,
                    in_dim: int | None = None) -> dict:
    """The wide forms' image (``stage_wide_train``) of ``cfg`` (at its
    width) in ``dtype`` (bf16, f32 or int8) for a head of ``in_dim`` inputs
    (``cfg.input_dim`` by default): 'kpad' (the head's input as staged,
    ``K_ALIGN``-padded), 'parts' (f32 2: its TF32 high and low parts),
    'head_bytes', 'layer_bytes' (a body layer's), 'weights_bytes', then for
    int8 the epilogue table's 'table_bytes' (the head's and each body
    layer's (m, b) a channel, f32), and 'nbytes'."""
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    kpad = _padded_in(cfg.input_dim if in_dim is None else in_dim)
    es = torch.empty(0, dtype=dtype).element_size()
    parts = 2 if dtype == torch.float32 else 1
    head, layer = W * kpad * es * parts, W * W * es * parts
    table = (1 + nbl) * W * 8 if dtype == torch.int8 else 0
    weights = head + nbl * layer
    return {"kpad": kpad, "parts": parts, "head_bytes": head,
            "layer_bytes": layer, "weights_bytes": weights,
            "table_bytes": table, "nbytes": weights + table}


def _layer_bytes(w: torch.Tensor) -> torch.Tensor:
    """Weights [..., N, K] as the pass skeleton reads B, matrix by matrix:
    bf16 and int8 row-major; f32 each matrix's TF32 high parts [N, K], then
    its low parts (``staging.tf32_split``)."""
    w = w.contiguous()
    if w.dtype != torch.float32:
        return w.view(torch.uint8).reshape(-1)
    hi, lo = tf32_split(w)
    return torch.stack([hi, lo], -3).contiguous().view(torch.uint8).reshape(
        -1)


def stage_wide_train(fp: FusedParams | FusedParamsInt8PE) -> torch.Tensor:
    """The wide forms' image (uint8, ``wide_stage_plan``), which the
    frame's (``csrc/r2l_wide.cu``: K1, K9, K2) and the training forward's
    (``csrc/r2l_wide_train.cu``: K3, K4/K8) read alike: the head's weights
    (``head_w`` or ``head_q`` [W, in_pad], its columns in the fields' order:
    freq-major from ``prepare_fused_params_pe`` and
    ``calibrate_r2l_int8_pe``, ``r2l_embed``'s from
    ``prepare_fused_params``), then each body layer's, each [out, in]
    row-major as the pass skeleton (``csrc/wide_hopper.cuh``) reads B
    (``_layer_bytes``: f32 its TF32 high parts, then its low parts, a layer
    at a time); for int8 then the epilogue table, (m, b) interleaved a
    channel, the head's row first."""
    if isinstance(fp, FusedParamsInt8PE):
        table = torch.cat([
            torch.stack([fp.head_m, fp.head_b], -1).reshape(-1),
            torch.stack([fp.body_m, fp.body_b], -1).reshape(-1)])
        return torch.cat([_layer_bytes(fp.head_q), _layer_bytes(fp.body_q),
                          table.float().contiguous().view(torch.uint8)])
    return torch.cat([_layer_bytes(fp.head_w), _layer_bytes(fp.body_w)])


def unstage_wide_train(staged: torch.Tensor, cfg: R2LConfig,
                       dtype: torch.dtype, in_dim: int | None = None
                       ) -> dict[str, torch.Tensor]:
    """The fields back from a wide image: 'head_w' [W, kpad] and 'body_w'
    [nb*nl, W, W] (f32: the TF32 high parts, and 'head_w_lo', 'body_w_lo'
    the low parts), or for int8 'head_q', 'body_q' and 'head_m', 'head_b'
    [W], 'body_m', 'body_b' [nb*nl, W]."""
    plan = wide_stage_plan(cfg, dtype, in_dim)
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    parts, cut, end = plan["parts"], plan["head_bytes"], plan["weights_bytes"]
    head = staged[:cut].clone().view(dtype).view(parts, W, plan["kpad"])
    body = staged[cut:end].clone().view(dtype).view(nbl, parts, W, W)
    if dtype == torch.float32:
        return {"head_w": head[0], "head_w_lo": head[1],
                "body_w": body[:, 0], "body_w_lo": body[:, 1]}
    if dtype != torch.int8:
        return {"head_w": head[0], "body_w": body[:, 0]}
    mb = staged[end:end + plan["table_bytes"]].clone().view(
        torch.float32).view(1 + nbl, W, 2)
    return {"head_q": head[0], "body_q": body[:, 0],
            "head_m": mb[0, :, 0], "head_b": mb[0, :, 1],
            "body_m": mb[1:, :, 0], "body_b": mb[1:, :, 1]}


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def wide_maps_x(dtype: torch.dtype, pe: bool, in_dim: int) -> bool:
    """Whether the frame's wide head reads its input as it is
    (``csrc/r2l_wide.cu``, maps_x): K9 f32 whose rows are a multiple of 16
    bytes, by TMA, which fills the columns past ``in_dim`` with zeros;
    every other head reads an encoding written first."""
    return not pe and dtype == torch.float32 and in_dim % 4 == 0


def wide_scratch_bytes(rows: int, W: int, dtype: torch.dtype, nl: int,
                       use_residual: bool, kp: int) -> int:
    """The scratch one wide call needs for passes of ``rows`` rays
    (``csrc/r2l_wide.cu``, frame_scratch): the head's input [rows, kp] of
    the compute type (int8: its codes; ``kp`` 0 where the head maps x,
    ``wide_maps_x``); bf16/f32 then h0 (with the global residual), two h
    and min(nl-1, 2) t of the compute type; int8 two code buffers, the bf16
    residual stream and an f32 h0 (with the global residual); each
    [rows, W], 256-byte aligned."""
    e = rows * W
    es = torch.empty(0, dtype=dtype).element_size()
    enc = _aligned(rows * kp * es)
    if dtype == torch.int8:
        return (enc + 2 * _aligned(e) + _aligned(2 * e)
                + (_aligned(4 * e) if use_residual else 0))
    return enc + (2 + min(nl - 1, 2) + int(use_residual)) * _aligned(e * es)


def _need_wide_image(fp) -> None:
    """Raise ValueError where ``fp`` carries no image staged for the wide
    forms (``stage_wide_train``), which the frame's and the training
    forward's read alike."""
    if getattr(fp, "staged", None) is None or fp.staged_for != "wide":
        raise ValueError(
            "fp has no staged image of the wide forms (stage_wide_train): "
            "pack it with prepare_fused_params, prepare_fused_params_pe or "
            "calibrate_r2l_int8_pe (stage=True) at its kernel width for the "
            "frame, with r2l_train.prepare_train_params (bf16, f32) or "
            "stage_int8_train (int8) for training")


def wide_rows(n: int, W: int, dtype: torch.dtype, nl: int,
              use_residual: bool, kp: int) -> int:
    """Rays a pass of a wide call on n rays: all of them, or as many as
    keep the scratch (``wide_scratch_bytes``) within
    ``WIDE_SCRATCH_BYTES``."""
    per_4096 = wide_scratch_bytes(4096, W, dtype, nl, use_residual, kp)
    return min(n, max(WIDE_CHANNELS, WIDE_SCRATCH_BYTES * 4096 // per_4096))


def wide_cast_ref(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain twin of K9's wide head input (``csrc/r2l_wide.cu``, cast_x):
    x [n, in_dim] f32 rounded to ``dtype`` (bf16, f32), zero-padded to
    [n, in_dim padded to 128]: ``fused_r2l_apply_ref``'s head input."""
    return torch.nn.functional.pad(x.to(dtype),
                                   (0, _padded_in(x.shape[1]) - x.shape[1]))


@trace.spanned("kernel.launch")
def _launch_wide(wrapper, fp: FusedParams | FusedParamsInt8PE,
                 cfg: R2LConfig, inp: torch.Tensor, dim_pts: int, L: int,
                 in_dim: int, epilogue: int) -> torch.Tensor:
    """One call of the wide form (``csrc/r2l_wide.cu``: over the rays in
    ``wide_rows`` passes, the head's input, then the head and each body
    layer a pass of the pass skeleton, then the tail) on the CUDA tensor
    ``inp`` (points with ``dim_pts``, else encoded rays), ``cfg`` at its
    width, the image checked here and a fresh scratch; counted in
    ``wrapper.launches``, K2's ``bf16_resid`` forms also in
    ``wrapper.launches_bf16_resid``."""
    from . import _build
    int8 = isinstance(fp, FusedParamsInt8PE)
    wd = fp.head_q.dtype if int8 else fp.head_w.dtype
    dev, n, W = inp.device, inp.shape[0], cfg.netwidth
    _check(fp.staged, "staged", torch.uint8,
           (wide_stage_plan(cfg, wd, in_dim)["nbytes"],), dev)
    tail_w = fp.tail_q if int8 else fp.tail_w
    out = torch.empty((n, tail_w.shape[0]), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    maps_x = wide_maps_x(wd, dim_pts > 0, in_dim)
    if maps_x and inp.data_ptr() % 16:   # TMA reads x from 16-byte bases
        inp = inp.clone()
    kp = 0 if maps_x else _padded_in(in_dim)
    rows = wide_rows(n, W, wd, cfg.n_learnable, cfg.use_residual, kp)
    scratch = torch.empty((wide_scratch_bytes(
        rows, W, wd, cfg.n_learnable, cfg.use_residual, kp),),
        dtype=torch.uint8, device=dev)
    def q8(name):    # int8's scales
        return _ptr(getattr(fp, name)) if int8 else None

    def bias(name):  # bf16/f32's biases (int8's are in the image)
        return None if int8 else _ptr(getattr(fp, name))
    lib = _build.load("r2l_wide")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        wrapper.launches += 1
        if int8 and epilogue & BF16_RESID:
            wrapper.launches_bf16_resid += 1
        rc = lib.r2l_wide_launch(
            _ptr(inp), n, dim_pts, L, in_dim, int(dim_pts > 0),
            _WIDE_TYPES[wd], _ptr(fp.staged), bias("head_b"),
            bias("body_b"), q8("head_inv"), q8("body_inv"), _ptr(tail_w),
            q8("tail_m"), _ptr(fp.tail_b), q8("tail_inv"), _ptr(out),
            _ptr(scratch),
            scratch.numel(), rows, W, cfg.num_blocks, cfg.n_learnable,
            out.shape[1], float(cfg.res_scale), int(cfg.use_residual),
            int(cfg.linear_tail), epilogue, ctypes.c_void_p(stream))
    _raise_on_error(rc, "r2l_wide")
    return out


def fused_r2l_apply_pe_wide(fp: FusedParams, cfg: R2LConfig,
                            pts: torch.Tensor, dim_pts: int,
                            L: int = 10) -> torch.Tensor:
    """K1's wide form: pts [N, dim_pts] -> RGB [N, out_dim] f32, the
    encoding written once, then a pass of the pass skeleton a layer (``fp``
    from ``prepare_fused_params_pe`` at its ``kernel_width``, staged). ``fused_r2l_apply_pe`` sends every
    student wider than ``R2L_KERNEL_WIDTHS`` here. CPU tensors take the
    plain version."""
    if pts.device.type == "cpu":
        return fused_r2l_apply_pe_ref(fp, cfg, pts, dim_pts, L)
    _refuse_frame(cfg, "K1's wide form (fused_r2l_apply_pe_wide)", L=L)
    _need_wide_image(fp)
    cfg, dev, in_dim = kernel_cfg(cfg), pts.device, dim_pts * (2 * L + 1)
    _check(pts, "pts", torch.float32, (pts.shape[0], dim_pts), dev)
    _check_chain_params(fp, cfg, in_dim, dev)
    return _launch_wide(fused_r2l_apply_pe_wide, fp, cfg, pts, dim_pts, L,
                        in_dim, 0)


fused_r2l_apply_pe_wide.launches = 0


def fused_r2l_apply_wide(fp: FusedParams, cfg: R2LConfig,
                         x: torch.Tensor) -> torch.Tensor:
    """K9's wide form: x [N, input_dim] (encoded rays, any float dtype,
    rounded once to the compute dtype, by the kernel as ``wide_cast_ref``
    does) -> RGB [N, out_dim] f32 (``fp`` from ``prepare_fused_params`` at
    its ``kernel_width``); ``fused_r2l_apply``
    sends every student wider than ``R2L_KERNEL_WIDTHS`` here. CPU tensors
    take the plain version."""
    if x.device.type == "cpu":
        return fused_r2l_apply_ref(fp, cfg, x)
    _refuse_frame(cfg, "K9's wide form (fused_r2l_apply_wide)")
    _need_wide_image(fp)
    cfg = kernel_cfg(cfg)
    dev, n, in_dim = x.device, x.shape[0], cfg.input_dim
    if not x.is_floating_point():
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    _check_chain_params(fp, cfg, in_dim, dev)
    if x.dtype != torch.float32:
        x = x.to(_compute_dtype(fp, cfg)).float()
    _check(x, "x", torch.float32, (n, in_dim), dev)
    return _launch_wide(fused_r2l_apply_wide, fp, cfg, x, 0, 0, in_dim, 0)


fused_r2l_apply_wide.launches = 0


def fused_r2l_apply_int8_pe_wide(fp: FusedParamsInt8PE, cfg: R2LConfig,
                                 pts: torch.Tensor, dim_pts: int,
                                 L: int = 10, fold_requant: bool = True,
                                 nobf16_inner: bool = True,
                                 bf16_resid: bool = False) -> torch.Tensor:
    """K2's wide form in ``_int8_pe_chain``'s three forms, each also with
    ``bf16_resid`` (the flags as in ``fused_r2l_apply_int8_pe``, ``fp``
    from ``calibrate_r2l_int8_pe`` at its ``kernel_width``, staged): the
    plain version's codes, sums and epilogues, bit for bit.
    ``fused_r2l_apply_int8_pe`` sends every ``wide_form`` student here. CPU
    tensors take the plain version."""
    if pts.device.type == "cpu":
        return fused_r2l_apply_int8_pe_ref(fp, cfg, pts, dim_pts, L,
                                           fold_requant, nobf16_inner,
                                           bf16_resid)
    _refuse_frame(cfg, "K2's wide form (fused_r2l_apply_int8_pe_wide)",
                  int8=True, L=L)
    _need_wide_image(fp)
    cfg, dev = kernel_cfg(cfg, int8=True, L=L), pts.device
    _check(pts, "pts", torch.float32, (pts.shape[0], dim_pts), dev)
    _check_int8_params(fp, cfg, dim_pts, L, dev)
    return _launch_wide(
        fused_r2l_apply_int8_pe_wide, fp, cfg, pts, dim_pts, L,
        dim_pts * (2 * L + 1),
        int8_form_code(fold_requant, nobf16_inner, bf16_resid))


fused_r2l_apply_int8_pe_wide.launches = 0
fused_r2l_apply_int8_pe_wide.launches_bf16_resid = 0   # of them, bf16_resid
