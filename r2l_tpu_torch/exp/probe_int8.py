"""K2's int8 ResMLP body with static activation scales, and its bf16
control.

Port of ``exp/probe_int8.py``, which measured the real ResMLP epilogue
(bias, ReLU, scaled residual), the requantize fold and two tiles in flight
to pick K2's design. It times 43 blocks of two W256 layers on [163840, 256]
f32 (the residual stream in bf16, ``res_scale`` 0.5, the static activation
scale A_SCALE = 2/127) through the hand-written CUDA kernel
``kernels/csrc/probe_resmlp.cu`` (replaces ``make_runner``): the int8
bodies on K2's ``wgmma`` s8 chain, the control on K1's bf16 one, two 64-ray
warpgroups a block, the weights a staged image (``stage_resmlp``: the
layers' stages and the int8 bodies' epilogue table) bulk-copied into a ring
shared by a 2-block cluster. One entry per distinct function of the JAX
runner:

* ``int8_resmlp`` (``resmlp_kernel``, fold=False): quantize, dot, one-FMA
  dequantize, ReLU, quantize, dot, dequantize + residual;
* ``int8_resmlp_fold`` (fold=True): ReLU and the requantize folded into the
  int32 -> int8 step;
* ``int8_resmlp_dual``: the block's two 64-ray warpgroups half a layer
  apart (single: in lockstep), one tile's products under the other's
  epilogue. JAX's ``dual`` (the two half tiles one after the other) and
  ``resmlp_kernel_interleaved`` (layer by layer) are the same function:
  rows never mix;
* ``bf16_resmlp``, ``bf16_resmlp_dual`` (``bf16_kernel``): the bf16
  control, f32 accumulation, the full epilogue.

The ray tiles (``_t1024``, ``_t2048``) and ``vmem_mb`` are TPU scheduling
and are not ported. The weights are drawn with numpy as ``mk_weights`` draws
them, so both packages hold the same arrays. The int8 bodies follow XLA's
CPU groupings (one FMA for acc*m + b; the scale products m*INV_A, b*INV_A,
m*RS, b*RS rounded on their own; the residual added after the FMA), so the
kernel equals its plain version and the JAX body bit for bit.

``resmlp`` runs its plain version for a CPU tensor only; for a CUDA tensor
it launches the kernel or raises, and counts the launch in
``resmlp.launches``.

    python -m r2l_tpu_torch.exp.probe_int8 [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from ..kernels.r2l_fused import (_check, _dequant, _mm_f32, _mm_int, _ptr,
                                  _q8, _raise_on_error)
from ..kernels.r2l_train import _stream
from ..kernels.staging import (STAGE_K, Image, check_image, source,
                               stage_matrices, unstage_matrices)
from . import _harness

N_BLOCKS = 43
W = 256
N_RAYS = 163840
RS = 0.5                  # res_scale
A_SCALE = 2.0 / 127.0     # static activation scale (residual stream ~[-2, 2])
INV_A = 1.0 / A_SCALE     # 63.5, exact in f32
SEED = 0                  # the weights (numpy, as JAX); the input SEED + 1
BODIES = {"int8": 0, "int8_fold": 1, "bf16": 2}
VARIANTS = ("int8_resmlp", "int8_resmlp_fold", "int8_resmlp_dual",
            "bf16_resmlp", "bf16_resmlp_dual")

_BF16 = torch.bfloat16


def mk_weights(seed: int = SEED, n_blocks: int = N_BLOCKS
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mk_weights``'s arrays from numpy's ``default_rng(seed)``: f32
    weights normal x 0.08 packed [2 n_blocks, out, in] (the transpose of
    JAX's [L, in, out]) and biases normal x 0.02 [2 n_blocks, 256]."""
    rng = np.random.default_rng(seed)
    wf = rng.normal(size=(2 * n_blocks, W, W)).astype(np.float32) * 0.08
    bf = rng.normal(size=(2 * n_blocks, W)).astype(np.float32) * 0.02
    return (torch.from_numpy(np.ascontiguousarray(np.swapaxes(wf, 1, 2))),
            torch.from_numpy(bf))


def quantize(wf: torch.Tensor, bf: torch.Tensor, a_scale: float = 1.0
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``quantize`` of f32 weights packed [L, out, in]: per (layer, out
    column) ws = max(max|w|, 1e-12) / 127, wq = clip(round(w / ws), ±127)
    int8, m = ws * a_scale f32 (the static activation scale folded into the
    dequantize), and the biases as f32."""
    ws = torch.clamp(wf.abs().amax(dim=2), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(wf / ws[:, :, None]), -127, 127)
    a = torch.tensor(a_scale, dtype=torch.float32, device=wf.device)
    return (wq.to(torch.int8).contiguous(), (ws * a).contiguous(),
            bf.float().contiguous())


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def resmlp_ref(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor | None,
               b: torch.Tensor, body: str = "int8") -> torch.Tensor:
    """Plain version of ``resmlp``: x [N, 256] f32 -> [N, 256] f32."""
    if body not in BODIES:
        raise ValueError(f"body must be one of {tuple(BODIES)}, got "
                         f"{body!r}")
    inv_a, rs = _f32(INV_A, x), _f32(RS, x)
    h = x.to(_BF16)
    for i in range(w.shape[0] // 2):
        w1, w2, b1, b2 = w[2 * i], w[2 * i + 1], b[2 * i], b[2 * i + 1]
        if body == "bf16":
            t = torch.relu(_mm_f32(h, w1) + b1).to(_BF16)
            h = ((_mm_f32(t, w2) + b2) * rs + h.float()).to(_BF16)
            continue
        m1, m2 = m[2 * i], m[2 * i + 1]
        a1 = _mm_int(_q8(h.float(), inv_a), w1)
        if body == "int8_fold":
            q1 = torch.clamp(torch.round(_dequant(a1, m1 * inv_a,
                                                  b1 * inv_a)),
                             0.0, 127.0).double()
        else:
            q1 = _q8(torch.relu(_dequant(a1, m1, b1)), inv_a)
        a2 = _mm_int(q1, w2)
        h = (_dequant(a2, m2 * rs, b2 * rs) + h.float()).to(_BF16)
    return h.float()


def epilogue_table(m: torch.Tensor, b: torch.Tensor,
                   body: str) -> torch.Tensor:
    """The int8 bodies' epilogue table [2 nb, 256, 2] f32, (m, b) per
    column of each layer as the kernel's one-FMA dequantize takes them:
    a block's first layer (m1, b1), or for ``int8_fold`` (m1 * INV_A,
    b1 * INV_A); its second (m2 * RS, b2 * RS). Each product is the plain
    version's, an f32 product rounded on its own."""
    inv_a, rs = _f32(INV_A, m), _f32(RS, m)
    m, b = m.clone(), b.clone()
    if body == "int8_fold":
        m[0::2], b[0::2] = m[0::2] * inv_a, b[0::2] * inv_a
    m[1::2], b[1::2] = m[1::2] * rs, b[1::2] * rs
    return torch.stack([m, b], -1).contiguous()


def _staged_from(w, m, b, body: str) -> tuple:
    """The tensors ``stage_resmlp`` stages for ``body``."""
    return (w,) if body == "bf16" else (w, m, b)


def stage_resmlp(w: torch.Tensor, m: torch.Tensor | None, b: torch.Tensor,
                 body: str = "int8") -> Image:
    """The image ``resmlp``'s kernel reads for ``body``: the weights w
    [2 nb, 256, 256] (int8, or bf16 for the control; packed [out, in]),
    layer by layer, each cut into stages of 128 bytes of each output row
    (``staging.STAGE_K``) laid out as ``wgmma`` reads B
    (``staging.stage_matrices``); for the int8
    bodies the epilogue table of m and b (``epilogue_table``), tagged
    with ``body`` and the tensors."""
    if body not in BODIES:
        raise ValueError(f"body must be one of {tuple(BODIES)}, got "
                         f"{body!r}")
    dtype = _BF16 if body == "bf16" else torch.int8
    if w.dtype != dtype or w.dim() != 3 or tuple(w.shape[1:]) != (W, W):
        raise ValueError(f"body {body} stages {dtype} [L, {W}, {W}] "
                         f"weights, got {w.dtype} {tuple(w.shape)}")
    table = None if body == "bf16" else epilogue_table(m, b, body)
    return Image(stage_matrices(w.contiguous(), STAGE_K[dtype]), body,
                 source(*_staged_from(w, m, b, body)), table)


def unstage_resmlp(img: Image) -> torch.Tensor:
    """``stage_resmlp``'s inverse for the weights: the image -> w [2 nb,
    256, 256] of the type it was staged from."""
    dtype = _BF16 if img.form == "bf16" else torch.int8
    return unstage_matrices(img.data, img.source[0][2], STAGE_K[dtype],
                            dtype)[0]


def check_resmlp_image(img: Image, w: torch.Tensor,
                       m: torch.Tensor | None, b: torch.Tensor,
                       body: str) -> None:
    """Raise ValueError unless ``img`` is ``stage_resmlp(w, m, b, body)``
    of the tensors as they are now, whole."""
    check_image(img, body, *_staged_from(w, m, b, body),
                what=f"stage_resmlp(w, m, b, {body!r})")
    if body != "bf16":
        _check(img.table, "table", torch.float32, (w.shape[0], W, 2),
               w.device)


def resmlp(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor | None,
           b: torch.Tensor, body: str = "int8", dual: bool = False,
           staged: Image | None = None) -> torch.Tensor:
    """x [N, 256] f32 through the ResMLP body of ``w`` [2 nb, 256, 256]
    (int8 for the int8 bodies, bf16 for ``bf16``; packed [out, in]), ``m``
    [2 nb, 256] f32 (the int8 bodies' dequantize multipliers; None for
    ``bf16``) and ``b`` [2 nb, 256] f32 -> [N, 256] f32. ``dual`` runs the
    block's two warpgroups half a layer apart (the same output, bit for
    bit). ``staged`` is ``stage_resmlp(w, m, b, body)``, made here when not
    given (a caller timing the kernel stages once); another body's or other
    tensors' image raises. CPU tensors take the plain version."""
    if body not in BODIES:
        raise ValueError(f"body must be one of {tuple(BODIES)}, got "
                         f"{body!r}")
    if x.device.type == "cpu":
        return resmlp_ref(x, w, m, b, body)
    from ..kernels import _build
    dev, L = x.device, w.shape[0]
    _check(x, "x", torch.float32, (x.shape[0], W), dev)
    if x.shape[0] == 0 or L == 0 or L % 2:
        raise ValueError(f"need rays and an even number of layers, got x "
                         f"{tuple(x.shape)}, {L} layers")
    _check(w, "w", _BF16 if body == "bf16" else torch.int8, (L, W, W), dev)
    _check(b, "b", torch.float32, (L, W), dev)
    if body != "bf16":
        _check(m, "m", torch.float32, (L, W), dev)
    if staged is None:
        staged = stage_resmlp(w, m, b, body)
    check_resmlp_image(staged, w, m, b, body)
    out = torch.empty_like(x)
    lib = _build.load("probe_resmlp")
    with torch.cuda.device(dev):
        resmlp.launches += 1
        rc = lib.probe_resmlp_launch(
            _ptr(x), x.shape[0], _ptr(staged.data),
            None if body == "bf16" else _ptr(staged.table),
            _ptr(b) if body == "bf16" else None, INV_A, RS, _ptr(out),
            L // 2, BODIES[body], int(dual), _stream(dev))
    _raise_on_error(rc, "probe_resmlp")
    return out


resmlp.launches = 0


# ---------------------------------------------------------------------------
# The runner: one entry per distinct function of the JAX probe's main()
# ---------------------------------------------------------------------------

def variant_body(name: str) -> tuple[str, bool]:
    """(body, dual) of a variant name."""
    dual = name.endswith("_dual")
    base = name.removesuffix("_dual")
    return {"int8_resmlp": "int8", "int8_resmlp_fold": "int8_fold",
            "bf16_resmlp": "bf16"}[base], dual


def variant_weights(name: str, device, n_blocks: int = N_BLOCKS) -> tuple:
    """The JAX runner's arrays for variant ``name`` on ``device``:
    ``quantize(mk_weights(), A_SCALE)`` for the int8 bodies, (the weights in
    bf16, None, b) for the control."""
    wf, bf = mk_weights(SEED, n_blocks)
    if variant_body(name)[0] == "bf16":
        return wf.to(_BF16).to(device), None, bf.to(device)
    return tuple(t.to(device) for t in quantize(wf, bf, A_SCALE))


def make_variant(name: str, weights: tuple
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> the sum of variant ``name``'s output (the JAX runner's
    ``apply_``), with ``weights`` from ``variant_weights`` (on the card
    staged once, here)."""
    body, dual = variant_body(name)
    staged = (stage_resmlp(*weights, body=body)   # once
              if weights[0].device.type == "cuda" else None)
    return lambda x: resmlp(x, *weights, body=body, dual=dual,
                            staged=staged).sum()


def ops_per_frame(n_rays: int = N_RAYS, n_blocks: int = N_BLOCKS) -> float:
    """Multiply-adds x 2 of one frame (``exp/probe_int8.py``'s FPF)."""
    return float(n_rays * n_blocks * 2 * 2 * W * W)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m r2l_tpu_torch.exp.probe_int8")
    p.add_argument("--out", help="also append the JSON records to this file")
    args = p.parse_args(argv)
    dev = _harness.require_cuda(p.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    x = torch.randn((N_RAYS, W), generator=torch.Generator().manual_seed(
        SEED + 1)).to(dev)
    scales = _harness.rep_scales(dev)
    for name in VARIANTS:
        fn = make_variant(name, variant_weights(name, dev))
        recs.append(_harness.time_variant(
            name, lambda i: fn(x * scales[i]), log, ops_per_frame(),
            variant_body(name)[0].split("_")[0]))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
