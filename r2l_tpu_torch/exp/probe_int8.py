"""K2's int8 ResMLP body with static activation scales, and its bf16
control.

Port of ``exp/probe_int8.py``, which measured the real ResMLP epilogue
(bias, ReLU, scaled residual), the requantize fold and two tiles in flight
to pick K2's design. It times 43 blocks of two W256 layers on [163840, 256]
f32 (the residual stream in bf16, ``res_scale`` 0.5, the static activation
scale A_SCALE = 2/127) through the hand-written CUDA kernel
``kernels/csrc/probe_resmlp.cu`` (replaces ``make_runner``), one entry per
distinct function of the JAX runner:

* ``int8_resmlp`` (``resmlp_kernel``, fold=False): quantize, dot, one-FMA
  dequantize, ReLU, quantize, dot, dequantize + residual;
* ``int8_resmlp_fold`` (fold=True): ReLU and the requantize folded into the
  int32 -> int8 step;
* ``int8_resmlp_dual``: two 64-ray tiles in flight per block. JAX's
  ``dual`` (the two half tiles one after the other) and
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


def resmlp(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor | None,
           b: torch.Tensor, body: str = "int8",
           dual: bool = False) -> torch.Tensor:
    """x [N, 256] f32 through the ResMLP body of ``w`` [2 nb, 256, 256]
    (int8 for the int8 bodies, bf16 for ``bf16``; packed [out, in]), ``m``
    [2 nb, 256] f32 (the int8 bodies' dequantize multipliers; None for
    ``bf16``) and ``b`` [2 nb, 256] f32 -> [N, 256] f32. ``dual`` runs two
    64-ray tiles per block (the same output, bit for bit). CPU tensors take
    the plain version."""
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
    out = torch.empty_like(x)
    lib = _build.load("probe_resmlp")
    with torch.cuda.device(dev):
        resmlp.launches += 1
        rc = lib.probe_resmlp_launch(
            _ptr(x), x.shape[0], _ptr(w), None if body == "bf16" else _ptr(m),
            _ptr(b), INV_A, RS, _ptr(out), L // 2, BODIES[body], int(dual),
            _stream(dev))
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
    ``apply_``), with ``weights`` from ``variant_weights``."""
    body, dual = variant_body(name)
    return lambda x: resmlp(x, *weights, body=body, dual=dual).sum()


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
