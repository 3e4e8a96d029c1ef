"""Tensor-core chain probe: the ceiling of K1's and K2's engines on the H100.

Port of ``exp/probe_mxu.py``, which asked why the W=256 bf16 chain capped at
about half the TPU's rate. It times the 86-layer W256 body alone (no head,
tail or encoding) through three hand-written CUDA kernels:

* ``chain`` (``kernels/csrc/probe_chain.cu``, replaces ``make_chain``):
  modes ``full`` (f32 accumulation, + bias, ReLU, bf16; K1's inner layer),
  ``lean`` (the dot rounded to bf16, + the bias rounded to bf16, ReLU) and
  ``none`` (the dot rounded to bf16), on K1's ``wgmma`` chain: two 64-ray
  warpgroups a block, the weights a staged image (``stage_chain``)
  bulk-copied into a ring shared by a 2-block cluster. The two warpgroups
  run in lockstep, or with ``dual=True`` half a layer apart (the probe's
  dual stream: one tile's products under the other's epilogue);
* ``bign`` (``probe_bign.cu``, replaces ``make_bign``): 43 pairs of
  256 -> 512 -> 256 with ReLU, on the same bf16 chain (``stage_bign``),
  the two warpgroups in lockstep;
* ``int8_chain`` (``probe_int8_chain.cu``, replaces ``make_int8``): the
  static-scale int8 chain on K2's ``wgmma`` s8 chain
  (``stage_int8_chain``: the weights and the scale table).

JAX asks ``lean``, ``none`` and ``bigN`` for a bf16 accumulation, which
neither ``mma.sync`` nor ``wgmma`` has: the port sums in f32 and rounds
once, and the plain versions compute the same. Weights are packed
``[L, out, in]`` (``weights_from_jax`` carries the JAX probe's
``[L, in, out]`` arrays over). The TPU knobs ``unroll``, ``tile`` and
``dimension_semantics`` (variants A/B, C/D, E at three tiles and E
par/arb) are TPU scheduling and are not ported.

Each wrapper runs its plain version for a CPU tensor only; for a CUDA
tensor it launches its kernel or raises, and counts the launch in
``.launches``.

    python -m r2l_tpu_torch.exp.probe_mxu [quick] [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from ..kernels.r2l_fused import (_check, _mm_f32, _mm_int, _ptr, _q8,
                                  _raise_on_error)
from ..kernels.r2l_train import _stream
from ..kernels.staging import (STAGE_K, Image, check_image, source,
                               stage_matrices, unstage_matrices)
from . import _harness

N_LAYERS = 86          # the body of the canonical D=88 net (43 blocks x 2)
W = 256
N_RAYS = 163840        # about one 400x400 frame
A_SCALE = 4.0 / 127.0  # make_int8's static activation scale
SEED = 0               # the runner's weights; its input from SEED + 1
MODES = {"full": 0, "lean": 1, "none": 2}
VARIANTS = ("full", "lean", "none", "dual_lean", "bigN", "int8_static")

_BF16 = torch.bfloat16


def weights_from_jax(w, b=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The JAX probe's weights ``w`` [L, in, out] (bf16, f32 or int8 numpy)
    as the port's packed [L, out, in] tensor of the same dtype, and its
    biases ``b`` [L, out] as f32."""
    a = np.asarray(w)
    dtype = {"bfloat16": _BF16, "float32": torch.float32,
             "int8": torch.int8}[a.dtype.name]
    packed = np.ascontiguousarray(np.swapaxes(
        a if dtype == torch.int8 else a.astype(np.float32), 1, 2))
    wt = torch.from_numpy(packed).to(dtype)
    bt = None if b is None else torch.from_numpy(
        np.asarray(b, np.float32).copy())
    return wt, bt


def mk_weights(generator: torch.Generator, n_layers: int = N_LAYERS,
               w_in: int = W, w_out: int = W, dtype=_BF16,
               device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's random weights (``_mk_weights``): normal x 0.05 packed
    [L, w_out, w_in] in ``dtype``, biases normal x 0.01 [L, w_out] f32,
    drawn from ``generator`` (a CPU generator)."""
    w = torch.randn((n_layers, w_out, w_in), generator=generator) * 0.05
    b = torch.randn((n_layers, w_out), generator=generator) * 0.01
    return w.to(dtype).to(device), b.to(device)


def quantize_int8(wf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``make_int8``'s quantization of f32 weights packed [L, out, in]:
    per output column ws = max|w| / 127, wq = clip(round(w / ws), ±127)
    int8, and the dequantize scale s = ws * A_SCALE [L, out] f32."""
    ws = wf.abs().amax(dim=2) / 127.0
    wq = torch.clamp(torch.round(wf / ws[:, :, None]), -127, 127)
    a = torch.tensor(A_SCALE, dtype=torch.float32, device=wf.device)
    return wq.to(torch.int8), (ws * a).contiguous()


def chain_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
              mode: str = "full") -> torch.Tensor:
    """Plain version of ``chain``: x [N, 256] f32 -> [N, 256] f32."""
    h = x.to(_BF16)
    for i in range(w.shape[0]):
        acc = _mm_f32(h, w[i])
        if mode == "full":
            acc = torch.relu(acc + b[i])
        elif mode == "lean":
            acc = torch.relu(acc.to(_BF16).float() + b[i].to(_BF16).float())
        elif mode != "none":
            raise ValueError(f"mode must be one of {tuple(MODES)}, got "
                             f"{mode!r}")
        h = acc.to(_BF16)
    return h.float()


def _check_x(x: torch.Tensor) -> None:
    _check(x, "x", torch.float32, (x.shape[0], W), x.device)
    if x.shape[0] == 0:
        raise ValueError("x has no rays")


def stage_chain(w: torch.Tensor) -> Image:
    """The image ``chain``'s kernel bulk-copies: the bf16 weights w [L, 256,
    256] (packed [out, in]), layer by layer, each cut into stages of 64
    input channels (``staging.STAGE_K``) laid out as ``wgmma`` reads B
    (``staging.stage_matrices``), tagged with w."""
    if w.dtype != _BF16 or w.dim() != 3 or tuple(w.shape[1:]) != (W, W):
        raise ValueError(f"the chain stages bf16 [L, {W}, {W}] weights, "
                         f"got {w.dtype} {tuple(w.shape)}")
    return Image(stage_matrices(w.contiguous(), STAGE_K[_BF16]), "chain",
                 source(w))


def unstage_chain(img: Image) -> torch.Tensor:
    """``stage_chain``'s inverse: the image -> w [L, 256, 256] bf16."""
    return unstage_matrices(img.data, img.source[0][2], STAGE_K[_BF16],
                            _BF16)[0]


def check_chain_image(img: Image, w: torch.Tensor) -> None:
    """Raise ValueError unless ``img`` is ``stage_chain(w)`` of w as it is
    now, whole."""
    check_image(img, "chain", w, what="stage_chain(w)")


def chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
          mode: str = "full", dual: bool = False,
          staged: Image | None = None) -> torch.Tensor:
    """x [N, 256] f32 through the bf16 chain of ``w`` [L, 256, 256] bf16
    (packed [out, in]) and ``b`` [L, 256] f32 (unused, may be None, in
    mode ``none``) -> [N, 256] f32. ``dual`` runs the block's two
    warpgroups half a layer apart (the same output, bit for bit).
    ``staged`` is ``stage_chain(w)``, made here when not given (a caller
    timing the kernel stages once); other weights' image raises. CPU
    tensors take the plain version."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if x.device.type == "cpu":
        return chain_ref(x, w, b, mode)
    from ..kernels import _build
    dev, L = x.device, w.shape[0]
    _check_x(x)
    _check(w, "w", _BF16, (L, W, W), dev)
    if mode != "none" or b is not None:
        _check(b, "b", torch.float32, (L, W), dev)
    if staged is None:
        staged = stage_chain(w)
    check_chain_image(staged, w)
    out = torch.empty_like(x)
    lib = _build.load("probe_chain")
    with torch.cuda.device(dev):
        chain.launches += 1
        rc = lib.probe_chain_launch(
            _ptr(x), x.shape[0], _ptr(staged.data),
            None if b is None else _ptr(b), _ptr(out), L, MODES[mode],
            int(dual), _stream(dev))
    _raise_on_error(rc, "probe_chain")
    return out


chain.launches = 0


def bign_ref(x: torch.Tensor, w1: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bign``: x [N, 256] f32 -> [N, 256] f32."""
    h = x.to(_BF16)
    for p in range(w1.shape[0]):
        a = torch.relu(_mm_f32(h, w1[p])).to(_BF16)
        h = torch.relu(_mm_f32(a, w2[p])).to(_BF16)
    return h.float()


def stage_bign(w1: torch.Tensor, w2: torch.Tensor) -> Image:
    """The image ``bign``'s kernel bulk-copies: per pair, W1's two 256-row
    halves (four stages of 64 input channels each), then W2 (eight), each
    stage laid out as ``wgmma`` reads B (``staging.stage_matrices``), from
    ``w1`` [P, 512, 256] and ``w2`` [P, 256, 512] bf16 (packed [out, in]),
    tagged with both."""
    P = w1.shape[0]
    if (w1.dtype != _BF16 or w2.dtype != _BF16 or w1.dim() != 3
            or tuple(w1.shape[1:]) != (2 * W, W)
            or tuple(w2.shape) != (P, W, 2 * W)):
        raise ValueError(f"bign stages bf16 [P, {2 * W}, {W}] and [P, {W}, "
                         f"{2 * W}] weights, got {w1.dtype} "
                         f"{tuple(w1.shape)} and {w2.dtype} "
                         f"{tuple(w2.shape)}")
    k = STAGE_K[_BF16]
    halves = stage_matrices(w1.contiguous().view(2 * P, W, W), k)
    second = stage_matrices(w2.contiguous(), k)
    data = torch.cat([halves.view(P, -1), second.view(P, -1)], 1)
    return Image(data.view(-1), "bign", source(w1, w2))


def unstage_bign(img: Image) -> tuple[torch.Tensor, torch.Tensor]:
    """``stage_bign``'s inverse: the image -> (w1 [P, 512, 256], w2 [P,
    256, 512]) bf16."""
    P = img.source[0][2][0]
    k = STAGE_K[_BF16]
    pairs = img.data.view(P, 2, -1)
    w1 = unstage_matrices(pairs[:, 0].reshape(-1), (2 * P, W, W), k,
                          _BF16)[0]
    w2 = unstage_matrices(pairs[:, 1].reshape(-1), (P, W, 2 * W), k,
                          _BF16)[0]
    return w1.view(P, 2 * W, W), w2


def check_bign_image(img: Image, w1: torch.Tensor, w2: torch.Tensor) -> None:
    """Raise ValueError unless ``img`` is ``stage_bign(w1, w2)`` of the
    tensors as they are now, whole."""
    check_image(img, "bign", w1, w2, what="stage_bign(w1, w2)", held=2)


def bign(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
         staged: Image | None = None) -> torch.Tensor:
    """x [N, 256] f32 through pairs h <- relu(relu(h W1_p^T) W2_p^T) in bf16,
    ``w1`` [P, 512, 256] and ``w2`` [P, 256, 512] bf16 (packed [out, in])
    -> [N, 256] f32. ``staged`` is ``stage_bign(w1, w2)``, made here when
    not given (a caller timing the kernel stages once); other weights'
    image raises. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return bign_ref(x, w1, w2)
    from ..kernels import _build
    dev, P = x.device, w1.shape[0]
    _check_x(x)
    _check(w1, "w1", _BF16, (P, 2 * W, W), dev)
    _check(w2, "w2", _BF16, (P, W, 2 * W), dev)
    if staged is None:
        staged = stage_bign(w1, w2)
    check_bign_image(staged, w1, w2)
    out = torch.empty_like(x)
    lib = _build.load("probe_bign")
    with torch.cuda.device(dev):
        bign.launches += 1
        rc = lib.probe_bign_launch(_ptr(x), x.shape[0], _ptr(staged.data),
                                   _ptr(out), P, _stream(dev))
    _raise_on_error(rc, "probe_bign")
    return out


bign.launches = 0


def int8_chain_ref(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                   inv: float = 1.0 / A_SCALE) -> torch.Tensor:
    """Plain version of ``int8_chain``: x [N, 256] f32 -> [N, 256] f32, the
    int32 dots exact (``_mm_int``). ``inv`` is the input scale (1 / A_SCALE;
    ``probe_wall``'s ``realistic`` mode passes 32)."""
    inv_t = torch.tensor(inv, dtype=torch.float32, device=x.device)
    h = x.to(_BF16)
    for i in range(wq.shape[0]):
        acc = _mm_int(_q8(h.float(), inv_t), wq[i])
        h = torch.relu(acc * s[i]).to(_BF16)
    return h.float()


def stage_int8_chain(wq: torch.Tensor, s: torch.Tensor) -> Image:
    """The image the int8 chain's kernel bulk-copies: the int8 weights wq
    [L, 256, 256] (packed [out, in]), layer by layer, each cut into two
    stages of 128 input channels (``staging.STAGE_K``) laid out as
    ``wgmma`` reads B (``staging.stage_matrices``), with its scale table s
    [L, 256] f32 (read by the static mode only), tagged with both."""
    if wq.dtype != torch.int8 or wq.dim() != 3 or \
            tuple(wq.shape[1:]) != (W, W):
        raise ValueError(f"the int8 chain stages int8 [L, {W}, {W}] "
                         f"weights, got {wq.dtype} {tuple(wq.shape)}")
    _check(s, "s", torch.float32, (wq.shape[0], W), wq.device)
    return Image(stage_matrices(wq.contiguous(), STAGE_K[torch.int8]),
                 "int8_chain", source(wq, s), s.contiguous())


def unstage_int8_chain(img: Image) -> torch.Tensor:
    """``stage_int8_chain``'s inverse for the weights: the image -> wq [L,
    256, 256] int8."""
    return unstage_matrices(img.data, img.source[0][2], STAGE_K[torch.int8],
                            torch.int8)[0]


def check_int8_chain_image(img: Image, wq: torch.Tensor,
                           s: torch.Tensor) -> None:
    """Raise ValueError unless ``img`` is ``stage_int8_chain(wq, s)`` of the
    tensors as they are now, whole."""
    check_image(img, "int8_chain", wq, s, what="stage_int8_chain(wq, s)")


def launch_int8_chain(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                      staged: Image | None, inv: float, mode: int,
                      wrapper: Callable) -> torch.Tensor:
    """One launch of ``csrc/probe_int8_chain.cu`` in ``mode`` (0 static, 1
    mxu_only, 2 mincast) on ``staged`` (``stage_int8_chain(wq, s)``, made
    here when None), after checking the arguments and the image, counted
    in ``wrapper.launches``."""
    from ..kernels import _build
    dev, L = x.device, wq.shape[0]
    _check_x(x)
    _check(wq, "wq", torch.int8, (L, W, W), dev)
    _check(s, "s", torch.float32, (L, W), dev)
    if staged is None:
        staged = stage_int8_chain(wq, s)
    check_int8_chain_image(staged, wq, s)
    out = torch.empty_like(x)
    lib = _build.load("probe_int8_chain")
    with torch.cuda.device(x.device):
        wrapper.launches += 1
        rc = lib.probe_int8_chain_launch(
            _ptr(x), x.shape[0], _ptr(staged.data), _ptr(staged.table),
            float(inv), _ptr(out), wq.shape[0], mode, _stream(x.device))
    _raise_on_error(rc, "probe_int8_chain")
    return out


def int8_chain(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
               staged: Image | None = None) -> torch.Tensor:
    """x [N, 256] f32 through the static-scale int8 chain: per layer
    q = clip(round_half_even(bf16(h) * (1 / A_SCALE)), ±127), an int32
    dot with ``wq`` [L, 256, 256] int8 (packed [out, in]), h =
    bf16(relu(f32(dot) * s[i])) with ``s`` [L, 256] f32 -> [N, 256] f32.
    ``staged`` is ``stage_int8_chain(wq, s)``, made here when not given (a
    caller timing the kernel stages once); other tensors' image raises.
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return int8_chain_ref(x, wq, s)
    return launch_int8_chain(x, wq, s, staged, 1.0 / A_SCALE, 0, int8_chain)


int8_chain.launches = 0


# ---------------------------------------------------------------------------
# The runner: one entry per distinct function of the JAX probe's main()
# ---------------------------------------------------------------------------

def variant_weights(name: str, generator: torch.Generator, device,
                    n_layers: int = N_LAYERS) -> tuple:
    """Variant ``name``'s weights, drawn as its JAX factory draws them
    (``make_chain``, ``make_bign`` with n_layers // 2 pairs,
    ``make_int8``)."""
    if name == "bigN":
        w1, _ = mk_weights(generator, n_layers // 2, W, 2 * W, device=device)
        w2, _ = mk_weights(generator, n_layers // 2, 2 * W, W, device=device)
        return w1, w2
    if name == "int8_static":
        wf, _ = mk_weights(generator, n_layers, dtype=torch.float32,
                           device=device)
        return quantize_int8(wf)
    return mk_weights(generator, n_layers, device=device)


def make_variant(name: str, weights: tuple
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> the sum of variant ``name``'s output (the JAX factory's
    ``apply_``), with ``weights`` from ``variant_weights`` or
    ``weights_from_jax`` (on the card staged once, here)."""
    cuda = weights[0].device.type == "cuda"
    if name == "bigN":
        staged = stage_bign(*weights) if cuda else None   # once
        return lambda x: bign(x, *weights, staged=staged).sum()
    if name == "int8_static":
        staged = stage_int8_chain(*weights) if cuda else None
        return lambda x: int8_chain(x, *weights, staged=staged).sum()
    dual = name.startswith("dual_")
    mode = name.removeprefix("dual_")
    w, b = weights
    staged = stage_chain(w) if cuda else None
    return lambda x: chain(x, w, b, mode=mode, dual=dual,
                           staged=staged).sum()


def ops_per_frame(name: str, n_rays: int = N_RAYS,
                  n_layers: int = N_LAYERS) -> float:
    """Multiply-adds x 2 of one frame (bigN: n_layers // 2 pairs of two
    256 x 512 products, twice the chain's)."""
    if name == "bigN":
        return float(n_rays * (n_layers // 2) * 2 * 2 * W * 2 * W)
    return float(n_rays * n_layers * 2 * W * W)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m r2l_tpu_torch.exp.probe_mxu")
    p.add_argument("quick", nargs="?", choices=["quick"],
                   help="only none, lean and full")
    p.add_argument("--out", help="also append the JSON records to this file")
    args = p.parse_args(argv)
    dev = _harness.require_cuda(p.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    x = torch.randn((N_RAYS, W), generator=torch.Generator().manual_seed(
        SEED + 1)).to(dev)
    scales = _harness.rep_scales(dev)
    names = ("none", "lean", "full") if args.quick else VARIANTS
    for name in names:
        fn = make_variant(name, variant_weights(
            name, torch.Generator().manual_seed(SEED), dev))
        recs.append(_harness.time_variant(
            name, lambda i: fn(x * scales[i]), log, ops_per_frame(name),
            "int8" if name == "int8_static" else "bf16"))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
