"""The int8 body's wall: what K2's epilogue costs above the bare product
rate.

Port of ``exp/probe_wall.py``: 86 int8 W256 layers on [163840, 256] f32,
weights randint[-4, 4) int8, m = 1e-3, in three modes (``make``, through
the hand-written CUDA kernel ``kernels/csrc/probe_int8_chain.cu``):

* ``mxu_only``: one q = clip(round(x * 32), ±127) of the f32 input, every
  layer's int32 dot of that q summed in int32 (the bare product rate);
* ``mincast``: q as above, then per layer q = int8(dot >> 8), an arithmetic
  shift and a wrapping cast (XLA's convert);
* ``realistic``: x rounded to bf16, per layer quantize x 32, dot, x m,
  ReLU, bf16: ``probe_mxu.int8_chain`` with inv = 32 and s = m.

The kernel is K2's ``wgmma`` s8 chain (``probe_hopper.cuh``'s skeleton:
two 64-ray warpgroups a block, the weights an image staged once,
``probe_mxu.stage_int8_chain(w, m)``, bulk-copied into a ring shared by a
2-block cluster); ``mxu_only`` adds every layer's product into one
accumulator.

All three are exact integer arithmetic with the plain version's roundings,
so the kernel equals its plain version bit for bit (``mxu_only``'s sum stays
below 86 * 256 * 127 * 4 < 2^24, exact in f32). The TPU ray tiles (512,
1024) are scheduling and are not ported.

``wall`` runs its plain version for a CPU tensor only; for a CUDA tensor it
launches the kernel or raises, and counts the launch in ``wall.launches``.

    python -m r2l_tpu_torch.exp.probe_wall [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse

import torch

from ..kernels.r2l_fused import _mm_int, _q8
from ..kernels.staging import Image
from . import _harness
from .probe_mxu import int8_chain_ref, launch_int8_chain, stage_int8_chain

N_LAYERS = 86
W = 256
N_RAYS = 163840
INV = 32.0           # the probe's input scale (x * 32)
M_SCALE = 1e-3       # the probe's dequantize multiplier, every column
SEED = 0             # the runner's weights; its input from SEED + 1
MODES = {"realistic": 0, "mxu_only": 1, "mincast": 2}


def make_weights(generator: torch.Generator, n_layers: int = N_LAYERS,
                 device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's weights (``make``): randint[-4, 4) int8 packed [L, out,
    in] from ``generator`` (a CPU generator), and m = 1e-3 [L, 256] f32."""
    w = torch.randint(-4, 4, (n_layers, W, W), generator=generator,
                      dtype=torch.int32).to(torch.int8)
    m = torch.full((n_layers, W), M_SCALE, dtype=torch.float32)
    return w.to(device), m.to(device)


def wall_ref(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
             mode: str) -> torch.Tensor:
    """Plain version of ``wall``: x [N, 256] f32 -> [N, 256] f32, the int32
    dots exact (``_mm_int``)."""
    if mode == "realistic":
        return int8_chain_ref(x, w, m, INV)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    q = _q8(x, torch.tensor(INV, dtype=torch.float32, device=x.device))
    if mode == "mxu_only":
        acc = torch.zeros_like(x)
        for i in range(w.shape[0]):
            acc = acc + _mm_int(q, w[i])
        return acc
    for i in range(w.shape[0]):
        a = _mm_int(q, w[i]).to(torch.int32)
        q = torch.bitwise_right_shift(a, 8).to(torch.int8).double()
    return q.float()


def wall(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor, mode: str,
         staged: Image | None = None) -> torch.Tensor:
    """x [N, 256] f32 through ``w`` [L, 256, 256] int8 (packed [out, in])
    in ``mode`` (``m`` [L, 256] f32 is read by ``realistic`` only) ->
    [N, 256] f32. ``staged`` is ``probe_mxu.stage_int8_chain(w, m)``, one
    image for the three modes, made here when not given (a caller timing
    the kernel stages once); other tensors' image raises. CPU tensors take
    the plain version."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if x.device.type == "cpu":
        return wall_ref(x, w, m, mode)
    return launch_int8_chain(x, w, m, staged, INV, MODES[mode], wall)


wall.launches = 0


def ops_per_frame(n_rays: int = N_RAYS, n_layers: int = N_LAYERS) -> float:
    """Multiply-adds x 2 of one frame (``exp/probe_wall.py``'s FPF)."""
    return float(n_rays * n_layers * 2 * W * W)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m r2l_tpu_torch.exp.probe_wall")
    p.add_argument("--out", help="also append the JSON records to this file")
    args = p.parse_args(argv)
    dev = _harness.require_cuda(p.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    x = torch.randn((N_RAYS, W), generator=torch.Generator().manual_seed(
        SEED + 1)).to(dev)
    scales = _harness.rep_scales(dev)
    w, m = make_weights(torch.Generator().manual_seed(SEED), device=dev)
    staged = stage_int8_chain(w, m)   # once, for the three modes
    for mode in ("mxu_only", "mincast", "realistic"):
        recs.append(_harness.time_variant(
            mode, lambda i: wall(x * scales[i], w, m, mode, staged).sum(),
            log, ops_per_frame(), "int8"))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
