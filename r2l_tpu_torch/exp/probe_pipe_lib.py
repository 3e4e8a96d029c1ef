"""K2 with each ray tile split into S streams.

Port of ``exp/probe_pipe_lib.py::apply_int8_pe_streams``: K2 whole (PE,
head, the 43 blocks, tail) in its deployed form (``fold_requant`` +
``nobf16_inner``), with each ray tile split into S streams whose products
are issued together per layer, so that one stream's epilogue can hide under
another's tensor-core work. On the card the S are schedules of K2's Hopper
kernel (``kernels/csrc/r2l_int8_hopper.cuh``, launched through K2's entry
point ``r2l_int8_hopper.cu``) on K2's image, its 64-ray consumer
warpgroups the streams: S = 1 is K2 in lockstep (``kStreams1``), S = 2 K2's
ping-pong itself (``kDeployed``), S = 4 four warpgroups a block, each a
turn behind the one before, each layer two products of W/2 outputs
(``kStreams4``). Rows never mix, so at every S the output is K2's bit for
bit and the plain version is K2's.

``apply_int8_pe_streams`` runs its plain version for a CPU tensor only; for
a CUDA tensor it launches the kernel or raises (also without K2's staged
image, which ``calibrate_r2l_int8_pe`` makes), and counts the launch in
``apply_int8_pe_streams.launches``. Its driver is ``probe_pipe``.
"""
from __future__ import annotations

import torch

from ..kernels.r2l_fused import (EPILOGUES, FusedParamsInt8PE,
                                  _launch_int8_hopper,
                                  fused_r2l_apply_int8_pe_ref,
                                  int8_chain_stage_plan)
from ..models.r2l import R2LConfig

STREAMS = (1, 2, 4)   # the kernel's S: 64-ray warpgroups in turn
# each S's form in csrc/r2l_int8_hopper.cuh's Epi: kStreams1, K2's
# kDeployed, kStreams4
STREAM_CODE = {1: 7, 2: EPILOGUES["deployed"], 4: 8}


def apply_int8_pe_streams_ref(fp: FusedParamsInt8PE, cfg: R2LConfig,
                              pts: torch.Tensor, dim_pts: int,
                              L: int = 10) -> torch.Tensor:
    """Plain version of ``apply_int8_pe_streams``: K2's deployed chain, the
    same at every S."""
    return fused_r2l_apply_int8_pe_ref(fp, cfg, pts, dim_pts, L)


def apply_int8_pe_streams(fp: FusedParamsInt8PE, cfg: R2LConfig,
                          pts: torch.Tensor, dim_pts: int, L: int = 10,
                          streams: int = 2) -> torch.Tensor:
    """pts [N, dim_pts] -> RGB [N, out_dim] f32 through K2's deployed chain
    with ``streams`` ray streams; ``fp`` from ``calibrate_r2l_int8_pe(...,
    fold_requant=True)``, width 256. CPU tensors take the plain version."""
    if streams not in STREAMS:
        raise ValueError(f"streams must be one of {STREAMS}, got {streams}")
    if pts.device.type == "cpu":
        return apply_int8_pe_streams_ref(fp, cfg, pts, dim_pts, L)
    if cfg.netwidth != 256:
        raise ValueError(f"the stream kernel takes width 256, got "
                         f"{cfg.netwidth}")
    return _launch_int8_hopper(fp, cfg, pts, dim_pts, L,
                               STREAM_CODE[streams],
                               wrapper=apply_int8_pe_streams)


apply_int8_pe_streams.launches = 0


def streams4_fill_order(cfg: R2LConfig, dim_pts: int, L: int
                        ) -> list[tuple[int, int, int, int]]:
    """The S = 4 kernel's ring, in the order its producer fills it: for each
    16 KB slot (half of one of K2's image stages, ``stage_int8_chain``), the
    (byte offset in the image, layer, the stage's first input channel in
    it, the half's first output) it copies. The head is layer -1 (its
    input channels in ``int8_head_columns`` order): half 0 over the slices
    of 2W columns from the first, half 1 from the last; then every body
    layer, half 0 then half 1, each over the layer's stages."""
    plan = int8_chain_stage_plan(cfg, dim_pts, L)
    W, k = cfg.netwidth, plan["stage_k"]
    nbl = cfg.num_blocks * cfg.n_learnable
    half = W // 2 * k
    nsl = -(-plan["kpad"] // (2 * W))
    order = []
    for hf in (0, 1):
        for s in range(nsl):
            i = s if hf == 0 else nsl - 1 - s
            c0 = 2 * W * i
            for c in range(c0, min(c0 + 2 * W, plan["kpad"]), k):
                order.append((c // k * W * k + hf * half, -1, c, hf * W // 2))
    head = plan["kpad"] // k
    for idx in range(nbl):
        for hf in (0, 1):
            for st in range(W // k):
                g = head + idx * (W // k) + st
                order.append((g * W * k + hf * half, idx, st * k,
                              hf * W // 2))
    return order
