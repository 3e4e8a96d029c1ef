"""K2 with each ray tile split into S streams.

Port of ``exp/probe_pipe_lib.py::apply_int8_pe_streams``: K2 whole (PE,
head, the 43 blocks, tail) in its deployed form (``fold_requant`` +
``nobf16_inner``), with each ray tile split into S streams whose products
are issued together per layer, so that one stream's epilogue can hide under
another's tensor-core work. On the card (K2's pre-Hopper chain,
``kernels/csrc/r2l_int8_chain.cuh``, through its entry point
``r2l_int8_pe_fused.cu``) S teams of 256 threads each own 64/S rays of a
block's 64, sharing K2's weight stages. Rows never mix, so at every S the
output is K2's bit for bit and the plain version is K2's.

``apply_int8_pe_streams`` runs its plain version for a CPU tensor only; for
a CUDA tensor it launches the kernel or raises, and counts the launch in
``apply_int8_pe_streams.launches``. Its driver is ``probe_pipe``.
"""
from __future__ import annotations

import torch

from ..kernels.r2l_fused import (FusedParamsInt8PE,
                                  fused_r2l_apply_int8_pe_ref,
                                  launch_int8_pe_chain)
from ..models.r2l import R2LConfig

STREAMS = (1, 2, 4)   # the kernel's S: 64/S rays per team


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
    with ``streams`` ray streams per 64-ray tile; ``fp`` from
    ``calibrate_r2l_int8_pe(..., fold_requant=True)``, width 256. CPU
    tensors take the plain version."""
    if streams not in STREAMS:
        raise ValueError(f"streams must be one of {STREAMS}, got {streams}")
    if pts.device.type == "cpu":
        return apply_int8_pe_streams_ref(fp, cfg, pts, dim_pts, L)
    return launch_int8_pe_chain(apply_int8_pe_streams, fp, cfg, pts,
                                dim_pts, L, streams)


apply_int8_pe_streams.launches = 0
