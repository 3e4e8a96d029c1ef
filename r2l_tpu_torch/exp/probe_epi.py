"""K2's requantize epilogue, three ways.

Port of ``exp/probe_epi.py``: ``apply_variant`` is K2 whole (PE, head, the
43 blocks, tail) with the inner requantize
  v0  the bf16 ReLU output times the next inverse scale in f32 (K2's
      ``fold_requant=False``);
  v1  the same product in bf16, ``t_bf16 * bf16(inv)`` rounded to bf16
      before round and clip (as XLA computes it), the first layer of each
      block too;
  v2  v1 with the inner ReLU folded into the clip's lower bound 0 (equal to
      v1 wherever every inverse scale is positive),
through K2's Hopper kernel (``kernels/csrc/r2l_int8_hopper.cuh``, whose
forms ``kEpiV1``/``kEpiV2`` are launched through K2's entry point,
``r2l_int8_hopper.cu``, at width 256; v0 is K2's ``kUnfolded``, the
``fold_requant=False`` form). The plain version is K2's plain chain with
this module's bf16 quantize as its hook. Mosaic refused v1 and v2 on the
TPU, so the card's runs are their only measurements.

Its driver follows ``exp/probe_epi.py:158-200``: the canonical W256/D88
student (random weights from a seeded generator), the int8 packing of
``evaluate._prepare_r2l`` (``fold_requant=True``), and per variant 16 lego
frames (``sample_test`` -> the variant -> the frame's sum, the min of 4
calls) and the max-abs distance of pose 0's output from K2 unfolded
(``fold_requant=False``, which is v0). The probe runs every variant on the
folded packing, so each block's inner layers are scaled twice and mostly
saturate: a fault of the reference (ROADMAP C), computed here as there. The
TPU tile (800) is not ported.

``apply_variant`` runs its plain version for a CPU tensor only; for a CUDA
tensor it launches the kernel or raises (also without K2's staged image,
``FusedParamsInt8PE.staged``, which ``calibrate_r2l_int8_pe`` and so
``setup`` make), and counts the launch in ``apply_variant.launches``.

    python -m r2l_tpu_torch.exp.probe_epi [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse

import torch

from ..evaluate import _prepare_r2l
from ..kernels.r2l_fused import (EPILOGUES, FusedParamsInt8PE,
                                  _launch_int8_hopper,
                                  fused_r2l_apply_int8_pe, int8_pe_chain_ref)
from ..models.r2l import R2LConfig, init_r2l
from . import _harness

VARIANTS = (0, 1, 2)
K = 16          # frames per call
L = 10
REPS = 4
SEED = 0        # the student's weights
# each variant's form in csrc/r2l_int8_hopper.cuh's Epi: K2's kUnfolded,
# kEpiV1, kEpiV2
_EPI_CODE = {0: EPILOGUES["unfolded"], 1: 5, 2: 6}


def _q8_bf16(t: torch.Tensor, inv: torch.Tensor, lo: float) -> torch.Tensor:
    """``clip(round(t_bf16 * inv.astype(bf16)), lo, 127)`` as XLA computes
    it: the product of two bf16 values (exact in f32) rounded to bf16 before
    the round-half-even; as float64, like the chain's ``_q8``."""
    y = (t.to(torch.bfloat16).float()
         * inv.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    return torch.clamp(torch.round(y), lo, 127.0).double()


def _quantize_v1(t: torch.Tensor, inv: torch.Tensor, j: int) -> torch.Tensor:
    """v1's quantize of layer j's bf16 input t: the inner ReLU, then the
    bf16 product."""
    return _q8_bf16(torch.relu(t) if j > 0 else t, inv, -127.0)


def _quantize_v2(t: torch.Tensor, inv: torch.Tensor, j: int) -> torch.Tensor:
    """v2's: the inner ReLU as the clip's lower bound 0."""
    return _q8_bf16(t, inv, 0.0 if j > 0 else -127.0)


_QUANTIZE = {0: None, 1: _quantize_v1, 2: _quantize_v2}


def apply_variant_ref(fp: FusedParamsInt8PE, cfg: R2LConfig,
                      pts: torch.Tensor, dim_pts: int, L: int,
                      variant: int) -> torch.Tensor:
    """Plain version of ``apply_variant``: pts [N, dim_pts] ->
    [N, out_dim] f32."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant}")
    return int8_pe_chain_ref(fp, cfg, pts, dim_pts, L, "unfolded",
                             _QUANTIZE[variant])


def apply_variant(fp: FusedParamsInt8PE, cfg: R2LConfig, pts: torch.Tensor,
                  dim_pts: int, L: int, variant: int) -> torch.Tensor:
    """pts [N, dim_pts] -> RGB [N, out_dim] f32 through K2 with epilogue
    ``variant`` (0, 1, 2), width 256. CPU tensors take the plain
    version."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant}")
    if pts.device.type == "cpu":
        return apply_variant_ref(fp, cfg, pts, dim_pts, L, variant)
    if cfg.netwidth != 256:
        raise ValueError(f"the epilogue kernel takes width 256, got "
                         f"{cfg.netwidth}")
    return _launch_int8_hopper(fp, cfg, pts, dim_pts, L, _EPI_CODE[variant],
                               wrapper=apply_variant)


apply_variant.launches = 0


def setup(device, k: int = K):
    """(cfg, the int8 packing, dim_pts, sampler, poses [k, 3, 4]) of the
    driver: the canonical student from ``SEED`` packed by
    ``_prepare_r2l(..., quantize="int8")`` (no calibration poses: its
    default cameras, as ``exp/probe_epi.py`` calls it)."""
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED), device)
    sampler, poses = _harness.lego_frames(k, device)
    fp, kind, dim_pts = _prepare_r2l(model, cfg, sampler, L, False, True,
                                     "int8")
    assert kind == "int8", kind
    return cfg, fp, dim_pts, sampler, poses


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m r2l_tpu_torch.exp.probe_epi")
    p.add_argument("--out", help="also append the JSON records to this file")
    args = p.parse_args(argv)
    dev = _harness.require_cuda(p.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, fp, dim_pts, sampler, poses = setup(dev)
    pts0 = sampler.sample_test(poses[0])
    ref = fused_r2l_apply_int8_pe(fp, cfg, pts0, dim_pts, L,
                                  fold_requant=False, nobf16_inner=False)
    ops = _harness.chain_ops(cfg, sampler.H * sampler.W, cfg.input_dim)
    for v in VARIANTS:
        err = float((apply_variant(fp, cfg, pts0, dim_pts, L, v)
                     - ref).abs().max())
        recs.append(_harness.time_frames(
            "name", f"epi_v{v}",
            lambda q, v=v: apply_variant(fp, cfg, q, dim_pts, L, v),
            sampler, poses, log, REPS, ops,
            extra={"max_abs_err_vs_prod": err}))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
