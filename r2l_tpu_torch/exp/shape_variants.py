"""Design alternatives of the shape probe's kernel, timed on the card.

``kernels/csrc/probe_shapes.cu`` (``run_shape`` on wgmma; ``probe_shapes.
unchained``) against copies of ``csrc/`` with a few source edits each,
built beside it and timed in turns (``_harness.in_turns``: kernel,
variant, variant, kernel) at the probe's (M, K, N) = (1024, 256, 256),
32,768 rows x 64 layers, free and chained, int8 and bf16:

* ``ring_only``: no wgmma issued: the ring's copies and handshakes, the
  adds and the row sums, what the ring costs alone;
* ``products_only``: each chunk's 64 products summed into one accumulator
  and added to the f32 sum once: the products and the ring without the
  per-product adds.

Both are splits of the kernel's time, not its function. The design
alternatives timed once beside them (4-block clusters, eight ring slots,
the two warpgroups' products in turns, int8 sums converted by two adds, A
from shared memory in the free form) lost or tied and were taken out with
their edits; their readings are in PERF.md section 6.

    python -m r2l_tpu_torch.exp.shape_variants [--variants a,b] [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from . import _harness
from . import probe_shapes as PS

SRC = "probe_shapes.cu"
RING = "hopper_ring.cuh"
SHAPE = (1024, 256, 256)

MMA = """      if constexpr (sizeof(T) == 1)
        Wgmma<N>::s8(d, da, db, st > 0 || j > 0 || accumulate);
      else
        Wgmma<N>::bf16(d, da, db, st > 0 || j > 0 || accumulate);"""
MMA_RS = """      if constexpr (std::is_same<typename R::Acc, int>::value)
        Wgmma<kNC>::s8_rs(d, a[st * kJ + j], desc(b + j * 256, R::kKSB * 8),
                          st > 0 || j > 0 || accumulate);
      else
        Wgmma<kNC>::bf16_rs(d, a[st * kJ + j],
                            desc(b + j * 256, R::kKSB * 8),
                            st > 0 || j > 0 || accumulate);"""
PRODUCT_FREE = """        if constexpr (kAB > 0)
          product_rs<kSteps, R>(acc, afr, ring, it, wtid);
        else
          product<T, kNC, kC, R>(acc, tiles, ld, a.K, tiles, ld, a.K, ring,
                                 it, wtid);"""
ADD = """#pragma unroll
        for (int q = 0; q < kNC / 2; ++q)
          sum[q] = __fadd_rn(sum[q], as_f32(acc[q]));"""
ADD_ONCE = """        if (i + 1 == a.n_layers)
          for (int q = 0; q < kNC / 2; ++q)
            sum[q] = __fadd_rn(sum[q], as_f32(acc[q]));"""
# name: [(file, text, replacement)]
VARIANTS = {
    "ring_only": [(RING, MMA, "      {}"), (SRC, MMA_RS, "      {}")],
    "products_only": [(SRC, PRODUCT_FREE + "\n" + ADD,
                       PRODUCT_FREE.replace("wtid);", "wtid, i > 0);")
                       + "\n" + ADD_ONCE)],
}
CASES = ((torch.int8, False), (torch.bfloat16, False), (torch.int8, True),
         (torch.bfloat16, True))


def time_variants(names, log, reps: int = 5) -> list[dict]:
    dev = _harness.require_cuda("shape_variants")
    recs = [log(_harness.device_record())]
    g = torch.Generator().manual_seed(PS.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _harness.build_variants(
            {n: (VARIANTS[n], "probe_shapes") for n in names}, Path(tmp))
        for dtype, chained in CASES:
            x, w = PS.shape_inputs(*SHAPE, dtype, g, device=dev)
            st = PS.stage_shape_weights(w, chained)
            for n in names:
                b, v, _ = _harness.in_turns(
                    lambda: PS.unchained(x, w, chained, st),
                    lambda: PS.unchained(x, w, chained, st),
                    lambda n=n: _harness.loading(libs[n][0]), reps)
                recs.append(log({
                    "name": n, "shape": PS.shape_name(*SHAPE, dtype, chained),
                    "kernel_ms": b, "variant_ms": v,
                    "registers": libs[n][1]}))
            del x, w, st
    recs.append(log({"name": "done"}))
    return recs


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m r2l_tpu_torch.exp.shape_variants")
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma-separated names (default: all)")
    p.add_argument("--out", help="also append the JSON records to this file")
    args = p.parse_args(argv)
    names = [n for n in args.variants.split(",") if n]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}; choose from {sorted(VARIANTS)}")
    return time_variants(names, _harness.Log(args.out))


if __name__ == "__main__":
    main()
