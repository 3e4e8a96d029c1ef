"""K1's design alternatives, measured on the card: variant copies of the
student's Hopper chain (``kernels/csrc/r2l_hopper.cuh``) timed against the
chain as built.

A variant is a copy of ``kernels/csrc`` with a few source edits
(``VARIANTS``), built with the repository's nvcc flags and swapped in for
K1's library; the staged image is packed at the variant's stage width and
the h0 scratch sized for its clusters. Each is timed on one 400x400 lego
frame of the canonical student (random weights, seed 0), in turns base /
variant / variant / base, CUDA events over 5 launches after one, in bf16
and f32; its output is held against K1's plain version, except the two
timing-only variants, whose outputs are wrong by design:

* ``c4``: 4-block clusters (the image read from L2 half as often);
* ``slots6``: six 16 KB ring slots (bf16 32-channel stages, f32 8-channel)
  in place of three of 32 KB;
* ``noepi``: without the hidden layers' epilogues (timing only);
* ``nomma``: without them and the products (timing only);
* ``epi_v1``: the epilogue as first written, each bias pair loaded where
  each row uses it and the tiles' row stride a runtime value;
* ``wait0``: each stage's products waited for and its slot released at
  once, no product in flight across a warpgroup's stages.

``--steps TREE ...`` times instead the four distillation kinds of
``chip_smoke.py``'s phase 6 in each checkout given, in order (a parent's
unpacked with ``git archive``, and ``.``), each in a process of its own,
with that checkout's code and constants (``_harness.time_steps``; PR 9's
runs timed ``xla`` and ``fused`` only).

    python -m r2l_tpu_torch.exp.chain_variants [--variants c4,...] \
        [--out PATH]
    python -m r2l_tpu_torch.exp.chain_variants --steps PARENT . . PARENT

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path

import torch

from . import _harness

BF16_KIND = ("static constexpr int kKS = 64, kKSB = 128, kWGs = 2, "
             "kStages = 3;")
F32_KIND = ("static constexpr int kKS = 16, kKSB = 64, kWGs = 1, "
            "kStages = 3;")
BF16_SLOTS6 = ("static constexpr int kKS = 32, kKSB = 64, kWGs = 2, "
               "kStages = 6;")
F32_SLOTS6 = ("static constexpr int kKS = 8, kKSB = 32, kWGs = 1, "
              "kStages = 6;")
INNER = "      if (j + 1 < a.nl) {  // inner layer: ReLU, round, into T"
# every block but the last skips its epilogues
NO_HIDDEN_EPI = "      if (blk + 1 < a.nb) {\n      } else " + INNER.lstrip()
MMA_BF16 = ("        Wgmma<N>::bf16(d, da, db, st > 0 || j > 0 || "
            "accumulate);")
MMA_TF32 = ("      Wgmma<N>::tf32(d, hi[j], bl, st > 0 || j > 0 || "
            "accumulate);\n"
            "      Wgmma<N>::tf32(d, lo[j], bh, 1);\n"
            "      Wgmma<N>::tf32(d, hi[j], bh, 1);")
BIAS_AHEAD = """    float2 bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bb[q] = ldg2(b + 8 * (j0 + q) + 2 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q, c = 8 * j + 2 * t;
      f(r0, c, d[4 * j], d[4 * j + 1], bb[q]);
      f(r0 + 8, c, d[4 * j + 2], d[4 * j + 3], bb[q]);
    }"""
BIAS_PER_ROW = """#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q, c = 8 * j + 2 * t;
      f(r0, c, d[4 * j], d[4 * j + 1], ldg2(b + c));
      f(r0 + 8, c, d[4 * j + 2], d[4 * j + 3], ldg2(b + c));
    }"""
RELEASE_BEHIND = """    wgmma_commit();
    if (pend >= 0) {
      wgmma_wait<1>();
      release<kC>(ring, pend, wtid);
    }
    pend = slot;
  }
  wgmma_wait<0>();
  fence_regs(d);
  release<kC>(ring, pend, wtid);
}"""
RELEASE_AT_ONCE = """    wgmma_commit();
    wgmma_wait<0>();
    release<kC>(ring, slot, wtid);
    pend = slot;
  }
  fence_regs(d);
}"""

# name: ([(file, text, replacement)], {weight dtype: (stage channels,
# blocks per cluster)} where they differ from the build, checked output)
VARIANTS = {
    "c4": ([("r2l_hopper.cuh",
             "  static constexpr bool kRegA = false;\n"
             "  static constexpr int kC = 2;",
             "  static constexpr bool kRegA = false;\n"
             "  static constexpr int kC = 4;"),
            ("r2l_hopper.cuh",
             "  static constexpr bool kRegA = true;\n"
             "  static constexpr int kC = 2;",
             "  static constexpr bool kRegA = true;\n"
             "  static constexpr int kC = 4;")],
           {torch.bfloat16: (None, 4), torch.float32: (None, 4)}, True),
    "slots6": ([("r2l_hopper.cuh", BF16_KIND, BF16_SLOTS6),
                ("r2l_hopper.cuh", F32_KIND, F32_SLOTS6)],
               {torch.bfloat16: (32, None), torch.float32: (8, None)}, True),
    "noepi": ([("r2l_hopper.cuh", INNER, NO_HIDDEN_EPI)], {}, False),
    "nomma": ([("r2l_hopper.cuh", INNER, NO_HIDDEN_EPI),
               ("hopper_ring.cuh", MMA_BF16, "        {}"),
               ("hopper_ring.cuh", MMA_TF32, "")], {}, False),
    "epi_v1": ([("r2l_hopper.cuh", "  constexpr int kLd = tile_ld<T, W>();",
                 "  const int kLd = tile_ld<T, W>() + (a.n < 0);"),
                ("r2l_hopper.cuh", BIAS_AHEAD, BIAS_PER_ROW)], {}, True),
    "wait0": ([("hopper_ring.cuh", RELEASE_BEHIND, RELEASE_AT_ONCE)], {},
              True),
}


def time_variants(names, log, reps: int = 5) -> None:
    from ..kernels import _build
    from ..kernels import r2l_fused as F
    from ..models.r2l import R2LConfig, init_r2l
    dev = _harness.require_cuda("chain_variants")
    log(_harness.device_record())
    sampler, poses = _harness.lego_frames(16, dev)
    pts = sampler.sample_test(poses[3])
    with tempfile.TemporaryDirectory() as tmp:
        libs = _harness.build_variants(
            {n: (VARIANTS[n][0], "r2l_pe_fused") for n in names}, Path(tmp))
        _build.load("r2l_pe_fused")
        for wd in (torch.bfloat16, torch.float32):
            cfg = R2LConfig(compute_dtype=wd)
            model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
            fp = F.prepare_fused_params_pe(model, cfg, 48, 10,
                                           weight_dtype=wd)
            want = F.fused_r2l_apply_pe_ref(fp, cfg, pts, 48, 10)
            for name in names:
                k, cluster = VARIANTS[name][1].get(wd, (None, None))
                keep = (F.CHAIN_STAGE_K[wd], F.CHAIN_CLUSTER[wd])
                F.CHAIN_STAGE_K[wd] = k or keep[0]
                F.CHAIN_CLUSTER[wd] = cluster or keep[1]
                fpv = F.prepare_fused_params_pe(model, cfg, 48, 10,
                                                weight_dtype=wd)
                F.CHAIN_STAGE_K[wd], F.CHAIN_CLUSTER[wd] = keep

                @contextlib.contextmanager
                def swap(lib=libs[name][0], wd=wd, cluster=cluster or keep[1],
                         keep=keep[1]):
                    F.CHAIN_CLUSTER[wd] = cluster
                    try:
                        with _harness.loading(lib):
                            yield
                    finally:
                        F.CHAIN_CLUSTER[wd] = keep

                base_ms, variant_ms, got = _harness.in_turns(
                    lambda: F.fused_r2l_apply_pe(fp, cfg, pts, 48, 10),
                    lambda: F.fused_r2l_apply_pe(fpv, cfg, pts, 48, 10),
                    swap, reps)
                kind = "bf16" if wd == torch.bfloat16 else "f32"
                log({"name": f"{name}_{kind}", "base_ms": base_ms,
                     "variant_ms": variant_ms,
                     "max_abs_err": float((got - want).abs().max())
                     if VARIANTS[name][2] else None,
                     "build": libs[name][1][:12]})


def main(argv=None) -> None:
    _harness.variants_main("chain_variants", __doc__, VARIANTS,
                           time_variants, argv)


if __name__ == "__main__":
    main()
