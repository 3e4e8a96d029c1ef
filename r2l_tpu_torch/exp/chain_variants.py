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

``--steps TREE ...`` times instead the ``xla`` and ``fused`` distillation
steps of ``chip_smoke.py``'s phase 6 in each checkout given, in order (a
parent's unpacked with ``git archive``, and ``.``), in a process of its
own, with that checkout's code and constants.

    python -m r2l_tpu_torch.exp.chain_variants [--variants c4,...] \
        [--out PATH]
    python -m r2l_tpu_torch.exp.chain_variants --steps PARENT . . PARENT

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
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


def edited_sources(name: str, csrc: Path, dst: Path) -> None:
    """Copy ``csrc`` to ``dst`` with variant ``name``'s edits, each of
    whose texts must occur exactly once."""
    shutil.copytree(csrc, dst)
    for fname, text, repl in VARIANTS[name][0]:
        src = (dst / fname).read_text()
        if src.count(text) != 1:
            raise ValueError(f"{name}: {fname} holds {src.count(text)} "
                             f"copies of {text[:60]!r}")
        (dst / fname).write_text(src.replace(text, repl))


def build_variants(names, work: Path) -> dict:
    """Build each variant's K1 library in parallel: name -> (CDLL, the
    compiler's register and spill lines)."""
    from ..kernels import _build
    procs = {}
    for name in names:
        d = work / name
        edited_sources(name, _build.CSRC, d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "r2l_pe_fused.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        entry, argtypes = _build.KERNELS["r2l_pe_fused"]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "Used" in ln or "spill" in ln])
    return out


def time_variants(names, log, reps: int = 5) -> None:
    from ..kernels import _build
    from ..kernels import r2l_fused as F
    from ..models.r2l import R2LConfig, init_r2l
    dev = _harness.require_cuda("chain_variants")
    log(_harness.device_record())
    sampler, poses = _harness.lego_frames(16, dev)
    pts = sampler.sample_test(poses[3])
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(names, Path(tmp))
        base_load = _build.load
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
                kind = "bf16" if wd == torch.bfloat16 else "f32"
                rec = {"name": f"{name}_{kind}", "base_ms": [],
                       "variant_ms": [], "max_abs_err": None,
                       "build": libs[name][1][:12]}
                for side in ("base", "variant", "variant", "base"):
                    lib = libs[name][0] if side == "variant" else None
                    if lib is not None:
                        _build.load = lambda _name, lib=lib: lib
                        F.CHAIN_CLUSTER[wd] = cluster or keep[1]
                    try:
                        p = fp if lib is None else fpv
                        got = F.fused_r2l_apply_pe(p, cfg, pts, 48, 10)
                        s, e = (torch.cuda.Event(enable_timing=True)
                                for _ in range(2))
                        torch.cuda.synchronize()
                        s.record()
                        for _ in range(reps):
                            F.fused_r2l_apply_pe(p, cfg, pts, 48, 10)
                        e.record()
                        torch.cuda.synchronize()
                    finally:
                        _build.load = base_load
                        F.CHAIN_CLUSTER[wd] = keep[1]
                    rec[f"{side}_ms"].append(s.elapsed_time(e) / reps)
                    if lib is not None and VARIANTS[name][2]:
                        rec["max_abs_err"] = float((got - want).abs().max())
                log(rec)


# The distillation steps in a checkout (argv[1]): its own code and
# chip_smoke.py constants, phase 6's data, warm-up and timed steps.
_STEPS = r'''
import os, sys, tempfile, time
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np, torch
import chip_smoke as cs
from r2l_tpu_torch.data import (RayBatchLoader, RayShardDataset,
                                write_ray_shards)
from r2l_tpu_torch.hardmine import parse_hard_ratio
from r2l_tpu_torch.models import R2LConfig, init_r2l
from r2l_tpu_torch.sampler import PointSampler
from r2l_tpu_torch.train import (DistillConfig, draw_step, init_train_state,
                                 make_distill_step)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
cfg = R2LConfig(compute_dtype=torch.bfloat16)
sampler = PointSampler(H=cs.H, W=cs.W, focal=cs.FOCAL, n_sample=cs.N_SAMPLE,
                       near=2.0, far=6.0)
n_in, n_out = parse_hard_ratio(cs.HARD_RATIO, cs.N_RAND)
dcfg = DistillConfig(batch_size=cs.N_RAND, n_hard_in=n_in, n_hard_out=n_out,
                     hard_mul=cs.HARD_MUL, warmup_lr=cs.WARMUP,
                     embed_L=cs.EMBED_L, perturb=True)
with tempfile.TemporaryDirectory() as tmp:
    write_ray_shards(tmp, cs.synthetic_rays(cs.N_SHARDS * cs.SHARD_RAYS,
                                            cs.SEED),
                     shard_size=cs.SHARD_RAYS,
                     rng=np.random.default_rng(cs.SEED))
    loader = RayBatchLoader(RayShardDataset(tmp), cs.N_RAND - n_out,
                            seed=cs.SEED, workers=2)
    try:
        batches = [next(loader) for _ in range(2 + cs.TIMED_STEPS)]
    finally:
        loader.close()
draws = [draw_step(dcfg, cs.N_SAMPLE, torch.Generator(dev).manual_seed(
    100 + i)) for i in range(len(batches))]
for kind, kw in (("xla", {}), ("fused", {"fused_vjp": True})):
    model = init_r2l(cfg, torch.Generator().manual_seed(cs.SEED), dev)
    state = init_train_state(model, dcfg, device=dev)
    step = make_distill_step(cfg, dcfg, sampler, device=dev, **kw)
    for i in range(2):
        state, m = step(state, batches[i], draws=draws[i])
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(); s.record()
    for i in range(2, 2 + cs.TIMED_STEPS):
        state, m = step(state, batches[i], draws=draws[i])
    e.record(); torch.cuda.synchronize()
    print(f"{kind} {s.elapsed_time(e) / cs.TIMED_STEPS} "
          f"{float(m['loss'])}", flush=True)
'''


def time_steps(trees, log) -> None:
    _harness.require_cuda("chain_variants")
    log(_harness.device_record())
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", _STEPS, tree],
                             cwd=tree, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=tree))
        if out.returncode != 0:
            raise RuntimeError(f"steps in {tree}:\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            kind, ms, loss = line.split()
            log({"name": f"steps_{kind}", "tree": tree,
                 "ms_per_step": float(ms), "loss": float(loss)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--steps", nargs="+", metavar="TREE")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    log = _harness.Log(args.out)
    if args.steps:
        time_steps(args.steps, log)
    else:
        names = [n for n in args.variants.split(",") if n]
        unknown = sorted(set(names) - set(VARIANTS))
        if unknown:
            raise SystemExit(f"unknown variants {unknown}")
        time_variants(names, log)
    log({"name": "done"})


if __name__ == "__main__":
    main()
