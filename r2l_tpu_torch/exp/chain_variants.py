"""K1's and K3's design alternatives, measured on the card: variant copies
of the student's Hopper chain (``kernels/csrc/r2l_hopper.cuh``) timed
against the chain as built.

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

K3's (``k3_*``, the training forward, library ``r2l_train_fwd``) are timed
instead at a distillation step's 81,920 rays (``chip_smoke.train_points``),
in f32 and bf16, and each side's rgb and stash rows are held against the
plain version (f32: max-abs, the share of ``chip_smoke.TOL_TRAIN_F32``):

* ``k3_onesum``: f32 weights' 3xTF32 products summed by the tensor cores
  into the running sum, as K1's, not each weight stage's apart in two
  halves of the outputs and added to it in f32 (the tensor cores truncate
  each sum they add to);
* ``k3_nostash``: without the stash stores (timing only);
* ``k3_pairs`` / ``k3_quad``: the stash rows of both weight types stored
  from the epilogues' registers as each thread's column pairs (4 or 8
  bytes; as built for f32) / 16 or 32 bytes a thread after a transpose
  within the quad (as built for bf16);
* ``k3_halves``: f32's stage sums apart in two halves of the outputs, one
  after the other, not in four parts of 64 in two buffers of 32 registers,
  each part's adds under the next part's products.

``--parent TREE`` builds K1 and K9 from a parent checkout's sources and
holds this checkout's to them on a frame, bit for bit, in turns, with both
builds' registers; then the chain probe (``probe_mxu.chain``, K1's chain
without its head, residual and tail) likewise at its runner's size, each
mode single and dual (``compare_parent_chain``), and bigN
(``probe_mxu.bign``, the chain at N=512) at its runner's size
(``compare_parent_bign``).

``--steps TREE ...`` times instead the five distillation kinds of
``chip_smoke.py``'s phase 6 (the four in bf16, and ``fused`` in f32) in
each checkout given, in order (a parent's unpacked with ``git archive``,
and ``.``), each in a process of its own, with that checkout's code and
constants (``_harness.time_steps``).

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
MMA_TF32 = ("        Wgmma<N>::tf32(d, hi[j], bl, st > 0 || j > 0 || "
            "accumulate);\n"
            "        Wgmma<N>::tf32(d, lo[j], bh, 1);\n"
            "        Wgmma<N>::tf32(d, hi[j], bh, 1);")
BIAS_AHEAD = """    float2 bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bb[q] = ldg2(b + 8 * (j0 + q) + 2 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q, c = 8 * j + 2 * t;
      f(r0, c, d[4 * j], d[4 * j + 1], bb[q], j, 0);
      f(r0 + 8, c, d[4 * j + 2], d[4 * j + 3], bb[q], j, 1);
    }"""
BIAS_PER_ROW = """#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q, c = 8 * j + 2 * t;
      f(r0, c, d[4 * j], d[4 * j + 1], ldg2(b + c), j, 0);
      f(r0 + 8, c, d[4 * j + 2], d[4 * j + 3], ldg2(b + c), j, 1);
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
STASH_STORE = """      if (g < a.n)
        *reinterpret_cast<typename PT::P*>(
            stash + ((size_t)row * a.n + g) * W + c) = PT::make(x0, x1);"""
K3_STASH = ("constexpr StashStore kK3Stash = sizeof(T) == 2 ? kStashQuad : "
            "kStashPairs;")
REG_STASH = """  auto stash_pair = [&](int row, int j, int h, float x0, float x1) {
    if constexpr (kTrain) {"""
SPLIT_HALVES = """      constexpr int NH = N >= 128 ? N / 2 : N;
#pragma unroll
      for (int hf = 0; hf < N / NH; ++hf) {
        float s[NH / 2];
        const uint32_t bo = b + hf * NH * K::kKSB;  // the half's rows of w
        if (hf > 0) wgmma_fence();
#pragma unroll
        for (int j = 0; j < K::kKS / 8; ++j) {
          const uint64_t bh = desc(bo + j * 256, K::kKSB * 8);
          const uint64_t bl = desc(bo + part + j * 256, K::kKSB * 8);
          Wgmma<NH>::tf32(s, hi[j], bl, j > 0);
          Wgmma<NH>::tf32(s, lo[j], bh, 1);
          Wgmma<NH>::tf32(s, hi[j], bh, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        const bool add = st > 0 || accumulate;
#pragma unroll
        for (int i = 0; i < NH / 2; ++i)
          d[hf * NH / 2 + i] =
              add ? __fadd_rn(d[hf * NH / 2 + i], s[i]) : s[i];
      }"""
# (as built) four parts of 64 outputs in two buffers, each part's adds
# under the next part's products
SPLIT_PARTS = """      constexpr int NP = N / 64;
      float s[2][32];
      auto issue = [&](int p) {
        const uint32_t bo = b + p * 64 * K::kKSB;  // the part's rows of w
#pragma unroll
        for (int j = 0; j < K::kKS / 8; ++j) {
          const uint64_t bh = desc(bo + j * 256, K::kKSB * 8);
          const uint64_t bl = desc(bo + part + j * 256, K::kKSB * 8);
          Wgmma<64>::tf32(s[p % 2], hi[j], bl, j > 0);
          Wgmma<64>::tf32(s[p % 2], lo[j], bh, 1);
          Wgmma<64>::tf32(s[p % 2], hi[j], bh, 1);
        }
        wgmma_commit();
      };
      const bool add = st > 0 || accumulate;
      issue(0);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p + 1 < NP) {
          wgmma_fence();  // the adds below read the other buffer last
          issue(p + 1);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s[p % 2]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          d[p * 32 + i] =
              add ? __fadd_rn(d[p * 32 + i], s[p % 2][i]) : s[p % 2][i];
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
    "k3_onesum": ([("r2l_hopper.cuh", "  static constexpr bool kSplit = true;",
                    "  static constexpr bool kSplit = false;")], {}, True),
    "k3_nostash": ([("r2l_hopper.cuh", STASH_STORE, "      (void)g;"),
                    ("r2l_hopper.cuh", REG_STASH,
                     REG_STASH.replace("(kTrain)", "(false)"))], {}, False),
    "k3_pairs": ([("r2l_hopper.cuh", K3_STASH,
                   "constexpr StashStore kK3Stash = kStashPairs;")], {},
                 True),
    "k3_quad": ([("r2l_hopper.cuh", K3_STASH,
                  "constexpr StashStore kK3Stash = kStashQuad;")], {}, True),
    "k3_halves": ([("hopper_ring.cuh", SPLIT_PARTS, SPLIT_HALVES)], {},
                  True),
}


def k3_errors(rgb, stash, rgb_p, stash_p, wd) -> dict:
    """K3's rgb max-abs and each stash row's (bf16: relative to the row's
    largest) against the plain version's."""
    row = (stash.float() - stash_p.float()).abs().amax(dim=(1, 2))
    if wd == torch.bfloat16:
        row = row / stash_p.float().abs().amax(dim=(1, 2)).clamp(min=1)
    return {"rgb": float((rgb - rgb_p).abs().max()),
            "stash_worst": float(row.max()),
            "stash_worst_row": int(row.argmax())}


def time_k3(names, libs, log, dev, reps: int = 5) -> None:
    """K3's variants at a step's rays, in f32 and bf16 (``k3_onesum``
    changes f32 weights' products only)."""
    import chip_smoke as cs
    from ..kernels import r2l_fused as F
    from ..kernels import r2l_train as T
    from ..models.r2l import R2LConfig, init_r2l
    from ..sampler import PointSampler
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(cs.SEED), dev)
    sampler = PointSampler(H=cs.H, W=cs.W, focal=cs.FOCAL,
                           n_sample=cs.N_SAMPLE, near=2.0, far=6.0)
    pts = cs.train_points(cfg, sampler, dev)
    for wd in (torch.float32, torch.bfloat16):
        kind = "bf16" if wd == torch.bfloat16 else "f32"
        fp = F.prepare_fused_params_pe(model, cfg, 48, 10, weight_dtype=wd)
        rgb_p, stash_p = T.train_fwd_ref(fp, cfg, pts, 48, 10)
        base = k3_errors(*T.train_fwd(fp, cfg, pts, 48, 10), rgb_p, stash_p,
                         wd)
        for name in names:
            if name in ("k3_onesum", "k3_halves") and kind == "bf16":
                continue
            base_ms, variant_ms, got = _harness.in_turns(
                lambda: T.train_fwd(fp, cfg, pts, 48, 10),
                lambda: T.train_fwd(fp, cfg, pts, 48, 10),
                lambda lib=libs[name][0]: _harness.loading(lib), reps)
            rec = {"name": f"{name}_{kind}", "base_ms": base_ms,
                   "variant_ms": variant_ms, "base_err": base,
                   "build": libs[name][1][:12]}
            if VARIANTS[name][2]:
                rec["variant_err"] = k3_errors(*got, rgb_p, stash_p, wd)
                if kind == "f32":
                    rec["share_of_tol"] = max(
                        rec["variant_err"]["rgb"],
                        rec["variant_err"]["stash_worst"]) / cs.TOL_TRAIN_F32
            log(rec)
            del got
        del stash_p
        torch.cuda.empty_cache()


def time_variants(names, log, reps: int = 5) -> None:
    from ..kernels import _build
    from ..kernels import r2l_fused as F
    from ..models.r2l import R2LConfig, init_r2l
    dev = _harness.require_cuda("chain_variants")
    log(_harness.device_record())
    k3 = [n for n in names if n.startswith("k3_")]
    names = [n for n in names if n not in k3]
    if k3:
        with tempfile.TemporaryDirectory() as tmp:
            time_k3(k3, _harness.build_variants(
                {n: (VARIANTS[n][0], "r2l_train_fwd") for n in k3},
                Path(tmp)), log, dev, reps)
    if not names:
        return
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


def compare_parent(tree: str, log, reps: int = 5) -> None:
    """K1 and K9 (bf16, f32) of this checkout against the parent's build on
    a lego frame: bit for bit, in turns, with both builds' registers; then
    the chain probe and bigN (``compare_parent_chain``,
    ``compare_parent_bign``)."""
    from ..encoding import r2l_embed
    from ..kernels import r2l_fused as F
    from ..models.r2l import R2LConfig, init_r2l
    dev = _harness.require_cuda("chain_variants")
    log(_harness.device_record())
    sampler, poses = _harness.lego_frames(16, dev)
    pts = sampler.sample_test(poses[3])
    x = r2l_embed(pts, 10)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _harness.parent_libs(
            tree, ("r2l_pe_fused", "r2l_fused", "probe_chain", "probe_bign"),
            Path(tmp))
        for wd in (torch.bfloat16, torch.float32):
            cfg = R2LConfig(compute_dtype=wd)
            model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
            for lib, fp, run in (
                    ("r2l_pe_fused", F.prepare_fused_params_pe(
                        model, cfg, 48, 10, weight_dtype=wd),
                     lambda fp, cfg=cfg: F.fused_r2l_apply_pe(
                         fp, cfg, pts, 48, 10)),
                    ("r2l_fused", F.prepare_fused_params(
                        model, cfg, weight_dtype=wd),
                     lambda fp, cfg=cfg: F.fused_r2l_apply(fp, cfg, x))):
                want = run(fp)
                base_ms, parent_ms, got = _harness.in_turns(
                    lambda: run(fp), lambda: run(fp),
                    lambda lib=libs[lib][0]: _harness.loading(lib), reps)
                log({"name": f"parent_{lib}_{'bf16' if wd == torch.bfloat16 else 'f32'}",
                     "base_ms": base_ms, "parent_ms": parent_ms,
                     "bit_for_bit": bool(torch.equal(got, want)),
                     "registers": _harness.registers(lib),
                     "parent_registers": libs[lib][1]})
        compare_parent_chain(tree, libs["probe_chain"], log, dev, reps)
        compare_parent_bign(tree, libs["probe_bign"], log, dev, reps)


def parent_chain(tree: str, lib):
    """The parent's build ``lib`` of the chain probe as a function (x, w, b,
    mode, dual, img) -> out: through this checkout's ``probe_mxu.chain``
    where the parent's takes the staged image too (its ``probe_mxu``
    defines ``stage_chain``), else through the C interface from before the
    image, which takes the packed weights."""
    from . import probe_mxu as PM
    if _harness.parent_defines(tree, "exp/probe_mxu", "stage_chain"):
        def run(x, w, b, mode, dual, img):
            with _harness.loading(lib):
                return PM.chain(x, w, b, mode, dual, staged=img)
        return run
    from ..kernels.r2l_fused import _ptr, _raise_on_error
    from ..kernels.r2l_train import _stream

    def run(x, w, b, mode, dual, img):
        out = torch.empty_like(x)
        _raise_on_error(lib.probe_chain_launch(
            _ptr(x), x.shape[0], _ptr(w), _ptr(b), _ptr(out), w.shape[0],
            PM.MODES[mode], int(dual), _stream(x.device)),
            "the parent's probe_chain")
        return out
    return run


def compare_parent_chain(tree: str, lib, log, dev, reps: int = 5) -> None:
    """The chain probe of this checkout against the parent's build ``lib``
    (CDLL, register lines) at its runner's size (163,840 rays, 86 layers,
    the weights staged once), in each mode single and dual
    (``_harness.parent_probe``)."""
    from . import probe_mxu as PM
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((PM.N_RAYS, PM.W), generator=gen).to(dev)
    w, b = PM.variant_weights("full", gen, dev)
    img = PM.stage_chain(w)
    old = parent_chain(tree, lib[0])
    for mode in PM.MODES:
        for dual in (False, True):
            _harness.parent_probe(
                f"probe_chain_{mode}{'_dual' if dual else ''}",
                "probe_chain",
                lambda: PM.chain(x, w, b, mode, dual, staged=img),
                lambda: old(x, w, b, mode, dual, img), lib[1], False, log,
                reps)


def parent_bign(tree: str, lib):
    """The parent's build ``lib`` of bigN as a function (x, w1, w2, img) ->
    out: through this checkout's ``probe_mxu.bign`` where the parent's
    takes the staged image too (its ``probe_mxu`` defines ``stage_bign``),
    else through the C interface from before the image, which takes the
    packed w1 and w2."""
    from . import probe_mxu as PM
    if _harness.parent_defines(tree, "exp/probe_mxu", "stage_bign"):
        def run(x, w1, w2, img):
            with _harness.loading(lib):
                return PM.bign(x, w1, w2, staged=img)
        return run
    import ctypes
    from ..kernels.r2l_fused import _ptr, _raise_on_error
    from ..kernels.r2l_train import _stream
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_bign_launch.argtypes = [P, I, P, P, P, I, P]

    def run(x, w1, w2, img):
        out = torch.empty_like(x)
        _raise_on_error(lib.probe_bign_launch(
            _ptr(x), x.shape[0], _ptr(w1), _ptr(w2), _ptr(out), w1.shape[0],
            _stream(x.device)), "the parent's probe_bign")
        return out
    return run


def compare_parent_bign(tree: str, lib, log, dev, reps: int = 5) -> None:
    """bigN of this checkout against the parent's build ``lib`` (CDLL,
    register lines) at its runner's size (163,840 rays, 43 pairs, the
    weights staged once) (``_harness.parent_probe``)."""
    from . import probe_mxu as PM
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((PM.N_RAYS, PM.W), generator=gen).to(dev)
    w1, w2 = PM.variant_weights("bigN", gen, dev)
    img = PM.stage_bign(w1, w2)
    old = parent_bign(tree, lib[0])
    _harness.parent_probe(
        "probe_bign", "probe_bign",
        lambda: PM.bign(x, w1, w2, staged=img),
        lambda: old(x, w1, w2, img), lib[1], False, log, reps)


def main(argv=None) -> None:
    _harness.variants_main("chain_variants", __doc__, VARIANTS,
                           time_variants, argv, compare_parent)


if __name__ == "__main__":
    main()
