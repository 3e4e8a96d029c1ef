"""K2's, K4/K8's and K5's design alternatives, measured on the card: variant
copies of their Hopper sources (``kernels/csrc/r2l_int8_hopper.cuh``,
``r2l_bwd_hopper.cuh``) timed against the kernels as built.

A variant is a copy of ``kernels/csrc`` with a few source edits
(``VARIANTS``), built with the repository's nvcc flags and swapped in for
the kernel's library. K2's are timed on one 400x400 lego frame of the
canonical student (random weights, seed 0, the deployed int8 form); K5's
on one 4-block call (the top group) at a distillation step's 81,920 rays on
the bf16 stash of the canonical student and on its int8 stash, and the f32
weights' own variants (``F32_ONLY``) on its f32 stash and on K8's bf16 one;
each in turns base / variant / variant / base, CUDA events over 5 launches
after one. A variant that keeps the function is held to the base's output
(K2: bit for bit; K5: dh bit for bit, dW and db norm-relative); the
timing-only ones, whose outputs are wrong by design, are not:

* ``k2_cvt``: K2's epilogue with the conversion instructions (int32 to
  f32, round, f32 to int) in place of the two-add forms;
* ``k2_tailf32``: the block tail's residual add in f32 and a rounding, not
  one bf16 add (the same value);
* ``k2_noepi``: without the inner layers' epilogues (timing only);
* ``k2_nope``: without the head's positional encoding (timing only);
* ``k2_nomma``: without them and the products (timing only);
* ``k5_dbpass1``: db as column sums in pass 1 (shuffles and a
  shared-memory pass), not as a product against ones in pass 2 (with the
  mask from device memory: compare ``k5_maskdirect``);
* ``k5_f32regs``: pass 1 with f32 weights storing dt from each thread's
  registers, not from the whole shared-memory tile;
* ``k5_maskdirect``: pass 1 reading the stash's mask rows from device
  memory, not prefetched into shared memory;
* ``k5_nopark``: pass 1 without parking dh in device memory between a
  block's two products (timing only);
* ``k5_nomask``: pass 1 without reading the stash for the ReLU mask
  (timing only);
* ``k5_nodts``: pass 1 with bf16 weights without writing the dt scratch
  (timing only);
* ``k48_nostash``: K4 and K8 without their stash stores (timing only);
* ``k48_lockstep``: K4's and K8's two consumer warpgroups starting each
  layer together, not half a layer apart (K2's lockstep is the stream
  probe's S = 1, ``probe_pipe_lib``);
* ``k4_regstash``: K4's stash rows stored from the epilogues' registers
  (each thread's column pairs, two bytes), not by bulk stores from Q;
* ``k8_quadstash``: K8's stash rows stored 16 bytes a thread after a
  transpose within the quad, not as each thread's 4-byte column pairs;
* ``k4_ks128``: K4 at W256 with K2's 128-channel stages in a ring of two
  32 KB slots, not four 16 KB slots of 64 channels (its image staged to
  match).

K4/K8's (``k48_*``, ``k4_*``) are timed at a distillation step's 81,920
rays (``chip_smoke.train_points``, the step's calibration points), each
held bit for bit to the base where it keeps the function.

The int8 chain probe's (``chain8_*``, library ``probe_int8_chain``: the
static chain of ``probe_mxu.int8_chain`` and the wall's three modes) are
timed at the runners' size (163,840 rays, 86 layers, each case's image
staged once), each held bit for bit to the base:

* ``chain8_sched``: every mode on the other schedule (the warpgroups in
  lockstep where the build runs them half a layer apart, and the other way
  round);
* ``chain8_slots4``: K2's four ring slots in place of six;
* ``chain8_mincastepi``: the static chain with mincast's epilogue (a shift
  and a byte, no dequantize or quantize; timing only).

``--parent TREE`` builds K2 from a parent checkout's sources and holds this
checkout's to it on a frame in its three forms, bit for bit, in turns, with
both builds' registers; then the ResMLP body probe (``probe_int8.resmlp``,
its int8 bodies on K2's chain and its bf16 control on K1's) likewise at its
runner's size, each body single and dual (``compare_parent_resmlp``), and
the int8 chain probe, static and the wall's three modes
(``compare_parent_int8_chain``).

``--steps TREE ...`` times instead the five distillation kinds of
``chip_smoke.py``'s phase 6 (``xla``, ``fused``, ``fused_int8``,
``fused_int8_bf16stash``, and ``fused_f32``) in each checkout given, as
``chain_variants`` does (``_harness.time_steps``).

    python -m r2l_tpu_torch.exp.int8_bwd_variants [--variants k2_cvt,...] \\
        [--out PATH]
    python -m r2l_tpu_torch.exp.int8_bwd_variants --steps PARENT . . PARENT

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from . import _harness

K2 = "r2l_int8_hopper.cuh"
CHAIN8 = "probe_int8_chain.cu"
K5 = "r2l_bwd_hopper.cuh"
RING = "hopper_ring.cuh"

I2F_ADDS = "  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.f);"
Q8_ADDS = """  return __float_as_int(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f),
                                  12582912.f));"""
LOCKSTEP = "  constexpr bool kLockstep = kEpi == kStreams1;"
INNER_STORE = "            putq(r, c, x0, x1);"
PE_STORE = "      put(r, p * ns + sl, q);"
TAIL_ADD = ("            hn = __hadd2(__floats2bfloat162_rn(t0, t1), "
            "hs[at(h, c)]);")
# the block tail's add in f32, then rounded to bf16
TAIL_ADD_F32 = """            const float2 tv =
                __bfloat1622float2(__floats2bfloat162_rn(t0, t1));
            const float2 hv = __bfloat1622float2(hs[at(h, c)]);
            hn = __floats2bfloat162_rn(__fadd_rn(tv.x, hv.x),
                                       __fadd_rn(tv.y, hv.y));"""
MMA_S8 = "        Wgmma<N>::s8(d, da, db, st > 0 || j > 0 || accumulate);"
PARK = """    // park dh, then dt2 = (dh * res_scale).cast(cd)
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = row0 + r0 + 8 * h;
        if (g < a.n)"""
RELOAD = """          d = *reinterpret_cast<const float2*>(a.dh_out + (size_t)g * W +
                                               8 * j + 2 * t);"""
MASK = "        live = stash2(p, sc ? sc + c : nullptr);"
DT_REGS = "        if (!P::kStoreTile && g < a.n)"
STORE_TILE = "  static constexpr bool kStoreTile = sizeof(T) == 4;"
PREFETCH = "  static constexpr bool kPrefetch = sizeof(T) == 2;"
KDB = "  static constexpr bool kDb = sizeof(T) == 4;"
F32_ONLY = ("k5_f32regs",)   # variants of f32 weights' code
STASH_Q = ("        *static_cast<uint16_t*>(p) = (uint16_t)__byte_perm(x0, "
           "x1, 0x0040);")
STASH_B = """      if (void* p = stash_at(row, r0 + 8 * h, 8 * j + 2 * (lane % 4)))
        *static_cast<__nv_bfloat162*>(p) = v;"""
# K8's pairs of four column groups traded within the quad, 16 bytes a lane
STASH_B_QUAD = """      const int tq = lane % 4;
      sb[h][j % 4] = *reinterpret_cast<const uint32_t*>(&v);
      if (j % 4 != 3) return;
      quad_transpose(sb[h], tq);
      if (void* p = stash_at(row, r0 + 8 * h, 8 * (j - 3 + tq)))
        *static_cast<uint4*>(p) =
            make_uint4(sb[h][0], sb[h][1], sb[h][2], sb[h][3]);"""
STASHB_DECL = ("  auto stashb = [&](int row, int j, int h, __nv_bfloat162 v) {")
K4_STAGE = "      W >= 128 && !(W == 256 && kEpi == kTrainQ) ? 128 : 64;"
K4_BULK = "      if (pend_row >= 0 && wtid == 0) {"
K4_FREE = """      if (wtid == 0) bulk_wait_read<0>();
      wg_bar(bar_id);"""
K4_HEAD_Q = """        const int2 q = q8_in<kEpi>(hv, inv);
        putq(r0 + 8 * h, c, q.x, q.y);"""
K4_INNER_Q = "            putq(r, c, x0, x1);"
K4_TAIL_Q = """            const int2 q = q8_in<kEpi>(block_out(j, h, c, p), iv);
            putq(r0 + 8 * h, c, q.x, q.y);"""
# K4's stash rows from the registers, as K8's
K4_REG_STASH = [
    (K2, K4_BULK, "      if (false) {"), (K2, K4_FREE, ""),
    (K2, K4_HEAD_Q, """        const int2 q = q8_in<kEpi>(hv, inv);
        putq(r0 + 8 * h, c, q.x, q.y);
        stashq(0, r0 + 8 * h, c, q.x, q.y);"""),
    (K2, K4_INNER_Q, K4_INNER_Q + "\n            stashq(a.nb + 1 + blk, r, c, "
                                  "x0, x1);"),
    (K2, K4_TAIL_Q, """            const int2 q = q8_in<kEpi>(block_out(j, h, c, p), iv);
            putq(r0 + 8 * h, c, q.x, q.y);
            stashq(blk + 1, r0 + 8 * h, c, q.x, q.y);""")]
K4_SLOTS = "  static constexpr int kStages = 4, kParts = 1;"
# the int8 chain's schedule of each mode (static, mxu_only, mincast) and
# its ring, as built
SCHED = "constexpr bool kPingPong[3] = {true, false, true};"
CHAIN8_SLOTS = "kWGs = 2, kStages = 6;"
CHAIN8_STATIC = "          if (kMode == kStatic) {"

# name: ([(file, text, replacement)], kernel ("k2" or "k5"), checked output)
VARIANTS = {
    "k2_cvt": ([(K2, I2F_ADDS, "  return __int2float_rn(acc);"),
                (K2, Q8_ADDS, "  return (int)r2l::q8(y);")], "k2", True),
    "k2_tailf32": ([(K2, TAIL_ADD, TAIL_ADD_F32)], "k2", True),
    "k2_noepi": ([(K2, INNER_STORE, "")], "k2", False),
    "k2_nope": ([(K2, PE_STORE, "      (void)q;")], "k2", False),
    "k2_nomma": ([(K2, INNER_STORE, ""), (RING, MMA_S8, "        {}")], "k2",
                 False),
    # with the mask read from device memory: the column sums' buffer and
    # the prefetched rows do not fit together (compare k5_maskdirect)
    "k5_dbpass1": ([(K5, KDB, KDB.replace("sizeof(T) == 4", "true")),
                    (K5, PREFETCH, PREFETCH.replace("sizeof(T) == 2",
                                                    "false")),
                    (K5, "  if (lane % 4 == 0) {  // every column of the "
                         "ones product is db",
                     "  if (false) {"),
                    (K5, "sizeof(T) == 4 ? ntiles : splits", "ntiles")],
                   "k5", True),
    "k5_nopark": ([(K5, PARK, PARK.replace("if (g < a.n)", "if (false)")),
                   (K5, RELOAD, "          d = make_float2(0.f, 0.f);")],
                  "k5", False),
    "k5_f32regs": ([(K5, STORE_TILE, STORE_TILE.replace("sizeof(T) == 4",
                                                         "false"))],
                   "k5", True),
    "k5_maskdirect": ([(K5, PREFETCH, PREFETCH.replace("sizeof(T) == 2",
                                                       "false"))], "k5",
                      True),
    "k5_nomask": ([(K5, MASK, "        live = make_float2(1.f, 1.f);")],
                  "k5", False),
    "k5_nodts": ([(K5, DT_REGS, "        if (false)")], "k5", False),
    "k48_nostash": ([(K2, STASH_Q, "        (void)p;"),
                     (K2, STASH_B, ""),
                     (K2, K4_BULK, "      if (false) {")], "k48", False),
    "k4_regstash": (K4_REG_STASH, "k48", True),
    "k48_lockstep": ([(K2, LOCKSTEP, LOCKSTEP.replace(
        "kEpi == kStreams1", "true"))], "k48", True),
    "k8_quadstash": ([(K2, STASH_B, STASH_B_QUAD),
                      (K2, STASHB_DECL,
                       "  uint32_t sb[2][4];\n" + STASHB_DECL)], "k48", True),
    "k4_ks128": ([(K2, K4_STAGE, "      W >= 128 ? 128 : 64;"),
                  (K2, K4_SLOTS, "  static constexpr int kStages = "
                                 "kEpi == kTrainQ && W == 256 ? 2 : 4;\n"
                                 "  static constexpr int kParts = 1;")],
                 "k48", True),
    "chain8_sched": ([(CHAIN8, SCHED, SCHED.replace(
        "true, false, true", "false, true, false"))], "chain8", True),
    "chain8_slots4": ([(CHAIN8, CHAIN8_SLOTS, CHAIN8_SLOTS.replace(
        "kStages = 6", "kStages = 4"))], "chain8", True),
    "chain8_mincastepi": ([(CHAIN8, CHAIN8_STATIC, "          if (false) {")],
                          "chain8", False),
}
LIBS = {"k2": "r2l_int8_hopper", "k5": "r2l_bwd_group",
        "k48": "r2l_train_fwd_int8", "chain8": "probe_int8_chain"}
# a variant's K4 image stage width where it differs from the build's
STAGE_K = {"k4_ks128": 128}


def k2_case(dev):
    """(run, the base output) of K2's deployed form on a lego frame."""
    from ..evaluate import _calibration_points
    from ..kernels import r2l_fused as F
    from ..models.r2l import R2LConfig, init_r2l
    sampler, poses = _harness.lego_frames(16, dev)
    pts = sampler.sample_test(poses[3])
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, _calibration_points(
        sampler, poses.cpu().numpy(), dev))
    return [("frame", lambda: F.fused_r2l_apply_int8_pe(fp, cfg, pts, 48,
                                                       10))]


def k5_cases(dev):
    """[(name, run)] of K5's top 4-block group at 81,920 rays, on the bf16
    stash (K3's) and the int8 stash (K4's) of the canonical student, and
    under f32 weights on the f32 stash (K3 f32's) and K8's bf16 one."""
    from ..kernels import r2l_fused as F
    from ..kernels import r2l_train as T
    from ..models.r2l import R2LConfig, init_r2l
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    g = torch.Generator(dev).manual_seed(1)
    n, nb, W = 81920, cfg.num_blocks, cfg.netwidth
    pts = torch.rand((n, 48), generator=g, device=dev) * 2 - 1
    fp = F.prepare_fused_params_pe(model, cfg, 48, 10)
    _, stash = T.train_fwd(fp, cfg, pts, 48, 10)
    fp8 = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, pts[::64],
                                  fold_requant=False, stage=False)
    _, stash8 = T.train_fwd_int8(F.stage_int8_train(fp8, cfg, 48, 10, True),
                                 cfg, pts, 48, 10, stash_q=True)
    dh = torch.randn((n, W), generator=g, device=dev)
    img = T.stage_bwd_weights(fp.body_w)
    fp32 = F.prepare_fused_params_pe(model, cfg, 48, 10,
                                     weight_dtype=torch.float32)
    _, stash32 = T.train_fwd(fp32, cfg, pts, 48, 10)
    img32 = T.stage_bwd_weights(fp32.body_w)
    _, stash8b = T.train_fwd_int8(F.stage_int8_train(fp8, cfg, 48, 10,
                                                     False),
                                  cfg, pts, 48, 10, stash_q=False)
    return [(kind, lambda w=w, st=st, sc=sc, im=im: T.bwd_group(
        w, st, dh, cfg, nb - 4, 4, body_scale=sc, staged=im))
            for kind, w, st, sc, im in (
                ("bf16", fp.body_w, stash, None, img),
                ("int8", fp.body_w, stash8, 1.0 / fp8.body_inv, img),
                ("f32", fp32.body_w, stash32, None, img32),
                ("f32_bf16stash", fp32.body_w, stash8b, None, img32))]


def k48_cases(dev):
    """[(name, run(fp), fp, stash_q)] of K4 and K8 at a step's 81,920 rays
    (``chip_smoke.train_points``) of the canonical student, calibrated on
    the step's calibration points."""
    import chip_smoke as cs
    from ..kernels import r2l_fused as F
    from ..kernels import r2l_train as T
    from ..models.r2l import R2LConfig, init_r2l
    from ..sampler import PointSampler
    from ..train import fused_int8_calib_points
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(cs.SEED), dev)
    sampler = PointSampler(H=cs.H, W=cs.W, focal=cs.FOCAL,
                           n_sample=cs.N_SAMPLE, near=2.0, far=6.0)
    pts = cs.train_points(cfg, sampler, dev)
    calib = fused_int8_calib_points(cs.H, cs.W, cs.FOCAL, cs.N_SAMPLE, 2.0,
                                    6.0, cs.lego_poses(cs.K), dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, calib,
                                 fold_requant=False, stage=False)
    return [(kind, lambda f, q=q: T.train_fwd_int8(f, cfg, pts, 48, 10,
                                                   stash_q=q),
             fp, q, cfg) for kind, q in (("k4", True), ("k8", False))]


def chain8_cases(dev):
    """[(name, run)] of the int8 chain probe at the runners' size: the
    static chain (``probe_mxu.int8_chain`` on ``make_int8``'s weights) and
    the wall's three modes (``probe_wall.make_weights``), each on its image
    staged once."""
    from . import probe_mxu as PM
    from . import probe_wall as PW
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((PM.N_RAYS, PM.W), generator=gen).to(dev)
    wq, s = PM.variant_weights("int8_static", gen, dev)
    img = PM.stage_int8_chain(wq, s)
    w, m = PW.make_weights(gen, device=dev)
    wimg = PM.stage_int8_chain(w, m)
    return [("static", lambda: PM.int8_chain(x, wq, s, staged=img))] + [
        (mode, lambda mode=mode: PW.wall(x, w, m, mode, staged=wimg))
        for mode in ("mxu_only", "mincast", "realistic")]


def agree(kernel: str, got, want) -> float:
    """K2: the largest difference; the int8 chain: 0 bit for bit, else inf;
    K4/K8: the largest rgb difference, or inf where a stash byte differs;
    K5: 0 for dh bit for bit (else inf), then the worst norm-relative
    difference of dW and db."""
    if kernel == "k2":
        return float((got - want).abs().max())
    if kernel == "chain8":
        return 0.0 if torch.equal(got, want) else float("inf")
    if kernel == "k48":
        if not torch.equal(got[1].view(torch.uint8),
                           want[1].view(torch.uint8)):
            return float("inf")
        return float((got[0] - want[0]).abs().max())
    if not torch.equal(got[0], want[0]):
        return float("inf")
    return max(float((a.double() - b.double()).norm() / b.double().norm())
               for a, b in zip(got[1:], want[1:]))


def time_variants(names, log, reps: int = 5) -> None:
    from ..kernels import _build
    dev = _harness.require_cuda("int8_bwd_variants")
    log(_harness.device_record())
    with tempfile.TemporaryDirectory() as tmp:
        libs = _harness.build_variants(
            {n: (VARIANTS[n][0], LIBS[VARIANTS[n][1]]) for n in names},
            Path(tmp))
        k48 = [n for n in names if VARIANTS[n][1] == "k48"]
        if k48:
            time_k48(k48, libs, log, dev, reps)
        cases = {"k2": k2_case, "k5": k5_cases, "chain8": chain8_cases}
        for kernel, make_cases in cases.items():
            mine = [n for n in names if VARIANTS[n][1] == kernel]
            if not mine:
                continue
            _build.load(LIBS[kernel])
            for case, run in make_cases(dev):
                want = run()
                for name in mine:
                    if case.startswith("f32") != (name in F32_ONLY):
                        continue  # f32 weights: their own variants only
                    base_ms, variant_ms, got = _harness.in_turns(
                        run, run, lambda lib=libs[name][0]:
                        _harness.loading(lib), reps)
                    log({"name": f"{name}_{case}", "base_ms": base_ms,
                         "variant_ms": variant_ms,
                         "diff": agree(kernel, got, want)
                         if VARIANTS[name][2] else None,
                         "build": libs[name][1][:24]})
                    del got
                del want
            torch.cuda.empty_cache()


def time_k48(names, libs, log, dev, reps: int = 5) -> None:
    """K4/K8's variants, each case's image staged at the variant's stage
    width (``STAGE_K``) on its side."""
    from ..kernels import _build
    from ..kernels import r2l_fused as F
    _build.load("r2l_train_fwd_int8")
    for case, run, fp, q, cfg in k48_cases(dev):
        base_fp = F.stage_int8_train(fp, cfg, 48, 10, q)
        want = run(base_fp)
        for name in names:
            if name.startswith("k4_") and not q or \
                    name.startswith("k8_") and q:
                continue
            keep = F.int8_train_stage_k
            if name in STAGE_K:
                F.int8_train_stage_k = lambda W, sq, k=STAGE_K[name]: k
            try:
                var_fp = F.stage_int8_train(fp, cfg, 48, 10, q)
            finally:
                F.int8_train_stage_k = keep
            base_ms, variant_ms, got = _harness.in_turns(
                lambda: run(base_fp), lambda: run(var_fp),
                lambda lib=libs[name][0]: _harness.loading(lib), reps)
            log({"name": f"{name}_{case}", "base_ms": base_ms,
                 "variant_ms": variant_ms,
                 "diff": agree("k48", got, want)
                 if VARIANTS[name][2] else None,
                 "build": libs[name][1][:24]})
            del got
        del want
        torch.cuda.empty_cache()


def compare_parent(tree: str, log, reps: int = 5) -> None:
    """K2 of this checkout against the parent's build on a lego frame, in
    its three forms: bit for bit, in turns, with both builds'
    registers; then the ResMLP body probe and the int8 chain probe
    (``compare_parent_resmlp``, ``compare_parent_int8_chain``)."""
    from ..evaluate import _calibration_points
    from ..kernels import r2l_fused as F
    from ..models.r2l import R2LConfig, init_r2l
    dev = _harness.require_cuda("int8_bwd_variants")
    log(_harness.device_record())
    sampler, poses = _harness.lego_frames(16, dev)
    pts = sampler.sample_test(poses[3])
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), dev)
    calib = _calibration_points(sampler, poses.cpu().numpy(), dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _harness.parent_libs(tree, ("r2l_int8_hopper",
                                           "probe_resmlp",
                                           "probe_int8_chain"), Path(tmp))
        lib = libs["r2l_int8_hopper"]
        for form, fold, nob in (("deployed", True, True),
                                ("fold", True, False),
                                ("unfolded", False, False)):
            fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, calib,
                                         fold_requant=fold)

            def run(fp=fp, fold=fold, nob=nob):
                return F.fused_r2l_apply_int8_pe(fp, cfg, pts, 48, 10, fold,
                                                 nob)
            want = run()
            base_ms, parent_ms, got = _harness.in_turns(
                run, run, lambda: _harness.loading(lib[0]), reps)
            log({"name": f"parent_r2l_int8_hopper_{form}",
                 "base_ms": base_ms, "parent_ms": parent_ms,
                 "bit_for_bit": bool(torch.equal(got, want)),
                 "registers": _harness.registers("r2l_int8_hopper"),
                 "parent_registers": lib[1]})
        compare_parent_resmlp(tree, libs["probe_resmlp"], log, dev, reps)
        compare_parent_int8_chain(tree, libs["probe_int8_chain"], log, dev,
                                  reps)


def parent_resmlp(tree: str, lib):
    """The parent's build ``lib`` of the ResMLP body probe as a function
    (x, w, m, b, body, dual, img) -> out: through this checkout's
    ``probe_int8.resmlp`` where the parent's takes the staged image too
    (its ``probe_int8`` defines ``stage_resmlp``), else through the C
    interface from before the image, which takes the packed w, m and b."""
    from . import probe_int8 as PI
    if _harness.parent_defines(tree, "exp/probe_int8", "stage_resmlp"):
        def run(x, w, m, b, body, dual, img):
            with _harness.loading(lib):
                return PI.resmlp(x, w, m, b, body, dual, staged=img)
        return run
    from ..kernels.r2l_fused import _ptr, _raise_on_error
    from ..kernels.r2l_train import _stream

    def run(x, w, m, b, body, dual, img):
        out = torch.empty_like(x)
        _raise_on_error(lib.probe_resmlp_launch(
            _ptr(x), x.shape[0], _ptr(w), None if m is None else _ptr(m),
            _ptr(b), PI.INV_A, PI.RS, _ptr(out), w.shape[0] // 2,
            PI.BODIES[body], int(dual), _stream(x.device)),
            "the parent's probe_resmlp")
        return out
    return run


def compare_parent_resmlp(tree: str, lib, log, dev, reps: int = 5) -> None:
    """The ResMLP body probe of this checkout against the parent's build
    ``lib`` (CDLL, register lines) at its runner's size (163,840 rays, 43
    blocks, the weights staged once), each body single and dual, the int8
    bodies bit for bit (``_harness.parent_probe``)."""
    from . import probe_int8 as PI
    x = torch.randn((PI.N_RAYS, PI.W),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    old = parent_resmlp(tree, lib[0])
    for name in ("int8_resmlp", "int8_resmlp_fold", "bf16_resmlp"):
        body = PI.variant_body(name)[0]
        w, m, b = PI.variant_weights(name, dev)
        img = PI.stage_resmlp(w, m, b, body)
        for dual in (False, True):
            _harness.parent_probe(
                f"probe_resmlp_{body}{'_dual' if dual else ''}",
                "probe_resmlp",
                lambda: PI.resmlp(x, w, m, b, body, dual, staged=img),
                lambda: old(x, w, m, b, body, dual, img), lib[1],
                body != "bf16", log, reps)
        del w, m, b, img


def parent_int8_chain(tree: str, lib):
    """The parent's build ``lib`` of the int8 chain probe as a function (x,
    wq, s, inv, mode, img) -> out: through this checkout's launcher where
    the parent's takes the staged image too (its ``probe_mxu`` defines
    ``stage_int8_chain``), else through the C interface from before the
    image, which takes the packed wq (the same argument types)."""
    from . import probe_mxu as PM
    from ..kernels.r2l_fused import _ptr, _raise_on_error
    from ..kernels.r2l_train import _stream
    if _harness.parent_defines(tree, "exp/probe_mxu", "stage_int8_chain"):
        def run(x, wq, s, inv, mode, img):
            with _harness.loading(lib):
                return PM.launch_int8_chain(x, wq, s, img, inv, mode,
                                            PM.int8_chain)
        return run

    def run(x, wq, s, inv, mode, img):
        out = torch.empty_like(x)
        _raise_on_error(lib.probe_int8_chain_launch(
            _ptr(x), x.shape[0], _ptr(wq), _ptr(s), float(inv), _ptr(out),
            wq.shape[0], mode, _stream(x.device)),
            "the parent's probe_int8_chain")
        return out
    return run


def compare_parent_int8_chain(tree: str, lib, log, dev,
                              reps: int = 5) -> None:
    """The int8 chain probe of this checkout against the parent's build
    ``lib`` (CDLL, register lines) at the runners' size (163,840 rays, 86
    layers, each image staged once): the static chain and the wall's three
    modes, bit for bit (``_harness.parent_probe``). The static chains decay
    to 0 by 86 layers, so they are also held at a depth where they do not
    (8 layers static, 4 realistic)."""
    from . import probe_mxu as PM
    from . import probe_wall as PW
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((PM.N_RAYS, PM.W), generator=gen).to(dev)
    old = parent_int8_chain(tree, lib[0])
    wq, s = PM.variant_weights("int8_static", gen, dev)
    w, m = PW.make_weights(gen, device=dev)
    cases = [("static_8", (wq[:8], s[:8]), 1.0 / PM.A_SCALE, 0),
             ("static", (wq, s), 1.0 / PM.A_SCALE, 0),
             ("wall_realistic_4", (w[:4], m[:4]), PW.INV, 0)]
    cases += [(f"wall_{k}", (w, m), PW.INV, v) for k, v in PW.MODES.items()]
    for name, ws, inv, mode in cases:
        img = PM.stage_int8_chain(*ws)
        _harness.parent_probe(
            f"probe_int8_chain_{name}", "probe_int8_chain",
            lambda: PM.launch_int8_chain(x, *ws, img, inv, mode,
                                         PM.int8_chain),
            lambda: old(x, *ws, inv, mode, img), lib[1], True, log, reps)


def main(argv=None) -> None:
    _harness.variants_main("int8_bwd_variants", __doc__, VARIANTS,
                           time_variants, argv, compare_parent)


if __name__ == "__main__":
    main()
