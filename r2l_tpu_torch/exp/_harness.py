"""The probes' shared protocols (the ports of ``exp/probe_mxu.py``'s
``time_variant`` and ``log``, and of the frame loops of
``exp/probe_pipe.py``'s ``bench`` and ``exp/probe_epi.py``'s ``main``).

A body variant is timed as K_REPS frames back to back, each on an input
varied per frame (``rep_scales``, as JAX scales the input by ``linspace(1,
1.0001, 8)``), their scalar checksums summed; one call warms up (and builds
the kernel), then the min of 3 calls timed with CUDA events, divided by
K_REPS. A frame variant (``time_frames``) renders K lego frames per call,
each ``sample_test`` of a pose then the variant and the frame's sum, one
call to warm up, then the min of N calls. Rates and bounds are held against
the H100's data-sheet peaks (dense, at 700 W), not the TPU's. Records are
JSON lines on stdout and, with an ``out`` path, appended there.

The design-run tools (``chain_variants.py`` for K1, ``int8_bwd_variants.py``
for K2 and K5) share the rest: a variant is a copy of ``kernels/csrc`` with
a few source edits (``edited_sources``), built with the repository's nvcc
flags (``build_variants``) and swapped in for its kernel's library
(``loading``), timed against the build in turns base / variant / variant /
base (``in_turns``); ``--steps TREE ...`` times instead the four
distillation kinds of ``chip_smoke.py``'s phase 6, and ``fused`` at the
CLI's default f32, in each checkout given (``time_steps``). ``variants_main`` is their command line.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..rays import pose_spherical
from ..sampler import PointSampler

K_REPS = 8
LEGO_HW, LEGO_FOCAL = 400, 555.5555155968841   # the frame drivers' camera
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit (f32:
# 67 T/s is the FMA units'; tf32, the tensor cores' TF32 rate, bounds K6
# f32's 3xTF32 products).
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}


def require_cuda(prog: str) -> torch.device:
    """The card, or exit non-zero: a probe measures only on a GPU."""
    if not torch.cuda.is_available():
        print(f"{prog}: torch.cuda.is_available() is false; the probes "
              "measure only on an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 plain matmuls
    return torch.device("cuda", 0)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def device_record() -> dict:
    return {"name": "device", "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi()}


class Log:
    """Print each record as a JSON line and append it to ``out`` if
    given."""

    def __init__(self, out: str | None = None):
        self.out = out

    def __call__(self, rec: dict) -> dict:
        rec["ts"] = time.time()
        line = json.dumps(rec)
        print(line, flush=True)
        if self.out:
            with open(self.out, "a") as f:
                f.write(line + "\n")
        return rec


def bound_ms(ops: float, kind: str) -> float:
    """The least ms ``ops`` operations take at the data-sheet peak of
    ``kind`` (every probe here is bound by operations, not bytes)."""
    return ops / PEAK_OPS[kind] * 1e3


def chain_ops(cfg, n_rays: int, in_dim: int) -> float:
    """Multiply-adds x 2 of the R2L chain (head, body, tail) for n_rays."""
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    return 2.0 * n_rays * (in_dim * W + nbl * W * W + W * cfg.output_dim)


def rep_scales(device) -> torch.Tensor:
    """The per-frame input scales: JAX's ``linspace(1.0, 1.0001, K_REPS)``
    in f32."""
    return torch.linspace(1.0, 1.0001, K_REPS, dtype=torch.float32,
                          device=device)


def time_variant(name: str, rep: Callable[[int], torch.Tensor], log: Log,
                 ops_per_frame: float | None = None, peak: str = "bf16",
                 extra: dict | None = None) -> dict:
    """Time ``rep(i)`` (frame i's scalar checksum) over K_REPS frames:
    ms per frame (min of 3 calls after a warm-up, CUDA events), the
    checksum, and with ``ops_per_frame`` the rate and its share of the
    ``peak`` kind's data-sheet rate."""
    t, out = time_calls(
        lambda: torch.stack([rep(i) for i in range(K_REPS)]).sum(), 3,
        K_REPS)
    rec = rate({"name": name, "ms_per_frame": t["ms"],
                "warmup_s": t["warmup_s"], "checksum": float(out)},
               ops_per_frame, peak, t["ms"])
    rec.update(extra or {})
    return log(rec)


def time_frames(key: str, name: str, net: Callable[[torch.Tensor],
                                                    torch.Tensor],
                sampler, poses: torch.Tensor, log: Log, reps: int,
                ops_per_frame: float, peak: str = "int8",
                extra: dict | None = None) -> dict:
    """Time ``net`` (sample points -> rgb) over the K frames of ``poses``
    [K, 3, 4] (each ``sampler.sample_test`` of its pose, then ``net``, then
    the frame's sum; the checksum is their sum): one call to warm up, then
    ``reps`` calls with CUDA events; ms per frame from the fastest, and
    every call's. The record names the variant under ``key``."""
    def render_k() -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=poses.device)
        for c2w in poses:
            total += net(sampler.sample_test(c2w)).sum()
        return total

    t, out = time_calls(render_k, reps, poses.shape[0])
    rec = rate({key: name, "ms_per_frame": t["ms"], "fps": 1000.0 / t["ms"],
                "warmup_s": t["warmup_s"], "checksum": float(out),
                "all_ms": t["all_ms"]}, ops_per_frame, peak, t["ms"])
    rec.update(extra or {})
    return log(rec)


def lego_poses(k: int) -> np.ndarray:
    """k poses ``pose_spherical(theta, -30, 4)`` [k, 3, 4] f32, theta evenly
    over the circle from -180 (the frame drivers' cameras)."""
    return np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                     for t in np.linspace(-180, 180, k, endpoint=False)])


def lego_frames(k: int, device, hw: int = LEGO_HW,
                focal: float = LEGO_FOCAL):
    """The frame drivers' scene (``exp/probe_pipe.py``, ``exp/probe_epi.py``):
    the lego 400x400 ``PointSampler`` (16 samples, near 2, far 6; a test
    passes a smaller ``hw``) and ``lego_poses(k)`` as a [k, 3, 4] f32
    tensor on ``device``."""
    sampler = PointSampler(H=hw, W=hw, focal=focal, n_sample=16, near=2.0,
                           far=6.0)
    return sampler, torch.as_tensor(lego_poses(k), dtype=torch.float32,
                                    device=device)


def parse(argv, prog: str, doc: str, variants: tuple = (),
          **counts: int) -> argparse.Namespace:
    """A driver's command line: ``--out`` and one integer option per entry
    of ``counts`` (its default the JAX driver's value), such as ``--frames``
    or ``--steps``: a smaller value only cuts the work per call or the
    number of timed calls. With ``variants``, the names given as arguments
    (``args.variant``, all of them when none is given) pick which run. The
    namespace carries ``prog``."""
    ap = argparse.ArgumentParser(prog=prog, description=doc.splitlines()[0])
    if variants:
        ap.add_argument("variant", nargs="*",
                        help=f"of {', '.join(variants)} (default all)")
    for name, default in counts.items():
        ap.add_argument(f"--{name}", type=int, default=default,
                        help=f"default {default}")
    ap.add_argument("--out", help="also append the JSON records to this file")
    args = ap.parse_args(argv)
    args.prog = prog
    if variants:
        unknown = sorted(set(args.variant) - set(variants))
        if unknown:
            ap.error(f"unknown variants {unknown}")
        args.variant = list(args.variant or variants)
    return args


def time_calls(fn: Callable[[], object], reps: int, per: int = 1,
               warm: bool = True) -> tuple[dict, object]:
    """Time ``fn()`` (a call of ``per`` frames, steps or iterations, queued
    back to back): one call to warm up (and build) unless ``warm`` is
    False, then ``reps`` calls, each between two CUDA events with one
    synchronisation. -> ({"ms": the fastest call / per, "all_ms": every
    call's / per, "warmup_s"}, the first call's output)."""
    t0 = time.time()
    out = fn() if warm else None
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
        out = got if out is None else out
    return {"ms": min(times), "all_ms": sorted(times),
            "warmup_s": warmup_s}, out


def rate(rec: dict, ops: float | None, peak: str, ms: float) -> dict:
    """Add to ``rec`` the rate of ``ops`` operations in ``ms`` and its share
    of the data-sheet ``peak`` (``mfu_<peak>``, ``bound_ms``)."""
    if ops:
        rec["tflops"] = ops / ms / 1e9
        rec[f"mfu_{peak}"] = ops / (ms * 1e-3) / PEAK_OPS[peak]
        rec["bound_ms"] = bound_ms(ops, peak)
    return rec


def timed(name: str, fn: Callable[[], torch.Tensor], reps: int, per: int,
          log: Log, unit: str = "ms_per_frame", ops: float | None = None,
          peak: str = "int8", extra: dict | None = None) -> dict:
    """One record of ``time_calls(fn, reps, per)``: ``unit`` (ms per frame,
    step or iteration), every call's, the warm-up, the checksum (the first
    call's scalar output), frames/s for frames, and with ``ops`` (per
    frame) the rate and share of ``peak``."""
    t, out = time_calls(fn, reps, per)
    rec = {"name": name, unit: t["ms"], "all_ms": t["all_ms"],
           "warmup_s": t["warmup_s"]}
    if torch.is_tensor(out) and out.numel() == 1:
        rec["checksum"] = float(out)
    if unit == "ms_per_frame":
        rec["fps"] = 1000.0 / t["ms"]
    rate(rec, ops, peak, t["ms"])
    rec.update(extra or {})
    return log(rec)


def edited_sources(edits, csrc: Path, dst: Path) -> None:
    """Copy ``csrc`` to ``dst`` with ``edits`` [(file, text, replacement)]
    applied, each of whose texts must occur exactly once."""
    shutil.copytree(csrc, dst)
    for fname, text, repl in edits:
        src = (dst / fname).read_text()
        if src.count(text) != 1:
            raise ValueError(f"{fname} holds {src.count(text)} copies of "
                             f"{text[:60]!r}")
        (dst / fname).write_text(src.replace(text, repl))


def build_variants(jobs: dict, work: Path, csrc: Path | None = None) -> dict:
    """Build each variant's library in parallel, ``jobs`` mapping its name
    to (edits, the library's name in ``_build.KERNELS``), from ``csrc``
    (default: this checkout's ``kernels/csrc``): name -> (CDLL, the
    compiler's register and spill lines)."""
    from ..kernels import _build
    procs = {}
    for name, (edits, lib) in jobs.items():
        d = work / name
        edited_sources(edits, csrc or _build.CSRC, d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        entry, argtypes = _build.KERNELS[jobs[name][1]]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "Used" in ln or "spill" in ln])
    return out


@contextlib.contextmanager
def loading(lib):
    """Inside the block every kernel library loads as ``lib``."""
    from ..kernels import _build
    keep = _build.load
    _build.load = lambda _name: lib
    try:
        yield
    finally:
        _build.load = keep


def in_turns(base: Callable, variant: Callable, swap, reps: int = 5):
    """Time ``base`` and ``variant`` in turns base / variant / variant /
    base, each side one call then ``reps`` timed with CUDA events, the
    variant's inside ``swap()`` (a context manager): ([base ms, ...],
    [variant ms, ...], the variant's last output)."""
    ms = {"base": [], "variant": []}
    got = None
    for side in ("base", "variant", "variant", "base"):
        run = base if side == "base" else variant
        with swap() if side == "variant" else contextlib.nullcontext():
            out = run()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            s.record()
            for _ in range(reps):
                run()
            e.record()
            torch.cuda.synchronize()
        ms[side].append(s.elapsed_time(e) / reps)
        if side == "variant":
            got = out
    return ms["base"], ms["variant"], got


# The distillation steps in a checkout (argv[1]): its own code and
# chip_smoke.py constants, phase 6's data, warm-up and timed steps.
_STEPS = r"""
import dataclasses, os, sys, tempfile
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np, torch
import chip_smoke as cs
from r2l_tpu_torch.data import (RayBatchLoader, RayShardDataset,
                                write_ray_shards)
from r2l_tpu_torch.hardmine import parse_hard_ratio
from r2l_tpu_torch.models import R2LConfig, init_r2l
from r2l_tpu_torch.sampler import PointSampler
from r2l_tpu_torch.train import (DistillConfig, draw_step,
                                 fused_int8_calib_points, init_train_state,
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
calib = fused_int8_calib_points(cs.H, cs.W, cs.FOCAL, cs.N_SAMPLE, 2.0, 6.0,
                                cs.lego_poses(cs.K), dev)
int8 = {"fused_vjp": True, "fused_quantize": "int8", "fused_calib_pts": calib}
kinds = (("xla", {}), ("fused", {"fused_vjp": True}), ("fused_int8", int8),
         ("fused_int8_bf16stash", {**int8, "fused_stash_q": False}),
         ("fused_f32", {"fused_vjp": True}))
cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
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
for kind, kw in kinds:
    kcfg = cfg32 if kind == "fused_f32" else cfg
    model = init_r2l(kcfg, torch.Generator().manual_seed(cs.SEED), dev)
    state = init_train_state(model, dcfg, device=dev)
    step = make_distill_step(kcfg, dcfg, sampler, device=dev, **kw)
    for i in range(2):
        state, m = step(state, batches[i], draws=draws[i])
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(); s.record()
    for i in range(2, 2 + cs.TIMED_STEPS):
        state, m = step(state, batches[i], draws=draws[i])
    e.record(); torch.cuda.synchronize()
    print(f"{kind} {s.elapsed_time(e) / cs.TIMED_STEPS} "
          f"{float(m['loss'])}", flush=True)
    del state, step, model
    torch.cuda.empty_cache()
"""


def time_steps(trees, log: Log, prog: str) -> None:
    """Time the five distillation kinds in each checkout of ``trees``, in
    order, each in a process of its own with that checkout's code and
    constants: one record per kind and checkout."""
    require_cuda(prog)
    log(device_record())
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


def parent_libs(tree: str, names, work: Path) -> dict:
    """The libraries ``names`` built from the sources of the checkout
    ``tree`` (a parent's, unpacked with ``git archive``): name -> (CDLL,
    register and spill lines)."""
    return build_variants({n: ([], n) for n in names}, work,
                          Path(tree) / "r2l_tpu_torch" / "kernels" / "csrc")


def parent_defines(tree: str, module: str, name: str) -> bool:
    """Whether the checkout ``tree``'s ``r2l_tpu_torch/<module>.py``
    defines the function ``name``: how a parent comparison tells a parent
    whose kernel takes this checkout's arguments from an older one."""
    src = Path(tree) / "r2l_tpu_torch" / f"{module}.py"
    return f"def {name}(" in src.read_text()


# Two builds of a bf16 probe each keep within 5e-2 of the plain version
# (``chip_smoke.TOL_PROBE_BF16``'s deep limit, max-abs relative to the
# largest |plain|), so they differ by at most twice that.
PARENT_REL = 0.1


def parent_probe(name: str, lib: str, new: Callable, old: Callable,
                 parent_regs: list[str], exact: bool, log: Log,
                 reps: int = 5) -> None:
    """A probe of this checkout (``new``) against the parent's build of
    its library ``lib`` (``old``, with the parent's register lines): held
    to each other first, bit for bit where ``exact``, else within
    PARENT_REL relative to the parent's largest |output| (AssertionError
    if not), then timed in turns (``in_turns``, the parent's as the
    variant)."""
    got, want = new(), old()
    same = torch.equal(got, want)   # also where both are all 0
    diff = 0.0 if same else float((got - want).abs().max()
                                  / want.abs().max())
    if (exact and not same) or not diff <= PARENT_REL:
        raise AssertionError(f"{name}: this checkout's output differs from "
                             f"the parent's by {diff:.3e} relative")
    del got, want
    base_ms, parent_ms, _ = in_turns(new, old, contextlib.nullcontext, reps)
    log({"name": f"parent_{name}", "base_ms": base_ms,
         "parent_ms": parent_ms, "max_rel_diff": diff, "bit_for_bit": same,
         "registers": registers(lib), "parent_registers": parent_regs})


def registers(name: str) -> list[str]:
    """This checkout's register and spill lines of library ``name``."""
    from ..kernels import _build
    return [ln.strip() for ln in _build.compiler_log(name).splitlines()
            if "Used" in ln or "spill" in ln]


def variants_main(prog: str, doc: str, variants: dict,
                  time_variants: Callable, argv=None,
                  compare_parent: Callable | None = None) -> None:
    """A design-run tool's command line: ``--variants a,b`` (default all of
    ``variants``) timed by ``time_variants(names, log)``, ``--steps TREE
    ...``, or ``--parent TREE`` (``compare_parent(tree, log)``: this
    checkout's kernels against a parent's, bit for bit); ``--out`` appends
    the records to a file."""
    ap = argparse.ArgumentParser(prog=prog, description=doc.splitlines()[0])
    ap.add_argument("--variants", default=",".join(variants))
    ap.add_argument("--steps", nargs="+", metavar="TREE")
    ap.add_argument("--parent", metavar="TREE")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    log = Log(args.out)
    if args.steps:
        time_steps(args.steps, log, prog)
    elif args.parent and compare_parent is not None:
        compare_parent(args.parent, log)
    else:
        names = [n for n in args.variants.split(",") if n]
        unknown = sorted(set(names) - set(variants))
        if unknown:
            raise SystemExit(f"unknown variants {unknown}")
        time_variants(names, log)
    log({"name": "done"})
