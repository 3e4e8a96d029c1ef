"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/r2l_tpu_torch/`` at the root of the checkout, named by a hash of its
sources and flags, so an edited source is rebuilt. The library is loaded with
``ctypes``. A failed build raises with nvcc's output.

No ``--use_fast_math``: the positional-encoding ladder doubles the error of
``sinf`` nine times, so the kernels use the accurate ``sinf``/``cosf``/
``expf``. FMA contraction stays on for the dot products; the epilogues that
must round exactly like the plain versions use ``__fmul_rn``/``__fadd_rn``,
and ``__fmaf_rn`` for the int8 dequantize, which the plain versions compute
as one fused multiply-add.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "r2l_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# argtypes of each library's one entry point: pointers and the stream as
# c_void_p, so ctypes does not cut them to 32 bits.
KERNELS = {
    "r2l_pe_fused": ("r2l_pe_fused_launch",
                     [_P, _I, _I, _I] + [_P] * 7
                     + [_LL, _I, _I, _I, _I, _F, _I, _I, _I, _P]),
    "r2l_fused": ("r2l_fused_launch",
                  [_P, _I, _I] + [_P] * 7
                  + [_LL, _I, _I, _I, _I, _F, _I, _I, _I, _P]),
    "r2l_int8_hopper": ("r2l_int8_hopper_launch",
                        [_P, _I, _I, _I] + [_P] * 9 + [_LL] + [_I] * 7
                        + [_P]),
    "r2l_wide": ("r2l_wide_launch",
                 [_P] + [_I] * 6 + [_P] * 11 + [_LL] + [_I] * 5 + [_F]
                 + [_I] * 3 + [_P]),
    "r2l_wide_train": ("r2l_wide_train_fwd_launch",
                       [_P] + [_I] * 5 + [_P] * 12 + [_LL] + [_I] * 3 + [_F]
                       + [_I] * 2 + [_P]),
    "r2l_wide_bwd": ("r2l_wide_bwd_launch",
                     [_P] * 11 + [_I] * 3 + [_F] + [_I] * 3 + [_P]),
    "r2l_train_fwd": ("r2l_train_fwd_launch",
                      [_P, _I, _I, _I] + [_P] * 7 + [_LL, _P]
                      + [_I, _I, _I, _F, _I, _I, _I, _P]),
    "r2l_train_fwd_int8": ("r2l_train_fwd_int8_launch",
                           [_P, _I, _I, _I] + [_P] * 8 + [_LL, _P]
                           + [_I] * 6 + [_P]),
    "r2l_bwd_group": ("r2l_bwd_group_launch",
                      [_P] * 11 + [_I, _I, _I, _F, _I, _I, _I, _P]),
    "r2l_bwd_qdx": ("r2l_bwd_qdx_launch",
                    [_P] * 12 + [_I, _I, _I, _F, _I, _I, _P]),
    "nerf_render": ("nerf_render_launch",
                    [_P] * 3 + [_I] * 2 + [_P] * 2 + [_I] * 3 + [_P] * 5
                    + [_I] * 6 + [_P] * 5),
    "nerf_render_int8": ("nerf_render_int8_launch",
                         [_P] * 3 + [_I] * 2 + [_P] * 5 + [_I] * 3
                         + [_P] * 13 + [_I] * 7 + [_P] * 5),
    "nerf_wide": ("nerf_wide_launch",
                  [_P] * 3 + [_I] * 2 + [_P, ctypes.POINTER(_I)] + [_I] * 3
                  + [_P] * 8 + [_I] * 6 + [_P] * 5 + [_LL, _I, _P]),
    # the tensor-core probes of r2l_tpu_torch/exp/
    "probe_chain": ("probe_chain_launch",
                    [_P, _I, _P, _P, _P, _I, _I, _I, _P]),
    "probe_bign": ("probe_bign_launch", [_P, _I, _P, _P, _I, _P]),
    "probe_int8_chain": ("probe_int8_chain_launch",
                         [_P, _I, _P, _P, _F, _P, _I, _I, _P]),
    "probe_shapes": ("probe_shapes_launch",
                     [_P, _I, _I, _I, _P, _I, _P, _I, _I, _P]),
    "probe_mma_sync": ("probe_mma_sync_launch",
                       [_P, _I, _I, _I, _P, _I, _P, _P]),
    "probe_resmlp": ("probe_resmlp_launch",
                     [_P, _I, _P, _P, _P, _F, _F, _P, _I, _I, _I, _P]),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (os.path.join(CUDA_HOME or "", "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in CUDA_HOME, PATH and "
                       "/usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the .cu and shared .cuh
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=tuple(KERNELS)) -> dict[str, float]:
    """Compile every library in ``names`` that is missing, in parallel.
    Returns the seconds each build took (0.0 where it was up to date); the
    compiler's log (register and shared-memory use) is kept beside each
    library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, time.time())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.time() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    build((name,))
    lib = ctypes.CDLL(str(_library_path(name)))
    entry, argtypes = KERNELS[name]
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def compiler_log(name: str) -> str:
    """nvcc's output of the current build of ``name`` ('' if not built)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
