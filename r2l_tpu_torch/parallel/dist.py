"""Process-group start-up for the port's multi-device runs.

Counterpart of the JAX package's multihost init (``r2l_tpu/app.py:1505-1527``,
``jax.distributed.initialize``) and of its virtual CPU devices
(``--num_cpu_devices``): the port runs one process per device.

* ``init_distributed``: under a launcher (``torchrun`` sets ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address), or with
  ``--multihost``, this process joins the group: NCCL on the card, gloo on
  the host (``--platform cpu``), and takes ``cuda:LOCAL_RANK``.
* ``spawn_ranks``: ``--num_cpu_devices N --platform cpu`` stands for JAX's N
  virtual CPU devices: the same command is started N times as gloo ranks
  that meet through a file in a temporary directory (no TCP port). Each
  rank runs with one intra-op thread; the ranks are joined, and if one
  fails or the wait runs out the others are killed.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

# The environment a spawned rank reads its file rendezvous from.
INIT_ENV = "R2L_DIST_INIT"


def launched() -> bool:
    """Whether a launcher (torchrun, or ``spawn_ranks``) started this
    process as one rank of a group."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(platform: str, multihost: bool = False
                     ) -> tuple[int, int]:
    """Join the process group when launched as a rank (or raise with
    ``--multihost`` and no launcher): ``(rank, world)``, ``(0, 1)`` for a
    lone process. On the card the rank's device becomes the current one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not launched():
        if multihost:
            raise SystemExit(
                "--multihost: no launcher environment (RANK, WORLD_SIZE, "
                "MASTER_ADDR/MASTER_PORT); start the ranks with torchrun, "
                "e.g. torchrun --nproc_per_node N main_cuda.py --mesh "
                "data:N ...")
        return 0, 1
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if platform == "cpu":
        backend = "gloo"
    else:
        backend = "nccl"
        torch.cuda.set_device(local)
    init = os.environ.get(INIT_ENV) or "env://"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    return rank, world


def spawn_ranks(cmd: list[str], n: int, timeout: float | None = None,
                env: dict | None = None) -> int:
    """Run ``cmd`` as ``n`` gloo ranks of one group on this host and wait
    for them: the worst exit code (a rank killed at ``timeout`` seconds
    counts as 124)."""
    base = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, base.get("PYTHONPATH", "")) if p)
    with tempfile.TemporaryDirectory(prefix="r2l_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = []
        for r in range(n):
            e = dict(base, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                     OMP_NUM_THREADS="1", **{INIT_ENV: init})
            procs.append(subprocess.Popen(cmd, env=e))
        return join_ranks(procs, timeout)


def join_ranks(procs: list, timeout: float | None = None) -> int:
    """Wait for every process; once one fails (or ``timeout`` passes) the
    rest are killed. The worst exit code, 124 for a timeout."""
    end = None if timeout is None else time.monotonic() + timeout
    rcs: dict[int, int] = {}
    try:
        while len(rcs) < len(procs):
            for i, p in enumerate(procs):
                if i not in rcs and p.poll() is not None:
                    rcs[i] = p.returncode
            if any(rc != 0 for rc in rcs.values()):
                break
            if end is not None and time.monotonic() > end:
                rcs[-1] = 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [abs(rc) for rc in rcs.values() if rc != 0]
    return max(bad) if bad else 0


def run_cli(argv: list[str], entry: list[str], platform: str,
            num_cpu_devices: int) -> int | None:
    """The ``--num_cpu_devices`` launcher of a command line: with
    ``--platform cpu`` and N > 1, outside a launched rank, run ``entry +
    argv`` as N gloo ranks and return the worst exit code; None when this
    process should run the command itself."""
    if platform == "cpu" and num_cpu_devices > 1 and not launched():
        return spawn_ranks(entry + list(argv), num_cpu_devices)
    return None


def python_entry(script_or_module: str) -> list[str]:
    """The interpreter command that runs a script path or ``-m`` module."""
    if script_or_module.endswith(".py"):
        return [sys.executable, os.path.abspath(script_or_module)]
    return [sys.executable, "-m", script_or_module]
