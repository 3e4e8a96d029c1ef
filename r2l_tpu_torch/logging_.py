"""Experiment logging runtime (the reference's "smilelogging" surface).

Counterpart of ``r2l_tpu/logging_.py`` (``check_path``, ``Timer``,
``AverageMeter``, ``LossLine``, ``LogTracker``, ``Logger`` with
``cache_code``), copied because the JAX package is not imported here. It
covers what R2L uses of the reference's `smilelogging/`: a per-run
experiment directory with a unique ExpID, prefix-stamped console printing
teed to ``log/log.txt``, args/env/git capture, metric trackers
(AverageMeter / LossLine EMA) and an ETA Timer, with no global singletons.
The port's command line runs one process (rank 0).
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
from datetime import datetime, timedelta


def check_path(pattern: str) -> str:
    """Glob-resolve a path pattern to exactly one file
    (reference `smilelogging/utils.py:424-432`)."""
    if not pattern or os.path.exists(pattern):
        return pattern
    hits = glob.glob(pattern)
    if len(hits) != 1:
        raise FileNotFoundError(
            f"{pattern!r} resolved to {len(hits)} files, expected 1: {hits}")
    return hits[0]


class Timer:
    """ETA predictor over a fixed number of future events
    (reference `smilelogging/utils.py:799-823`)."""

    def __init__(self, total_epochs: int):
        self.total = total_epochs
        self.t0 = time.time()
        self.marks: list[float] = []

    def __call__(self) -> str:
        self.marks.append(time.time())
        done = len(self.marks)
        if self.total <= 0:
            return "unknown"
        per = (self.marks[-1] - self.t0) / done
        eta = per * (self.total - done)
        finish = datetime.fromtimestamp(time.time() + eta)
        return finish.strftime("%Y/%m/%d-%H:%M:%S")


class AverageMeter:
    """Running average (reference `smilelogging/utils.py:1185-1224`)."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class LossLine:
    """Accumulate named values, format one log line; EMA smoothing to match
    the reference's 0.95-smoothed loss prints (`main.py:1383-1386`)."""

    def __init__(self, ema: float = 0.0):
        self.ema = ema
        self.vals: dict[str, float] = {}

    def update(self, name: str, value: float):
        v = float(value)
        if self.ema > 0 and name in self.vals:
            v = self.ema * self.vals[name] + (1 - self.ema) * v
        self.vals[name] = v
        return v

    def format(self) -> str:
        return " ".join(f"{k} {v:.6f}" for k, v in self.vals.items())


class LogTracker:
    """Named metric histories + fnmatch-filtered formatting + moving average
    (reference `smilelogging/logger.py:90-147`)."""

    def __init__(self):
        self._hist: dict[str, list[float]] = {}

    def update(self, name: str, value: float):
        self._hist.setdefault(name, []).append(float(value))

    def get(self, name: str) -> list[float]:
        return self._hist.get(name, [])

    def moving_avg(self, name: str, window: int = 10) -> float:
        h = self._hist.get(name, [])
        if not h:
            return float("nan")
        return float(sum(h[-window:]) / len(h[-window:]))

    def format(self, pattern: str = "*", fmt: str = ".4f") -> str:
        import fnmatch
        keys = [k for k in self._hist if fnmatch.fnmatch(k, pattern)]
        return " ".join(f"{k} {self._hist[k][-1]:{fmt}}" for k in sorted(keys))


def _git_info(cwd: str) -> dict:
    def run(*cmd):
        try:
            return subprocess.run(cmd, cwd=cwd, capture_output=True,
                                  text=True, timeout=5).stdout.strip()
        except Exception:
            return ""
    return {"commit": run("git", "rev-parse", "--short", "HEAD"),
            "branch": run("git", "rev-parse", "--abbrev-ref", "HEAD"),
            "dirty": bool(run("git", "status", "--porcelain"))}


class Logger:
    """Per-run experiment directory + stamped, teed logging.

    Directory layout (reference `smilelogging/logger.py:234-294`):
    ``<experiments_dir>/<name>-<timestamp>/{weights, gen_img, log}`` with
    ``log/log.txt`` teeing every print. ``debug=True`` routes to
    ``Debug_Dir``. ``resume_TimeID='latest'`` reuses the newest matching
    experiment dir (`logger.py:247-255`).
    """

    def __init__(self, experiment_name: str = "", experiments_dir: str =
                 "Experiments", debug: bool = False, resume_time_id: str = "",
                 args=None, main_process: bool = True, rank: int = 0):
        self.name = experiment_name or "exp"
        self.main_process = main_process
        self.rank = rank
        ts = datetime.now().strftime("%Y%m%d-%H%M%S")
        if debug:
            root, self.expid = os.path.join(experiments_dir, "Debug_Dir"), "Debug"
        elif resume_time_id:
            if resume_time_id == "latest":
                import re
                pat = re.compile(re.escape(self.name) + r"-\d{8}-\d{6}$")
                cands = sorted(
                    p for p in glob.glob(
                        os.path.join(experiments_dir, f"{self.name}-*"))
                    if pat.search(os.path.basename(p)))
                root = cands[-1] if cands else os.path.join(
                    experiments_dir, f"{self.name}-{ts}")
            else:
                root = os.path.join(experiments_dir,
                                    f"{self.name}-{resume_time_id}")
            # Timestamp = the LAST two '-' segments (experiment names may
            # themselves contain hyphens: 'lego-r2l-20260101-120000').
            self.expid = "-".join(os.path.basename(root).rsplit("-", 2)[-2:])
        else:
            root, self.expid = os.path.join(
                experiments_dir, f"{self.name}-{ts}"), ts
            if not main_process:
                # Non-main ranks must nest under the MAIN process's run
                # root (reference `logger.py:240-241`), not a sibling dir
                # from their own clock second — wait for the main rank to
                # create a FRESH matching dir (name timestamp no older
                # than this process's start minus slack; a stale dir from
                # a previous run must not be attached to). Falls back to
                # the newest dir after ~10 s.
                import re
                import time as _time
                pat = re.compile(re.escape(self.name) + r"-(\d{8}-\d{6})$")
                floor = (datetime.now() - timedelta(seconds=120)
                         ).strftime("%Y%m%d-%H%M%S")

                def newest(min_ts):
                    best = None
                    for p in glob.glob(os.path.join(
                            experiments_dir, f"{self.name}-*")):
                        m = pat.search(os.path.basename(p))
                        if m and (min_ts is None or m.group(1) >= min_ts):
                            if best is None or m.group(1) > best[1]:
                                best = (p, m.group(1))
                    return best

                got = None
                for _ in range(50):           # up to ~10 s for a fresh dir
                    got = newest(floor)
                    if got:
                        break
                    _time.sleep(0.2)
                got = got or newest(None)     # last resort: newest overall
                if got:
                    root, self.expid = got
        self.exp_dir = root
        self.weights_dir = os.path.join(root, "weights")
        self.gen_img_dir = os.path.join(root, "gen_img")
        self.log_dir = os.path.join(root, "log")
        if main_process:
            for d in (self.weights_dir, self.gen_img_dir, self.log_dir):
                os.makedirs(d, exist_ok=True)
            self._log_path = os.path.join(self.log_dir, "log.txt")
            # Rotate a pre-existing log (reference `logger.py:290-294`).
            if os.path.exists(self._log_path) and not resume_time_id:
                os.replace(self._log_path, self._log_path + ".bak")
            self._f = open(self._log_path, "a")
            self._capture_environment(args)
        else:
            # Non-main processes log under OtherRanks/rank_<r>/ so
            # multi-host runs keep every process's output (reference
            # `logger.py:240-241` routes non-zero ranks to OtherRanks/).
            rank_root = os.path.join(root, "OtherRanks", f"rank_{rank}")
            self.log_dir = os.path.join(rank_root, "log")
            self.weights_dir = os.path.join(rank_root, "weights")
            self.gen_img_dir = os.path.join(rank_root, "gen_img")
            for d in (self.weights_dir, self.gen_img_dir, self.log_dir):
                os.makedirs(d, exist_ok=True)
            self._log_path = os.path.join(self.log_dir, "log.txt")
            self._f = open(self._log_path, "a")

    def _capture_environment(self, args):
        """Record invocation line, sorted args, git state
        (reference `logger.py:463-509`)."""
        import shlex
        with open(os.path.join(self.log_dir, "script.sh"), "w") as f:
            f.write("python " + " ".join(shlex.quote(a)
                                         for a in sys.argv) + "\n")
        if args is not None:
            payload = {k: repr(v) for k, v in sorted(vars(args).items())}
            with open(os.path.join(self.log_dir, "args.json"), "w") as f:
                json.dump(payload, f, indent=1)
        with open(os.path.join(self.log_dir, "git.json"), "w") as f:
            json.dump(_git_info(os.getcwd()), f, indent=1)
        if args is not None and not getattr(args, "no_cache", True):
            self.cache_code()

    def cache_code(self, root: str | None = None):
        """Snapshot the source tree into the experiment dir (the
        reference's code cache, `logger.py:514-528`, minus the user
        shell script indirection)."""
        import zipfile
        root = root or os.getcwd()
        dst = os.path.join(self.exp_dir, ".caches")
        os.makedirs(dst, exist_ok=True)
        out = os.path.join(dst, "code.zip")
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
            for dirpath, dirnames, files in os.walk(root):
                dirnames[:] = [d for d in dirnames
                               if d not in (".git", "__pycache__",
                                            "Experiments", ".caches",
                                            ".pytest_cache")]
                for f in files:
                    if f.endswith(".py"):
                        p = os.path.join(dirpath, f)
                        z.write(p, os.path.relpath(p, root))
        return out

    def _stamp(self) -> str:
        return (f"[{self.expid} {os.getpid()} "
                f"{datetime.now().strftime('%m/%d %H:%M:%S')}]")

    def print(self, *msg, main_process_only: bool = True):
        line = f"{self._stamp()} " + " ".join(str(m) for m in msg)
        if self.main_process or not main_process_only:
            print(line, flush=True)
        # Non-main processes still tee into their OtherRanks/ log file
        # (reference `logger.py:309-310` gates the console, not the file).
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()

    info = print

    def warn(self, *msg):
        self.print("[WARN]", *msg)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
