"""Viewers asking for frames of the R2L student: a closed loop of
``viewers`` clients (one, as ``render_path`` renders), each sending its
next pose once its last frame is on the host. Poses lie on an orbit
(``radius``, ``elevation``) at a random azimuth drawn from the seed. The
program's frame function (``make_r2l_frame_fn``, with ``quantize`` "int8"
or "" and the configuration's compute dtype) renders each pose; the frame
is copied to pinned host memory as ``render_path`` reads it. A frame's
latency runs from its send to the moment it is on the host.

The check: a sample of the window's frames, drawn from the seed, against
the plain reference's float32 frames of the same poses and weights.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import poses, runner, weights
from ..runner import Check, Window
from ..trace import span

_SEED_POSES = 1
_SEED_SAMPLE = 2


def _r2l_cfg(config: dict, traffic: dict):
    from r2l_tpu_torch.models import R2LConfig
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        traffic.get("compute_dtype", "float32")]
    return R2LConfig(input_dim=config["input_dim"],
                     output_dim=config["output_dim"],
                     netdepth=config["netdepth"],
                     netwidth=config["netwidth"],
                     use_residual=config["use_residual"],
                     compute_dtype=dtype)


def load_student(config: dict, traffic: dict, w: dict, device):
    """The program's student holding the benchmark's weights."""
    from r2l_tpu_torch.models import R2L
    cfg = _r2l_cfg(config, traffic)
    model = R2L(cfg, torch.device("meta"))
    model.load_state_dict({k: v.clone() for k, v in w.items()}, assign=True)
    return model.to(device), cfg


def setup(job) -> None:
    from r2l_tpu_torch.evaluate import make_r2l_frame_fn
    from r2l_tpu_torch.sampler import PointSampler
    c, t, dev = job.config, job.traffic, job.device
    job.weights = weights.r2l_weights(
        c, torch.Generator(dev).manual_seed(job.seed))
    model, cfg = load_student(c, t, job.weights, dev)
    sampler = PointSampler(H=c["H"], W=c["W"], focal=c["focal"],
                           n_sample=c["n_sample"], near=c["near"],
                           far=c["far"])
    job.calib_poses = poses.orbit_poses(t["calib_poses"], t["elevation"],
                                        t["radius"])
    job.frame_fn = make_r2l_frame_fn(
        model, cfg, sampler, embed_L=c["embed_L"], use_pallas=True,
        quantize=t["quantize"], calib_poses=job.calib_poses)
    if job.frame_fn.kind != t["expect_kind"]:
        raise RuntimeError(f"the frame took path {job.frame_fn.kind!r}, "
                           f"not {t['expect_kind']!r}")
    job.model = model
    # warm-up: the window's own loop, on poses the window does not draw
    warm = poses.OrbitDraws(job.seed + 7, t["elevation"], t["radius"])
    _loop(job, warm, t["warmup_frames"], None, 0.0, None)


class _Frame:
    __slots__ = ("viewer", "pose", "t_send", "event", "host")


def _loop(job, draw, n_frames: int | None, tracer, seconds: float,
          keep) -> Window:
    """The closed loop: until ``n_frames`` frames are sent (set-up) or the
    window's ``seconds`` are over; ``keep(index, pose, host frame)`` sees
    every frame as it arrives."""
    t, dev = job.traffic, job.device
    cuda = dev.type == "cuda"
    n_view = t["viewers"]
    H, W = job.config["H"], job.config["W"]
    bufs = [torch.empty((H, W, 3), dtype=torch.float32, pin_memory=cuda)
            for _ in range(n_view)]
    pose_bufs = [torch.empty((3, 4), dtype=torch.float32, pin_memory=cuda)
                 for _ in range(n_view)]
    inflight: collections.deque = collections.deque()
    sent = 0
    completions, latencies = [], []

    def send(v: int) -> None:
        nonlocal sent
        f = _Frame()
        f.viewer, f.pose = v, draw()
        f.t_send = time.perf_counter()
        if tracer is not None:
            tracer.unit_begun()
        pose_bufs[v].copy_(torch.from_numpy(f.pose))
        with span(tracer, "frame"):
            frame = job.frame_fn(pose_bufs[v].to(dev, non_blocking=True))
        with span(tracer, "readback"):
            bufs[v].copy_(frame, non_blocking=True)
            f.event = torch.cuda.Event() if cuda else None
            if cuda:
                f.event.record()
        f.host = bufs[v]
        inflight.append(f)
        sent += 1

    t_start = time.perf_counter()
    for v in range(min(n_view, n_frames or n_view)):
        send(v)
    while inflight:
        f = inflight.popleft()
        with span(tracer, "wait"):
            if f.event is not None:
                f.event.synchronize()
        now = time.perf_counter()
        completions.append(now)
        latencies.append(now - f.t_send)
        if keep is not None:
            keep(len(completions) - 1, f.pose, f.host)
        more = (sent < n_frames if n_frames is not None
                else now - t_start < seconds)
        if tracer is not None:
            tracer.maybe_start(t_start, seconds, now)
        if more:
            send(f.viewer)
    return Window(t_start, completions[-1], sent, completions, latencies)



class _Reservoir:
    """A uniform sample of ``k`` frames of a stream of unknown length,
    drawn from the seed (the frame copied only when it is taken)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.items: list = []

    def __call__(self, i: int, pose, host) -> None:
        if len(self.items) < self.k:
            self.items.append((i, pose, host.numpy().copy()))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = (i, pose, host.numpy().copy())


def window(job, seconds: float, tracer) -> Window:
    t = job.traffic
    draw = poses.OrbitDraws(job.seed * 4 + _SEED_POSES, t["elevation"],
                            t["radius"])
    job.sample = _Reservoir(t["check"]["frames"],
                            job.seed * 4 + _SEED_SAMPLE)
    return _loop(job, draw, None, tracer, seconds, job.sample)


def frame_ops(job) -> float:
    from counts import r2l_fused
    c = job.config
    return r2l_fused.frame_ops(c, c["H"] * c["W"])


def release(job) -> None:
    job.frame_fn = job.model = None


def check(job, win: Window) -> list[Check]:
    from reference import r2l as ref
    lim = runner.limits_of(job)
    rmse, max_abs = [], []
    with ref.matmul_precision(False), torch.no_grad():
        for _, pose, got in job.sample.items:
            want = ref.frame(job.weights, job.config,
                             torch.as_tensor(pose, device=job.device),
                             job.traffic["check"]["block_rays"])
            d = torch.as_tensor(got, device=job.device).double() - \
                want.double()
            rmse.append(float(d.pow(2).mean().sqrt()))
            max_abs.append(float(d.abs().max()))
    return [Check("frame_rmse", max(rmse), lim.get("frame_rmse")),
            Check("frame_max_abs", max(max_abs), lim.get("frame_max_abs"))]


def control(job) -> dict:
    """The numbers of ``check`` with the reference in the program's place,
    one precision below the path's: int4 codes for the int8 path
    (calibrated as the reference calibrates, on the calibration poses at an
    eighth of the resolution), TF32 for float32."""
    from reference import r2l as ref
    c, t = job.config, job.traffic
    kind = t["check"]["control"]
    lin, tf32 = None, False
    if kind == "tf32":
        tf32 = True
    else:
        bits = {"int4": 4}[kind]
        sub = dict(c, H=c["H"] // 8, W=c["W"] // 8, focal=c["focal"] / 8)
        pts = torch.cat([ref.frame_points(
            torch.as_tensor(p, dtype=torch.float32, device=job.device),
            sub["H"], sub["W"], sub["focal"], c["n_sample"], c["near"],
            c["far"]) for p in job.calib_poses])
        with ref.matmul_precision(False):
            ranges = ref.calibrate(job.weights, c, pts)
        lin = ref.quantized_linear(bits, ranges)
    rmse, max_abs = [], []
    with torch.no_grad():
        for _, pose, _ in job.sample.items:
            p = torch.as_tensor(pose, device=job.device)
            with ref.matmul_precision(False):
                want = ref.frame(job.weights, c, p,
                                 t["check"]["block_rays"])
            with ref.matmul_precision(tf32):
                got = ref.frame(job.weights, c, p, t["check"]["block_rays"],
                                lin)
            d = got.double() - want.double()
            rmse.append(float(d.pow(2).mean().sqrt()))
            max_abs.append(float(d.abs().max()))
    return {"frame_rmse": max(rmse), "frame_max_abs": max(max_abs)}
