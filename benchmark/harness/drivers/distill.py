"""R2L distillation steps, rays mode, with the README's flags: a batch of
``batch_rays`` rays, ``hard_ratio`` of it from a hard pool of ``hard_mul``
batches, the warm-up and decay schedule, the fused training kernels in the
traffic's compute dtype. The fresh rays come from a live ``RayBatchLoader``
over the configuration's ``pseudo_rays`` pseudo-data records in shards of
``shard_rays``, written in set-up from the seed; each step's draws (the
pool's strata and shuffle, the depth jitter) are made by the benchmark on
the card and handed in through ``draws=``. Nothing syncs the host between
steps but what the step itself does.

Set-up builds the one state and step and drives them through the first
``checked_steps`` steps with the window's own feed and call; the window
goes on with that same state. The check, against the plain reference from
the same weights, batches and draws:

* those first steps: each step's loss, the first gradient (Adam's first
  moment after one step), the parameters' change over the checked steps,
  and the rays each step mined into the hard pool (still filling);
* one step with the pool full (``after_window``): once the window has
  closed, the window's state (stepped on with the window's feed until the
  pool is full, where the window did not fill it) is copied, one more step
  runs through the window's call, and the reference takes the same step
  from the copy: the rows it wrote to the pool's slots (the slot draw and
  the write), and as readings its loss and its gradient (from Adam's first
  moment before and after).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import poses, runner, weights
from ..runner import Check, Window
from ..trace import span
from .view import load_student


def write_records(root: str, n: int, per_shard: int,
                  generator: torch.Generator) -> None:
    """``n`` pseudo-data records [o(3), d(3), rgb(3)] in shards of
    ``per_shard``: origins on the radius-4 sphere, directions toward its
    centre jittered by up to ~0.3, colours a smooth function of the ray
    (``chip_smoke.synthetic_rays``'s scene), made on the card."""
    dev = generator.device
    o = torch.randn((n, 3), generator=generator, device=dev)
    o = 4.0 * o / o.norm(dim=1, keepdim=True)
    d = -o / 4.0 + 0.3 * (torch.rand((n, 3), generator=generator,
                                     device=dev) * 2 - 1)
    d = d / d.norm(dim=1, keepdim=True)
    a, b, c = (torch.randn(s, generator=generator, device=dev)
               for s in ((3, 3), (3, 3), (3,)))
    rgb = 0.5 + 0.45 * torch.sin(d @ a + (o / 4.0) @ b + c)
    rec = torch.cat([o, d, rgb], 1).cpu().numpy()
    os.makedirs(root, exist_ok=True)
    for i, s in enumerate(range(0, n, per_shard)):
        np.save(os.path.join(root, f"pseudo_{i:06d}.npy"),
                rec[s:s + per_shard])


def _dcfg(traffic: dict, config: dict):
    from r2l_tpu_torch.hardmine import parse_hard_ratio
    from r2l_tpu_torch.train import DistillConfig
    n = traffic["batch_rays"]
    n_in, n_out = parse_hard_ratio(traffic["hard_ratio"], n)
    return DistillConfig(batch_size=n, lrate=traffic["lrate"],
                         lrate_decay=traffic["lrate_decay"],
                         warmup_lr=traffic["warmup_lr"], n_hard_in=n_in,
                         n_hard_out=n_out, hard_mul=traffic["hard_mul"],
                         perturb=True, embed_L=config["embed_L"])


def _draws(job, g: torch.Generator):
    """One step's draws: (u [n_hard], perm [n_hard], z_u [batch,
    n_sample])."""
    n_hard = job.dcfg.n_hard_out
    dev = g.device
    u = torch.rand(n_hard, generator=g, device=dev)
    perm = torch.randperm(n_hard, generator=g, device=dev)
    z_u = torch.rand((job.dcfg.batch_size, job.config["n_sample"]),
                     generator=g, device=dev)
    return u, perm, z_u


def _program(job, quantize: str = ""):
    """(state, step) of the program from the benchmark's weights."""
    from r2l_tpu_torch.sampler import PointSampler
    from r2l_tpu_torch.train import (fused_int8_calib_points,
                                     init_train_state, make_distill_step)
    c, t, dev = job.config, job.traffic, job.device
    model, cfg = load_student(c, t, job.weights, dev)
    sampler = PointSampler(H=c["H"], W=c["W"], focal=c["focal"],
                           n_sample=c["n_sample"], near=c["near"],
                           far=c["far"])
    calib = None
    if quantize == "int8":
        calib = fused_int8_calib_points(
            c["H"], c["W"], c["focal"], c["n_sample"], c["near"], c["far"],
            poses.orbit_poses(16, -30.0, 4.0), device=dev)
    step = make_distill_step(cfg, job.dcfg, sampler, fused_vjp=True,
                             fused_group_blocks=t["group_blocks"],
                             fused_quantize=quantize,
                             fused_calib_pts=calib, device=dev)
    return init_train_state(model, job.dcfg, device=dev), step


def _one(job, state, step, fresh, d, tracer=None):
    from r2l_tpu_torch.hardmine import HardDraws
    from r2l_tpu_torch.train import StepDraws
    with span(tracer, "step"):
        return step(state, fresh, draws=StepDraws(HardDraws(d[0], d[1]),
                                                  d[2]))



def _readings(state, names) -> dict:
    """The gradient of each leaf as Adam's first moment holds it after one
    step."""
    opt = state.optimizer
    return {k: opt.state[p]["exp_avg"].detach().clone() / 0.1
            for k, p in zip(names, state.params.parameters())}


def _mined(job, state) -> torch.Tensor:
    """The rows the checked steps wrote to the hard pool, in order (the
    pool fills from slot 0 and is far from full)."""
    n = job.traffic["checked_steps"] * job.dcfg.n_hard_in
    return state.pool.rays[:n].detach().clone()


def setup(job) -> None:
    from r2l_tpu_torch.data.rayshards import RayBatchLoader, RayShardDataset
    c, t, dev = job.config, job.traffic, job.device
    g = torch.Generator(dev).manual_seed(job.seed)
    job.weights = weights.r2l_weights(c, g)
    job.root = tempfile.mkdtemp(prefix="r2l_bench_distill_")
    write_records(job.root, c["pseudo_rays"], c["shard_rays"], g)
    job.dcfg = _dcfg(t, c)
    job.state, job.step = _program(job)
    job.names = [k for k, _ in job.state.params.named_parameters()]
    job.loader = RayBatchLoader(
        RayShardDataset(job.root), job.dcfg.batch_size - job.dcfg.n_hard_out,
        seed=job.seed % (2 ** 32), chunk=t["loader_chunk"],
        workers=t["loader_workers"])
    job.gen = torch.Generator(dev).manual_seed(job.seed * 4 + 1)
    # the checked steps: the window's own feed and call
    job.fed, job.losses = [], []
    for i in range(t["checked_steps"]):
        fresh = next(job.loader)
        d = _draws(job, job.gen)
        job.fed.append((fresh.copy(), d))
        job.state, m = _one(job, job.state, job.step, fresh, d)
        job.losses.append(m["loss"])
        if i == 0:
            job.grad1 = _readings(job.state, job.names)
    job.losses = [float(x) for x in job.losses]
    job.change = {k: p.detach() - job.weights[k]
                  for k, p in job.state.params.named_parameters()}
    job.mined = _mined(job, job.state)


def window(job, seconds: float, tracer) -> Window:
    completions = []
    t_start = time.perf_counter()
    k = 0
    while True:
        now = time.perf_counter()
        if k > 0 and now - t_start >= seconds:
            break
        tracer.maybe_start(t_start, seconds, now)
        tracer.unit_begun()
        with tracer.span("loader"):
            fresh = next(job.loader)
        with tracer.span("draws"):
            d = _draws(job, job.gen)
        job.state, _ = _one(job, job.state, job.step, fresh, d, tracer)
        k += 1
        completions.append(time.perf_counter())
    if job.device.type == "cuda":
        torch.cuda.synchronize(job.device)
    # the window closes when the last step's work is done
    completions[-1] = time.perf_counter()
    return Window(t_start, completions[-1], k, completions)


def step_ops(job) -> float:
    """The model FLOPs of a step: forward and backward, 3x the forward's,
    on the whole batch."""
    from counts import r2l_fused
    return 3.0 * r2l_fused.frame_ops(job.config, job.traffic["batch_rays"])


def _snapshot(state) -> dict:
    """A copy of the program's state as the reference resumes it: the
    leaves (f32), Adam's moments, the schedule's count, the pool."""
    opt = state.optimizer
    named = list(state.params.named_parameters())
    return {"w": {k: p.detach().float().clone() for k, p in named},
            "m": {k: opt.state[p]["exp_avg"].detach().clone()
                  for k, p in named},
            "v": {k: opt.state[p]["exp_avg_sq"].detach().clone()
                  for k, p in named},
            "count": int(state.lr_count),
            "pool": state.pool.rays.detach().clone(),
            "size": int(state.pool.size), "ptr": int(state.pool.ptr)}


def after_window(job) -> None:
    """One step with the pool full, from the window's state, through the
    window's feed and call; what the check reads of it is kept."""
    cap = job.dcfg.pool_capacity
    job.fill_steps = 0
    while int(job.state.pool.size) < cap:
        d = _draws(job, job.gen)
        job.state, _ = _one(job, job.state, job.step, next(job.loader), d)
        job.fill_steps += 1
    fresh = next(job.loader)
    d = _draws(job, job.gen)
    snap = _snapshot(job.state)
    job.state, m = _one(job, job.state, job.step, fresh, d)
    opt = job.state.optimizer
    grad = {k: (opt.state[p]["exp_avg"].detach().double()
                - 0.9 * snap["m"][k].double()) / 0.1
            for k, p in job.state.params.named_parameters()}
    job.full = {"snap": snap, "fresh": fresh.copy(), "draws": d,
                "loss": float(m["loss"]), "grad": grad,
                "pool": job.state.pool.rays.detach().clone()}


def release(job) -> None:
    job.loader.close()
    job.state = job.step = job.loader = None


def _reference(job, tf32: bool = False):
    """The reference over the checked steps: (losses, first gradients,
    change, mined rows)."""
    from reference import distill, r2l
    with r2l.matmul_precision(tf32):
        tr = distill.Trainer(job.weights, job.config, job.traffic,
                             job.device)
        losses, grad1 = [], None
        for fresh, (u, perm, z_u) in job.fed:
            value, g = tr.step(torch.as_tensor(fresh, device=job.device),
                               u, perm, z_u)
            losses.append(value)
            grad1 = grad1 or g
        change = {k: (p.detach() - job.weights[k]) for k, p in tr.w.items()}
        mined = tr.pool.rays[:tr.pool.ptr].clone()
    return losses, grad1, change, mined


def _compare(job, ref, losses, grad1, change, mined) -> dict:
    from reference import distill
    r_loss, r_grad, r_change, r_mined = ref
    norms = {k: float(r_grad[k].norm()) for k in r_grad}
    med = float(np.median(list(norms.values())))
    keep = [k for k in r_grad if norms[k] >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, r_loss)),
            "grad_gap": distill.leaf_gaps(grad1, r_grad, keep),
            "change_gap": distill.leaf_gaps(change, r_change, keep),
            "mined_off": distill.mined_off(mined, r_mined,
                                           job.dcfg.n_hard_in)}


def _full_step(job, tf32: bool = False) -> dict:
    """The pool-full step's numbers: the reference resumes from the copy
    of the program's state and takes the same step."""
    from reference import distill, r2l
    f = job.full
    u, perm, z_u = f["draws"]
    with r2l.matmul_precision(tf32):
        tr = distill.Trainer.resume(f["snap"], job.config, job.traffic,
                                    job.device)
        value, r_grad = tr.step(torch.as_tensor(f["fresh"],
                                                device=job.device),
                                u, perm, z_u)
    norms = {k: float(r_grad[k].norm()) for k in r_grad}
    med = float(np.median(list(norms.values())))
    keep = [k for k in r_grad if norms[k] >= 1e-3 * med]
    slots = tr.pool.written
    return {"full_loss_gap": abs(f["loss"] - value) / abs(value),
            "full_grad_gap": distill.leaf_gaps(f["grad"], r_grad, keep),
            "full_mined_off": distill.mined_off(f["pool"][slots],
                                                tr.pool.rays[slots],
                                                job.dcfg.n_hard_in)}


def check(job, win: Window) -> list[Check]:
    shutil.rmtree(job.root, ignore_errors=True)
    lim = runner.limits_of(job)
    job.ref = _reference(job)
    got = _compare(job, job.ref, job.losses, job.grad1, job.change,
                   job.mined)
    got.update(_full_step(job))
    # the pool-full step's loss and gradient gaps are readings (no limit:
    # a late bf16 step's gradient scale swings by seed), its mined rows
    # compared; also read: the steps the pool still needed after the window
    out = [Check(k, v, lim.get(k)) for k, v in got.items()]
    return out + [Check("fill_steps", float(job.fill_steps), None)]


def control(job) -> dict:
    """``check``'s numbers with the program's own lower-precision path in
    its place: the int8 training forward (K4, its stash and K5), from the
    same weights, batches and draws."""
    state, step = _program(job, job.traffic["check"]["control"])
    losses, grad1 = [], None
    for i, (fresh, d) in enumerate(job.fed):
        state, m = _one(job, state, step, fresh, d)
        losses.append(m["loss"])
        if i == 0:
            grad1 = _readings(state, job.names)
    change = {k: p.detach() - job.weights[k]
              for k, p in state.params.named_parameters()}
    return _compare(job, job.ref, [float(x) for x in losses], grad1, change,
                    _mined(job, state))
