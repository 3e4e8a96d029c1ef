"""R2L distillation training (rays data mode): one step is hard-pool
augment -> stratified sampling -> forward -> MSE -> backward -> Adam with
the warm-up/decay schedule -> pool update.

Counterpart of ``r2l_tpu/train.py`` (``make_lr_schedule`` :35,
``make_optimizer`` :56, ``DistillConfig`` :66, ``TrainState`` :136,
``init_train_state`` :143, ``_r2l_inputs`` :152, ``distill_loss_fn`` :166,
``_distill_core`` :187, ``make_distill_step`` :308) and of the fused-VJP
gate and int8 calibration points of ``r2l_tpu/app.py:815-839``.

Three kinds of step, chosen by the JAX flags:

* ``xla`` (``fused_vjp=False``): plain autograd through the ``R2L`` module;
* ``fused`` (``fused_vjp=True``): the fused forward K3 and backward K5
  (``kernels/r2l_train.py``);
* ``fused_int8`` (``fused_vjp=True, fused_quantize='int8'``): the int8
  forward K4 with recalibrated scales, and K5 on the int8 stash.

The model and its Adam state are updated in place; ``TrainState.step``
counts the updates. The random draws of a step (hard-pool slots, depth
jitter) are explicit: passed in (``StepDraws``, a test hands over JAX's) or
drawn from a ``torch.Generator``. ``scan_steps=k`` is a plain loop of k
steps over ``batches [k, B, D]``. Not here: the images data mode, the
checkpoints, the CLI loop and the mesh.
"""
from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from .encoding import r2l_embed
from .hardmine import (HardDraws, HardPool, draw_hard, init_pool,
                       sample_hard, update_pool)
from .kernels.r2l_train import make_fused_train_apply
from .models.r2l import R2L, R2LConfig
from .rays import plucker
from .sampler import PointSampler, stratify_z


def make_lr_schedule(lrate: float, lrate_decay: int,
                     warmup: str | tuple | None = None
                     ) -> Callable[[int], float]:
    """step -> learning rate: linear warm-up from ``warmup``'s start over
    its end step, then lrate * 0.1^(step / (lrate_decay * 1000)), in f32
    as the JAX schedule computes it."""
    w_start, w_end = 0.0, 0
    if warmup:
        a, b = warmup.split(",") if isinstance(warmup, str) else warmup
        w_start, w_end = float(a), int(b)
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if w_end > 0 and s < w_end:
            return float(f32(w_start) + f32(lrate - w_start) * s / f32(w_end))
        return float(f32(lrate) * np.power(f32(0.1),
                                           s / f32(lrate_decay * 1000.0)))

    return schedule


def make_optimizer(params, lrate: float) -> torch.optim.Adam:
    """Adam with optax's betas and eps (eps outside the square root of the
    bias-corrected second moment, in both); the step sets the learning
    rate from the schedule before each update."""
    return torch.optim.Adam(params, lr=lrate, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    batch_size: int = 81920          # N_rand(20) * 4096 rays/step
    lrate: float = 5e-4
    lrate_decay: int = 250
    warmup_lr: str | None = None     # 'start,end_iter'
    lw_rgb: float = 1.0
    lw_depth: float = 0.0            # >0 with learn_depth data
    n_hard_in: int = 0
    n_hard_out: int = 0
    hard_mul: float = 1.0
    perturb: bool = True
    embed_L: int = 10                # --multires for the R2L input PE
    plucker: bool = False
    learn_depth: bool = False        # records carry a depth column
    hard_sample: str = "stratified"  # or 'permutation'

    def __post_init__(self):
        # the pool draws without replacement from batch_size*hard_mul slots
        # and fills from the fresh part of the batch
        if self.n_hard_out > self.batch_size - self.n_hard_out:
            raise ValueError(
                f"hard out-count {self.n_hard_out} exceeds the fresh "
                f"part of the batch ({self.batch_size - self.n_hard_out})"
                " — use a hard out-ratio <= 0.5")
        if self.n_hard_out > self.pool_capacity:
            raise ValueError(
                f"hard out-count {self.n_hard_out} exceeds the pool "
                f"capacity {self.pool_capacity} (batch_size*hard_mul) — "
                "raise --hard_mul")

    @property
    def pool_capacity(self) -> int:
        return max(int(self.batch_size * self.hard_mul), 1)


class TrainState(NamedTuple):
    params: R2L                      # updated in place
    optimizer: torch.optim.Adam      # updated in place
    step: int                        # updates made so far
    pool: HardPool


class StepDraws(NamedTuple):
    """The random draws of one step: the hard-pool draws (None without
    hard mining) and the depth jitter ``z_u`` [batch, n_sample] (None
    without perturbation)."""
    hard: HardDraws | None
    z_u: torch.Tensor | None


def init_train_state(model: R2L, dcfg: DistillConfig, record_dim: int = 9,
                     device: torch.device | str = torch.device("cuda")
                     ) -> TrainState:
    """A fresh state around ``model`` (which must live on ``device``): Adam
    with zeroed moments, step 0, an empty hard pool on ``device``."""
    device = torch.device(device)
    for p in model.parameters():
        if p.device.type != device.type:
            raise ValueError(f"model is on {p.device}, the state on {device}")
    return TrainState(params=model,
                      optimizer=make_optimizer(model.parameters(),
                                               dcfg.lrate),
                      step=0, pool=init_pool(dcfg.pool_capacity, record_dim,
                                             device))


def clone_train_state(state: TrainState) -> TrainState:
    """A deep copy: a new model, an optimizer over its parameters with a
    copy of the moments, and a copy of the pool."""
    model = copy.deepcopy(state.params)
    opt = make_optimizer(model.parameters(),
                         state.optimizer.param_groups[0]["lr"])
    opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    pool = HardPool(*(t.clone() for t in state.pool))
    return TrainState(model, opt, state.step, pool)


def draw_step(dcfg: DistillConfig, n_sample: int,
              generator: torch.Generator) -> StepDraws:
    """A step's draws from ``generator`` (on its device)."""
    hard = (draw_hard(dcfg.n_hard_out, dcfg.pool_capacity, dcfg.hard_sample,
                      generator) if dcfg.n_hard_out > 0 else None)
    z_u = (torch.rand((dcfg.batch_size, n_sample), generator=generator,
                      device=generator.device)
           if dcfg.perturb and not dcfg.plucker else None)
    return StepDraws(hard, z_u)


def _r2l_inputs(batch: torch.Tensor, sampler: PointSampler,
                dcfg: DistillConfig, z_u: torch.Tensor | None):
    """Split records into (sample points, rgb target, depth target)."""
    rays_o, rays_d = batch[:, 0:3], batch[:, 3:6]
    rgb = batch[:, 6:9]
    depth = batch[:, 9:] if (dcfg.learn_depth and batch.shape[1] > 9) \
        else None
    if dcfg.plucker:
        return plucker(rays_o, rays_d), rgb, depth
    z = None
    if dcfg.perturb:
        z = stratify_z(sampler.z_vals(batch.device), (batch.shape[0],),
                       u=z_u)
    return sampler.sample_train(rays_o, rays_d, z), rgb, depth


def distill_loss_fn(model: R2L, cfg: R2LConfig, dcfg: DistillConfig,
                    sampler: PointSampler, batch: torch.Tensor,
                    z_u: torch.Tensor | None, fused_apply=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, per-ray RGB MSE [B]) of ``model`` on ``batch``."""
    pts, rgb_t, depth_t = _r2l_inputs(batch, sampler, dcfg, z_u)
    if fused_apply is not None:
        pred = fused_apply(model, pts)
    else:
        pred = model(r2l_embed(pts, dcfg.embed_L))
    # the RGB term takes the first 3 channels (learn_depth emits 4)
    per_ray = torch.mean((pred[..., :3] - rgb_t) ** 2, dim=-1)
    loss = dcfg.lw_rgb * torch.mean(per_ray)
    if depth_t is not None and dcfg.lw_depth > 0:
        loss = loss + dcfg.lw_depth * torch.mean((pred[..., 3:] - depth_t)
                                                 ** 2)
    return loss, per_ray


def _distill_core(state: TrainState, fresh: torch.Tensor, draws: StepDraws,
                  cfg: R2LConfig, dcfg: DistillConfig, sampler: PointSampler,
                  schedule: Callable[[int], float], n_fresh: int,
                  fused_apply=None) -> tuple[TrainState, dict]:
    """One step: hard-pool augment -> grad -> Adam -> pool refresh."""
    if dcfg.n_hard_out > 0:
        hard, idx = sample_hard(state.pool, dcfg.n_hard_out, fresh,
                                mode=dcfg.hard_sample, draws=draws.hard)
        batch = torch.cat([fresh, hard], dim=0)
    else:
        idx = torch.zeros((1,), dtype=torch.int64, device=fresh.device)
        batch = fresh
    model, opt = state.params, state.optimizer
    opt.zero_grad(set_to_none=True)
    loss, per_ray = distill_loss_fn(model, cfg, dcfg, sampler, batch,
                                    draws.z_u, fused_apply)
    loss.backward()
    # the schedule at the count before this update, as optax evaluates it
    for group in opt.param_groups:
        group["lr"] = schedule(state.step)
    opt.step()

    pool = state.pool
    per_ray = per_ray.detach()
    if dcfg.n_hard_in > 0:
        # hard rays come from the fresh rays only
        hard_ids = torch.topk(per_ray[:n_fresh], dcfg.n_hard_in).indices
        pool = update_pool(pool, batch[hard_ids], idx)
    rgb_mse = torch.mean(per_ray)
    metrics = {"loss": loss.detach(),
               "psnr": -10.0 * torch.log10(torch.clamp(rgb_mse, min=1e-12))}
    return state._replace(step=state.step + 1, pool=pool), metrics


def make_distill_step(cfg: R2LConfig, dcfg: DistillConfig,
                      sampler: PointSampler, fused_vjp: bool = False,
                      fused_group_blocks: int = 4, scan_steps: int = 1,
                      fused_quantize: str = "",
                      fused_calib_pts: torch.Tensor | None = None,
                      fused_calib_every: int = 1,
                      device: torch.device | str = torch.device("cuda")):
    """The distillation step (rays mode).

    ``scan_steps == 1``: ``step(state, fresh, generator=None, draws=None)
    -> (state, metrics)`` with ``fresh`` [B - n_hard_out, record_dim]
    (tensor or array). ``scan_steps = k > 1``: ``step(state, batches [k, B -
    n_hard_out, record_dim], generator=None, draws=None) -> (state,
    metrics stacked [k])``, the same as k single steps. ``draws`` (a
    ``StepDraws``, or a list of k) are the steps' random draws; without them
    they come from ``generator``, or from the step's own generator on
    ``device`` (seeded with 0 at the first call).

    ``fused_vjp``: the fused kernels (single device, canonical resmlp body,
    sampled points). ``fused_quantize='int8'`` runs the forward in int8
    (needs ``fused_calib_pts``); ``fused_calib_every=N > 1`` with k > 1
    recalibrates at the call's entry and then when ``step % N == 0``.
    """
    device = torch.device(device)
    fused_apply = fused_calibrate = None
    if fused_vjp:
        if dcfg.plucker:
            raise ValueError("fused_vjp takes sampled points, not Plücker "
                             "rays")
        dim_pts = cfg.input_dim // (2 * dcfg.embed_L + 1)
        external = bool(fused_calib_every > 1 and fused_quantize == "int8"
                        and scan_steps > 1)
        built = make_fused_train_apply(
            cfg, dim_pts, dcfg.embed_L, group_blocks=fused_group_blocks,
            compute_dtype=cfg.compute_dtype, quantize=fused_quantize,
            calib_pts=fused_calib_pts, external_calib=external)
        if external:
            fused_apply, fused_calibrate = built
        else:
            fused_apply = built
    schedule = make_lr_schedule(dcfg.lrate, dcfg.lrate_decay, dcfg.warmup_lr)
    n_fresh = dcfg.batch_size - dcfg.n_hard_out
    gens: list[torch.Generator] = []

    def draws_of(generator, draws, j: int | None) -> StepDraws:
        if draws is not None:
            return draws if j is None else draws[j]
        if generator is None:
            if not gens:
                gens.append(torch.Generator(device).manual_seed(0))
            generator = gens[0]
        return draw_step(dcfg, sampler.n_sample, generator)

    def one(state, fresh, draws, fp=None):
        fresh = torch.as_tensor(fresh, dtype=torch.float32, device=device)
        apply = fused_apply
        if fp is not None:
            apply = lambda m, x: fused_apply(m, x, fp)  # noqa: E731
        return _distill_core(state, fresh, draws, cfg, dcfg, sampler,
                             schedule, n_fresh, apply)

    if scan_steps <= 1:
        def step(state: TrainState, fresh, generator=None, draws=None):
            return one(state, fresh, draws_of(generator, draws, None))
        return step

    def scan(state: TrainState, batches, generator=None, draws=None):
        entry_step = state.step
        fp = fused_calibrate(state.params) if fused_calibrate else None
        ms = []
        for j in range(scan_steps):
            if (fused_calibrate and state.step % fused_calib_every == 0
                    and state.step != entry_step):
                fp = fused_calibrate(state.params)
            state, m = one(state, batches[j], draws_of(generator, draws, j),
                           fp)
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return scan


def fused_vjp_gate(fused_train_vjp: bool, cfg: R2LConfig, plucker_: bool,
                   n_devices: int = 1, log=None) -> bool:
    """Whether ``--fused_train_vjp`` takes the fused step: a single device,
    sampled points (not Plücker), netwidth % 128 == 0 and the canonical
    two-layer resmlp body; otherwise the plain step, with a warning."""
    ok = bool(fused_train_vjp and n_devices == 1 and not plucker_
              and cfg.netwidth % 128 == 0 and cfg.n_learnable == 2
              and cfg.body_arch == "resmlp")
    if fused_train_vjp and not ok:
        (log or (lambda s: print(s, file=sys.stderr)))(
            "WARNING: --fused_train_vjp requires a single device, "
            "non-Plücker rays, netwidth % 128 == 0 and the canonical "
            "2-layer resmlp body — using the XLA step.")
    return ok


def fused_int8_calib_points(H: int, W: int, focal: float, n_sample: int,
                            near: float, far: float, poses,
                            device: torch.device | str = torch.device("cuda")
                            ) -> torch.Tensor:
    """The int8 training forward's calibration points: ``sample_test`` of
    a sampler at H/8 x W/8 with focal/8 on 6 of the scene's poses (a
    linspace pick)."""
    sub = PointSampler(H=max(H // 8, 4), W=max(W // 8, 4), focal=focal / 8.0,
                       n_sample=n_sample, near=near, far=far)
    arr = np.asarray(poses, np.float32)
    pick = np.linspace(0, len(arr) - 1, min(len(arr), 6)).astype(int)
    return torch.cat([sub.sample_test(torch.as_tensor(arr[i][:3, :4],
                                                      device=device))
                      for i in pick])
