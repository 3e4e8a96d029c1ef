"""Training: R2L distillation (rays and images data modes) and the NeRF
teacher.

Counterpart of ``r2l_tpu/train.py`` (``make_lr_schedule`` :35,
``make_optimizer`` :56, ``DistillConfig`` :66, ``_patch_dims`` :103,
``_patch_coords`` :121, ``TrainState`` :136, ``init_train_state`` :143,
``_r2l_inputs`` :152, ``distill_loss_fn`` :166, ``_distill_core`` :187,
``make_distill_step`` :308, ``make_distill_step_images`` :406,
``TeacherTrainConfig`` :472, ``TeacherState`` :487, ``init_teacher_state``
:494, ``make_teacher_step_batched`` :513, ``make_teacher_step`` :562) and of
the fused-VJP gate and int8 calibration points of ``r2l_tpu/app.py:815-839``.

A distillation step is hard-pool augment -> stratified sampling -> forward
-> MSE -> backward -> Adam with the warm-up/decay schedule -> pool update,
in one of four kinds chosen by the JAX flags:

* ``xla`` (``fused_vjp=False``): plain autograd through the ``R2L`` module;
* ``fused`` (``fused_vjp=True``): the fused forward K3 and backward K5
  (``kernels/r2l_train.py``);
* ``fused_int8`` (``fused_vjp=True, fused_quantize='int8'``): the int8
  forward K4 with recalibrated scales, and K5 on the int8 stash;
  ``fused_stash_q=False`` (kind ``fused_int8_bf16stash``): the int8 forward
  K8 with a bf16 stash, and K5 on it.

The images data mode (``make_distill_step_images``) picks a step's pixels
from one image on the device and runs the same step on their rays. The
teacher steps (``make_teacher_step``: images, no_batching;
``make_teacher_step_batched``: a ray pool, use_batching) render a ray batch
with both networks (``render.render_rays_nerf``) and take Adam over both on
fine + coarse MSE: plain autograd, as JAX leaves them to XLA.

Models and Adam states are updated in place; a state's ``step`` counts the
updates and drives the precrop and the int8 calibration cadence, and its
``lr_count`` gives the learning rate: the two part only after a resume
that restores the step without the optimizer (``checkpoint.py``). The
random draws of a step (hard-pool slots, depth jitter, pixels, the training
image, the render's jitter and sigma noise) are explicit:
passed in (``StepDraws``, ``ImageStepDraws``, ``TeacherStepDraws``; a test
hands over JAX's) or drawn from a ``torch.Generator``. ``scan_steps=k`` is
a plain loop of k steps. Not here: the CLI loop and the mesh; the
checkpoints and resume are ``checkpoint.py``'s.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from .encoding import r2l_embed
from .hardmine import (HardDraws, HardPool, draw_hard, init_pool,
                       sample_hard, update_pool)
from .kernels.r2l_train import make_fused_train_apply
from .models.nerf import NeRF, NeRFConfig
from .models.r2l import R2L, R2LConfig
from .rays import get_rays, ndc_rays, plucker
from .render import ChunkDraws, VolRenderConfig, draw_chunk, render_rays_nerf
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


def _patch_dims(H: int, W: int, n: int) -> tuple[int, int]:
    """Aspect-matched patch dimensions covering >= n pixels: the
    reference's rand_patch sizes the patch [H*k, W*k] with k = sqrt(n/(H*W))
    (<= n pixels); the width is rounded up, and a step takes the first n
    row-major pixels of the patch."""
    if n > H * W:
        raise ValueError(f"N_rand {n} exceeds image pixels {H * W}")
    k = math.sqrt(n / (H * W))
    ph = max(1, min(H, int(H * k)))
    pw = max(1, min(W, math.ceil(n / ph)))
    if ph * pw < n:                     # pw hit W: grow the height
        ph = min(H, math.ceil(n / pw))
    return ph, pw


class _Box(NamedTuple):
    """A step's pixel box (the precrop's central crop, or the image):
    top-left (hs, ws) and size (hn, wn)."""
    hs: int
    ws: int
    hn: int
    wn: int


def _precrop_box(H: int, W: int, dH: int, dW: int, crop: bool) -> _Box:
    """The central 2dH x 2dW crop while ``crop``, else the whole image."""
    if crop:
        return _Box(H // 2 - dH, W // 2 - dW, 2 * dH, 2 * dW)
    return _Box(0, 0, H, W)


def _pixel_coords(u: torch.Tensor, box: _Box, H: int, W: int, n: int,
                  mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) [n] of a step's pixels from its uniform draws ``u``:
    ``rand_pixel``, u [n, 2]: each pixel uniform in the box; ``rand_patch``,
    u [2]: a patch origin uniform in the box, then the first n row-major
    pixels of the ``_patch_dims`` patch (``_patch_coords`` of the JAX
    package). The f32 products are truncated toward zero, as JAX's
    ``astype(int32)``."""
    i32 = torch.int32
    if mode == "rand_patch":
        ph, pw = _patch_dims(H, W, n)
        h0 = (box.hs + (u[0] * max(box.hn - ph, 1)).to(i32)).clamp(0, H - ph)
        w0 = (box.ws + (u[1] * max(box.wn - pw, 1)).to(i32)).clamp(0, W - pw)
        flat = torch.arange(n, dtype=i32, device=u.device)
        return ((h0 + flat // pw).clamp(0, H - 1),
                (w0 + flat % pw).clamp(0, W - 1))
    return ((box.hs + (u[:, 0] * box.hn).to(i32)).clamp(0, H - 1),
            (box.ws + (u[:, 1] * box.wn).to(i32)).clamp(0, W - 1))


def draw_pixels(n: int, mode: str, generator: torch.Generator
                ) -> torch.Tensor:
    """A step's pixel draws: u [n, 2] (``rand_pixel``) or [2]
    (``rand_patch``)."""
    return torch.rand((2,) if mode == "rand_patch" else (n, 2),
                      generator=generator, device=generator.device)


def _image_batch(image: torch.Tensor, c2w, H: int, W: int, focal: float,
                 hh: torch.Tensor, ww: torch.Tensor, ndc: bool = False
                 ) -> torch.Tensor:
    """[n, 9] records (o, d, rgb) of pixels (hh, ww) of ``image`` [H, W, 3]
    seen from pose ``c2w``, rays NDC-warped when ``ndc``."""
    rays_o, rays_d = get_rays(H, W, focal, c2w, device=image.device)
    if ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    hh, ww = hh.long(), ww.long()
    return torch.cat([rays_o[hh, ww], rays_d[hh, ww],
                      image[hh, ww].float()], dim=-1)


class TrainState(NamedTuple):
    params: R2L                      # updated in place
    optimizer: torch.optim.Adam      # updated in place
    step: int                        # updates made so far
    pool: HardPool
    # the learning-rate schedule's count (optax's opt_state[1].count): the
    # step's but for a resume that restores the step and not the optimizer
    lr_count: int = 0


class StepDraws(NamedTuple):
    """The random draws of one step: the hard-pool draws (None without
    hard mining) and the depth jitter ``z_u`` [batch, n_sample] (None
    without perturbation)."""
    hard: HardDraws | None
    z_u: torch.Tensor | None


class ImageStepDraws(NamedTuple):
    """The random draws of one images-mode step: the pixels' (``u_pix``,
    see ``draw_pixels``), then the rays-mode step's on them (``core``)."""
    u_pix: torch.Tensor
    core: StepDraws


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
    return TrainState(model, opt, state.step, pool, state.lr_count)


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
        group["lr"] = schedule(state.lr_count)
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
    return state._replace(step=state.step + 1, lr_count=state.lr_count + 1,
                          pool=pool), metrics


def make_distill_step(cfg: R2LConfig, dcfg: DistillConfig,
                      sampler: PointSampler, fused_vjp: bool = False,
                      fused_group_blocks: int = 4, scan_steps: int = 1,
                      fused_quantize: str = "",
                      fused_calib_pts: torch.Tensor | None = None,
                      fused_stash_q: bool = True,
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
    (needs ``fused_calib_pts``), stashing int8 q-values, or with
    ``fused_stash_q=False`` bf16 dequantized activations;
    ``fused_calib_every=N > 1`` with k > 1 recalibrates at the call's entry
    and then when ``step % N == 0``.
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
            calib_pts=fused_calib_pts, stash_q=fused_stash_q,
            external_calib=external)
        if external:
            fused_apply, fused_calibrate = built
        else:
            fused_apply = built
    schedule = make_lr_schedule(dcfg.lrate, dcfg.lrate_decay, dcfg.warmup_lr)
    n_fresh = dcfg.batch_size - dcfg.n_hard_out
    calib: dict = {}    # a k-step call's int8 parameters and its entry step

    def enter(state):
        calib.update(fp=fused_calibrate(state.params), entry=state.step)

    def one(state, fresh, draws):
        fresh = torch.as_tensor(fresh, dtype=torch.float32, device=device)
        apply = fused_apply
        if fused_calibrate is not None:
            if (state.step % fused_calib_every == 0
                    and state.step != calib["entry"]):
                calib["fp"] = fused_calibrate(state.params)
            fp = calib["fp"]
            apply = lambda m, x: fused_apply(m, x, fp)  # noqa: E731
        return _distill_core(state, fresh, draws, cfg, dcfg, sampler,
                             schedule, n_fresh, apply)

    return _maybe_scan(
        one, scan_steps, "distill",
        lambda g, args: draw_step(dcfg, sampler.n_sample, g), device,
        enter=enter if fused_calibrate is not None else None)


_SCAN_ARGS = {
    "distill": lambda a, j, stride: (a[0][j],),
    "distill_images": lambda a, j, stride: (a[0][j], a[1][j]),
    "teacher_images": lambda a, j, stride: a,
    "teacher_batched": lambda a, j, stride: (a[0], a[1] + j * stride),
}


def _maybe_scan(one, n: int, mode: str, draw, device: torch.device,
                stride: int = 0, enter=None):
    """The step ``step(state, *args, generator=None, draws=None) -> (state,
    metrics)`` that runs ``one(state, *args, draws)``, or, when ``n > 1``, a
    plain loop of n such steps per call, metrics stacked [n]. ``mode`` says
    how the call's arguments give each step's, as in JAX's ``_maybe_scan``:
    ``distill`` (batches [n, ...]), ``distill_images`` (images and poses
    [n, ...]), ``teacher_images`` (the same images and poses each step),
    ``teacher_batched`` (the offset advances by ``stride`` each step). A
    step's draws are ``draws`` (``draws[j]`` in a loop) when given, else
    ``draw(generator, step_args)``, from ``generator`` or from the step's
    own generator on ``device`` (seeded with 0 at its first use).
    ``enter(state)`` runs at the start of each k-step call."""
    gens: list[torch.Generator] = []

    def draws_for(generator, draws, args):
        if draws is not None:
            return draws
        if generator is None:
            if not gens:
                gens.append(torch.Generator(device).manual_seed(0))
            generator = gens[0]
        return draw(generator, args)

    if n <= 1:
        def step(state, *args, generator=None, draws=None):
            return one(state, *args, draws_for(generator, draws, args))
        return step

    def scan(state, *args, generator=None, draws=None):
        if enter is not None:
            enter(state)
        ms = []
        for j in range(n):
            a = _SCAN_ARGS[mode](args, j, stride)
            state, m = one(state, *a, draws_for(
                generator, None if draws is None else draws[j], a))
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return scan


def make_distill_step_images(cfg: R2LConfig, dcfg: DistillConfig,
                             sampler: PointSampler, H: int, W: int,
                             focal: float, precrop_iters: int = 0,
                             precrop_frac: float = 0.5,
                             select_pixel_mode: str = "rand_pixel",
                             scan_steps: int = 1,
                             device: torch.device | str = torch.device(
                                 "cuda")):
    """The distillation step of the images data mode: one (image [H, W, 3],
    pose [3, 4]) per step; ``batch_size - n_hard_out`` pixels are chosen on
    the device (the central ``precrop_frac`` crop for the first
    ``precrop_iters`` steps; ``rand_pixel``, or ``rand_patch``: one patch),
    their raw camera rays made with ``get_rays`` (the student takes raw rays
    even for LLFF), and the rays-mode step (``_distill_core``: hard pool,
    loss, Adam, pool update) runs on them.

    ``scan_steps == 1``: ``step(state, image, pose, generator=None,
    draws=None) -> (state, metrics)``; ``scan_steps = k > 1``: ``step(state,
    images [k, H, W, 3], poses [k, 3, 4], generator=None, draws=None)``, the
    same as k single steps. ``draws`` (an ``ImageStepDraws``, or a list of
    k) are the steps' random draws; without them they come from
    ``generator``, or from the step's own generator on ``device``.
    """
    device = torch.device(device)
    schedule = make_lr_schedule(dcfg.lrate, dcfg.lrate_decay, dcfg.warmup_lr)
    n_fresh = dcfg.batch_size - dcfg.n_hard_out
    dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)

    def draw(g, args) -> ImageStepDraws:
        return ImageStepDraws(draw_pixels(n_fresh, select_pixel_mode, g),
                              draw_step(dcfg, sampler.n_sample, g))

    def one(state, image, pose, draws: ImageStepDraws):
        image = torch.as_tensor(image, dtype=torch.float32, device=device)
        box = _precrop_box(H, W, dH, dW, state.step < precrop_iters)
        hh, ww = _pixel_coords(draws.u_pix.to(device), box, H, W, n_fresh,
                               select_pixel_mode)
        fresh = _image_batch(image, pose, H, W, focal, hh, ww)
        return _distill_core(state, fresh, draws.core, cfg, dcfg, sampler,
                             schedule, n_fresh)

    return _maybe_scan(one, scan_steps, "distill_images", draw, device)


# ---------------------------------------------------------------------------
# NeRF teacher training (r2l_tpu/train.py:471-638)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TeacherTrainConfig:
    n_rand: int = 1024               # rays per step (--N_rand for nerf)
    lrate: float = 5e-4
    lrate_decay: int = 250
    warmup_lr: str | None = None     # 'start,end_iter'
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    select_pixel_mode: str = "rand_pixel"  # or 'rand_patch'


class TeacherState(NamedTuple):
    model_c: NeRF                    # updated in place
    model_f: NeRF | None             # None without a fine network
    optimizer: torch.optim.Adam      # over both networks, updated in place
    step: int                        # updates made so far
    lr_count: int = 0                # the schedule's count (``TrainState``)


class TeacherStepDraws(NamedTuple):
    """The random draws of one teacher step: the training image's index
    (0-d long; None in the batched mode), the pixels' (``draw_pixels``;
    None in the batched mode) and the render's (``ChunkDraws`` of the
    step's rays)."""
    img_i: torch.Tensor | None
    u_pix: torch.Tensor | None
    render: ChunkDraws


def _teacher_params(model_c: NeRF, model_f: NeRF | None) -> list:
    return list(model_c.parameters()) + (
        list(model_f.parameters()) if model_f is not None else [])


def init_teacher_state(model_c: NeRF, model_f: NeRF | None,
                       tcfg: TeacherTrainConfig) -> TeacherState:
    """A fresh teacher state: Adam (optax's betas and eps) over the coarse
    and the fine network's parameters, step 0."""
    return TeacherState(model_c, model_f,
                        make_optimizer(_teacher_params(model_c, model_f),
                                       tcfg.lrate), 0)


def _teacher_update(state: TeacherState, ncfg: NeRFConfig,
                    vcfg: VolRenderConfig, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, target: torch.Tensor,
                    draws: ChunkDraws, schedule, ncfg_fine
                    ) -> tuple[TeacherState, dict]:
    """One update on a ray batch: the volumetric render, loss = fine MSE +
    coarse MSE, backward, Adam at the schedule's rate for the count before
    this update. PSNR is the fine MSE's alone (the reference's log)."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    out = render_rays_nerf(state.model_c, state.model_f, ncfg, vcfg, rays_o,
                           rays_d, draws, ncfg_fine=ncfg_fine)
    loss_rgb = torch.mean((out.rgb_map - target) ** 2)
    loss = loss_rgb
    if out.rgb0 is not None:
        loss = loss + torch.mean((out.rgb0 - target) ** 2)
    loss.backward()
    for group in opt.param_groups:
        group["lr"] = schedule(state.lr_count)
    opt.step()
    loss_rgb = loss_rgb.detach()
    return state._replace(step=state.step + 1,
                          lr_count=state.lr_count + 1), {
        "loss": loss.detach(),
        "psnr": -10.0 * torch.log10(torch.clamp(loss_rgb, min=1e-12))}


def make_teacher_step(ncfg: NeRFConfig, vcfg: VolRenderConfig,
                      tcfg: TeacherTrainConfig, H: int, W: int, focal: float,
                      ncfg_fine: NeRFConfig | None = None, ndc: bool = False,
                      scan_steps: int = 1,
                      device: torch.device | str = torch.device("cuda")):
    """The teacher step over training images (``no_batching``, the lego
    default): a random image, ``n_rand`` of its pixels (the central
    ``precrop_frac`` crop for the first ``precrop_iters`` steps;
    ``rand_pixel`` or one ``rand_patch``), their rays (NDC-warped with
    ``ndc``, LLFF), the volumetric render of both networks, MSE of the fine
    and the coarse pass, Adam.

    ``step(state, images [N, H, W, 3], poses [N, 3|4, 4], generator=None,
    draws=None) -> (state, metrics)``; with ``scan_steps = k > 1`` k such
    steps, metrics stacked [k]. ``draws`` (a ``TeacherStepDraws``, or a list
    of k) are the steps' random draws; without them they come from
    ``generator``, or from the step's own generator on ``device``. Images
    and poses should live on ``device``: a copy from the host each step
    makes the host wait for the card.
    """
    device = torch.device(device)
    schedule = make_lr_schedule(tcfg.lrate, tcfg.lrate_decay, tcfg.warmup_lr)
    n, mode = tcfg.n_rand, tcfg.select_pixel_mode
    fH, fW = int(H * tcfg.precrop_frac / 2), int(W * tcfg.precrop_frac / 2)

    def draw(g, args) -> TeacherStepDraws:
        return TeacherStepDraws(
            torch.randint(0, len(args[0]), (1,), generator=g,
                          device=g.device),
            draw_pixels(n, mode, g), draw_chunk(vcfg, n, g))

    def one(state, images, poses, draws: TeacherStepDraws):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
        idx = torch.as_tensor(draws.img_i, device=device).reshape(1)
        target_img = images.index_select(0, idx)[0]
        c2w = poses.index_select(0, idx)[0]
        box = _precrop_box(H, W, fH, fW, state.step < tcfg.precrop_iters)
        hh, ww = _pixel_coords(draws.u_pix.to(device), box, H, W, n, mode)
        batch = _image_batch(target_img, c2w, H, W, focal, hh, ww, ndc)
        return _teacher_update(state, ncfg, vcfg, batch[:, 0:3],
                               batch[:, 3:6], batch[:, 6:9], draws.render,
                               schedule, ncfg_fine)

    return _maybe_scan(one, scan_steps, "teacher_images", draw, device)


def make_teacher_step_batched(ncfg: NeRFConfig, vcfg: VolRenderConfig,
                              tcfg: TeacherTrainConfig,
                              ncfg_fine: NeRFConfig | None = None,
                              scan_steps: int = 1,
                              device: torch.device | str = torch.device(
                                  "cuda")):
    """The teacher step over a pre-shuffled ray pool (``use_batching``, the
    LLFF default): each step renders the ``n_rand`` records [o, d, rgb] of
    ``ray_pool`` [N, 9] at ``offset`` (clamped so that the slice fits, as
    ``dynamic_slice``); the caller advances the offset and reshuffles the
    pool at the end of an epoch.

    ``step(state, ray_pool, offset, generator=None, draws=None) -> (state,
    metrics)``; with ``scan_steps = k > 1`` k steps at offsets ``offset +
    j * n_rand``, metrics stacked [k]. ``draws``: a ``TeacherStepDraws``
    (only ``render`` is read), or a list of k.
    """
    device = torch.device(device)
    schedule = make_lr_schedule(tcfg.lrate, tcfg.lrate_decay, tcfg.warmup_lr)
    n = tcfg.n_rand

    def draw(g, args) -> TeacherStepDraws:
        return TeacherStepDraws(None, None, draw_chunk(vcfg, n, g))

    def one(state, ray_pool, offset: int, draws: TeacherStepDraws):
        pool = torch.as_tensor(ray_pool, dtype=torch.float32, device=device)
        start = min(max(int(offset), 0), pool.shape[0] - n)
        batch = pool[start:start + n]
        return _teacher_update(state, ncfg, vcfg, batch[:, 0:3],
                               batch[:, 3:6], batch[:, 6:9], draws.render,
                               schedule, ncfg_fine)

    return _maybe_scan(one, scan_steps, "teacher_batched", draw, device,
                       stride=n)


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
