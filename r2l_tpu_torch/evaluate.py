"""Frame paths: pose -> [H, W, 3] frame, for the R2L student and the NeRF
teacher.

Counterpart of ``r2l_tpu/evaluate.py`` (``_r2l_net_fn`` :52,
``_prepare_r2l`` :221, ``make_r2l_frame_fn`` :345, ``make_r2l_bench_fn``
:444, ``make_nerf_frame_fn`` :499). The student's kinds are the JAX ones:

* ``jnp``: the plain ``R2L`` module over ``r2l_embed`` (eager PyTorch);
* ``pe``: the PE-fused kernel ``fused_r2l_apply_pe``;
* ``int8``: the static-scale int8 kernel ``fused_r2l_apply_int8_pe``.

Everything runs on the device of the model's parameters. The TPU-only parts
are not ported: the VMEM tile-fit model and the mesh sharding of rays.
``pallas_tile`` is accepted so that the CLI flags carry over, and ignored:
the CUDA kernels choose their own ray tile.

The teacher's frame (``make_nerf_frame_fn``, the ``--test_teacher`` path)
renders through the fused volumetric kernel on the card, else through the
plain volumetric path.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

from .encoding import r2l_embed
from .kernels.r2l_fused import (calibrate_r2l_int8_pe,
                                fused_kernel_supported,
                                fused_r2l_apply_int8_pe, fused_r2l_apply_pe,
                                prepare_fused_params_pe)
from .models.nerf import NeRF, NeRFConfig
from .models.r2l import R2L, R2LConfig
from .rays import ndc_rays, pose_spherical
from .render import (VolRenderConfig, prepare_fused_teacher,
                     render_frame_nerf, render_frame_nerf_fused)
from .sampler import PointSampler


def _r2l_net_fn(cfg: R2LConfig, embed_L: int, kind: str,
                dim_pts: int) -> Callable:
    """The per-ray-batch forward of a prepared ``kind``: (prepared params,
    pts [n, dim_pts]) -> rgb [n, >=3]."""
    def net(p, pts: torch.Tensor) -> torch.Tensor:
        if kind == "int8":
            return fused_r2l_apply_int8_pe(p, cfg, pts, dim_pts, embed_L)
        if kind == "pe":
            return fused_r2l_apply_pe(p, cfg, pts, dim_pts, embed_L)
        return p(r2l_embed(pts, embed_L))
    return net


def _model_device(model: R2L) -> torch.device:
    return next(model.parameters()).device


def _as_f32(x, device: torch.device) -> torch.Tensor:
    """A pose (or stack of poses) given as a tensor or an array, on
    ``device``; arrays are read as f32."""
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, device=device)


def _calibration_points(sampler: PointSampler, calib_poses,
                        device: torch.device) -> torch.Tensor:
    """int8 calibration points: ``sample_test`` at 1/8 resolution on up to
    8 of the deployment poses (linspace pick), or on blender-convention
    radius-4 spherical cameras when none are given."""
    sub = PointSampler(H=max(sampler.H // 8, 4), W=max(sampler.W // 8, 4),
                       focal=sampler.focal / 8.0, n_sample=sampler.n_sample,
                       near=sampler.near, far=sampler.far)
    if calib_poses is not None and len(calib_poses) > 0:
        arr = np.asarray(calib_poses)
        pick = np.linspace(0, len(arr) - 1, min(len(arr), 8)).astype(int)
        poses = [arr[i][:3, :4] for i in pick]
    else:
        print("WARNING: int8 calibration falling back to blender-"
              "convention radius-4 spherical cameras (no calib_poses "
              "given) — pass the scene's poses for other layouts.",
              file=sys.stderr)
        poses = [pose_spherical(t, p, 4.0)[:3, :4]
                 for t in (0.0, 90.0, 180.0, 270.0)
                 for p in (-10.0, -70.0)]
    return torch.cat([
        sub.sample_test(_as_f32(p, device)) for p in poses])


def _prepare_r2l(model: R2L, cfg: R2LConfig, sampler: PointSampler,
                 embed_L: int, plucker: bool, use_pallas: bool,
                 quantize: str, calib_poses=None):
    """Pick the path for the flags and pack the parameters for it.
    Returns (prepared, kind, dim_pts).

    The rules are the JAX ones: non-canonical activations go to the plain
    module; int8 with Plücker inputs falls back to ``pe``; int8 with
    ``use_pallas=False`` goes to the plain module. ``calib_poses``
    [M, 3/4, 4] are the deployment poses int8 calibrates on."""
    if not fused_kernel_supported(cfg):
        use_pallas = False
        quantize = ""
    dim_pts = 6 if plucker else cfg.input_dim // (2 * embed_L + 1)
    if quantize == "int8" and plucker:
        print("WARNING: --quantize int8 is not implemented for Plücker "
              "inputs (the static-scale calibration assumes the sampled-"
              "points PE layout) — falling back to "
              + ("the bf16 PE-fused kernel." if use_pallas
                 else "the plain XLA forward."), file=sys.stderr)
    if quantize == "int8" and not use_pallas:
        print("WARNING: --quantize int8 requires the Pallas kernel; "
              "--use_pallas 0 was given — rendering with the plain XLA "
              "forward instead.", file=sys.stderr)
        quantize = ""
    if quantize == "int8" and not plucker:
        calib_pts = _calibration_points(sampler, calib_poses,
                                        _model_device(model))
        prepared = calibrate_r2l_int8_pe(model, cfg, dim_pts, embed_L,
                                         calib_pts=calib_pts,
                                         fold_requant=True)
        return prepared, "int8", dim_pts
    if use_pallas:
        wd = (torch.bfloat16 if cfg.compute_dtype == torch.bfloat16
              else torch.float32)
        prepared = prepare_fused_params_pe(model, cfg, dim_pts, embed_L,
                                           weight_dtype=wd)
        return prepared, "pe", dim_pts
    return model, "jnp", dim_pts


def _frame(net: Callable, prepared, sampler: PointSampler, plucker: bool,
           c2w: torch.Tensor) -> torch.Tensor:
    pts = (sampler.sample_test_plucker(c2w) if plucker
           else sampler.sample_test(c2w))
    # learn_depth models emit 4 channels; frames keep RGB
    return net(prepared, pts)[:, :3].reshape(sampler.H, sampler.W, 3)


def make_r2l_frame_fn(model: R2L, cfg: R2LConfig, sampler: PointSampler,
                      embed_L: int = 10, plucker: bool = False,
                      use_pallas: bool = True, pallas_tile: int = 512,
                      quantize: str = "", calib_poses=None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """c2w [3/4, 4] (tensor or array) -> frame [H, W, 3] f32 on the model's
    device. The returned function carries ``.kind`` (the chosen path)."""
    prepared, kind, dim_pts = _prepare_r2l(
        model, cfg, sampler, embed_L, plucker, use_pallas, quantize,
        calib_poses=calib_poses)
    net = _r2l_net_fn(cfg, embed_L, kind, dim_pts)
    device = _model_device(model)

    @torch.no_grad()
    def frame_fn(c2w) -> torch.Tensor:
        return _frame(net, prepared, sampler, plucker, _as_f32(c2w, device))

    frame_fn.kind = kind
    return frame_fn


def make_r2l_bench_fn(model: R2L, cfg: R2LConfig, sampler: PointSampler,
                      embed_L: int = 10, plucker: bool = False,
                      use_pallas: bool = True, pallas_tile: int = 512,
                      quantize: str = "", calib_poses=None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """poses [K, 3/4, 4] -> scalar checksum (sum of every pixel of the K
    frames), rendered one after another with no host synchronisation: the
    caller times the call with CUDA events or a synchronise. The returned
    function carries ``.kind``."""
    prepared, kind, dim_pts = _prepare_r2l(
        model, cfg, sampler, embed_L, plucker, use_pallas, quantize,
        calib_poses=calib_poses)
    net = _r2l_net_fn(cfg, embed_L, kind, dim_pts)
    device = _model_device(model)

    @torch.no_grad()
    def bench_fn(poses) -> torch.Tensor:
        poses = _as_f32(poses, device)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for c2w in poses:
            total += _frame(net, prepared, sampler, plucker, c2w).sum()
        return total

    bench_fn.kind = kind
    return bench_fn


def make_nerf_frame_fn(model_c: NeRF, model_f: NeRF | None,
                       ncfg: NeRFConfig, vcfg: VolRenderConfig,
                       sampler: PointSampler,
                       ndc_params: tuple | None = None,
                       use_pallas: bool = False,
                       ncfg_fine: NeRFConfig | None = None,
                       perturb_test: bool = False, with_disp: bool = False,
                       device: torch.device | str = torch.device("cuda")
                       ) -> Callable:
    """c2w [3/4, 4] (tensor or array) -> frame [H, W, 3] f32 through the
    volumetric teacher on ``device`` (the card unless told otherwise; the
    models must be there). ``ndc_params = (H, W, focal)`` turns on the LLFF
    NDC warp. With ``use_pallas`` on a CUDA device (and the positional
    encoding on) each pass runs through the fused kernel, packed once here.

    ``perturb_test`` jitters the depths with the sigma noise off (the
    reference's test kwargs); the draws come from a generator seeded from
    the pose's bits, so a frame is deterministic per pose (the role of the
    JAX package's key, not its numbers). ``with_disp`` returns (rgb,
    disp [H, W]). The function carries ``.kind``: 'fused' or 'plain'."""
    device = torch.device(device)
    if _model_device(model_c) != device:
        raise ValueError(f"the teacher is on {_model_device(model_c)}, "
                         f"expected {device}")
    vcfg_t = dataclasses.replace(vcfg, perturb=perturb_test,
                                 raw_noise_std=0.0)
    model_f = model_f if model_f else None
    fused = bool(use_pallas and device.type == "cuda" and vcfg.multires > 0)
    packed = (prepare_fused_teacher(model_c, model_f, ncfg, vcfg_t,
                                    ncfg_fine) if fused else None)

    @torch.no_grad()
    def frame_fn(c2w):
        c2w = _as_f32(c2w, device)
        rays_o, rays_d = sampler.frame_rays(c2w)
        if ndc_params is not None:
            h, w, f = ndc_params
            rays_o, rays_d = ndc_rays(h, w, f, 1.0, rays_o, rays_d)
        gen = None
        if perturb_test:
            bits = int(c2w.contiguous().view(torch.int32).sum())
            gen = torch.Generator(device).manual_seed(bits & 0xFFFFFFFF)
        kw = dict(generator=gen, ncfg_fine=ncfg_fine)
        if fused:
            out = render_frame_nerf_fused(model_c, model_f, ncfg, vcfg_t,
                                          rays_o, rays_d, packed=packed,
                                          **kw)
        else:
            out = render_frame_nerf(model_c, model_f, ncfg, vcfg_t, rays_o,
                                    rays_d, **kw)
        rgb = out["rgb"].reshape(sampler.H, sampler.W, 3)
        if with_disp:
            return rgb, out["disp"].reshape(sampler.H, sampler.W)
        return rgb

    frame_fn.kind = "fused" if fused else "plain"
    return frame_fn
