"""Frame paths and evaluation: pose (or given rays) -> [H, W, 3] frame, for
the R2L student and the NeRF teacher, and the eval loop over a pose list.

Counterpart of ``r2l_tpu/evaluate.py`` (``to8b`` :31, ``EvalResult`` :36,
``_r2l_net_fn`` :52, ``_prepare_r2l`` :221, ``make_r2l_frame_fn`` :345,
``_givenrays_calib_pts`` :363, ``make_r2l_givenrays_frame_fn`` :378,
``make_r2l_givenrays_bench_fn`` :413, ``make_r2l_bench_fn`` :444,
``make_nerf_bench_fn`` :473, ``make_nerf_frame_fn`` :499, ``render_path``
:586, ``load_given_render_path_rays`` :716, ``render_path_given_rays`` :733,
``write_video`` :776). The student's kinds are the JAX ones:

* ``jnp``: the plain ``R2L`` module over ``r2l_embed`` (eager PyTorch);
* ``pe``: the PE-fused kernel ``fused_r2l_apply_pe``;
* ``int8``: the static-scale int8 kernel ``fused_r2l_apply_int8_pe``.

Everything runs on the device of the model's parameters. The TPU-only parts
are not ported: the VMEM tile-fit model and the mesh sharding of rays.
``pallas_tile`` is accepted so that the CLI flags carry over, and ignored:
the CUDA kernels choose their own ray tile.

The teacher's frame (``make_nerf_frame_fn``, the ``--test_teacher`` path)
and its benchmark (``make_nerf_bench_fn``) render through the fused
volumetric kernel on the card, else through the plain volumetric path.

``render_path`` writes 8-bit RGB PNGs with a writer of its own
(``write_png``: ``zlib`` and ``struct``), so evaluation needs no image
package; ``write_video`` uses ``imageio`` where it is installed.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import sys
import time
import zlib
from typing import Callable, Sequence

import numpy as np
import torch

from . import metrics as M
from .encoding import r2l_embed
from .flip import flip as flip_metric
from .kernels.r2l_fused import (calibrate_r2l_int8_pe,
                                fused_kernel_supported,
                                fused_r2l_apply_int8_pe, fused_r2l_apply_pe,
                                prepare_fused_params_pe)
from .lpips import lpips, minmax_rescale
from .models.nerf import NeRF, NeRFConfig
from .models.r2l import R2L, R2LConfig
from .rays import ndc_rays, plucker as plucker_fn, pose_spherical
from .render import (VolRenderConfig, prepare_fused_teacher,
                     render_frame_nerf, render_frame_nerf_fused)
from .sampler import PointSampler


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


@dataclasses.dataclass
class EvalResult:
    frames: np.ndarray               # [N, H, W, 3] float32
    test_psnr: float | None = None
    test_psnr_v2: float | None = None
    test_ssim: float | None = None
    test_lpips: float | None = None
    test_flip: float | None = None
    per_frame_psnr: list[float] = dataclasses.field(default_factory=list)
    ms_per_frame: float | None = None
    disp_frames: np.ndarray | None = None  # [N, H, W] when the frame
    #                                        function returns (rgb, disp)


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
    """A tensor or an array (poses, rays) as an f32 tensor on ``device``,
    copied once at most."""
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _checksum(frames, device: torch.device) -> torch.Tensor:
    """The sum of every pixel of ``frames`` (an iterable of tensors), added
    up on ``device`` with no host synchronisation: the caller times the
    call with CUDA events or a synchronise."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for f in frames:
        total += f.sum()
    return total


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
                 quantize: str, calib_poses=None, calib_pts=None):
    """Pick the path for the flags and pack the parameters for it.
    Returns (prepared, kind, dim_pts): a frame function's ``.parts``, which
    a bench function takes to reuse the packing.

    The rules are the JAX ones: non-canonical activations go to the plain
    module; int8 with Plücker inputs falls back to ``pe``; int8 with
    ``use_pallas=False`` goes to the plain module. ``calib_poses``
    [M, 3/4, 4] are the deployment poses int8 calibrates on;
    ``calib_pts`` [M, dim_pts] (sample points, tensor or array) win over
    them (the given-rays path calibrates on its own rays)."""
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
        device = _model_device(model)
        calib_pts = (_as_f32(calib_pts, device) if calib_pts is not None
                     else _calibration_points(sampler, calib_poses, device))
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


def _givenrays_calib_pts(sampler: PointSampler, plucker: bool,
                         quantize: str, calib_rays,
                         device: torch.device) -> torch.Tensor | None:
    """int8 calibration points on ``device``: ``sample_train`` with the even
    depths on a linspace pick of at most 16,384 of the deployment rays
    ``calib_rays = (rays_o, rays_d)`` (tensors or arrays, [..., 3]; the pick
    is made where they lie, so only the picked rays are copied), or None
    where the path does not calibrate: not int8, Plücker inputs, no rays."""
    if quantize != "int8" or plucker or calib_rays is None:
        return None
    ro, rd = (r.reshape(-1, 3) if torch.is_tensor(r)
              else np.asarray(r, np.float32).reshape(-1, 3)
              for r in calib_rays)
    pick = np.linspace(0, ro.shape[0] - 1,
                       min(ro.shape[0], 16384)).astype(int)
    if torch.is_tensor(ro):
        pick = torch.from_numpy(pick).to(ro.device)
    return sampler.sample_train(_as_f32(ro[pick], device),
                                _as_f32(rd[pick], device))


def _givenrays_frame(net: Callable, prepared, sampler: PointSampler,
                     plucker: bool, H: int, W: int, rays_o: torch.Tensor,
                     rays_d: torch.Tensor) -> torch.Tensor:
    pts = (plucker_fn(rays_o, rays_d) if plucker
           else sampler.sample_train(rays_o, rays_d))
    return net(prepared, pts)[:, :3].reshape(H, W, 3)


def make_r2l_givenrays_frame_fn(model: R2L, cfg: R2LConfig,
                                sampler: PointSampler, H: int, W: int,
                                embed_L: int = 10, plucker: bool = False,
                                use_pallas: bool = True,
                                pallas_tile: int = 512, quantize: str = "",
                                calib_rays=None) -> Callable:
    """(rays_o [H*W, 3], rays_d [H*W, 3]) -> frame [H, W, 3] f32 on the
    model's device, for the DONeRF given-rays path, through the same kinds
    as ``make_r2l_frame_fn``: the points are the rays' Plücker coordinates
    or ``sample_train`` with the even depths (on a pose's own rays, the
    points of ``sample_test``). The rays are tensors or arrays, each copied
    once to the device.

    ``calib_rays = (rays_o, rays_d)`` span the deployment rays; int8
    calibrates on a subsample of them (``_givenrays_calib_pts``). The
    function carries ``.kind`` and ``.parts``, which
    ``make_r2l_givenrays_bench_fn(parts=...)`` takes to reuse the packing
    and calibration."""
    device = _model_device(model)
    parts = _prepare_r2l(
        model, cfg, sampler, embed_L, plucker, use_pallas, quantize,
        calib_pts=_givenrays_calib_pts(sampler, plucker, quantize,
                                       calib_rays, device))
    prepared, kind, dim_pts = parts
    net = _r2l_net_fn(cfg, embed_L, kind, dim_pts)

    @torch.no_grad()
    def frame_fn(rays_o, rays_d) -> torch.Tensor:
        return _givenrays_frame(net, prepared, sampler, plucker, H, W,
                                _as_f32(rays_o, device).reshape(-1, 3),
                                _as_f32(rays_d, device).reshape(-1, 3))

    frame_fn.kind, frame_fn.parts = kind, parts
    return frame_fn


def make_r2l_givenrays_bench_fn(model: R2L, cfg: R2LConfig,
                                sampler: PointSampler, H: int, W: int,
                                embed_L: int = 10, plucker: bool = False,
                                use_pallas: bool = True,
                                pallas_tile: int = 512, quantize: str = "",
                                calib_rays=None, parts=None) -> Callable:
    """(rays_o [K, H*W, 3], rays_d [K, H*W, 3]) -> scalar checksum of the K
    given-rays frames, rendered one after another with no host
    synchronisation (``make_r2l_bench_fn``'s protocol). ``parts`` (a frame
    function's ``.parts``) reuses its packing: no second calibration. The
    function carries ``.kind``."""
    device = _model_device(model)
    if parts is None:
        parts = _prepare_r2l(
            model, cfg, sampler, embed_L, plucker, use_pallas, quantize,
            calib_pts=_givenrays_calib_pts(sampler, plucker, quantize,
                                           calib_rays, device))
    prepared, kind, dim_pts = parts
    net = _r2l_net_fn(cfg, embed_L, kind, dim_pts)

    @torch.no_grad()
    def bench_fn(ros, rds) -> torch.Tensor:
        ros, rds = _as_f32(ros, device), _as_f32(rds, device)
        return _checksum((_givenrays_frame(net, prepared, sampler, plucker,
                                           H, W, ro, rd)
                          for ro, rd in zip(ros, rds)), device)

    bench_fn.kind = kind
    return bench_fn


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
        return _checksum((_frame(net, prepared, sampler, plucker, c2w)
                          for c2w in _as_f32(poses, device)), device)

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


def make_nerf_bench_fn(model_c: NeRF, model_f: NeRF | None,
                       ncfg: NeRFConfig, vcfg: VolRenderConfig,
                       sampler: PointSampler,
                       ndc_params: tuple | None = None,
                       use_pallas: bool = False,
                       ncfg_fine: NeRFConfig | None = None,
                       perturb_test: bool = False,
                       device: torch.device | str = torch.device("cuda")
                       ) -> Callable:
    """The teacher's benchmark (``--benchmark --model_name nerf``): poses
    [K, 3/4, 4] -> scalar checksum of the K volumetric frames, rendered one
    after another with no host synchronisation (with ``perturb_test`` each
    frame seeds its draws from the pose's bits, read on the host). The
    frames are ``make_nerf_frame_fn``'s: the same device rule (the card
    unless told otherwise; the models must be there), and the fused kernel
    on a CUDA device with ``use_pallas`` and the positional encoding on,
    packed once here. The function carries ``.kind``."""
    frame = make_nerf_frame_fn(model_c, model_f, ncfg, vcfg, sampler,
                               ndc_params, use_pallas, ncfg_fine,
                               perturb_test, device=device)
    device = torch.device(device)

    @torch.no_grad()
    def bench_fn(poses) -> torch.Tensor:
        return _checksum((frame(c2w) for c2w in _as_f32(poses, device)),
                         device)

    bench_fn.kind = frame.kind
    return bench_fn


def write_png(path: str, img: np.ndarray) -> None:
    """``img`` [H, W, 3] uint8 as an 8-bit RGB PNG, written with the
    standard library alone (``zlib``, ``struct``), so evaluation needs no
    image package."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    # each scanline: filter type 0 (none), then its bytes
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def _mean_of(vals: list[torch.Tensor]) -> float:
    """The mean of per-frame scalars, read back in one copy."""
    return float(np.mean(torch.stack(vals).tolist()))


def render_path(frame_fn: Callable, poses: Sequence,
                gt_images: np.ndarray | None = None,
                savedir: str | None = None,
                lpips_params: dict | None = None,
                compute_flip: bool = True,
                lpips_rescale: str = "standard",
                flip_rescale: str = "standard",
                logger=None) -> EvalResult:
    """Render every pose (or, for the given-rays path, every (rays_o, rays_d)
    tuple) and compute the metrics against ``gt_images`` [N, H, W, 3] when
    given: per frame MSE, PSNR and SSIM on the frame's device (read back
    once a frame), then FLIP and LPIPS over the whole stack; ``test_psnr``
    is the PSNR of the mean MSE, ``test_psnr_v2`` the mean of the per-frame
    PSNRs. ``savedir`` receives ``NNN.png``, and with ground truth
    ``NNN_err.png`` and ``NNN_gt.png``. A frame function that returns (rgb,
    disp) fills ``disp_frames``.

    ``flip_rescale``/``lpips_rescale`` ``minmax``: the reference's min-max
    rescale of each whole stack to [-1, 1] (FLIP then clips to [0, 1]),
    then per-image values. ``ms_per_frame`` times each frame to its end on
    the card (a synchronise after it) and leaves the first frame out, as a
    warm-up; with one frame it is that frame's time."""
    frames, disps, mses, psnrs, ssims = [], [], [], [], []
    t_total, n_timed, t_first = 0.0, 0, 0.0
    dev = None
    for i, x in enumerate(poses):
        t0 = time.perf_counter()
        if isinstance(x, tuple):
            img = frame_fn(*x)
        else:
            img = frame_fn(x[:3, :4] if torch.is_tensor(x)
                           else np.asarray(x)[:3, :4])
        disp = None
        if isinstance(img, tuple):
            img, disp = img
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
        if i > 0:
            t_total += time.perf_counter() - t0
            n_timed += 1
        else:
            t_first = time.perf_counter() - t0
        dev = img.device
        if disp is not None:
            disps.append(disp.float().cpu().numpy())
        img_np = img.float().cpu().numpy()
        frames.append(img_np)

        if gt_images is not None:
            m = M.frame_metrics(img, _as_f32(gt_images[i], dev))
            mse, p, s = torch.stack([m["mse"], m["psnr"], m["ssim"]]
                                    ).tolist()
            mses.append(mse)
            psnrs.append(p)
            ssims.append(s)
            if savedir is not None:
                write_png(os.path.join(savedir, f"{i:03d}_err.png"),
                          to8b(np.abs(img_np - gt_images[i])))
                write_png(os.path.join(savedir, f"{i:03d}_gt.png"),
                          to8b(np.asarray(gt_images[i], np.float32)))
        if savedir is not None:
            write_png(os.path.join(savedir, f"{i:03d}.png"), to8b(img_np))
        if logger is not None:
            msg = f"frame {i}/{len(poses)}"
            if psnrs:
                msg += f" psnr {psnrs[-1]:.4f}"
            logger.print(msg)

    result = EvalResult(frames=np.stack(frames))
    if disps:
        result.disp_frames = np.stack(disps)
    if n_timed:
        result.ms_per_frame = 1000.0 * t_total / n_timed
    elif frames:
        result.ms_per_frame = 1000.0 * t_first

    if gt_images is not None and mses:
        result.per_frame_psnr = psnrs
        result.test_psnr = float(M.mse2psnr(torch.tensor(
            np.mean(mses), dtype=torch.float32)))
        result.test_psnr_v2 = float(np.mean(psnrs))
        result.test_ssim = float(np.mean(ssims))
        n = len(frames)
        if compute_flip or lpips_params is not None:
            gts = _as_f32(gt_images, dev)
            recs = torch.from_numpy(result.frames).to(dev)
        if compute_flip:
            if flip_rescale == "minmax":
                g = torch.clamp(minmax_rescale(gts), 0.0, 1.0)
                r = torch.clamp(minmax_rescale(recs), 0.0, 1.0)
            else:
                g, r = gts, recs
            result.test_flip = _mean_of([flip_metric(g[i], r[i])
                                         for i in range(n)])
        if lpips_params is not None:
            # per-image values, averaged (a batch mean would over-weight a
            # ragged last batch)
            if lpips_rescale == "minmax":
                g, r = minmax_rescale(gts), minmax_rescale(recs)
                vals = [lpips(lpips_params, g[i], r[i], rescale="none")
                        for i in range(n)]
            else:
                vals = [lpips(lpips_params, gts[i], recs[i],
                              rescale=lpips_rescale) for i in range(n)]
            result.test_lpips = _mean_of(vals)
    return result


def load_given_render_path_rays(path: str):
    """A DONeRF precomputed ray file: ``all_rays_o``/``all_rays_d``
    [N, H*W, 3] and optionally ``gt_imgs`` [N, H, W, 3], from an ``.npz``
    or a torch ``.pt`` of tensors (read with ``weights_only``: no code in
    the file runs). -> (rays_o, rays_d, gt or None), f32 numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            data = dict(f)
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        data = {k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in loaded.items()}
    gt = data.get("gt_imgs")
    return (np.asarray(data["all_rays_o"], np.float32),
            np.asarray(data["all_rays_d"], np.float32),
            None if gt is None else np.asarray(gt, np.float32))


def render_path_given_rays(model: R2L, cfg: R2LConfig,
                           sampler: PointSampler,
                           all_rays_o: np.ndarray, all_rays_d: np.ndarray,
                           H: int, W: int,
                           gt_images: np.ndarray | None = None,
                           savedir: str | None = None,
                           embed_L: int = 10, plucker: bool = False,
                           use_pallas: bool = True, pallas_tile: int = 512,
                           quantize: str = "",
                           lpips_params: dict | None = None,
                           lpips_rescale: str = "standard",
                           flip_rescale: str = "standard",
                           compute_flip: bool = True,
                           logger=None, frame_fn=None) -> EvalResult:
    """The DONeRF path: ``render_path`` over frames of precomputed rays
    [N, H*W, 3], through ``make_r2l_givenrays_frame_fn`` (int8 calibrated
    on these rays) or a prebuilt ``frame_fn`` whose packing a caller shares
    with its bench function; ``gt_images`` are cut to [:, :H, :W]."""
    if frame_fn is None:
        frame_fn = make_r2l_givenrays_frame_fn(
            model, cfg, sampler, H, W, embed_L=embed_L, plucker=plucker,
            use_pallas=use_pallas, pallas_tile=pallas_tile,
            quantize=quantize, calib_rays=(all_rays_o, all_rays_d))
    if logger is not None:
        logger.print(f"given-rays inference path: {frame_fn.kind}")
    inputs = [(all_rays_o[i], all_rays_d[i])
              for i in range(all_rays_o.shape[0])]
    gt = None
    if gt_images is not None:
        gt = np.asarray(gt_images, np.float32)[:, :H, :W]
    return render_path(frame_fn, inputs, gt_images=gt, savedir=savedir,
                       lpips_params=lpips_params,
                       lpips_rescale=lpips_rescale,
                       flip_rescale=flip_rescale,
                       compute_flip=compute_flip, logger=logger)


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """Write ``frames`` [N, H, W, 3] in [0, 1] as a video; returns the path
    written. With ``imageio``: an mp4 where it has a video backend, else a
    GIF. Without ``imageio``: a numbered PNG sequence in
    ``<stem>_frames/``, with a warning on stderr."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        out = os.path.splitext(path)[0] + "_frames"
        os.makedirs(out, exist_ok=True)
        for i, f in enumerate(to8b(frames)):
            write_png(os.path.join(out, f"{i:03d}.png"), f)
        print(f"WARNING: imageio is not installed; wrote {len(frames)} "
              f"frames as PNGs into {out} instead of {path}",
              file=sys.stderr)
        return out
    try:
        imageio.mimwrite(path, to8b(frames), fps=fps, quality=8)
        return path
    except (ValueError, RuntimeError, OSError):
        # no video backend (imageio raises ValueError) or a failed encode
        gif = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(gif, to8b(frames),
                         duration=max(1000.0 / fps, 1.0), loop=0)
        return gif
