"""Pseudo-data generation: the frozen teacher renders random poses into ray
shards (the ``rand`` mode); real training images become ray records
(``images_to_ray_records``, the teacher's batched ray pool).

Counterpart of ``r2l_tpu/datagen.py:32-270, 331-332, 516-545``: random
spherical
poses with a random focal x [1, 2), full-frame teacher renders, records
``[o(3), d(3), rgb(3)(, depth)]`` per ray, shuffled and written as shards
with the same names, layout and row order as the JAX package's. Poses and
rays are made on the host with numpy (the same draws as the JAX package);
each pose batch is one chunked volumetric render on the device, through the
fused kernel (``render_frame_nerf_fused``) when the device is CUDA, the
sigma noise is off and the positional encoding is on, else through the
plain path. A writer thread shuffles and writes the shards behind the next
render. Records store the raw rays; with ``ndc`` the warp applies inside
the render only.

Randomness: the stratified and inverse-CDF draws of pose ``i`` come from a
``torch.Generator`` on the device seeded ``seed*100003 + i`` (the role of
the JAX package's ``_pose_key``, not its numbers), or from ``draws_fn``.
The other datagen modes (tworays, 3x3rays, rand images, patches, pseudo
images), and the ray sharding over several devices, are not ported yet.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import warnings
from typing import Callable

import numpy as np
import torch

from .data.rayshards import shuffle_rays, write_ray_shards
from .models.nerf import NeRF, NeRFConfig
from .rays import (donerf_ray_dirs, get_rand_pose, get_rays, get_rays_np,
                   ndc_rays)
from .render import (VolRenderConfig, prepare_fused_teacher,
                     render_frame_nerf, render_frame_nerf_fused)


@dataclasses.dataclass(frozen=True)
class DataGenConfig:
    n_pose: int = 10000             # --n_pose_kd
    H: int = 400
    W: int = 400
    focal: float = 555.555
    use_rand_focal: bool = True     # focal x [1, 2) per pose
    learn_depth: str | bool = ""    # '' | 'depth' (1 extra column) |
    #                                 'surface' (o + d*depth, 3 columns);
    #                                 True == 'depth'
    save_every: int = 100           # poses per shard flush (--i_save)
    shard_size: int = 1 << 20
    seed: int = 0
    poses_per_batch: int = 1        # poses per device render
    use_pallas: bool = True         # the fused volumetric kernel on CUDA
    quantize: str = ""              # 'int8': static-scale int8 teacher
    #                                 (calibrated on this run's poses;
    #                                 fused path only)


def pose_seed(seed: int, i: int) -> int:
    """The seed of pose ``i``'s draws (the JAX package's ``_pose_key``)."""
    return seed * 100003 + i


def _pose_rays(rng: np.random.Generator, gcfg: DataGenConfig, radius: float,
               pose_fn=None) -> tuple[np.ndarray, np.ndarray]:
    """One random pose -> host [H, W, 3] ray origins and directions: a
    random spherical pose (or ``pose_fn(rng)``), a random focal x [1, 2)
    unless disabled, rays in numpy. Shared by the main loop and the int8
    calibration, which must see the same distribution."""
    c2w = np.asarray(pose_fn(rng) if pose_fn is not None
                     else get_rand_pose(rng, radius=radius))
    focal = gcfg.focal
    if gcfg.use_rand_focal:
        focal = gcfg.focal * rng.uniform(1.0, 2.0)
    return get_rays_np(gcfg.H, gcfg.W, focal, c2w)


def int8_calibration_set(gcfg: DataGenConfig, vcfg: VolRenderConfig,
                         radius: float = 4.0, pose_fn=None,
                         ndc: bool = False
                         ) -> tuple[np.ndarray, np.ndarray | None]:
    """The int8 teacher's calibration points (pts [n, 3], viewdirs [n, 3] or
    None): 8 poses from ``default_rng(seed + 7)``, every (H*W/256)-th ray
    (after the NDC warp when ``ndc``), 9 even depths in [near, far]."""
    H, W = gcfg.H, gcfg.W
    crng = np.random.default_rng(gcfg.seed + 7)
    c_pts, c_vds = [], []
    for _ in range(8):
        ro, rd = (a.reshape(-1, 3) for a in _pose_rays(crng, gcfg, radius,
                                                         pose_fn))
        if ndc:
            ro, rd = (t.numpy() for t in ndc_rays(
                H, W, gcfg.focal, 1.0, torch.from_numpy(ro),
                torch.from_numpy(rd)))
        sub = slice(None, None, max(H * W // 256, 1))
        ro, rd = ro[sub], rd[sub]
        z = np.linspace(vcfg.near, vcfg.far, 9, dtype=np.float32)
        pts = (ro[:, None, :] + rd[:, None, :] * z[None, :, None])
        vd = rd / np.maximum(np.linalg.norm(rd, axis=-1, keepdims=True),
                             1e-12)
        c_pts.append(pts.reshape(-1, 3))
        c_vds.append(np.broadcast_to(vd[:, None, :], (vd.shape[0], 9, 3)
                                     ).reshape(-1, 3))
    return (np.concatenate(c_pts),
            np.concatenate(c_vds) if vcfg.use_viewdirs else None)


def _writer(datadir: str, gcfg: DataGenConfig, q: queue.Queue,
            total: dict, errors: list) -> None:
    """Shuffle each flushed batch (the writer's own ``default_rng(seed +
    1)``: numpy generators are not thread-safe) and write it as shards."""
    rng = np.random.default_rng(gcfg.seed + 1)
    try:
        while True:
            item = q.get()
            if item is None:
                return
            rays = shuffle_rays(rng, item)
            write_ray_shards(datadir, rays, prefix="pseudo",
                             shard_size=gcfg.shard_size, shuffle=False)
            total["rays"] += rays.shape[0]
    except Exception as e:  # surface IO failures to the main loop
        errors.append(e)
        while q.get() is not None:  # drain so the producer never blocks
            pass


def generate_pseudo_data(model_c: NeRF, model_f: NeRF | None,
                         ncfg: NeRFConfig, vcfg: VolRenderConfig,
                         gcfg: DataGenConfig, datadir: str,
                         radius: float = 4.0,
                         progress: Callable | None = None,
                         pose_fn: Callable | None = None, ndc: bool = False,
                         ncfg_fine: NeRFConfig | None = None,
                         device: torch.device | str = torch.device("cuda"),
                         draws_fn: Callable | None = None) -> int:
    """Render ``n_pose`` random views with the teacher and write ray shards
    to ``datadir``; returns the number of rays written.

    ``progress(i_pose, n_pose)`` is called after each pose batch;
    ``pose_fn(rng)`` replaces the pose distribution; ``ndc`` warps the rays
    to NDC inside the render only. The render runs on ``device`` (the card
    unless told otherwise; the models must be there too). ``draws_fn(i,
    rays_o, rays_d)`` may return the per-chunk draws of the batch that
    starts at pose ``i`` instead of the generator's (tests hand over
    JAX's)."""
    device = torch.device(device)
    rng = np.random.default_rng(gcfg.seed)
    H, W = gcfg.H, gcfg.W
    ld = "depth" if gcfg.learn_depth is True else (gcfg.learn_depth or "")
    record_dim = 9 + {"": 0, "depth": 1, "surface": 3}[ld]
    ppb = max(gcfg.poses_per_batch, 1)
    use_fused = (gcfg.use_pallas and device.type == "cuda"
                 and vcfg.raw_noise_std == 0.0 and vcfg.multires > 0)
    if gcfg.quantize == "int8" and not use_fused:
        warnings.warn(
            "--quantize int8 requested for datagen but the fused TPU path "
            "is unavailable (CPU backend, mesh sharding, or "
            "raw_noise_std > 0) — generating with the full-precision "
            "teacher instead", stacklevel=2)
    packed = None
    if use_fused:
        int8_calib = None
        if gcfg.quantize == "int8":
            pts, vds = int8_calibration_set(gcfg, vcfg, radius, pose_fn, ndc)
            int8_calib = (torch.from_numpy(pts).to(device),
                          None if vds is None
                          else torch.from_numpy(vds).to(device))
        packed = prepare_fused_teacher(model_c, model_f, ncfg, vcfg,
                                       ncfg_fine, int8_calib,
                                       fold_requant=True)

    def render(ro: np.ndarray, rd: np.ndarray, i: int):
        rays_o = torch.from_numpy(ro).to(device)
        rays_d = torch.from_numpy(rd).to(device)
        if ndc:
            rays_o, rays_d = ndc_rays(H, W, gcfg.focal, 1.0, rays_o, rays_d)
        draws = gen = None
        if draws_fn is not None:
            draws = draws_fn(i, rays_o, rays_d)
        elif vcfg.perturb:
            gen = torch.Generator(device).manual_seed(pose_seed(gcfg.seed, i))
        kw = dict(draws=draws, generator=gen, ncfg_fine=ncfg_fine)
        if use_fused:
            out = render_frame_nerf_fused(model_c, model_f, ncfg, vcfg,
                                          rays_o, rays_d, packed=packed, **kw)
        else:
            out = render_frame_nerf(model_c, model_f, ncfg, vcfg, rays_o,
                                    rays_d, **kw)
        return out["rgb"], out["depth"]

    writer_q: queue.Queue = queue.Queue(maxsize=2)
    total, errors = {"rays": 0}, []
    wt = threading.Thread(target=_writer, daemon=True,
                          args=(datadir, gcfg, writer_q, total, errors))
    wt.start()
    buf: list[np.ndarray] = []
    done = 0
    try:
        while done < gcfg.n_pose:
            if errors:
                raise RuntimeError("pseudo-data writer failed") from errors[0]
            k = min(ppb, gcfg.n_pose - done)
            rays = [_pose_rays(rng, gcfg, radius, pose_fn) for _ in range(k)]
            ro = np.concatenate([r[0].reshape(-1, 3) for r in rays])
            rd = np.concatenate([r[1].reshape(-1, 3) for r in rays])
            rgb, depth = render(ro, rd, done)
            cols = [ro, rd, rgb.cpu().numpy()]
            if ld == "surface":   # the surface point o + d*depth
                cols.append(ro + rd * depth.cpu().numpy()[:, None])
            elif ld == "depth":
                cols.append(depth.cpu().numpy()[:, None])
            rec = np.concatenate(cols, axis=1).astype(np.float32)
            assert rec.shape[1] == record_dim, (rec.shape, record_dim)
            buf.append(rec)
            done += k
            if progress is not None:
                progress(done, gcfg.n_pose)
            if sum(b.shape[0] for b in buf) >= gcfg.save_every * H * W:
                writer_q.put(np.concatenate(buf, axis=0))
                buf = []
        if buf:
            writer_q.put(np.concatenate(buf, axis=0))
    finally:
        writer_q.put(None)
        wt.join()
    if errors:
        raise RuntimeError("pseudo-data writer failed") from errors[0]
    return total["rays"]


def images_to_ray_records(images: np.ndarray, poses: np.ndarray, H: int,
                          W: int, focal: float, ndc: bool = False,
                          donerf: bool = False,
                          device: torch.device | str = torch.device("cuda")
                          ) -> np.ndarray:
    """Training images [N, H, W, 3] and poses [N, 3|4, 4] -> ray records
    [N*H*W, 9] (o, d, rgb) on the host, in image then row-major pixel order
    (the offline converter; the teacher's ``use_batching`` pool). The rays
    and the NDC warp are computed on ``device``, then copied to the host.
    ``ndc`` stores NDC-warped rays (LLFF forward-facing); ``donerf`` makes
    the rays in the DONeRF convention (half-pixel centres, unit directions
    rotated by the pose on the host, as the JAX package does), which lines
    converted shards up with given eval rays."""
    dirs_cam = donerf_ray_dirs(H, W, focal) if donerf else None
    records = []
    for img, c2w in zip(images, poses):
        c2w = np.asarray(c2w, np.float32)
        if donerf:
            rd = torch.from_numpy(dirs_cam @ c2w[:3, :3].T).to(device)
            ro = torch.from_numpy(c2w[:3, -1]).to(device).expand(rd.shape)
        else:
            ro, rd = get_rays(H, W, focal, c2w, device=device)
        if ndc:
            ro, rd = ndc_rays(H, W, focal, 1.0, ro, rd)
        records.append(np.concatenate([
            ro.reshape(-1, 3).cpu().numpy(), rd.reshape(-1, 3).cpu().numpy(),
            np.asarray(img, np.float32).reshape(-1, 3)], axis=1))
    return np.concatenate(records, axis=0)
