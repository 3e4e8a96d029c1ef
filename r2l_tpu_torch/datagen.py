"""Pseudo-data generation: the frozen teacher renders random poses into
ray records, in the six modes of ``tools/create_data.py``; real training
images become ray records (``images_to_ray_records``, the teacher's batched
ray pool and ``convert_rays``).

Counterpart of ``r2l_tpu/datagen.py`` (``DataGenConfig`` :32,
``generate_pseudo_data`` :63, ``_pose_rays`` :251, ``_rand_neighbor_offsets``
:273, ``_make_rgb_renderer`` :308, ``generate_tworays`` :335,
``generate_3x3rays`` :368, ``generate_rand_images`` :404,
``generate_patches`` :436, ``generate_pseudo_images`` :478,
``images_to_ray_records`` :516). The modes:

* ``rand`` (``generate_pseudo_data``): random spherical poses with a random
  focal x [1, 2), full-frame renders, records ``[o(3), d(3), rgb(3)(,
  depth)]`` per ray, shuffled and written as ``pseudo_*.npy`` shards by a
  writer thread behind the next render; records store the raw rays, and
  with ``ndc`` the warp applies inside the render only. ``quantize='int8'``
  packs a static-scale int8 teacher (K7), calibrated on this run's poses.
* ``rand_tworays`` (15 floats: o, d, a random neighbour's d, rgb, its
  rgb), ``3x3rays`` (57 floats: o and the 3x3 neighbourhood's d and rgb of
  the interior pixels), both shuffled into ``pseudo2ray_*``/``pseudo3x3_*``
  shards every ``save_every`` poses; ``rand_images`` (``[H, W, 9]`` frames
  in ``rand_images_XXXXX.npz`` batches of ``save_every``); ``16x16patches``
  (the pose's origin and ``[n_patch, 16, 16, 6]`` (d, rgb) tiles in
  ``patches_XXXXX.npz``, numbered modulo ``max_save``); and
  ``spiral_evenly_spaced`` (``generate_pseudo_images``: an even pose grid,
  ``pseudo_images_XXXX.npy`` + ``pseudo_poses_XXXX.npy``).

Every mode draws its poses, focals, neighbour offsets and shuffles with
numpy in the JAX package's order, so the files have the same names, shapes
and row order. Each render runs on the device, through the fused
volumetric kernel (``render_frame_nerf_fused``: K6, or K7 for an int8
teacher) when the device is CUDA, ``use_pallas`` is on, the sigma noise is
off and the positional encoding is on, else through the plain path. The
int8 teacher is wired into ``rand`` only; the other modes warn and render
at full precision, as the JAX package does.

Randomness: the stratified and inverse-CDF draws of pose ``i`` come from a
``torch.Generator`` on the device seeded ``pose_seed(seed, i)`` (the role of
the JAX package's ``_pose_key``, not its numbers), or from ``draws_fn(i,
rays_o, rays_d)`` (tests hand over JAX's). The ray sharding over several
devices is not ported (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import warnings
from typing import Callable

import numpy as np
import torch

from .data.rayshards import shuffle_rays, write_ray_shards
from .models.nerf import NeRF, NeRFConfig
from .rays import (donerf_ray_dirs, get_novel_poses, get_rand_pose, get_rays,
                   get_rays_np, ndc_rays)
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
    #                                 fused path of 'rand' only)
    max_save: int = 40000           # patches mode: shard numbers wrap
    #                                 modulo this (bounded file count)


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


def _fused_gate(gcfg: DataGenConfig, vcfg: VolRenderConfig,
                device: torch.device) -> bool:
    """Whether the renders take the fused kernel: ``use_pallas`` on a CUDA
    device, no sigma noise, the positional encoding on."""
    return bool(gcfg.use_pallas and device.type == "cuda"
                and vcfg.raw_noise_std == 0.0 and vcfg.multires > 0)


def _renderer(model_c: NeRF, model_f: NeRF | None, ncfg: NeRFConfig,
              vcfg: VolRenderConfig, gcfg: DataGenConfig,
              device: torch.device, fused: bool, packed,
              ncfg_fine: NeRFConfig | None, draws_fn: Callable | None,
              ndc: bool = False) -> Callable:
    """``render(ro, rd, i) -> (rgb, depth)`` on ``device`` of flat host rays
    [n, 3] whose first pose is pose ``i``: NDC-warped inside the render with
    ``ndc``; the draws from ``draws_fn(i, rays_o, rays_d)``, else (when
    perturbing) from a generator seeded ``pose_seed(seed, i)``; through the
    fused kernel on ``packed`` when ``fused``."""
    H, W = gcfg.H, gcfg.W

    def render(ro: np.ndarray, rd: np.ndarray, i: int):
        rays_o = torch.from_numpy(np.ascontiguousarray(ro)).to(device)
        rays_d = torch.from_numpy(np.ascontiguousarray(rd)).to(device)
        if ndc:
            rays_o, rays_d = ndc_rays(H, W, gcfg.focal, 1.0, rays_o, rays_d)
        draws = gen = None
        if draws_fn is not None:
            draws = draws_fn(i, rays_o, rays_d)
        elif vcfg.perturb:
            gen = torch.Generator(device).manual_seed(pose_seed(gcfg.seed, i))
        kw = dict(draws=draws, generator=gen, ncfg_fine=ncfg_fine)
        if fused:
            out = render_frame_nerf_fused(model_c, model_f, ncfg, vcfg,
                                          rays_o, rays_d, packed=packed, **kw)
        else:
            out = render_frame_nerf(model_c, model_f, ncfg, vcfg, rays_o,
                                    rays_d, **kw)
        return out["rgb"], out["depth"]

    return render


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
    use_fused = _fused_gate(gcfg, vcfg, device)
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

    render = _renderer(model_c, model_f, ncfg, vcfg, gcfg, device, use_fused,
                       packed, ncfg_fine, draws_fn, ndc=ndc)

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


def _rand_neighbor_offsets(rng: np.random.Generator, H: int, W: int,
                           include_center: bool = False) -> np.ndarray:
    """Per-pixel random valid 8(9)-neighbourhood offset, [H, W, 2]: draw
    from the offset set, redraw (up to 8 times) where the neighbour falls
    outside the image, then mirror any axis still outside inward (the
    reference's per-pixel resample loop, `create_data.py:914-929`, in the
    JAX package's vectorized form and draw order)."""
    offsets = [[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 1],
               [1, -1], [1, 0], [1, 1]]
    if include_center:
        offsets.insert(4, [0, 0])
    offs = np.asarray(offsets)
    hh = np.arange(H)[:, None]
    ww = np.arange(W)[None, :]
    pick = rng.integers(0, len(offs), size=(H, W))
    for _ in range(8):
        oh, ow = offs[pick][..., 0], offs[pick][..., 1]
        bad = ((hh + oh < 0) | (hh + oh >= H)
               | (ww + ow < 0) | (ww + ow >= W))
        if not bad.any():
            break
        pick = np.where(bad, rng.integers(0, len(offs), size=(H, W)), pick)
    out = np.array(offs[pick])
    oh, ow = out[..., 0], out[..., 1]
    out[..., 0] = np.where((hh + oh < 0) | (hh + oh >= H), -oh, oh)
    out[..., 1] = np.where((ww + ow < 0) | (ww + ow >= W), -ow, ow)
    return out


def _make_rgb_renderer(model_c: NeRF, model_f: NeRF | None,
                       ncfg: NeRFConfig, vcfg: VolRenderConfig,
                       gcfg: DataGenConfig, device: torch.device | str,
                       ncfg_fine: NeRFConfig | None = None,
                       draws_fn: Callable | None = None) -> Callable:
    """``render(ro, rd, i) -> rgb [H, W, 3]`` (host numpy) of one pose's rays
    [H, W, 3] for the modes other than ``rand``, through the fused kernel
    where ``rand``'s gate allows it. Every reference mode renders with the
    training kwargs (perturb=1). An int8 request warns: the int8 teacher is
    ``rand``'s alone."""
    if gcfg.quantize:
        warnings.warn(
            f"--quantize {gcfg.quantize} is only wired into the 'rand' "
            "datagen mode's fused path — this mode renders with the "
            "full-precision teacher", stacklevel=3)
    device = torch.device(device)
    fused = _fused_gate(gcfg, vcfg, device)
    packed = (prepare_fused_teacher(model_c, model_f, ncfg, vcfg, ncfg_fine)
              if fused else None)
    render = _renderer(model_c, model_f, ncfg, vcfg, gcfg, device, fused,
                       packed, ncfg_fine, draws_fn)

    def render_rgb(ro, rd, i: int) -> np.ndarray:
        rgb, _ = render(np.asarray(ro).reshape(-1, 3),
                        np.asarray(rd).reshape(-1, 3), i)
        return rgb.cpu().numpy().reshape(gcfg.H, gcfg.W, 3)

    return render_rgb


def _flush_shards(rng: np.random.Generator, buf: list, datadir: str,
                  prefix: str, gcfg: DataGenConfig) -> int:
    """Shuffle the buffered records with the mode's own generator and write
    them as ``<prefix>_*.npy`` shards; returns the rays written."""
    rays = shuffle_rays(rng, np.concatenate(buf, 0))
    write_ray_shards(datadir, rays, prefix=prefix,
                     shard_size=gcfg.shard_size, shuffle=False)
    return rays.shape[0]


def generate_tworays(model_c: NeRF, model_f: NeRF | None, ncfg: NeRFConfig,
                     vcfg: VolRenderConfig, gcfg: DataGenConfig,
                     datadir: str, radius: float = 4.0,
                     ncfg_fine: NeRFConfig | None = None,
                     device: torch.device | str = torch.device("cuda"),
                     draws_fn: Callable | None = None) -> int:
    """``rand_tworays`` mode: per pixel, also a random neighbour's direction
    and rgb -> 15-float records [o, d, d2, rgb, rgb2] in ``pseudo2ray_*``
    shards (reference `create_data.py:874-966`, for the nerf_v4 student).
    Returns the rays written."""
    rng = np.random.default_rng(gcfg.seed)
    H, W = gcfg.H, gcfg.W
    render = _make_rgb_renderer(model_c, model_f, ncfg, vcfg, gcfg, device,
                                ncfg_fine, draws_fn)
    total, buf = 0, []
    for i in range(gcfg.n_pose):
        ro, rd = _pose_rays(rng, gcfg, radius)
        rgb = render(ro, rd, i)
        off = _rand_neighbor_offsets(rng, H, W)
        nh = np.arange(H)[:, None] + off[..., 0]
        nw = np.arange(W)[None, :] + off[..., 1]
        rec = np.concatenate([ro, rd, rd[nh, nw], rgb, rgb[nh, nw]],
                             axis=-1).reshape(-1, 15)
        buf.append(rec.astype(np.float32))
        if (i + 1) % gcfg.save_every == 0 or i == gcfg.n_pose - 1:
            total += _flush_shards(rng, buf, datadir, "pseudo2ray", gcfg)
            buf = []
    return total


def generate_3x3rays(model_c: NeRF, model_f: NeRF | None, ncfg: NeRFConfig,
                     vcfg: VolRenderConfig, gcfg: DataGenConfig,
                     datadir: str, radius: float = 4.0,
                     ncfg_fine: NeRFConfig | None = None,
                     device: torch.device | str = torch.device("cuda"),
                     draws_fn: Callable | None = None) -> int:
    """``3x3rays`` mode: interior pixels with their full 3x3 neighbourhood
    -> 57-float records [o(3), d3x3(27), rgb3x3(27)] in ``pseudo3x3_*``
    shards (reference `create_data.py:1020-1115`, for the nerf_v3.4
    student). Returns the rays written."""
    rng = np.random.default_rng(gcfg.seed)
    H, W = gcfg.H, gcfg.W
    render = _make_rgb_renderer(model_c, model_f, ncfg, vcfg, gcfg, device,
                                ncfg_fine, draws_fn)
    offsets = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
               (1, -1), (1, 0), (1, 1)]
    total, buf = 0, []
    for i in range(gcfg.n_pose):
        ro, rd = _pose_rays(rng, gcfg, radius)
        rgb = render(ro, rd, i)
        d_parts = [rd[1 + oh:H - 1 + oh, 1 + ow:W - 1 + ow]
                   for oh, ow in offsets]
        c_parts = [rgb[1 + oh:H - 1 + oh, 1 + ow:W - 1 + ow]
                   for oh, ow in offsets]
        rec = np.concatenate([ro[1:H - 1, 1:W - 1]] + d_parts + c_parts,
                             axis=-1).reshape(-1, 57)
        buf.append(rec.astype(np.float32))
        if (i + 1) % gcfg.save_every == 0 or i == gcfg.n_pose - 1:
            total += _flush_shards(rng, buf, datadir, "pseudo3x3", gcfg)
            buf = []
    return total


def generate_rand_images(model_c: NeRF, model_f: NeRF | None,
                         ncfg: NeRFConfig, vcfg: VolRenderConfig,
                         gcfg: DataGenConfig, datadir: str,
                         radius: float = 4.0,
                         ncfg_fine: NeRFConfig | None = None,
                         device: torch.device | str = torch.device("cuda"),
                         draws_fn: Callable | None = None) -> int:
    """``rand_images`` mode: one [H, W, 9] (o, d, rgb) frame per random pose
    (reference `create_data.py:968-1018`, for the nerf_v6 student), in
    ``rand_images_XXXXX.npz`` batches of ``save_every`` frames. Returns the
    poses rendered."""
    rng = np.random.default_rng(gcfg.seed)
    render = _make_rgb_renderer(model_c, model_f, ncfg, vcfg, gcfg, device,
                                ncfg_fine, draws_fn)
    os.makedirs(datadir, exist_ok=True)
    frames, n_batch = [], 0
    for i in range(gcfg.n_pose):
        ro, rd = _pose_rays(rng, gcfg, radius)
        rgb = render(ro, rd, i)
        frames.append(np.concatenate([ro, rd, rgb], -1).astype(np.float32))
        if (i + 1) % gcfg.save_every == 0 or i == gcfg.n_pose - 1:
            np.savez(os.path.join(datadir, f"rand_images_{n_batch:05d}.npz"),
                     data=np.stack(frames))
            n_batch += 1
            frames = []
    return gcfg.n_pose


def generate_patches(model_c: NeRF, model_f: NeRF | None, ncfg: NeRFConfig,
                     vcfg: VolRenderConfig, gcfg: DataGenConfig,
                     datadir: str, patch_size: int = 16, radius: float = 4.0,
                     ncfg_fine: NeRFConfig | None = None,
                     device: torch.device | str = torch.device("cuda"),
                     draws_fn: Callable | None = None) -> int:
    """``16x16patches`` mode: per random pose, the shared origin and
    [n_patch, patch, patch, 6] (d, rgb) tiles (reference
    `create_data.py:1117-1186`), in ``patches_XXXXX.npz`` batches of
    ``save_every`` poses numbered modulo ``max_save``. Returns the poses
    rendered."""
    rng = np.random.default_rng(gcfg.seed)
    H, W = gcfg.H, gcfg.W
    ph, pw = H // patch_size, W // patch_size
    render = _make_rgb_renderer(model_c, model_f, ncfg, vcfg, gcfg, device,
                                ncfg_fine, draws_fn)
    os.makedirs(datadir, exist_ok=True)
    origins, patches, n_batch = [], [], 0
    for i in range(gcfg.n_pose):
        ro, rd = _pose_rays(rng, gcfg, radius)
        rgb = render(ro, rd, i)
        data = np.concatenate([rd, rgb], -1)                # [H, W, 6]
        tiles = (data[:ph * patch_size, :pw * patch_size]
                 .reshape(ph, patch_size, pw, patch_size, 6)
                 .transpose(0, 2, 1, 3, 4)
                 .reshape(ph * pw, patch_size, patch_size, 6))
        origins.append(ro[0, 0])
        patches.append(tiles.astype(np.float32))
        if (i + 1) % gcfg.save_every == 0 or i == gcfg.n_pose - 1:
            np.savez(os.path.join(
                datadir, f"patches_{n_batch % gcfg.max_save:05d}.npz"),
                rays_o=np.stack(origins), patches=np.stack(patches))
            n_batch += 1
            origins, patches = [], []
    return gcfg.n_pose


def generate_pseudo_images(model_c: NeRF, model_f: NeRF | None,
                           ncfg: NeRFConfig, vcfg: VolRenderConfig,
                           gcfg: DataGenConfig, datadir: str, n_pose=10,
                           ncfg_fine: NeRFConfig | None = None,
                           device: torch.device | str = torch.device("cuda"),
                           draws_fn: Callable | None = None) -> int:
    """``spiral_evenly_spaced`` mode: render the even pose grid of
    ``get_novel_poses(n_pose)`` at ``gcfg``'s focal (reference
    `create_data.py:749-775` and `load_blender.py:185-215`), saved as the
    next ``pseudo_images_XXXX.npy`` [n, H, W, 3] and ``pseudo_poses_XXXX
    .npy`` [n, 4, 4] pair in ``datadir``. Returns the images rendered."""
    os.makedirs(datadir, exist_ok=True)
    poses = get_novel_poses(n_pose)
    render = _make_rgb_renderer(model_c, model_f, ncfg, vcfg, gcfg, device,
                                ncfg_fine, draws_fn)
    imgs = []
    for c2w in poses:
        ro, rd = get_rays(gcfg.H, gcfg.W, gcfg.focal, c2w, device="cpu")
        imgs.append(render(ro.numpy(), rd.numpy(), len(imgs)))
    existing = len([f for f in os.listdir(datadir)
                    if f.startswith("pseudo_images") and f.endswith(".npy")])
    np.save(os.path.join(datadir, f"pseudo_images_{existing:04d}.npy"),
            np.stack(imgs).astype(np.float32))
    np.save(os.path.join(datadir, f"pseudo_poses_{existing:04d}.npy"),
            poses.astype(np.float32))
    return len(imgs)


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
