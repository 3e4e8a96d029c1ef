"""LLFF real-scene dataset loader (poses_bounds.npy + images).

Host-side numpy rework of the reference's `dataset/load_llff.py`
(itself from Fyusion/LLFF): pose-matrix column reorder, bounds rescale by
``1/(bds.min()*bd_factor)``, recentering around the average pose, optional
spherification for 360° scenes, spiral render path, nearest-to-mean holdout
view, and random-pose synthesis inside the training-camera bbox
(``get_rand_pose_llff``, reference `load_llff.py:187-218` — here with an
explicit rng instead of module GLOBALS).

Counterpart of ``r2l_tpu/data/llff.py``, copied because the JAX package is
not imported here. Downscaled image caches (`images_{factor}/`) are built
with ``imageio_.resize_area`` (cv2's INTER_AREA on 8-bit RGB, as the JAX
package builds them with cv2) instead of the reference's imagemagick
``mogrify`` shell-out, and written as PNG; images are read by
``imageio_.read_image`` (PNG, or baseline JPEG as LLFF ships them). The
cache applies a JPEG's EXIF orientation, as ``cv2.imread`` does there; the
images themselves are read as ``imageio.imread`` reads them, which ignores
it.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .imageio_ import (apply_orientation, image_files, jpeg_orientation,
                       read_image, resize_area)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """poses [N, 3, 5] -> average c2w [3, 5] (keeps hwf column)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform all poses by the inverse average pose."""
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], (1, 4))
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(bottom[None], (poses.shape[0], 1, 1))
    p44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_[:, :3, :4] = (np.linalg.inv(c2w) @ p44)[:, :3, :4]
    return poses_


def spherify_poses(poses: np.ndarray, bds: np.ndarray, n_views: int = 120):
    """Re-center 360° captures on the point nearest all camera axes and
    synthesize a circular render path."""
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.eye(4)[-1].reshape(1, 1, 4), (p.shape[0], 1, 1))],
            1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    a = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b = -a @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a, (0, 2, 1)) @ a).mean(0)) @ b.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(
        poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = poses_reset[:, :3, 3].mean(0)
    zh = centroid[2]
    radcircle = np.sqrt(max(rad ** 2 - zh ** 2, 1e-12))
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_views):
        camorigin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up2 = np.array([0, 0, -1.0])
        v2 = _normalize(camorigin)
        v0 = _normalize(np.cross(v2, up2))
        v1 = _normalize(np.cross(v2, v0))
        new_poses.append(np.stack([v0, v1, v2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)

    hwf = np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)
    new_poses = np.concatenate([new_poses, hwf], -1)
    hwf2 = np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)
    poses_reset = np.concatenate([poses_reset[:, :3, :4], hwf2], -1)
    return poses_reset.astype(np.float32), new_poses.astype(np.float32), bds


def render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=2, n=120):
    poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return np.stack(poses).astype(np.float32)


@dataclasses.dataclass
class LLFFData:
    images: np.ndarray        # [N, H, W, 3] float32 in [0,1]
    poses: np.ndarray         # [N, 3, 5] (c2w | hwf)
    bds: np.ndarray           # [N, 2]
    render_poses: np.ndarray  # [M, 3, 5]
    i_test: int
    H: int
    W: int
    focal: float

    def splits(self, llffhold: int = 8):
        """(i_train, i_test) — every llffhold-th frame is test
        (reference `main.py:899-907`)."""
        n = self.images.shape[0]
        if llffhold > 0:
            i_test = np.arange(n)[::llffhold]
        else:
            i_test = np.array([self.i_test])
        i_train = np.array([i for i in range(n) if i not in i_test])
        return i_train, i_test

    def near_far(self, no_ndc: bool) -> tuple[float, float]:
        """reference `main.py:913-920`."""
        if no_ndc:
            return float(self.bds.min() * 0.9), float(self.bds.max())
        return 0.0, 1.0


def _as_rgb8(img: np.ndarray) -> np.ndarray:
    """What cv2's IMREAD_COLOR keeps of a decoded 8-bit image: 3 channels
    (grey repeated, alpha dropped)."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _minify(basedir: str, factor: int) -> str:
    """Build (or reuse) the images_{factor} cache with the area resize, as
    the JAX package's ``_minify_cv2`` does (cv2.imread, INTER_AREA, PNG)."""
    from ..evaluate import write_png
    imgdir = os.path.join(basedir, f"images_{factor}")
    srcdir = os.path.join(basedir, "images")
    src_files = image_files(srcdir)
    if os.path.exists(imgdir) and len(image_files(imgdir)) == len(src_files):
        return imgdir
    os.makedirs(imgdir, exist_ok=True)
    for f in src_files:
        img = np.asarray(read_image(f))
        if f.lower().endswith((".jpg", ".jpeg")):
            # cv2.imread turns a JPEG upright from its EXIF orientation
            img = apply_orientation(img, jpeg_orientation(f))
        img = _as_rgb8(img)
        h, w = img.shape[:2]
        out = resize_area(img, w // factor, h // factor)
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        write_png(os.path.join(imgdir, name), out)
    return imgdir


def load_llff_data(basedir: str, factor: int = 8, recenter: bool = True,
                   bd_factor: float = 0.75, spherify: bool = False,
                   n_pose_video: int = 120) -> LLFFData:
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape(-1, 3, 5).transpose(1, 2, 0)
    bds = poses_arr[:, -2:].transpose(1, 0)

    imgdir = (os.path.join(basedir, "images") if factor in (None, 1)
              else _minify(basedir, factor))
    files = image_files(imgdir)
    assert poses.shape[-1] == len(files), \
        f"{len(files)} images vs {poses.shape[-1]} poses"
    imgs = np.stack([np.asarray(read_image(f)[..., :3]) / 255.0
                     for f in files], -1).astype(np.float32)

    sh = imgs.shape[:2]
    poses[:2, 4, :] = np.array(sh).reshape(2, 1)
    poses[2, 4, :] = poses[2, 4, :] / float(factor or 1)

    # Column reorder: [down, right, back] -> [right, up, back] convention.
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds, n_pose_video)
    else:
        c2w = poses_avg(poses)
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        up = _normalize(poses[:, :3, 1].sum(0))
        render_poses = render_path_spiral(c2w, up, rads, focal,
                                          rots=2, n=n_pose_video)

    c2w = poses_avg(poses)
    dists = np.sum((c2w[:3, 3] - poses[:, :3, 3]) ** 2, -1)
    i_test = int(np.argmin(dists))

    H, W, f = poses[0, :3, -1]
    return LLFFData(images=imgs, poses=poses, bds=bds,
                    render_poses=render_poses, i_test=i_test,
                    H=int(H), W=int(W), focal=float(f))


def get_rand_pose_llff(rng: np.random.Generator,
                       poses: np.ndarray) -> np.ndarray:
    """Random pose in the 1.1x bbox of training origins/directions
    (reference `load_llff.py:187-218`, explicit rng)."""
    c2w = poses_avg(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    hwf = c2w[:, 4:5]

    def rand_in(mins, maxs, scale=1.1):
        mid = (mins + maxs) * 0.5
        half = (maxs - mins) * scale * 0.5
        return rng.uniform(mid - half, mid + half)

    origins, dirs = poses[:, :3, 3], poses[:, :3, 2]
    c = c2w[:3, :4] @ np.append(
        rand_in(origins.min(0), origins.max(0)), 1.0)
    z = c2w[:3, :4] @ np.append(rand_in(dirs.min(0), dirs.max(0)), 1.0)
    return np.concatenate(
        [viewmatrix(_normalize(z), up, c), hwf], 1).astype(np.float32)
