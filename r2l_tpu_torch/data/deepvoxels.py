"""DeepVoxels dataset loader (512x512 synthetic captures).

Counterpart of ``r2l_tpu/data/deepvoxels.py``, copied because the JAX
package is not imported here; images are read by ``imageio_.read_image``
(PNG). Host-side numpy rework of the reference's
`dataset/load_deepvoxels.py:6-120`: intrinsics.txt parsing
(focal rescaled to the 512 target side length), pose directories per split
with the y/z-flip convention transform, ``testskip`` subsampling of
val/test. Near/far for these hemisphere scenes comes from the mean camera
radius (reference `main.py:948-950`).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .imageio_ import read_image

_FLIP_YZ = np.array([
    [1, 0, 0, 0],
    [0, -1, 0, 0],
    [0, 0, -1, 0],
    [0, 0, 0, 1.0],
], dtype=np.float32)


def parse_intrinsics(path: str, target_side: int) -> float:
    """intrinsics.txt -> focal length rescaled to ``target_side``."""
    with open(path) as f:
        fval, cx, cy = [float(x) for x in f.readline().split()][:3]
        f.readline()  # grid barycenter
        f.readline()  # near plane
        f.readline()  # scale
        height, width = map(float, f.readline().split())
    return target_side / height * fval


def _load_pose(path: str) -> np.ndarray:
    nums = [float(x) for x in open(path).read().split()]
    return np.asarray(nums, dtype=np.float32).reshape(4, 4)


def _dir2poses(posedir: str) -> np.ndarray:
    poses = np.stack([_load_pose(os.path.join(posedir, f))
                      for f in sorted(os.listdir(posedir))
                      if f.endswith("txt")], 0)
    return (poses @ _FLIP_YZ)[:, :3, :4].astype(np.float32)


def _load_images(d: str, skip: int = 1) -> np.ndarray:
    files = [f for f in sorted(os.listdir(d)) if f.endswith("png")][::skip]
    return np.stack([np.asarray(read_image(os.path.join(d, f))) / 255.0
                     for f in files], 0).astype(np.float32)


@dataclasses.dataclass
class DeepVoxelsData:
    images: np.ndarray        # [N, 512, 512, 3]
    poses: np.ndarray         # [N, 3, 4]
    render_poses: np.ndarray  # test poses
    H: int
    W: int
    focal: float
    i_split: tuple[np.ndarray, np.ndarray, np.ndarray]

    def near_far(self) -> tuple[float, float]:
        """Hemisphere scenes: near/far around the mean camera radius
        (reference `main.py:948-950`)."""
        hemi_r = float(np.mean(np.linalg.norm(self.poses[:, :3, 3], axis=-1)))
        return hemi_r - 1.0, hemi_r + 1.0


def load_dv_data(basedir: str, scene: str = "greek",
                 testskip: int = 8) -> DeepVoxelsData:
    H = W = 512
    base = os.path.join(basedir, "train", scene)
    focal = parse_intrinsics(os.path.join(base, "intrinsics.txt"), H)

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(os.path.join(basedir, "test", scene, "pose"))[::testskip]
    valposes = _dir2poses(
        os.path.join(basedir, "validation", scene, "pose"))[::testskip]

    imgs = _load_images(os.path.join(base, "rgb"))
    testimgs = _load_images(os.path.join(basedir, "test", scene, "rgb"),
                            testskip)
    valimgs = _load_images(
        os.path.join(basedir, "validation", scene, "rgb"), testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = tuple(np.arange(counts[i], counts[i + 1]) for i in range(3))

    return DeepVoxelsData(
        images=np.concatenate(all_imgs, 0),
        poses=np.concatenate([poses, valposes, testposes], 0),
        render_poses=testposes, H=H, W=W, focal=float(focal),
        i_split=i_split)
