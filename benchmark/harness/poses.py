"""Camera poses of the traffic, copied from the program's pose helpers
(``r2l_tpu_torch/rays.py``: ``pose_spherical``; the lego orbit of
``bench_cuda.lego_poses``) so that the traffic stays fixed whatever the
program does to its own."""
from __future__ import annotations

import numpy as np


def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


_FLIP = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                 dtype=np.float32)


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] on a sphere (Blender convention)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    return _FLIP @ c2w


def orbit_poses(k: int, elevation: float, radius: float) -> np.ndarray:
    """``k`` poses [k, 3, 4] evenly spaced in azimuth from -180 degrees
    (``bench_cuda.lego_poses``)."""
    return np.stack([pose_spherical(t, elevation, radius)[:3, :4]
                     for t in np.linspace(-180, 180, k, endpoint=False)])


class OrbitDraws:
    """Poses at a random azimuth on a fixed orbit, drawn one after another
    from ``seed``: the same seed gives the same sequence."""

    def __init__(self, seed: int, elevation: float, radius: float):
        self.rng = np.random.default_rng(seed)
        self.elevation, self.radius = elevation, radius

    def __call__(self) -> np.ndarray:
        theta = float(self.rng.uniform(-180.0, 180.0))
        return pose_spherical(theta, self.elevation, self.radius)[:3, :4]


def rand_pose_and_focal(rng: np.random.Generator, focal: float,
                        rand_focal: bool, radius: float = 4.0
                        ) -> tuple[np.ndarray, float]:
    """One pose of pseudo-data generation's ``rand`` mode, in its order of
    draws: azimuth in [-180, 180], elevation in [-90, 0], then the focal
    times [1, 2)."""
    theta = rng.uniform(-180.0, 180.0)
    phi = rng.uniform(-90.0, 0.0)
    c2w = pose_spherical(theta, phi, radius)
    if rand_focal:
        focal = focal * rng.uniform(1.0, 2.0)
    return c2w, float(focal)
