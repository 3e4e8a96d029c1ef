"""Ray generation and Blender-style pose synthesis.

Counterpart of ``r2l_tpu/rays.py`` (``camera_ray_dirs`` :22, ``plucker``
:145, the numpy pose helpers :159-194). The pose helpers are numpy and are
copied here because the JAX module imports jax at module scope.

Conventions (identical to the reference):
  * pixel (i, j) -> camera-frame direction [(i - W/2)/f, -(j - H/2)/f, -1]
  * c2w is a [3, 4] (or [4, 4]) camera-to-world matrix; rays_d = R @ dir,
    rays_o = t broadcast to every pixel.
"""
from __future__ import annotations

import numpy as np
import torch


def camera_ray_dirs(H: int, W: int, focal: float,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-pixel camera-frame ray directions, shape [H, W, 3] f32."""
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    return torch.stack([
        ((i - W * 0.5) / focal).expand(H, W),
        (-(j - H * 0.5) / focal).expand(H, W),
        -torch.ones((H, W), dtype=torch.float32, device=device),
    ], dim=-1)


def plucker(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Plücker ray coordinates [..., 6] = (d, o x d)."""
    return torch.cat([rays_d, torch.linalg.cross(rays_o, rays_d, dim=-1)],
                     dim=-1)


def trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


_FLIP = np.array(
    [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.float32)


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] on a sphere (Blender convention)."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    return _FLIP @ c2w
