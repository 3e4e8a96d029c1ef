"""Ray generation, NDC warp and Blender-style pose synthesis.

Counterpart of ``r2l_tpu/rays.py`` (``camera_ray_dirs`` :22,
``donerf_ray_dirs`` :37, ``get_rays`` :72, ``get_rays_np`` :95,
``ndc_rays`` :122, ``plucker`` :145, the numpy pose helpers :159-241). The
numpy helpers are copied here because the JAX module imports jax at module
scope. ``trans_origin`` is an
argument here (the JAX module reads a module-wide default set from the
CLI).

Conventions (identical to the reference):
  * pixel (i, j) -> camera-frame direction [(i - W/2)/f, -(j - H/2)/f, -1]
  * c2w is a [3, 4] (or [4, 4]) camera-to-world matrix; rays_d = R @ dir,
    rays_o = t broadcast to every pixel.
"""
from __future__ import annotations

import numpy as np
import torch


def camera_ray_dirs(H: int, W: int, focal: float,
                    device: torch.device | str) -> torch.Tensor:
    """Per-pixel camera-frame ray directions, shape [H, W, 3] f32."""
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    return torch.stack([
        ((i - W * 0.5) / focal).expand(H, W),
        (-(j - H * 0.5) / focal).expand(H, W),
        -torch.ones((H, W), dtype=torch.float32, device=device),
    ], dim=-1)


def donerf_ray_dirs(H: int, W: int, focal: float) -> np.ndarray:
    """DONeRF-convention unit ray directions [H, W, 3] in the camera frame
    (numpy): pixel centres at the half-pixel offset, directions normalized
    before the rotation, y and z flipped."""
    i = np.arange(W, dtype=np.float64)
    j = np.arange(H, dtype=np.float64)
    d = np.stack(np.broadcast_arrays(
        (i - W / 2 + 0.5)[None, :],
        (j - H / 2 + 0.5)[:, None],
        np.full((H, W), float(focal))), axis=-1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d[..., 1] *= -1.0
    d[..., 2] *= -1.0
    return d.astype(np.float32)


def _trans_origin_scale(trans_origin: str) -> float:
    """'fixed' -> 30 units, a numeric string -> that scale (reference
    ``translate_origin_fixed``)."""
    return 30.0 if trans_origin == "fixed" else float(trans_origin)


def get_rays(H: int, W: int, focal: float, c2w,
             focal_scale: float = 1.0, trans_origin: str = "",
             device: torch.device | str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-frame rays of pose ``c2w`` [3/4, 4]: (rays_o, rays_d), each
    [H, W, 3] f32. ``trans_origin`` slides the origins along the unit ray
    direction. The rays live on ``device``: by default the pose's device
    for a tensor, and the card for a numpy pose (pass ``device="cpu"``
    without one). The rotation is computed elementwise, in full f32 whatever
    the matmul precision flags say, and rounds as XLA's einsum does on the
    CPU: d0*r0, then two fused multiply-adds (float64 products of f32
    values are exact), so the rays equal the JAX package's bit for bit."""
    if device is None:
        device = c2w.device if torch.is_tensor(c2w) else torch.device("cuda")
    if not torch.is_tensor(c2w):
        c2w = torch.from_numpy(np.asarray(c2w, np.float32))
    c2w = c2w.to(device=device, dtype=torch.float32)
    d = camera_ray_dirs(H, W, focal * focal_scale, device)[..., None, :]
    r = c2w[:3, :3]
    f64 = torch.float64
    acc = d[..., 0] * r[:, 0]
    for k in (1, 2):
        acc = (d[..., k].to(f64) * r[:, k].to(f64) + acc.to(f64)).float()
    rays_d = acc
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    if trans_origin:
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rays_o = rays_o + _trans_origin_scale(trans_origin) * unit
    return rays_o, rays_d


def get_rays_np(H: int, W: int, focal: float, c2w,
                focal_scale: float = 1.0, trans_origin: str = ""
                ) -> tuple[np.ndarray, np.ndarray]:
    """The numpy twin of ``get_rays`` (host-side ray generation for the
    pose loops of pseudo-data generation); the same arithmetic as the JAX
    package's, so the two give the same bits."""
    f = focal * focal_scale
    i = np.arange(W, dtype=np.float32)[None, :]
    j = np.arange(H, dtype=np.float32)[:, None]
    dirs = np.stack([
        np.broadcast_to((i - W * 0.5) / f, (H, W)),
        np.broadcast_to(-(j - H * 0.5) / f, (H, W)),
        -np.ones((H, W), dtype=np.float32)], axis=-1)
    c2w = np.asarray(c2w, dtype=np.float32)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape).copy()
    if trans_origin:
        unit = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = rays_o + _trans_origin_scale(trans_origin) * unit
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def ndc_rays(H: int, W: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp rays into NDC space (LLFF forward-facing scenes)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


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


def get_rand_pose(rng: np.random.Generator, radius: float = 4.0
                  ) -> np.ndarray:
    """Uniform random spherical pose: theta in [-180, 180], phi in
    [-90, 0]."""
    theta = rng.uniform(-180.0, 180.0)
    phi = rng.uniform(-90.0, 0.0)
    return pose_spherical(theta, phi, radius)


def get_novel_poses(n_pose, phi: float = -30.0,
                    radius: float = 4.0) -> np.ndarray:
    """Evenly spaced novel poses: an int gives a theta ring at fixed
    (phi, radius); [n_theta, n_phi, n_radius] gives the grid (theta ring
    in [-180, 180), phi interior of [-90, 0], radius interior of [2, 6]);
    a 'sample:N' item gives N even values on its axis, any other
    'mode:value' item that one fixed value."""
    if isinstance(n_pose, int):
        thetas = np.linspace(-180.0, 180.0, n_pose + 1)[:-1]
        return np.stack([pose_spherical(t, phi, radius) for t in thetas])

    def _axis(item, lo: float, hi: float, interior: bool):
        if isinstance(item, str) and ":" in item:
            mode, value = item.split(":", 1)
            if mode != "sample":
                return [float(value)]
            n = int(value)
        else:
            n = int(item)
        if interior:
            return np.linspace(lo, hi, n + 2)[1:-1]
        return np.linspace(lo, hi, n + 1)[:-1]

    thetas = _axis(n_pose[0], -180.0, 180.0, False)
    phis = _axis(n_pose[1], -90.0, 0.0, True)
    radii = _axis(n_pose[2], 2.0, 6.0, True)
    return np.stack([pose_spherical(t, p, r) for r in radii for p in phis
                     for t in thetas])
