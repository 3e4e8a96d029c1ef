"""Point sampling along rays (the R2L ray representation).

Counterpart of ``r2l_tpu/sampler.py:25-108``. A ray is ``n_sample`` points
o + d*z for z evenly spaced in [near, far], flattened to a
[n_ray, n_sample*3] vector: the input of the R2L light-field MLP.
``sample_train`` takes the per-ray depths ``z`` as an argument instead of a
PRNG key, so a caller (or a test) decides the jitter; ``stratify_z`` makes
the stratified depths from uniform draws or a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from .rays import camera_ray_dirs, plucker


def linspace01(n: int, device: torch.device | str) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in f32, bit for bit: t = i * (1/(n-1))
    with an exact 1 at the end (``torch.linspace`` rounds differently)."""
    step = torch.tensor(1.0, dtype=torch.float32) / max(n - 1, 1)
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    if n > 1:
        t[-1] = 1.0
    return t


def even_z_vals(near: float, far: float, n_sample: int,
                device: torch.device | str) -> torch.Tensor:
    """Evenly spaced sample depths in [near, far], shape [n_sample]:
    ``near*(1-t) + far*t`` as in the reference, with ``linspace01``'s t."""
    t = linspace01(n_sample, device)
    return near * (1.0 - t) + far * t


def _strat_bounds(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bin [lower, upper] bounds of the stratified jitter: the bins are
    split at the midpoints of neighbouring depths."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower, upper


def stratify_z(z_vals: torch.Tensor, shape_prefix: tuple[int, ...],
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Stratified jitter of per-ray depths within their bins: z_vals
    [..., n_sample] (broadcast to ``shape_prefix + (n_sample,)``) ->
    lower + (upper - lower) * u.

    ``u`` are the uniform draws in [0, 1) of that shape, drawn by the caller
    (a test hands over JAX's); without them they are drawn from
    ``generator`` on the depths' device."""
    z = z_vals.expand(*shape_prefix, z_vals.shape[-1])
    lower, upper = _strat_bounds(z)
    if u is None:
        u = torch.rand(z.shape, generator=generator, dtype=z.dtype,
                       device=z.device)
    return lower + (upper - lower) * u


def ray_points(rays_o: torch.Tensor, rays_d: torch.Tensor,
               z_vals: torch.Tensor) -> torch.Tensor:
    """Sample points o + d*z. rays_o/d: [..., 3], z_vals: [..., n_sample]
    -> [..., n_sample, 3]."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]


@dataclasses.dataclass(frozen=True)
class PointSampler:
    """Sampling config for one camera intrinsics + depth range. Every
    method works on the device of the tensors it is given."""
    H: int
    W: int
    focal: float
    n_sample: int
    near: float
    far: float

    def z_vals(self, device: torch.device | str) -> torch.Tensor:
        return even_z_vals(self.near, self.far, self.n_sample, device)

    def frame_rays(self, c2w: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Flattened full-frame rays -> (rays_o, rays_d) each [H*W, 3].

        The rotation is three products summed elementwise, so it is full
        f32 whatever the matmul precision flags say."""
        dirs = camera_ray_dirs(self.H, self.W, self.focal, c2w.device)
        rot = c2w[:3, :3].to(torch.float32)
        rays_d = (dirs[..., None, :] * rot).sum(-1).reshape(-1, 3)
        rays_o = c2w[:3, -1].to(torch.float32).expand(rays_d.shape)
        return rays_o, rays_d

    def sample_test(self, c2w: torch.Tensor) -> torch.Tensor:
        """Full-frame even samples: c2w [3, 4] -> [H*W, n_sample*3]."""
        rays_o, rays_d = self.frame_rays(c2w)
        pts = ray_points(rays_o, rays_d, self.z_vals(c2w.device)[None, :])
        return pts.reshape(pts.shape[0], -1)

    def sample_train(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     z: torch.Tensor | None = None) -> torch.Tensor:
        """Batch samples: rays_o/d [n_ray, 3] -> [n_ray, n_sample*3].

        ``z`` [n_ray, n_sample] are pre-drawn (e.g. stratified) depths;
        ``None`` means the even depths (the reference's ``perturb=0``)."""
        if z is None:
            z = self.z_vals(rays_o.device).expand(rays_o.shape[0],
                                                  self.n_sample)
        pts = ray_points(rays_o, rays_d, z)
        return pts.reshape(pts.shape[0], -1)

    def sample_test_plucker(self, c2w: torch.Tensor) -> torch.Tensor:
        rays_o, rays_d = self.frame_rays(c2w)
        return plucker(rays_o, rays_d)
