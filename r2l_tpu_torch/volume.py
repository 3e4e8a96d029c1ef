"""Volumetric rendering math: alpha compositing and hierarchical resampling.

Counterpart of ``r2l_tpu/volume.py``, with the reference's constants: the
1e10 far-distance pad, the 1e-10 transmittance epsilon, the 1e-5 pdf floor
and ``denom < 1e-5`` guard, sigmoid on RGB, relu on sigma, and
``disp = 1/max(1e-10, depth/acc)``, which is NaN where acc == 0 (as in the
reference). The JAX package's gather-free bin lookup in ``sample_pdf`` is a
TPU artefact: ``torch.searchsorted`` and ``gather`` with the same clamping
give the same values. Random draws are arguments (or come from a
``torch.Generator``), so a test can hand over JAX's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .sampler import linspace01


class RenderOutputs(NamedTuple):
    rgb_map: torch.Tensor    # [n_ray, 3]
    disp_map: torch.Tensor   # [n_ray]
    acc_map: torch.Tensor    # [n_ray]
    weights: torch.Tensor    # [n_ray, n_sample]
    depth_map: torch.Tensor  # [n_ray]


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once to f32, as XLA contracts it on the CPU and as
    the CUDA kernels compute it (``__fmaf_rn``): the product of two f32
    values is exact in float64, so only the sum rounds before the final
    rounding (a double rounding that differs from a true FMA only when the
    float64 sum lands exactly on an f32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def ray_points(rays_o: torch.Tensor, rays_d: torch.Tensor,
               z_vals: torch.Tensor) -> torch.Tensor:
    """Sample points o + d*z as one FMA per coordinate: rays_o/d [..., 3],
    z_vals [..., S] -> [..., S, 3]. The positional encoding's ladder
    doubles an ulp of a point L-1 times, so the rounding here matters."""
    return fma(rays_d[..., None, :], z_vals[..., :, None],
               rays_o[..., None, :])


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor, raw_noise_std: float = 0.0,
                white_bkgd: bool = False, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> RenderOutputs:
    """Alpha-composite raw network outputs into per-ray maps.

    raw [n_ray, n_sample, 4] (rgb logits, sigma), z_vals [n_ray, n_sample],
    rays_d [n_ray, 3]. With ``raw_noise_std > 0`` the sigma noise is
    ``noise`` (standard normal draws of sigma's shape) or drawn from
    ``generator``."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            if generator is None:
                raise ValueError("raw_noise_std > 0 needs noise or a "
                                 "generator")
            noise = torch.randn(sigma.shape, generator=generator,
                                device=sigma.device)
        sigma = sigma + noise * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
        -1)[..., :-1]
    weights = alpha * trans
    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z_vals).sum(-1)
    acc_map = weights.sum(-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, u: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF importance sampling of new depths from coarse weights:
    bins [n_ray, n_bin], weights [n_ray, n_bin - 1] -> [n_ray, n_samples].

    ``det`` takes ``jnp.linspace(0, 1, n_samples)``'s u; otherwise ``u``
    [n_ray, n_samples] are the uniform draws (a test hands over JAX's), or
    they are drawn from ``generator``."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    n_bin1 = cdf.shape[-1]
    shape = (*cdf.shape[:-1], n_samples)
    if det:
        u = linspace01(n_samples, cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()
    # inds = searchsorted(cdf, u, 'right'); below = inds - 1 (cdf[0] == 0
    # <= u, so never -1); above = min(inds, n_bin1 - 1); the bins index is
    # clamped to len(bins) - 1.
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = inds - 1
    above = inds.clamp(max=n_bin1 - 1)
    last = bins.shape[-1] - 1
    cdf_g0, cdf_g1 = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_g0 = bins.gather(-1, below.clamp(max=last))
    bins_g1 = bins.gather(-1, above.clamp(max=last))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return fma(t, bins_g1 - bins_g0, bins_g0)
