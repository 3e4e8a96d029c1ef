"""Volumetric (NeRF teacher) rendering: the plain path and the fused one.

Counterpart of ``r2l_tpu/render.py:60-319``. Rays are the parallel axis:
a frame's flat rays are padded to a multiple of ``ray_chunk`` (as
``_pad_to_multiple``) and rendered chunk by chunk; the compositing runs
along each ray's samples.

* ``render_frame_nerf``: the plain path (``render_rays_nerf`` per chunk:
  coarse depths, ``nerf_embed``, the ``NeRF`` module, ``raw2outputs``, then
  ``sample_pdf`` and the fine pass).
* ``render_frame_nerf_fused``: each pass of a chunk is one call of the
  fused volumetric kernel (``kernels/nerf_render.py``: points, positional
  encoding, the MLP and the compositing in one kernel, f32/bf16 or int8
  weights), around the same ``sample_pdf`` and sort. It is noise-free.

Randomness: JAX threads a key per chunk; here each chunk takes a
``ChunkDraws`` of uniform (and normal) draws, given by the caller (a test
hands over JAX's) or drawn from a ``torch.Generator`` in a fixed order per
chunk: the stratified jitter, the coarse sigma noise, the inverse-CDF draws,
the fine sigma noise, each only where the config needs it. Without draws or
a generator the render is deterministic (JAX's ``key=None``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from .encoding import nerf_embed
from .models.nerf import NeRF, NeRFConfig
from .sampler import even_z_vals, linspace01, stratify_z
from .volume import ray_points, raw2outputs, sample_pdf


@dataclasses.dataclass(frozen=True)
class VolRenderConfig:
    n_coarse: int = 64            # --N_samples
    n_fine: int = 0               # --N_importance
    perturb: bool = True
    lindisp: bool = False
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    use_viewdirs: bool = True
    multires: int = 10            # position PE bands
    multires_views: int = 4       # viewdir PE bands
    near: float = 2.0
    far: float = 6.0
    ray_chunk: int = 32768        # rays per chunk of a frame render


class VolOutputs(NamedTuple):
    rgb_map: torch.Tensor         # [n_ray, 3] (fine if n_fine > 0)
    disp_map: torch.Tensor
    acc_map: torch.Tensor
    depth_map: torch.Tensor
    rgb0: torch.Tensor | None     # coarse outputs when hierarchical
    disp0: torch.Tensor | None
    acc0: torch.Tensor | None
    z_std: torch.Tensor | None = None  # per-ray std of the fine samples


class ChunkDraws(NamedTuple):
    """The random draws of one chunk's render (None where unused)."""
    u_strat: torch.Tensor | None = None  # [n, n_coarse] uniform
    noise: torch.Tensor | None = None    # [n, n_coarse] normal
    u_pdf: torch.Tensor | None = None    # [n, n_fine] uniform
    noise2: torch.Tensor | None = None   # [n, n_coarse + n_fine] normal


def draw_chunk(vcfg: VolRenderConfig, n: int, generator: torch.Generator,
               fused: bool = False) -> ChunkDraws:
    """One chunk's draws from ``generator`` on its device, in the fixed
    order; ``fused`` draws no sigma noise (the fused path has none)."""
    dev = generator.device

    def rand(m, normal=False):
        f = torch.randn if normal else torch.rand
        return f((n, m), generator=generator, device=dev)

    noisy = vcfg.raw_noise_std > 0.0 and not fused
    hier = vcfg.n_fine > 0
    u_strat = rand(vcfg.n_coarse) if vcfg.perturb else None
    noise = rand(vcfg.n_coarse, True) if noisy else None
    u_pdf = rand(vcfg.n_fine) if (hier and vcfg.perturb) else None
    noise2 = (rand(vcfg.n_coarse + vcfg.n_fine, True)
              if (noisy and hier) else None)
    return ChunkDraws(u_strat, noise, u_pdf, noise2)


def coarse_z(vcfg: VolRenderConfig, n_ray: int, device: torch.device,
             u: torch.Tensor | None = None) -> torch.Tensor:
    """[n_ray, n_coarse] depths: even in depth (or in disparity with
    ``lindisp``), jittered within their bins by ``u`` when perturbing."""
    if vcfg.lindisp:
        t = linspace01(vcfg.n_coarse, device)
        z = 1.0 / (1.0 / vcfg.near * (1.0 - t) + 1.0 / vcfg.far * t)
    else:
        z = even_z_vals(vcfg.near, vcfg.far, vcfg.n_coarse, device)
    if u is not None and vcfg.perturb:
        return stratify_z(z, (n_ray,), u=u)
    return z.expand(n_ray, vcfg.n_coarse)


def _query_nerf(model: NeRF, ncfg: NeRFConfig, vcfg: VolRenderConfig,
                pts: torch.Tensor, viewdirs: torch.Tensor | None
                ) -> torch.Tensor:
    """pts [n_ray, n_s, 3] (+ viewdirs [n_ray, 3]) -> raw [n_ray, n_s, 4]."""
    emb = nerf_embed(pts, vcfg.multires)
    if vcfg.use_viewdirs:
        vemb = nerf_embed(viewdirs, vcfg.multires_views)
        vemb = vemb[:, None, :].expand(*pts.shape[:2], vemb.shape[-1])
        emb = torch.cat([emb, vemb], -1)
    return model(emb, ncfg)


def _fine_model(model_c, model_f, ncfg, ncfg_fine):
    """The fine pass's (model, config): the fine network where there is
    one, with its own config where one is given."""
    if model_f is None:
        return model_c, ncfg
    return model_f, (ncfg_fine if ncfg_fine is not None else ncfg)


def render_rays_nerf(model_c: NeRF, model_f: NeRF | None, ncfg: NeRFConfig,
                     vcfg: VolRenderConfig, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, draws: ChunkDraws | None = None,
                     ncfg_fine: NeRFConfig | None = None) -> VolOutputs:
    """The plain volumetric pass over a flat ray batch [n_ray, 3] x 2.
    ``draws=None`` is deterministic (eval). Differentiable in the networks'
    parameters (teacher training), with the gradient stopped where JAX
    stops it: the coarse weights that place the fine samples, and those
    samples."""
    n_ray = rays_o.shape[0]
    d = draws or ChunkDraws()
    viewdirs = None
    if vcfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    z_vals = coarse_z(vcfg, n_ray, rays_o.device, d.u_strat)
    raw = _query_nerf(model_c, ncfg, vcfg,
                      ray_points(rays_o, rays_d, z_vals), viewdirs)
    out_c = raw2outputs(raw, z_vals, rays_d, vcfg.raw_noise_std,
                        vcfg.white_bkgd, noise=d.noise)
    if vcfg.n_fine <= 0:
        return VolOutputs(out_c.rgb_map, out_c.disp_map, out_c.acc_map,
                          out_c.depth_map, None, None, None)
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, out_c.weights[..., 1:-1].detach(),
                           vcfg.n_fine,
                           det=(draws is None or not vcfg.perturb),
                           u=d.u_pdf).detach()
    z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
    model, nf = _fine_model(model_c, model_f, ncfg, ncfg_fine)
    raw_f = _query_nerf(model, nf, vcfg,
                        ray_points(rays_o, rays_d, z_all), viewdirs)
    out_f = raw2outputs(raw_f, z_all, rays_d, vcfg.raw_noise_std,
                        vcfg.white_bkgd, noise=d.noise2)
    z_std = z_samples.std(-1, unbiased=False)
    return VolOutputs(out_f.rgb_map, out_f.disp_map, out_f.acc_map,
                      out_f.depth_map, out_c.rgb_map, out_c.disp_map,
                      out_c.acc_map, z_std)


def _pad_to_multiple(x: torch.Tensor, m: int) -> tuple[torch.Tensor, int]:
    n = x.shape[0]
    pad = (-n) % m
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], 0)
    return x, n


def _chunks(vcfg: VolRenderConfig, rays_o: torch.Tensor,
            rays_d: torch.Tensor, draws: Sequence[ChunkDraws] | None,
            generator: torch.Generator | None, fused: bool):
    """Yield (o, d, chunk draws or None) over the padded chunks."""
    chunk = min(vcfg.ray_chunk, max(rays_o.shape[0], 1))
    ro, _ = _pad_to_multiple(rays_o, chunk)
    rd, _ = _pad_to_multiple(rays_d, chunk)
    n_chunks = ro.shape[0] // chunk
    if draws is not None and len(draws) != n_chunks:
        raise ValueError(f"{len(draws)} chunk draws for {n_chunks} chunks")
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        if draws is not None:
            dr = draws[i]
        elif generator is not None:
            dr = draw_chunk(vcfg, chunk, generator, fused=fused)
        else:
            dr = None
        yield ro[sl].contiguous(), rd[sl].contiguous(), dr


def _frame_dict(parts: list, n: int) -> dict[str, torch.Tensor]:
    rgb, disp, acc, depth = (torch.cat(p, 0)[:n] for p in zip(*parts))
    return {"rgb": rgb, "disp": disp, "acc": acc, "depth": depth}


@torch.no_grad()
def render_frame_nerf(model_c: NeRF, model_f: NeRF | None, ncfg: NeRFConfig,
                      vcfg: VolRenderConfig, rays_o: torch.Tensor,
                      rays_d: torch.Tensor,
                      draws: Sequence[ChunkDraws] | None = None,
                      generator: torch.Generator | None = None,
                      ncfg_fine: NeRFConfig | None = None
                      ) -> dict[str, torch.Tensor]:
    """Chunked full-frame render over flat rays [N, 3] x 2 -> {'rgb',
    'disp', 'acc', 'depth'}, each [N, ...]. ``draws`` holds one
    ``ChunkDraws`` per chunk; without it they come from ``generator``."""
    parts = []
    for o, d, dr in _chunks(vcfg, rays_o, rays_d, draws, generator, False):
        out = render_rays_nerf(model_c, model_f, ncfg, vcfg, o, d, dr,
                               ncfg_fine=ncfg_fine)
        parts.append((out.rgb_map, out.disp_map, out.acc_map,
                      out.depth_map))
    return _frame_dict(parts, rays_o.shape[0])


def prepare_fused_teacher(model_c: NeRF, model_f: NeRF | None,
                          ncfg: NeRFConfig, vcfg: VolRenderConfig,
                          ncfg_fine: NeRFConfig | None = None,
                          int8_calib: tuple | None = None,
                          fold_requant: bool = False) -> tuple:
    """Pack the coarse and fine networks for the fused kernel: (coarse,
    fine). ``int8_calib = (pts [n, 3], viewdirs [n, 3] | None)`` switches
    both to static-scale int8, calibrated on those points; otherwise the
    weights take each config's compute dtype."""
    from .kernels.nerf_render import prepare_fused_nerf
    model, nf = _fine_model(model_c, model_f, ncfg, ncfg_fine)

    def pack(m, cfg):
        return prepare_fused_nerf(m, cfg, vcfg.multires,
                                  vcfg.multires_views, calib=int8_calib,
                                  weight_dtype=cfg.compute_dtype,
                                  fold_requant=fold_requant)

    fpc = pack(model_c, ncfg)
    fpf = pack(model, nf) if model_f is not None else fpc
    return fpc, fpf


@torch.no_grad()
def render_frame_nerf_fused(model_c: NeRF, model_f: NeRF | None,
                            ncfg: NeRFConfig, vcfg: VolRenderConfig,
                            rays_o: torch.Tensor, rays_d: torch.Tensor,
                            draws: Sequence[ChunkDraws] | None = None,
                            generator: torch.Generator | None = None,
                            ncfg_fine: NeRFConfig | None = None,
                            int8_calib: tuple | None = None,
                            fold_requant: bool = False,
                            packed: tuple | None = None
                            ) -> dict[str, torch.Tensor]:
    """The contract of ``render_frame_nerf``, with each pass of a chunk
    (coarse, then fine) one call of the fused volumetric kernel. Noise-free:
    ``vcfg.raw_noise_std`` must be 0. ``packed`` is the output of
    ``prepare_fused_teacher`` (made here from ``int8_calib`` and
    ``fold_requant`` if None), so a caller that renders many frames packs
    (and calibrates) once; the packing carries the int8 mode and the fold,
    so with ``packed`` neither is given again."""
    assert vcfg.raw_noise_std == 0.0, \
        "fused render path is noise-free; use render_frame_nerf"
    from .kernels.nerf_render import fused_nerf_render
    if packed is not None and (int8_calib is not None or fold_requant):
        raise ValueError("int8_calib and fold_requant are packing arguments;"
                         " the packed parameters already carry them")
    fpc, fpf = packed or prepare_fused_teacher(
        model_c, model_f, ncfg, vcfg, ncfg_fine, int8_calib, fold_requant)
    nf = _fine_model(model_c, model_f, ncfg, ncfg_fine)[1]
    kw = dict(L_pts=vcfg.multires, L_views=vcfg.multires_views,
              white_bkgd=vcfg.white_bkgd)
    det = draws is None and generator is None
    parts = []
    for o, d, dr in _chunks(vcfg, rays_o, rays_d, draws, generator, True):
        dr = dr or ChunkDraws()
        z = coarse_z(vcfg, o.shape[0], o.device, dr.u_strat).contiguous()
        rgb, acc, depth, w = fused_nerf_render(fpc, ncfg, o, d, z, **kw)
        if vcfg.n_fine > 0:
            z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
            z_samp = sample_pdf(z_mid, w[:, 1:-1], vcfg.n_fine,
                                det=(det or not vcfg.perturb), u=dr.u_pdf)
            z_all = torch.sort(torch.cat([z, z_samp], -1), -1).values
            rgb, acc, depth, _ = fused_nerf_render(fpf, nf, o, d,
                                                   z_all.contiguous(), **kw)
        # as raw2outputs: acc == 0 gives NaN on both paths
        disp = 1.0 / torch.clamp(depth / acc, min=1e-10)
        parts.append((rgb, disp, acc, depth))
    return _frame_dict(parts, rays_o.shape[0])
