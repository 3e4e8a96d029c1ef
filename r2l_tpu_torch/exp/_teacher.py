"""The teacher-frame drivers' shared setup (``exp/probe_teacher_int8.py:40-
71``, repeated by ``probe_teacher_fold.py``, ``probe_teacher_chunk.py`` and,
in part, ``probe_teacher_decomp.py``).

The teacher is the canonical NeRF: 8 layers of width 256 with a skip at 4,
view directions, the positional encodings at L = 10 (points) and 4 (views),
bf16 compute; 64 coarse and 128 fine samples, no perturbation, a white
background, near 2 and far 6, 400x400 frames at lego's focal. The coarse
and the fine network come from one seeded generator, in that order, each
with 1 added to its density head's bias (``DENSITY_FLOOR``, as
``chip_smoke.py``'s teachers): at a random teacher's density near 0, the
last sample's alpha (its distance 1e10) flips between 0 and 1 at any
rounding change, which on the card put K6, K7 and the plain render 0.46
apart on a few rays of a frame; the JAX drivers' teachers have no floor.
The int8 calibration of the JAX drivers: every 640th ray of each frame at 9
even depths in [2, 6], with the rays' normalised view directions.

Each setup function takes an explicit device (and a seeded
``torch.Generator`` where it draws), so the tests build the same pieces on
the CPU at small sizes, where the kernels run their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..encoding import nerf_embed_dim
from ..models.nerf import NeRF, NeRFConfig, init_nerf
from ..rays import get_rays
from ..render import VolRenderConfig
from . import _harness

H = W = _harness.LEGO_HW
FOCAL = _harness.LEGO_FOCAL
K = 4                   # frames per call
D, WIDTH, SKIPS = 8, 256, (4,)
L_PTS, L_VIEWS = 10, 4
N_COARSE, N_FINE = 64, 128
CHUNK = 32768           # rays per chunk of a frame
CALIB_EVERY, CALIB_DEPTHS = 640, 9
SEED = 0                # the networks' weights
DENSITY_FLOOR = 1.0     # added to alpha_linear's bias


def nerf_cfg(D: int = D, W: int = WIDTH, skips: tuple = SKIPS,
             L: int = L_PTS, Lv: int = L_VIEWS) -> NeRFConfig:
    """The teacher's config (a test passes smaller widths)."""
    return NeRFConfig(D=D, W=W, skips=skips, use_viewdirs=True,
                      input_ch=nerf_embed_dim(3, L),
                      input_ch_views=nerf_embed_dim(3, Lv), output_ch=5,
                      compute_dtype=torch.bfloat16)


def vol_cfg(n_coarse: int = N_COARSE, n_fine: int = N_FINE,
            chunk: int = CHUNK, L: int = L_PTS,
            Lv: int = L_VIEWS) -> VolRenderConfig:
    """The render's config: deterministic, white background."""
    return VolRenderConfig(n_coarse=n_coarse, n_fine=n_fine, perturb=False,
                           use_viewdirs=True, white_bkgd=True, near=2.0,
                           far=6.0, ray_chunk=chunk, multires=L,
                           multires_views=Lv)


def networks(ncfg: NeRFConfig, generator: torch.Generator, device,
             density_floor: float = DENSITY_FLOOR) -> tuple[NeRF, NeRF]:
    """(coarse, fine), drawn from ``generator`` in that order, the density
    head's bias raised by ``density_floor``."""
    nets = (init_nerf(ncfg, generator, device),
            init_nerf(ncfg, generator, device))
    with torch.no_grad():
        for m in nets:
            m.alpha_linear.bias += density_floor
    return nets


def frame_rays(k: int, device, hw: int = H, focal: float = FOCAL
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k frames' rays (rays_o, rays_d), each [k, hw * hw, 3], of the
    poses ``pose_spherical(theta, -30, 4)``, theta evenly over the
    circle."""
    ro, rd = zip(*(get_rays(hw, hw, focal, p, device=device)
                   for p in _harness.lego_poses(k)))
    return (torch.stack(ro).reshape(k, -1, 3),
            torch.stack(rd).reshape(k, -1, 3))


def calibration(ro: torch.Tensor, rd: torch.Tensor,
                every: int = CALIB_EVERY, n_depth: int = CALIB_DEPTHS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 calibration (points [n, 3], view directions [n, 3]) of frames
    ``ro``/``rd`` [k, N, 3]: every ``every``-th ray of each frame at
    ``n_depth`` even depths in [2, 6], o + d * z as numpy computes it (a
    product, then a sum), with the ray's normalised direction."""
    z = torch.from_numpy(np.linspace(2.0, 6.0, n_depth, dtype=np.float32)
                         ).to(ro.device)
    o, d = ro[:, ::every], rd[:, ::every]
    pts = (o[:, :, None, :] + d[:, :, None, :] * z[:, None]).reshape(-1, 3)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    vds = vd[:, :, None, :].expand(*vd.shape[:2], n_depth, 3).reshape(-1, 3)
    return pts, vds


def point_ops(ncfg: NeRFConfig) -> float:
    """Multiply-adds x 2 of the teacher MLP for one point (unpadded)."""
    W_ = ncfg.W
    macs = ncfg.input_ch * W_ + sum(
        (W_ + ncfg.input_ch if i in ncfg.skips else W_) * W_
        for i in range(ncfg.D - 1))
    macs += W_ + W_ * W_ + (W_ + ncfg.input_ch_views) * (W_ // 2) \
        + (W_ // 2) * 3
    return 2.0 * macs


def frame_ops(ncfg: NeRFConfig, vcfg: VolRenderConfig, n_rays: int
              ) -> float:
    """Operations of one frame: the coarse pass's points and the fine
    pass's (coarse + fine samples)."""
    return (point_ops(ncfg) * n_rays
            * (vcfg.n_coarse + (vcfg.n_coarse + vcfg.n_fine
                                if vcfg.n_fine > 0 else 0)))


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB of a against b (values in [0, 1]); inf where equal."""
    mse = float((a.double() - b.double()).pow(2).mean())
    return float("inf") if mse == 0 else -10.0 * float(np.log10(mse))


def rgb_errors(rgb: torch.Tensor, ref: torch.Tensor, tag: str) -> dict:
    """``rgb_err_vs_<tag>_max``/``_mean`` (the JAX drivers' fields) and
    ``psnr_vs_<tag>``."""
    err = (rgb - ref).abs()
    return {f"rgb_err_vs_{tag}_max": float(err.max()),
            f"rgb_err_vs_{tag}_mean": float(err.mean()),
            f"psnr_vs_{tag}": psnr(rgb, ref)}
