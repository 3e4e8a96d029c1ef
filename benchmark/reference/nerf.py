"""The NeRF teacher's volumetric render, plain (Mildenhall et al., ECCV
2020; yenchenlin/nerf-pytorch ``render_rays``): stratified coarse depths,
the 8x256 MLP with its skip and view branch, alpha compositing, inverse-CDF
fine depths from the coarse weights, the fine network on the sorted union.
float32, TF32 off unless the caller's ``matmul_precision`` says otherwise.
The random draws (``u_strat`` [n, n_coarse], ``u_pdf`` [n, n_fine]) are
the benchmark's, handed to the program too.
"""
from __future__ import annotations

import numpy as np
import torch


def rays(c2w: np.ndarray, H: int, W: int, focal: float
         ) -> tuple[np.ndarray, np.ndarray]:
    """(origins, directions) [H*W, 3] float32 of pose ``c2w``: pixel (i, j)
    looks along R [(i - W/2)/f, -(j - H/2)/f, -1]."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                     -np.ones_like(i)], -1)
    R = np.asarray(c2w, np.float64)[:3, :3]
    d = (dirs.reshape(-1, 3).astype(np.float64) @ R.T).astype(np.float32)
    o = np.broadcast_to(np.asarray(c2w, np.float32)[:3, 3], d.shape)
    return np.ascontiguousarray(o), d


def embed(x: torch.Tensor, L: int) -> torch.Tensor:
    """[..., d] -> [..., d(2L+1)]: x, then sin(2^k x), cos(2^k x) for each
    k < L."""
    parts = [x]
    for k in range(L):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, -1)


def mlp(w: dict, cfg: dict, pts: torch.Tensor, views: torch.Tensor
        ) -> torch.Tensor:
    """raw [..., 4] (rgb logits, density) of points and view directions."""
    x = embed(pts, cfg["multires"])
    h = x
    for i in range(cfg["D"]):
        h = torch.relu(h @ w[f"pts_linears.{i}.weight"].T
                       + w[f"pts_linears.{i}.bias"])
        if i in cfg["skips"]:
            h = torch.cat([x, h], -1)
    alpha = h @ w["alpha_linear.weight"].T + w["alpha_linear.bias"]
    feat = h @ w["feature_linear.weight"].T + w["feature_linear.bias"]
    v = embed(views, cfg["multires_views"]).expand(*feat.shape[:-1], -1)
    h = torch.relu(torch.cat([feat, v], -1) @ w["views_linears.0.weight"].T
                   + w["views_linears.0.bias"])
    rgb = h @ w["rgb_linear.weight"].T + w["rgb_linear.bias"]
    return torch.cat([rgb, alpha], -1)


def composite(raw: torch.Tensor, z: torch.Tensor, d: torch.Tensor,
              white_bkgd: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(rgb [n, 3], weights [n, S])."""
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    weights = alpha * trans
    rgb = (weights[..., None] * torch.sigmoid(raw[..., :3])).sum(1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
    return rgb, weights


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF depths at the uniform draws ``u`` [n, m]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def render(w_coarse: dict, w_fine: dict, cfg: dict, o: torch.Tensor,
           d: torch.Tensor, u_strat: torch.Tensor, u_pdf: torch.Tensor
           ) -> torch.Tensor:
    """rgb [n, 3] of rays (o, d) [n, 3]."""
    n, S = o.shape[0], cfg["N_samples"]
    t = torch.arange(S, dtype=torch.float32, device=o.device) / (S - 1)
    z = cfg["near"] * (1.0 - t) + cfg["far"] * t
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]])
    lower = torch.cat([z[:1], mids])
    z = lower + (upper - lower) * u_strat
    views = (d / torch.linalg.norm(d, dim=-1, keepdim=True))[:, None, :]
    raw = mlp(w_coarse, cfg, o[:, None] + d[:, None] * z[..., None], views)
    _, weights = composite(raw, z, d, cfg["white_bkgd"])
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_fine = sample_pdf(z_mid, weights[:, 1:-1], u_pdf)
    z_all = torch.sort(torch.cat([z, z_fine], -1), -1).values
    raw = mlp(w_fine, cfg, o[:, None] + d[:, None] * z_all[..., None], views)
    rgb, _ = composite(raw, z_all, d, cfg["white_bkgd"])
    return rgb
