"""Positional encoding of ray samples and of NeRF teacher inputs.

Counterpart of ``r2l_tpu/encoding.py:27-64``. Two layouts:

* ``r2l_embed``: the R2L per-scalar layout [sin(s*2^0..2^{L-1}),
  cos(s*2^0..2^{L-1}), s] for each input scalar s, flattened; 48-d ray
  samples with L=10 give 1008 dims.
* ``nerf_embed``: the NeRF per-frequency layout applied to whole vectors,
  [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]; a 3-d point with
  L=10 gives 63 dims, a view direction with L=4 gives 27.
"""
from __future__ import annotations

import torch


def r2l_embed(x: torch.Tensor, L: int,
              include_input: bool = True) -> torch.Tensor:
    """[..., dim] -> [..., dim*(2L+1)] in the per-scalar layout."""
    freqs = 2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)
    y = x[..., None] * freqs                               # [..., dim, L]
    parts = [torch.sin(y), torch.cos(y)]
    if include_input:
        parts.append(x[..., None])
    y = torch.cat(parts, dim=-1)                           # [..., dim, 2L+1]
    return y.reshape(*x.shape[:-1], -1)


def nerf_embed_dim(input_dims: int, L: int,
                   include_input: bool = True) -> int:
    return input_dims * (2 * L + (1 if include_input else 0))


def nerf_embed(x: torch.Tensor, L: int,
               include_input: bool = True) -> torch.Tensor:
    """[..., d] -> [..., d*(2L+1)] in the per-frequency layout; ``L == 0``
    is the identity (or nothing without the input)."""
    if L == 0:
        return x if include_input else x[..., :0]
    freqs = 2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)
    y = x[..., None, :] * freqs[:, None]                   # [..., L, d]
    sc = torch.stack([torch.sin(y), torch.cos(y)], dim=-2)  # [..., L, 2, d]
    sc = sc.reshape(*x.shape[:-1], 2 * L * x.shape[-1])
    return torch.cat([x, sc], dim=-1) if include_input else sc
