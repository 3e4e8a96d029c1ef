"""Positional encoding of ray samples.

Counterpart of ``r2l_tpu/encoding.py:52-64`` (``r2l_embed``): the R2L
per-scalar layout [sin(s*2^0..2^{L-1}), cos(s*2^0..2^{L-1}), s] for each
input scalar s, flattened; 48-d ray samples with L=10 give 1008 dims.
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
