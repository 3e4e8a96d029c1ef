"""FLOPs and parameter accounting from the parameters alone.

Counterpart of the parameter-based counts of ``r2l_tpu/flops.py:17-86``
(``count_params``, ``param_bytes``, ``r2l_analytic_flops_per_pixel``,
``flops_per_pixel_from_params``, ``nerf_flops_per_pixel_from_params``), the
numbers the reference logs as "FLOPs/pixel" from forward hooks
(`smilelogging/utils.py:129-138,259-316`, `main.py:538-552`). The JAX
module's ``xla_cost`` and ``flops_per_pixel`` read XLA's cost analysis of a
compiled function and have no torch counterpart: they are not ported.

``params`` is a torch module (the student or a teacher network); its
parameters are counted.
"""
from __future__ import annotations

import torch


def count_params(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def param_bytes(params: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def r2l_analytic_flops_per_pixel(cfg) -> float:
    """Closed-form matmul FLOPs/ray for the CANONICAL resmlp body
    (W256/D88 -> 11.79M, matching the paper table in BASELINE.md).
    For mlp / layerwise / odd-depth bodies use
    ``flops_per_pixel_from_params`` — this formula assumes a uniform
    num_blocks x n_learnable x W^2 body."""
    return 2.0 * (cfg.input_dim * cfg.netwidth
                  + cfg.num_blocks * cfg.n_learnable * cfg.netwidth ** 2
                  + cfg.netwidth * cfg.output_dim)


def flops_per_pixel_from_params(params: torch.nn.Module) -> float:
    """Matmul FLOPs/ray counted from the ACTUAL weight shapes: one ray
    uses every linear once, so FLOPs = 2 * sum(in*out) over the weight
    matrices, exact for any body architecture (mlp, layerwise widths,
    resmlp, the teacher). Matches the reference's hook counter with
    ``count_adds=False`` (the reference's `main.py:546-552`,
    `smilelogging/utils.py:259-316`)."""
    return float(sum(2 * m.weight.numel() for m in params.modules()
                     if isinstance(m, torch.nn.Linear)))


def nerf_flops_per_pixel_from_params(params: torch.nn.Module,
                                     n_samples: int,
                                     n_importance: int) -> float:
    """Teacher FLOPs/pixel, reference semantics (`main.py:541-545`):
    one per-point forward's matmul FLOPs times the number of network
    queries per pixel — coarse pass N_samples points plus fine pass
    (N_samples + N_importance) points, i.e. (2*N_samples + N_importance)
    total (the reference multiplies the single-model count by that sum,
    coarse and fine sharing the same architecture)."""
    return flops_per_pixel_from_params(params) * (2 * n_samples
                                                  + n_importance)
