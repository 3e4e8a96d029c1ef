"""NeRF teacher MLP (the classic 8x256 with a skip concat and a view branch).

Counterpart of ``r2l_tpu/models/nerf.py``: D linears with ReLU, the input
concatenated again after each layer in ``skips``; with viewdirs a sigma head
(``alpha_linear``), a feature linear, one W/2 view layer and an RGB head,
else one ``output_linear``. ``NeRF.forward`` computes what ``apply_nerf``
computes, with the same rounding points: each dot is accumulated in f32, the
f32 bias is added, and the sum is cast to the compute dtype; the raw output
is f32. f32 matmuls run in full f32 (``NeRFConfig`` has no ``precision``).

Module names follow the reference ``NeRF`` state_dict (``pts_linears.{i}``,
``views_linears.0``, ``feature_linear``, ``alpha_linear``, ``rgb_linear``,
``output_linear``), so a reference ``network_fn_state_dict`` loads with
``load_state_dict``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ._layout import Entry, from_jax, host_tree, linear, named, to_jax


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    input_ch: int = 63          # nerf_embed_dim(3, L=10)
    input_ch_views: int = 27    # nerf_embed_dim(3, L=4)
    output_ch: int = 4
    skips: tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    compute_dtype: torch.dtype = torch.float32  # activation dtype


def _linear(h: torch.Tensor, m: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """The dot of h and m's weight in ``cd`` accumulated in f32, plus the
    f32 bias, cast to ``cd`` (``_linear`` of the JAX model). bf16 products
    are exact in f32, so an f32 matmul of the bf16 values is that dot."""
    out = h.to(cd).float() @ m.weight.to(cd).float().T + m.bias.float()
    return out.to(cd)


class NeRF(nn.Module):
    """x [..., input_ch (+ input_ch_views)] -> raw [..., 4] f32 (rgb
    logits, sigma)."""

    def __init__(self, cfg: NeRFConfig,
                 device: torch.device | str = torch.device("cuda")):
        super().__init__()
        self.cfg = cfg

        def lin(fan_in: int, fan_out: int) -> nn.Linear:
            return nn.Linear(fan_in, fan_out, device=device)

        self.pts_linears = nn.ModuleList(
            [lin(cfg.input_ch, cfg.W)]
            + [lin(cfg.W + cfg.input_ch if i in cfg.skips else cfg.W, cfg.W)
               for i in range(cfg.D - 1)])
        if cfg.use_viewdirs:
            self.views_linears = nn.ModuleList(
                [lin(cfg.input_ch_views + cfg.W, cfg.W // 2)])
            self.feature_linear = lin(cfg.W, cfg.W)
            self.alpha_linear = lin(cfg.W, 1)
            self.rgb_linear = lin(cfg.W // 2, 3)
        else:
            self.output_linear = lin(cfg.W, cfg.output_ch)

    def forward(self, x: torch.Tensor,
                cfg: NeRFConfig | None = None) -> torch.Tensor:
        """``cfg`` overrides the module's own (as ``apply_nerf`` takes the
        config apart from the parameters): its compute dtype is used."""
        cfg = cfg or self.cfg
        cd = cfg.compute_dtype
        input_pts = x[..., :cfg.input_ch].to(cd)
        h = input_pts
        for i, m in enumerate(self.pts_linears):
            h = torch.relu(_linear(h, m, cd))
            if i in cfg.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if cfg.use_viewdirs:
            views = x[..., cfg.input_ch:cfg.input_ch
                      + cfg.input_ch_views].to(cd)
            alpha = _linear(h, self.alpha_linear, cd)
            h = torch.cat([_linear(h, self.feature_linear, cd), views], -1)
            for m in self.views_linears:
                h = torch.relu(_linear(h, m, cd))
            rgb = _linear(h, self.rgb_linear, cd)
            return torch.cat([rgb, alpha], dim=-1).float()
        return _linear(h, self.output_linear, cd).float()


def init_nerf(cfg: NeRFConfig, generator: torch.Generator,
              device: torch.device | str = torch.device("cuda")) -> NeRF:
    """A ``NeRF`` with U(±1/sqrt(fan_in)) for every weight and bias (the
    JAX package's init and ``nn.Linear``'s default), drawn from
    ``generator`` on its own device, so a CPU generator gives the same
    weights on every target device. The model lives on the card unless
    ``device`` says otherwise."""
    model = NeRF(cfg, device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=generator,
                                   device=generator.device)
                    p.copy_((u * 2.0 - 1.0) * bound)
    return model


def nerf_table(D: int, use_viewdirs: bool) -> list[Entry]:
    """Each ``NeRF`` parameter's state_dict name and place in the JAX
    pytree (``pts_linears`` and ``views_linears`` lists, the heads)."""
    table = []
    for i in range(D):
        table += linear(f"pts_linears.{i}", ("pts_linears", i))
    if use_viewdirs:
        table += linear("views_linears.0", ("views_linears", 0))
        for name in ("feature_linear", "alpha_linear", "rgb_linear"):
            table += linear(name, (name,))
    else:
        table += linear("output_linear", ("output_linear",))
    return table


def nerf_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``r2l_tpu`` teacher param pytree (numpy arrays, weights [in, out];
    lists as lists or as a checkpoint's "0", "1", ... dicts) -> ``NeRF``
    state_dict (weights [out, in])."""
    table = nerf_table(len(params["pts_linears"]), "alpha_linear" in params)
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in from_jax(params, table).items()}


def nerf_params_to_jax(model_c: NeRF) -> dict:
    """The inverse of ``nerf_params_from_jax``: the teacher's parameters as
    the ``r2l_tpu`` pytree of numpy f32 arrays."""
    table = nerf_table(model_c.cfg.D, model_c.cfg.use_viewdirs)
    return host_tree(to_jax(named(model_c), table))
