"""Random weights made from ``--seed`` on the device, in one draw a model:
the inputs that the benchmark hands to the program and to the reference
alike. Each weight and bias is U(+-1/sqrt(fan_in)) (``torch.nn.Linear``'s
default), keyed by the published models' state_dict names."""
from __future__ import annotations

import math

import torch


def _draw(shapes: dict[str, tuple], fan_in: dict[str, int],
          generator: torch.Generator) -> dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator, device=generator.device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in[name])
        out[name] = ((u[off:off + n] * 2.0 - 1.0) * bound).view(shape)
        off += n
    return out


def _linear(shapes, fan_in, name: str, fin: int, fout: int) -> None:
    shapes[name + ".weight"] = (fout, fin)
    shapes[name + ".bias"] = (fout,)
    fan_in[name + ".weight"] = fan_in[name + ".bias"] = fin


def r2l_weights(cfg: dict, generator: torch.Generator
                ) -> dict[str, torch.Tensor]:
    """The R2L student's state_dict (``head.0``, ``body.<i>.body.<2j>``,
    ``tail.0``: the reference ``NeRF_v3_2``'s names), f32."""
    shapes, fan_in = {}, {}
    W = cfg["netwidth"]
    _linear(shapes, fan_in, "head.0", cfg["input_dim"], W)
    for i in range(cfg["num_blocks"]):
        for j in range(cfg["n_learnable"]):
            _linear(shapes, fan_in, f"body.{i}.body.{2 * j}", W, W)
    _linear(shapes, fan_in, "tail.0", W, cfg["output_dim"])
    return _draw(shapes, fan_in, generator)


def nerf_weights(cfg: dict, generator: torch.Generator
                 ) -> dict[str, torch.Tensor]:
    """One NeRF network's state_dict (``pts_linears.<i>``,
    ``views_linears.0``, ``feature_linear``, ``alpha_linear``,
    ``rgb_linear``: nerf-pytorch's names), f32, with ``density_floor``
    added to the density head's bias."""
    shapes, fan_in = {}, {}
    W, cin, cv = cfg["W"], cfg["input_ch"], cfg["input_ch_views"]
    _linear(shapes, fan_in, "pts_linears.0", cin, W)
    for i in range(cfg["D"] - 1):
        _linear(shapes, fan_in, f"pts_linears.{i + 1}",
                W + cin if i in cfg["skips"] else W, W)
    if cfg["use_viewdirs"]:
        _linear(shapes, fan_in, "views_linears.0", cv + W, W // 2)
        _linear(shapes, fan_in, "feature_linear", W, W)
        _linear(shapes, fan_in, "alpha_linear", W, 1)
        _linear(shapes, fan_in, "rgb_linear", W // 2, 3)
    else:
        _linear(shapes, fan_in, "output_linear", W, cfg["output_ch"])
    out = _draw(shapes, fan_in, generator)
    if cfg["use_viewdirs"]:
        out["alpha_linear.bias"] += cfg.get("density_floor", 0.0)
    return out
