"""R2L student: a deep residual-MLP neural light field (ray -> RGB).

Counterpart of ``r2l_tpu/models/r2l.py:28-194``. ``R2L.forward`` computes
what ``apply_r2l`` computes, with the same rounding points in the compute
dtype: each dot is accumulated in f32 and cast to the compute dtype, then the
bias is added in the compute dtype; the tail dot stays f32. Parameters are
kept in f32 and cast at use, as the JAX pytree is.

Module names follow the reference ``NeRF_v3_2`` state_dict
(``head.0``, ``body.<i>.body.<2j>``, ``tail.0`` or ``tail``), so the
reference ``.tar`` checkpoints and ``tools/export_torch_ckpt.py`` output load
with ``load_state_dict``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class R2LConfig:
    input_dim: int = 1008          # n_sample*3*(2L+1) = 16*3*21
    output_dim: int = 3
    netdepth: int = 88             # D (reference --netdepth)
    netwidth: int = 256            # W (reference --netwidth)
    n_block: int = -1              # -1 -> (D-2)//2 (reference trial.n_block)
    n_learnable: int = 2           # linears per block
    act: str = "relu"              # head activation
    inact: str = "relu"            # within-block activation
    outact: str = "none"           # block output activation
    res_scale: float = 1.0
    body_arch: str = "resmlp"      # 'resmlp' | 'mlp'
    use_residual: bool = True      # global body(x) + x
    linear_tail: bool = False      # tail without sigmoid
    layerwise_widths: tuple = ()   # per-layer widths of the plain-MLP body
    compute_dtype: torch.dtype = torch.float32  # activation dtype

    @property
    def num_blocks(self) -> int:
        return r2l_num_blocks(self.netdepth, self.n_block)

    @property
    def widths(self) -> list:
        """Per-layer widths Ws[0..D-1]: the given list plus a trailing 3,
        uniform netwidth otherwise."""
        if self.layerwise_widths:
            ws = list(self.layerwise_widths) + [3]
            if len(ws) < self.netdepth - 1:
                raise ValueError(
                    f"layerwise_netwidths needs >= netdepth-2 = "
                    f"{self.netdepth - 2} entries, got {len(ws) - 1}")
            return ws
        return [self.netwidth] * (self.netdepth - 1) + [3]


def r2l_num_blocks(netdepth: int, n_block: int = -1) -> int:
    return n_block if n_block > 0 else (netdepth - 2) // 2


def _activation(name: str) -> nn.Module:
    """The reference's activation module; ``nn.Identity`` for 'none'."""
    name = name.lower()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(0.01)
    if name == "none":
        return nn.Identity()
    raise NotImplementedError(f"activation {name!r}")


class _ResBlock(nn.Module):
    """Reference ``ResMLP``: ``body`` alternates Linear and the in-block
    activation, so the Linears sit at the even indices."""

    def __init__(self, width: int, n_learnable: int, inact: str,
                 device: torch.device | str):
        super().__init__()
        layers: list[nn.Module] = []
        for j in range(n_learnable):
            layers.append(nn.Linear(width, width, device=device))
            if j < n_learnable - 1:
                layers.append(_activation(inact))
        self.body = nn.Sequential(*layers)


class R2L(nn.Module):
    """x [..., input_dim] -> [..., output_dim] f32 (``apply_r2l``)."""

    def __init__(self, cfg: R2LConfig, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        Ws, D = cfg.widths, cfg.netdepth
        self.head = nn.Sequential(nn.Linear(cfg.input_dim, Ws[0],
                                            device=device))
        if cfg.body_arch == "resmlp":
            self.body = nn.ModuleList(
                _ResBlock(cfg.netwidth, cfg.n_learnable, cfg.inact, device)
                for _ in range(cfg.num_blocks))
        elif cfg.body_arch == "mlp":
            layers: list[nn.Module] = []
            for i in range(1, D - 1):
                layers += [nn.Linear(Ws[i - 1], Ws[i], device=device),
                           _activation(cfg.act)]
            self.body = nn.Sequential(*layers)
        else:
            raise NotImplementedError(cfg.body_arch)
        tail = nn.Linear(Ws[D - 2], cfg.output_dim, device=device)
        self.tail = tail if cfg.linear_tail else nn.Sequential(tail,
                                                               nn.Sigmoid())
        self.act = _activation(cfg.act)
        self.outact = _activation(cfg.outact)

    def linears(self) -> tuple[nn.Linear, list[nn.Linear], nn.Linear]:
        """(head, body linears in forward order, tail)."""
        body = [m for m in self.body.modules() if isinstance(m, nn.Linear)]
        tail = self.tail if self.cfg.linear_tail else self.tail[0]
        return self.head[0], body, tail

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cd = cfg.compute_dtype

        def lin(m: nn.Linear, h: torch.Tensor) -> torch.Tensor:
            # dot accumulated in f32 and cast to cd, then the bias in cd
            return (h @ m.weight.to(cd).T) + m.bias.to(cd)

        h = self.act(lin(self.head[0], x.to(cd)))
        if cfg.body_arch == "resmlp":
            out = h
            for blk in self.body:
                t = out
                for m in blk.body:
                    t = lin(m, t) if isinstance(m, nn.Linear) else m(t)
                out = self.outact(t * cfg.res_scale + out)
        else:
            out = h
            for m in self.body:
                out = lin(m, out) if isinstance(m, nn.Linear) else m(out)
        out = out + h if cfg.use_residual else out

        _, _, tail = self.linears()
        y = out.float() @ tail.weight.to(cd).float().T + tail.bias.float()
        return y if cfg.linear_tail else torch.sigmoid(y)


def init_r2l(cfg: R2LConfig, generator: torch.Generator,
             device: torch.device | str = "cpu") -> R2L:
    """An ``R2L`` with the torch.nn.Linear default init U(±1/sqrt(fan_in))
    for every weight and bias, drawn from ``generator`` on its own device
    (so a CPU generator gives the same weights on every target device)."""
    model = R2L(cfg, device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=generator,
                                   device=generator.device)
                    p.copy_((u * 2.0 - 1.0) * bound)
    return model


def params_from_jax(np_params: dict, cfg: R2LConfig
                    ) -> dict[str, torch.Tensor]:
    """``r2l_tpu`` param pytree (numpy arrays) -> ``R2L`` state_dict.

    JAX stores weights [in, out] and ``nn.Linear`` [out, in], so every
    weight is transposed (``r2l_tpu/checkpoint.py::params_to_torch_r2l``).
    """
    def t(a) -> torch.Tensor:
        if not isinstance(a, np.ndarray):
            raise TypeError(f"params_from_jax takes numpy arrays, got "
                            f"{type(a).__name__}")
        return torch.from_numpy(np.array(a, np.float32))

    sd = {"head.0.weight": t(np_params["head"]["w"].T),
          "head.0.bias": t(np_params["head"]["b"])}
    body = np_params["body"]
    if isinstance(body, (list, tuple)):
        for k, layer in enumerate(body):
            sd[f"body.{2 * k}.weight"] = t(layer["w"].T)
            sd[f"body.{2 * k}.bias"] = t(layer["b"])
    else:
        for i in range(cfg.num_blocks):
            for j in range(cfg.n_learnable):
                sd[f"body.{i}.body.{2 * j}.weight"] = t(body["w"][i, j].T)
                sd[f"body.{i}.body.{2 * j}.bias"] = t(body["b"][i, j])
    tail = "tail" if cfg.linear_tail else "tail.0"
    sd[tail + ".weight"] = t(np_params["tail"]["w"].T)
    sd[tail + ".bias"] = t(np_params["tail"]["b"])
    return sd
