"""LPIPS perceptual metric with the AlexNet, VGG16 and SqueezeNet 1.1
backbones.

Counterpart of ``r2l_tpu/lpips_jax.py``: sRGB in [0, 1] -> [-1, 1] ->
LPIPS's scaling layer -> the backbone's conv stages -> each stage's features
normalised over channels -> the 1x1 heads (weights clamped at 0) -> spatial
mean -> summed over stages. Parameters are ``{"net", "convs": [{"w"
[O, I, kh, kw], "b" [O]}], "lins": [{"w" [1, C, 1, 1]}]}`` in torch's
layout. No pretrained weights ship with the repository: ``load_torch_lpips``
converts the pip ``lpips`` package's state_dict, ``init_lpips`` draws random
weights, ``lpips_params_from_jax`` carries the JAX package's params across.
Every convolution runs with TF32 off (``full_f32``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import full_f32

# (out_ch, in_ch, kernel, stride, pad) per AlexNet-features conv layer,
# with maxpool(3, 2) after layers 0 and 1 and ReLU after every conv.
_ALEX = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
_ALEX_POOL_AFTER = {0, 1}

# VGG16 stages: (out_ch, n_convs), every conv 3x3 s1 p1, maxpool(2, 2)
# between stages, features at each stage's last ReLU.
_VGG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# SqueezeNet 1.1: conv(3 -> 64, k3, s2) then 8 Fire modules (squeeze_ch,
# expand_ch); expand1x1 and expand3x3 concatenate to 2 * expand_ch.
# Features after relu1 and fires 1, 3, 4, 5, 6, 7; maxpool(3, 2) before
# fires 0, 2 and 4.
_SQUEEZE_FIRES = [(16, 64), (16, 64), (32, 128), (32, 128),
                  (48, 192), (48, 192), (64, 256), (64, 256)]
_SQUEEZE_POOL_BEFORE = {0, 2, 4}
_SQUEEZE_FEAT_AFTER = {1, 3, 4, 5, 6, 7}

_N_STAGES = {"alex": 5, "vgg": 5, "squeeze": 7}
_N_CONVS = {"alex": 5, "vgg": 13, "squeeze": 25}

# LPIPS's input normalisation (the package's ScalingLayer constants).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _feat_channels(net: str) -> list[int]:
    if net == "alex":
        return [oc for oc, *_ in _ALEX]
    if net == "vgg":
        return [oc for oc, _ in _VGG]
    if net == "squeeze":
        return [64, 128, 256, 384, 384, 512, 512]
    raise ValueError(net)


def _conv_shapes(net: str) -> list[tuple[int, int, int]]:
    """(out, in, kernel) of each backbone conv, in forward order (a Fire
    module's squeeze, expand1x1, expand3x3)."""
    if net == "alex":
        return [(oc, ic, k) for oc, ic, k, _, _ in _ALEX]
    if net == "vgg":
        shapes, ic = [], 3
        for oc, n in _VGG:
            for _ in range(n):
                shapes.append((oc, ic, 3))
                ic = oc
        return shapes
    if net == "squeeze":
        shapes, ic = [(64, 3, 3)], 64
        for s, e in _SQUEEZE_FIRES:
            shapes += [(s, ic, 1), (e, s, 1), (e, s, 3)]
            ic = 2 * e
        return shapes
    raise ValueError(net)


def init_lpips(generator: torch.Generator, net: str = "alex",
               device: torch.device | str = torch.device("cuda")) -> dict:
    """Random LPIPS parameters (tests, shape checks): each conv's weights
    N(0, 1/fan_in), biases 0, the heads U[0, 1); drawn from ``generator`` on
    its own device, then placed on ``device`` (the card unless told
    otherwise)."""
    def draw(shape, normal):
        f = torch.randn if normal else torch.rand
        return f(shape, generator=generator,
                 device=generator.device).to(device)

    convs = [{"w": draw((oc, ic, k, k), True) / math.sqrt(ic * k * k),
              "b": torch.zeros(oc, device=device)}
             for oc, ic, k in _conv_shapes(net)]
    lins = [{"w": draw((1, c, 1, 1), False)} for c in _feat_channels(net)]
    return {"net": net, "convs": convs, "lins": lins}


def _check_layout(params: dict, net: str) -> dict:
    n_convs, n_lins = len(params["convs"]), len(params["lins"])
    if n_convs != _N_CONVS[net] or n_lins != _N_STAGES[net]:
        raise ValueError(f"unrecognized lpips parameter layout for "
                         f"net={net!r}: {n_convs} convs / {n_lins} lins")
    return params


def load_torch_lpips(state_dict: dict, net: str = "alex",
                     device: torch.device | str = torch.device("cuda")
                     ) -> dict:
    """Parameters from a pip ``lpips.LPIPS(net=...)`` state_dict: backbone
    convs ``net.slice{k}.<idx>[.squeeze|.expand1x1|.expand3x3].weight``
    [O, I, kh, kw] (a Fire module's squeeze, expand1x1, expand3x3 in that
    order) and heads ``lin{i}.model.1.weight`` (or ``lins.{i}...``)
    [1, C, 1, 1]. The layouts are torch's already, so nothing is
    transposed."""
    def tensor(v):
        return torch.as_tensor(np.asarray(v.detach().cpu()
                                          if torch.is_tensor(v) else v,
                                          np.float32), device=device)

    sub_order = {"": 0, "squeeze": 0, "expand1x1": 1, "expand3x3": 2}

    def sort_key(k):
        parts = k.split(".")
        sub = parts[3] if len(parts) > 4 else ""
        return int(parts[1][5:]), int(parts[2]), sub_order.get(sub, 9)

    conv_keys = sorted((k for k in state_dict
                        if k.startswith("net.") and k.endswith(".weight")),
                       key=sort_key)
    convs = [{"w": tensor(state_dict[k]),
              "b": tensor(state_dict[k[:-6] + "bias"])} for k in conv_keys]
    lins = []
    for i in range(_N_STAGES[net]):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in state_dict:
                lins.append({"w": tensor(state_dict[cand])})
                break
    return _check_layout({"net": net, "convs": convs, "lins": lins}, net)


def lpips_params_from_jax(np_params: dict,
                          device: torch.device | str = torch.device("cuda")
                          ) -> dict:
    """The JAX package's LPIPS params (numpy arrays; weights HWIO, heads
    [1, 1, C, 1]) in the port's layout (OIHW, heads [1, C, 1, 1])."""
    def t(a):
        return torch.as_tensor(np.array(
            np.asarray(a, np.float32).transpose(3, 2, 0, 1), order="C"),
            device=device)

    net = np_params.get("net", "alex")
    convs = [{"w": t(c["w"]), "b": torch.as_tensor(
        np.array(c["b"], np.float32), device=device)}
        for c in np_params["convs"]]
    lins = [{"w": t(h["w"])} for h in np_params["lins"]]
    return _check_layout({"net": net, "convs": convs, "lins": lins}, net)


def _conv(x: torch.Tensor, p: dict, stride: int = 1, pad: int = 0
          ) -> torch.Tensor:
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad)


def _alex_features(convs: list, x: torch.Tensor) -> list[torch.Tensor]:
    feats, h = [], x
    for i, (_, _, _, s, p) in enumerate(_ALEX):
        h = F.relu(_conv(h, convs[i], s, p))
        feats.append(h)
        if i in _ALEX_POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return feats


def _vgg_features(convs: list, x: torch.Tensor) -> list[torch.Tensor]:
    feats, h, ci = [], x, 0
    for si, (_, n) in enumerate(_VGG):
        for _ in range(n):
            h = F.relu(_conv(h, convs[ci], 1, 1))
            ci += 1
        feats.append(h)
        if si < len(_VGG) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def _squeeze_features(convs: list, x: torch.Tensor) -> list[torch.Tensor]:
    h = F.relu(_conv(x, convs[0], 2, 0))
    feats, ci = [h], 1
    for fi in range(len(_SQUEEZE_FIRES)):
        if fi in _SQUEEZE_POOL_BEFORE:
            h = F.max_pool2d(h, 3, 2)
        sq = F.relu(_conv(h, convs[ci], 1, 0))
        e1 = F.relu(_conv(sq, convs[ci + 1], 1, 0))
        e3 = F.relu(_conv(sq, convs[ci + 2], 1, 1))
        h = torch.cat([e1, e3], dim=1)
        ci += 3
        if fi in _SQUEEZE_FEAT_AFTER:
            feats.append(h)
    return feats


_FEATURES = {"alex": _alex_features, "vgg": _vgg_features,
             "squeeze": _squeeze_features}


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Each pixel's feature vector (dim 1, NCHW) to unit length."""
    n = torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True))
    return f / (n + eps)


def minmax_rescale(x: torch.Tensor, ymin: float = -1.0,
                   ymax: float = 1.0) -> torch.Tensor:
    """The reference's rescale over the WHOLE tensor: its min to ``ymin``,
    its max to ``ymax`` (applied to a whole frame stack at once)."""
    lo, hi = torch.min(x), torch.max(x)
    return (ymax - ymin) / torch.clamp(hi - lo, min=1e-12) * (x - lo) + ymin


@torch.no_grad()
def lpips(params: dict, img0: torch.Tensor, img1: torch.Tensor,
          rescale: str = "standard") -> torch.Tensor:
    """LPIPS distance of [N, H, W, 3] (or [H, W, 3]) sRGB images in [0, 1],
    the mean over the N pairs, a scalar on the parameters' device.

    ``rescale``: ``standard`` maps [0, 1] to [-1, 1] by 2x - 1 (LPIPS's
    convention); ``minmax`` is the reference's min-max rescale of each input
    tensor to [-1, 1]; ``none`` takes inputs already in [-1, 1] (the eval
    loop rescales a whole frame stack, then passes each image with
    ``none``)."""
    if img0.ndim == 3:
        img0 = img0[None]
    if img1.ndim == 3:
        img1 = img1[None]
    if img0.shape != img1.shape:
        raise ValueError(f"image shapes differ: {tuple(img0.shape)} vs "
                         f"{tuple(img1.shape)}")
    if rescale == "standard":
        x0, x1 = 2.0 * img0 - 1.0, 2.0 * img1 - 1.0
    elif rescale == "minmax":
        x0, x1 = minmax_rescale(img0), minmax_rescale(img1)
    elif rescale == "none":
        x0, x1 = img0, img1
    else:
        raise ValueError(f"unknown rescale {rescale!r}")
    dev = params["lins"][0]["w"].device
    shift = torch.tensor(_SHIFT, device=dev)
    scale = torch.tensor(_SCALE, device=dev)

    def prep(x):
        return ((x.to(dev, torch.float32) - shift) / scale).permute(
            0, 3, 1, 2)

    features = _FEATURES[params.get("net", "alex")]
    with full_f32():
        f0s = features(params["convs"], prep(x0))
        f1s = features(params["convs"], prep(x1))
        total = 0.0
        for f0, f1, head in zip(f0s, f1s, params["lins"]):
            d = (_unit_normalize(f0) - _unit_normalize(f1)) ** 2
            val = F.conv2d(d, torch.clamp(head["w"], min=0.0))
            total = total + torch.mean(val, dim=(1, 2, 3))
    return torch.mean(total)
