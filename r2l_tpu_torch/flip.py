"""LDR-FLIP perceptual difference metric (Andersson et al., HPG 2020).

Counterpart of ``r2l_tpu/flip.py:44-241``: the colour pipeline (sRGB ->
YCxCz, a CSF filter per opponent channel, Hunt-adjusted L*a*b*, HyAB error
and its redistribution) and the feature pipeline (edge and point detectors
on the achromatic channel), combined as ``deltaE_c ** (1 - deltaE_f)``.
The filter kernels are built in numpy as in JAX; every convolution pads by
replicating the border, then runs VALID, with TF32 off (``full_f32``).
Inputs are [H, W, 3] sRGB tensors in [0, 1]; the metric runs on their
device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import full_f32

# A 0.7 m wide 3840-pixel monitor viewed from 0.7 m (the reference's).
DEFAULT_PPD = 0.7 * (3840.0 / 0.7) * (np.pi / 180.0)

_QC, _QF = 0.7, 0.5
_PC, _PT = 0.4, 0.95

# D65 white point.
_XW, _YW, _ZW = 0.950428545, 1.0, 1.088900371

_RGB2XYZ = np.array([
    [0.41238656, 0.35759149, 0.18045049],
    [0.21263682, 0.71518298, 0.07218020],
    [0.01933062, 0.11919716, 0.95037259],
], dtype=np.float32)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)


def _mat3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``einsum('...c,rc->...r', x, m)``."""
    return x @ torch.from_numpy(m).to(x.device).T


def srgb_to_ycxcz(srgb: torch.Tensor) -> torch.Tensor:
    xyz = _mat3(srgb_to_linear(srgb), _RGB2XYZ)
    x, y, z = xyz[..., 0] / _XW, xyz[..., 1] / _YW, xyz[..., 2] / _ZW
    return torch.stack([116.0 * y - 16.0, 500.0 * (x - y), 200.0 * (y - z)],
                       dim=-1)


def ycxcz_to_linrgb(ycc: torch.Tensor) -> torch.Tensor:
    y = (ycc[..., 0] + 16.0) / 116.0
    x = ycc[..., 1] / 500.0 + y
    z = y - ycc[..., 2] / 200.0
    return _mat3(torch.stack([x * _XW, y * _YW, z * _ZW], dim=-1), _XYZ2RGB)


def _linrgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    xyz = _mat3(torch.clamp(rgb, 0.0, 1.0), _RGB2XYZ)
    t = torch.stack([xyz[..., 0] / _XW, xyz[..., 1] / _YW,
                     xyz[..., 2] / _ZW], dim=-1)
    delta = 6.0 / 29.0
    f = torch.where(t > delta ** 3,
                    torch.clamp(t, min=1e-12) ** (1.0 / 3.0),
                    t / (3 * delta ** 2) + 4.0 / 29.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def _hunt(lab: torch.Tensor) -> torch.Tensor:
    """Hunt adjustment: scale chroma by lightness."""
    L = lab[..., 0]
    return torch.stack([L, 0.01 * L * lab[..., 1], 0.01 * L * lab[..., 2]],
                       dim=-1)


def _hyab(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.abs(d[..., 0]) + torch.linalg.vector_norm(d[..., 1:],
                                                           dim=-1)


_CSF = {  # a1, b1, a2, b2 per channel
    "A": (1.0, 0.0047, 0.0, 1.0e-5),
    "RG": (1.0, 0.0053, 0.0, 1.0e-5),
    "BY": (34.1, 0.04, 13.5, 0.025),
}


@functools.lru_cache(maxsize=8)
def _csf_kernels(ppd: float) -> tuple[np.ndarray, int]:
    """The three 2-D CSF kernels [3, k, k] (sums of Gaussians) and their
    radius."""
    b_max = 0.04  # the largest b of the channels sets the support
    radius = int(math.ceil(3.0 * math.sqrt(b_max / (2.0 * math.pi ** 2))
                           * ppd))
    ax = np.arange(-radius, radius + 1) / ppd
    xx, yy = np.meshgrid(ax, ax)
    d2 = xx ** 2 + yy ** 2
    kernels = []
    for name in ("A", "RG", "BY"):
        a1, b1, a2, b2 = _CSF[name]
        g = (a1 * math.sqrt(math.pi / b1) *
             np.exp(-math.pi ** 2 * d2 / b1) +
             a2 * math.sqrt(math.pi / b2) *
             np.exp(-math.pi ** 2 * d2 / b2))
        kernels.append(g / g.sum())
    return np.stack(kernels).astype(np.float32), radius


def _conv2d_single(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """img [H, W], kernel [k, k] -> [H, W]: the border replicated by the
    kernel's radius, then a VALID convolution (zero padding would darken the
    borders and move the mean error by several percent on small images)."""
    r = (kernel.shape[0] - 1) // 2
    x = F.pad(img[None, None], (r, r, r, r), mode="replicate")
    w = torch.from_numpy(kernel).to(img.device)[None, None]
    return F.conv2d(x, w)[0, 0]


@functools.lru_cache(maxsize=8)
def _feature_kernels(ppd: float) -> tuple[np.ndarray, np.ndarray, int]:
    """Gaussian first (edge) and second (point) derivative kernels, each
    [2 (x, y), k, k], and their radius."""
    w = 0.082
    sd = 0.5 * w * ppd
    radius = int(math.ceil(3.0 * sd))
    ax = np.arange(-radius, radius + 1, dtype=np.float32)
    xx, yy = np.meshgrid(ax, ax)
    g = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sd ** 2))
    edge_x = -xx * g
    point_x = (xx ** 2 / (sd ** 2) - 1.0) * g

    def norm(kern):
        # positive and negative lobes to unit mass each (FLIP's convention)
        pos = np.maximum(kern, 0.0)
        neg = np.maximum(-kern, 0.0)
        out = np.where(kern > 0, kern / max(pos.sum(), 1e-8),
                       kern / max(neg.sum(), 1e-8))
        return out.astype(np.float32)

    edge = np.stack([norm(edge_x), norm(edge_x.T)])
    point = np.stack([norm(point_x), norm(point_x.T)])
    return edge, point, radius


def _detect(y_norm: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    gx = _conv2d_single(y_norm, kern[0])
    gy = _conv2d_single(y_norm, kern[1])
    return torch.sqrt(gx ** 2 + gy ** 2)


def _flip_impl(reference: torch.Tensor, test: torch.Tensor,
               ppd: float) -> torch.Tensor:
    csf, _ = _csf_kernels(ppd)
    edge_k, point_k, _ = _feature_kernels(ppd)
    ycc_r = srgb_to_ycxcz(reference.float())
    ycc_t = srgb_to_ycxcz(test.float())

    # colour pipeline
    def filter_ycc(ycc):
        return torch.stack([_conv2d_single(ycc[..., c], csf[c])
                            for c in range(3)], dim=-1)

    hunt_r = _hunt(_linrgb_to_lab(ycxcz_to_linrgb(filter_ycc(ycc_r))))
    hunt_t = _hunt(_linrgb_to_lab(ycxcz_to_linrgb(filter_ycc(ycc_t))))
    hyab = _hyab(hunt_r, hunt_t)

    primaries = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                             device=reference.device)
    green, blue = _hunt(_linrgb_to_lab(primaries))
    cmax = _hyab(green, blue) ** _QC

    de = hyab ** _QC
    pccmax = _PC * cmax
    delta_e_c = torch.where(
        de < pccmax,
        (_PT / pccmax) * de,
        _PT + ((de - pccmax) / (cmax - pccmax)) * (1.0 - _PT))

    # feature pipeline (achromatic channel)
    y_r = (ycc_r[..., 0] + 16.0) / 116.0
    y_t = (ycc_t[..., 0] + 16.0) / 116.0
    d_edge = torch.abs(_detect(y_r, edge_k) - _detect(y_t, edge_k))
    d_point = torch.abs(_detect(y_r, point_k) - _detect(y_t, point_k))
    delta_e_f = torch.clamp(torch.maximum(d_edge, d_point)
                            * (1.0 / math.sqrt(2.0)), 0.0, 1.0) ** _QF
    return torch.clamp(delta_e_c, 0.0, 1.0) ** (1.0 - delta_e_f)


@torch.no_grad()
def flip_error_map(reference: torch.Tensor, test: torch.Tensor,
                   ppd: float = DEFAULT_PPD) -> torch.Tensor:
    """Per-pixel FLIP error in [0, 1] of two [H, W, 3] sRGB images in
    [0, 1]."""
    with full_f32():
        return _flip_impl(reference, test, float(ppd))


def flip(reference: torch.Tensor, test: torch.Tensor,
         ppd: float = DEFAULT_PPD) -> torch.Tensor:
    """Mean FLIP error (lower is better), a scalar on the images' device."""
    return torch.mean(flip_error_map(reference, test, ppd))
