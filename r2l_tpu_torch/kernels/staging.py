"""Weight staging for the Hopper kernels (K1, K6, K7, K9).

Those kernels read their GEMM weights from a staged image, made once per
model: each layer ([out, in], ``nn.Linear``'s layout) cut into stages of
``STAGE_K[dtype]`` input channels for all its outputs, each stage laid out
exactly as Hopper's ``wgmma`` reads B from shared memory (K-major 8-row x
16-byte core matrices, no swizzle), so that one bulk copy moves it. f32
weights are staged as their TF32 high and low parts (3xTF32: a_hi w_lo +
a_lo w_hi + a_hi w_hi), the high part's stage first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Input channels per stage, by weight dtype: 128 bytes of each output row
# (f32: 64 bytes twice, high and low).
STAGE_K = {torch.bfloat16: 64, torch.int8: 128, torch.float32: 16}


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo), both TF32 values (the low 13 mantissa bits zero):
    hi = w rounded to TF32 (to nearest, ties away from zero: the card's
    ``cvt.rna.tf32.f32``), lo = w - hi (exact in f32) rounded the same way;
    hi + lo is within 2^-21 of w, relative."""
    def rna(x):
        b = x.contiguous().view(torch.int32)
        return ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(w.float())
    return hi, rna(w.float() - hi)


def _parts(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.float32 else 1


def stage_matrices(w: torch.Tensor, k: int) -> torch.Tensor:
    """Weights [..., N, K] (one layer [out, in], or a stack of them) -> the
    flat uint8 image of their stages in order, layer by layer: stage s of a
    layer holds input channels [s*k, (s+1)*k) of its N outputs, byte (n, b)
    of its [N, k] rows at ((n//8) * (B//16) + b//16) * 128 + (n%8) * 16 +
    b%16, B = k * element size; f32 as the high part's stage, then the
    low part's."""
    *lead, n, kk = w.shape
    s = kk // k   # whole stages (a remainder of columns is not staged)
    w = w[..., :s * k]
    parts = tf32_split(w) if w.dtype == torch.float32 else (w,)
    kb = k * w.element_size()
    x = torch.stack([p.contiguous().view(torch.uint8) for p in parts], -3)
    x = x.reshape(*lead, len(parts), n // 8, 8, s, kb // 16, 16)
    d = len(lead)
    lead_dims = list(range(d))
    return x.permute(*lead_dims, d + 3, d, d + 1, d + 4, d + 2,
                     d + 5).reshape(-1)


def source(*tensors) -> tuple:
    """What names the contents of ``tensors`` (None stays None): each one's
    storage, shape, type and version (an in-place write bumps the version,
    so an image staged before it does not match)."""
    return tuple(None if t is None else (t.device, t.data_ptr(),
                                         tuple(t.shape), t.dtype, t._version)
                 for t in tensors)


class Image(NamedTuple):
    """A probe's staged weights: ``data`` the uint8 bytes its kernel
    bulk-copies, ``form`` what they were staged for (the kernel's form or
    body, whose order or table they hold), ``source`` the ``source`` of
    the tensors they were staged from, and ``table`` an epilogue table
    staged beside them, where the kernel takes one."""
    data: torch.Tensor
    form: object
    source: tuple
    table: torch.Tensor | None = None


def check_image(img: Image, form, *tensors, what: str,
                held: int = 1) -> None:
    """Raise ValueError unless ``img`` was staged for ``form`` from
    ``tensors`` as they are now, its data whole: the bytes of the first
    ``held`` of them, on the first's device. ``what`` names the staging
    call."""
    if (not isinstance(img, Image) or img.form != form
            or img.source != source(*tensors)):
        raise ValueError(f"staged must be {what} of these tensors as they "
                         f"are now")
    w, d = tensors[0], img.data
    nbytes = sum(t.numel() * t.element_size() for t in tensors[:held])
    if (d.dtype != torch.uint8 or tuple(d.shape) != (nbytes,)
            or d.device != w.device or not d.is_contiguous()):
        raise ValueError(f"the image of {what} holds {d.dtype} "
                         f"{tuple(d.shape)} on {d.device}, not {nbytes} "
                         f"contiguous bytes on {w.device}")


def unstage_matrices(staged: torch.Tensor, shape: tuple, k: int,
                     dtype: torch.dtype) -> list[torch.Tensor]:
    """``stage_matrices``' inverse: the image of weights of ``shape`` [...,
    N, K] -> [w] (f32: [hi, lo]), each of ``shape`` in ``dtype``."""
    *lead, n, kk = shape
    es = torch.empty(0, dtype=dtype).element_size()
    kb, p = k * es, _parts(dtype)
    x = staged.reshape(*lead, kk // k, p, n // 8, kb // 16, 8, 16)
    d = len(lead)
    lead_dims = list(range(d))
    x = x.permute(*lead_dims, d + 1, d + 2, d + 4, d, d + 3, d + 5)
    x = x.reshape(*lead, p, n, kk * es)
    return [x[..., i, :, :].contiguous().view(dtype) for i in range(p)]
