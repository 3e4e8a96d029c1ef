"""Image reading and area resizing for the dataset loaders, with the
standard library and numpy alone.

The JAX package's loaders read images with ``imageio.imread`` and shrink
them with ``cv2.resize(..., INTER_AREA)`` (``r2l_tpu/data/blender.py:45-46,
101-105``, ``llff.py:151-184``, ``deepvoxels.py:49-51``,
``r2l_tpu/app.py:197-200``). The port's loaders use this module instead, so
they need neither package:

* ``read_png``: a PNG decoder (``zlib``, ``struct``): 8- and 16-bit grey,
  grey+alpha, RGB and RGBA, 8-bit palette images (expanded to RGB, or RGBA
  with a ``tRNS`` chunk), the five scanline filters, no interlace. The array
  is ``imageio.imread``'s: ``uint8`` or big-endian-decoded ``uint16``, [H,
  W] for grey, [H, W, C] otherwise.
* ``read_image``: ``read_png`` for a PNG; a JPEG (by name or by its first
  bytes) raises: JPEG decoding is not ported (ROADMAP A5). ``imageio`` and
  ``cv2`` are never imported, whether installed or not.
* ``resize_area``: what ``cv2.resize(img, (w, h), interpolation=
  cv2.INTER_AREA)`` computes when shrinking, for integer and non-integer
  factors: each output pixel is the mean of the source pixels under it,
  weighted by their overlap (cv2's area table, ``computeResizeAreaTab``),
  applied along rows then columns in float64; ``uint8`` results are rounded
  as cv2 rounds them.
"""
from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples/pixel


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec 9.2): ``data`` holds each
    row as a filter byte then ``stride`` bytes; ``bpp`` is bytes per pixel
    (at least 1). -> [height, stride] uint8."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:      # Sub: a running sum along each byte lane
            cur = np.empty(stride, np.uint8)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(row[c::bpp], dtype=np.uint64) % 256
        elif ftype == 2:      # Up
            cur = row + prior
        elif ftype in (3, 4):
            r = bytearray(row.tobytes())
            p = prior.tobytes()
            if ftype == 3:    # Average
                for i in range(stride):
                    a = r[i - bpp] if i >= bpp else 0
                    r[i] = (r[i] + ((a + p[i]) >> 1)) & 0xFF
            else:             # Paeth
                for i in range(stride):
                    if i >= bpp:
                        a, c = r[i - bpp], p[i - bpp]
                    else:
                        a = c = 0
                    b = p[i]
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                    r[i] = (r[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"PNG scanline filter {ftype} is not one of "
                             "the five")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` as ``imageio.imread`` returns it."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_PNG_SIG):
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, ihdr, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (
            ctype == 3 and depth != 8):
        raise ValueError(f"{path}: colour type {ctype} at {depth} bits is "
                         "not supported (8/16-bit grey, grey+alpha, RGB, "
                         "RGBA; 8-bit palette)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rows.reshape(h, w, ch)
    if ctype == 3:
        idx = img[..., 0]
        rgb = plte[idx]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(plte)]
            return np.concatenate([rgb, alpha[idx][..., None]], -1)
        return rgb
    return img[..., 0] if ch == 1 else img


def _is_jpeg(path: str) -> bool:
    if path.lower().endswith((".jpg", ".jpeg")):
        return True
    with open(path, "rb") as f:
        return f.read(3) == b"\xff\xd8\xff"


def read_image(path: str) -> np.ndarray:
    """An image file as ``imageio.imread`` returns it; PNG only."""
    if _is_jpeg(path):
        raise NotImplementedError(
            f"{path}: JPEG decoding is not ported (ROADMAP A5); convert the "
            "images to PNG (e.g. LLFF's images_<factor>/ caches)")
    return read_png(path)


def _area_table(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of cv2's INTER_AREA along one axis when
    shrinking (``computeResizeAreaTab``): output i covers source
    [i*s, (i+1)*s), s = src/dst; each source pixel counts by its overlap
    over the covered width, the weights rounded to f32 as cv2 keeps
    them."""
    scale = 1.0 / (dst / src)
    tab = np.zeros((dst, src), np.float64)
    for i in range(dst):
        f1 = i * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            tab[i, s1 - 1] = np.float32((s1 - f1) / cell)
        tab[i, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            tab[i, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return tab


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    for a shrink (or the same size): [H, W(, C)] -> [height, width(, C)] in
    the input's dtype (float32 or uint8)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if (height, width) == (h, w):
        return img.copy()
    if height > h or width > w:
        raise ValueError(f"resize_area shrinks only: {h}x{w} -> "
                         f"{height}x{width}")
    x = img.astype(np.float64)
    if w % width == 0 and h % height == 0:
        fy, fx = h // height, w // width
        out = x.reshape(height, fy, width, fx, *x.shape[2:]).mean(axis=(1, 3))
    else:
        ty, tx = _area_table(h, height), _area_table(w, width)
        out = np.tensordot(ty, x, axes=(1, 0))
        out = np.moveaxis(np.tensordot(tx, out, axes=(1, 1)), 0, 1)
    if img.dtype == np.uint8:
        if (h, w) == (2 * height, 2 * width):
            # cv2's 2x2 path: (a + b + c + d + 2) >> 2, ties upward
            out = np.floor(out + 0.5)
        else:
            out = np.rint(out)           # cvRound: ties to even
        return np.clip(out, 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def image_files(d: str) -> list[str]:
    """The image files of a directory (JPEG or PNG by name), sorted."""
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.lower().endswith(("jpg", "jpeg", "png"))]
