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
* ``read_jpeg``: a baseline JPEG decoder (SOF0/SOF1, Huffman, 8-bit; 1 or 3
  components; 4:4:4, 4:2:2 and 4:2:0; restart intervals), bit for bit what
  ``imageio.imread`` returns through Pillow over libjpeg(-turbo): the
  ISLOW integer IDCT (``jidctint.c``), the "fancy" triangular chroma
  upsampling (``jdsample.c``) and the fixed-point YCbCr->RGB tables
  (``jdcolor.c``), all in integer numpy over whole planes. The Huffman
  decode reads 16-bit table lookups (a code and, where it fits, its
  magnitude bits in one step). Progressive, arithmetic-coded, 12-bit,
  lossless and CMYK files raise, naming the file and the marker.
  ``jpeg_orientation`` reads the EXIF orientation tag and
  ``apply_orientation`` turns an image as ``cv2.imread`` does
  (``imageio.imread`` ignores the tag).
* ``read_image``: ``read_png`` for a PNG, ``read_jpeg`` for a JPEG (by name
  or by its first bytes). ``imageio`` and ``cv2`` are never imported,
  whether installed or not.
* ``resize_area``: what ``cv2.resize(img, (w, h), interpolation=
  cv2.INTER_AREA)`` computes when shrinking, for integer and non-integer
  factors: each output pixel is the mean of the source pixels under it,
  weighted by their overlap (cv2's area table, ``computeResizeAreaTab``),
  applied along rows then columns in float64; ``uint8`` results are rounded
  as cv2 rounds them.
"""
from __future__ import annotations

import array
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


# ---------------------------------------------------------------------------
# JPEG (baseline sequential Huffman, 8-bit), libjpeg's decoder arithmetic
# ---------------------------------------------------------------------------

def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each coefficient in zigzag order."""
    order = sorted(((r + c, c if (r + c) % 2 == 0 else r, r * 8 + c)
                    for r in range(8) for c in range(8)))
    return np.array([n for _, _, n in order])


_ZIGZAG = _zigzag()
_SOF_NAMES = {0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
              0xC5: "differential sequential (SOF5)",
              0xC6: "differential progressive (SOF6)",
              0xC7: "differential lossless (SOF7)",
              0xC9: "arithmetic-coded sequential (SOF9)",
              0xCA: "arithmetic-coded progressive (SOF10)",
              0xCB: "arithmetic-coded lossless (SOF11)",
              0xCD: "arithmetic-coded differential sequential (SOF13)",
              0xCE: "arithmetic-coded differential progressive (SOF14)",
              0xCF: "arithmetic-coded differential lossless (SOF15)"}
# kinds of a Huffman lookup entry (bits 5-6)
_FAST, _EOB, _ZRL, _SLOW = 0, 1, 2, 3


def _huffman_lookup(counts: bytes, symbols: bytes, ac: bool) -> list:
    """A 65,536-entry table indexed by the next 16 bits of the stream.
    Entry = bits consumed (5 bits) | kind << 5 | run << 7 | (value + 32768)
    << 11. ``_FAST``: the code and its magnitude bits fit in 16 bits, the
    coefficient (or DC difference) is ``value`` after ``run`` zeros;
    ``_SLOW``: the code alone is consumed and ``value`` holds the magnitude
    size to read next; ``_EOB``/``_ZRL``: the AC end-of-block and 16-zero
    run. Codes are assigned canonically (JPEG Annex C)."""
    lens = np.zeros(65536, np.int64)
    kind = np.zeros(65536, np.int64)
    run = np.zeros(65536, np.int64)
    val = np.zeros(65536, np.int64)
    peek = np.arange(65536, dtype=np.int64)
    code, k = 0, 0
    for L in range(1, 17):
        for _ in range(counts[L - 1]):
            sym = symbols[k]
            k += 1
            lo, hi = code << (16 - L), (code + 1) << (16 - L)
            code += 1
            size = sym & 15
            if ac and size == 0 and sym != 0xF0:
                # libjpeg ends the block on any size-0 symbol but ZRL
                lens[lo:hi], kind[lo:hi] = L, _EOB
            elif ac and sym == 0xF0:
                lens[lo:hi], kind[lo:hi] = L, _ZRL
            elif L + size <= 16:
                bits = (peek[lo:hi] >> (16 - L - size)) & ((1 << size) - 1)
                if size:
                    bits = np.where(bits < (1 << (size - 1)),
                                    bits - (1 << size) + 1, bits)
                lens[lo:hi] = L + size
                kind[lo:hi] = _FAST
                run[lo:hi] = sym >> 4 if ac else 0
                val[lo:hi] = bits
            else:
                lens[lo:hi], kind[lo:hi] = L, _SLOW
                run[lo:hi] = sym >> 4 if ac else 0
                val[lo:hi] = size
        code <<= 1
    return (lens | (kind << 5) | (run << 7) | ((val + 32768) << 11)).tolist()


def _windows(seg: bytes) -> list:
    """w[i] = the 48 bits of ``seg`` from byte i on (zero past the end), so
    that any 27 bits from bit 8i + o, o < 8, sit inside one window."""
    b = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint64)
    n = len(seg) + 2
    w = np.zeros(n, np.uint64)
    for j in range(6):
        w |= b[j:j + n] << np.uint64(8 * (5 - j))
    return w.tolist()


def _decode_segment(seg: bytes, units: list, dc_tabs: list, ac_tabs: list,
                    coefs: list) -> None:
    """Huffman-decode the blocks of one restart interval: ``units`` lists
    (component slot, block offset) in stream order; the coefficients go to
    ``coefs[slot]`` (flat int32 arrays, zigzag order) at their offsets. The
    DC predictors start at 0 (a restart resets them)."""
    w = _windows(seg)
    p = 0
    pred = [0] * len(dc_tabs)
    for slot, base in units:
        dct, act, out = dc_tabs[slot], ac_tabs[slot], coefs[slot]
        e = dct[(w[p >> 3] >> (32 - (p & 7))) & 0xFFFF]
        p += e & 31
        v = (e >> 11) - 32768
        if (e >> 5) & 3 == _SLOW:
            s = v
            v = (w[p >> 3] >> (48 - (p & 7) - s)) & ((1 << s) - 1) if s else 0
            if s and v < (1 << (s - 1)):
                v -= (1 << s) - 1
            p += s
        pred[slot] += v
        out[base] = pred[slot]
        k = 1
        while k < 64:
            e = act[(w[p >> 3] >> (32 - (p & 7))) & 0xFFFF]
            p += e & 31
            t = (e >> 5) & 3
            if t == _FAST:
                k += (e >> 7) & 15
                # past the end, libjpeg's natural-order table points at 63
                out[base + min(k, 63)] = (e >> 11) - 32768
                k += 1
            elif t == _EOB:
                break
            elif t == _ZRL:
                k += 16
            else:
                s = (e >> 11) - 32768
                v = (w[p >> 3] >> (48 - (p & 7) - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                p += s
                k += (e >> 7) & 15
                out[base + min(k, 63)] = v
                k += 1


def _scan_segments(blob: bytes, pos: int) -> tuple[list, int]:
    """The entropy-coded data from ``pos``: its restart intervals (split at
    the RSTn markers, byte stuffing undone) and the offset of the marker
    that ends the scan."""
    segs, start, i = [], pos, pos
    n = len(blob)
    while True:
        i = blob.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            segs.append(blob[start:].replace(b"\xff\x00", b"\xff"))
            return segs, n
        m = blob[i + 1]
        if m == 0x00 or m == 0xFF:      # stuffed byte, or fill before a marker
            i += 1
            continue
        segs.append(blob[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            start = i = i + 2
            continue
        return segs, i


# ISLOW constants (jidctint.c): FIX(x) = round(x * 2^13)
_C = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373,
          c1175=9633, c1501=12299, c1847=15137, c1961=16069, c2053=16819,
          c2562=20995, c3072=25172)


def _idct_pass(x: list, shift: int) -> list:
    """One 1-D pass of libjpeg's ISLOW IDCT over eight int64 arrays (the
    eight inputs of each column or row), descaled by ``shift`` with
    rounding (``DESCALE``)."""
    c = _C
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * c["c0541"]
    tmp2 = z1 - z3 * c["c1847"]
    tmp3 = z1 + z2 * c["c0765"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["c1175"]
    t0 = t0 * c["c0298"]
    t1 = t1 * c["c2053"]
    t2 = t2 * c["c3072"]
    t3 = t3 * c["c1501"]
    z1 = z1 * -c["c0899"]
    z2 = z2 * -c["c2562"]
    z3 = z3 * -c["c1961"] + z5
    z4 = z4 * -c["c0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table, indexed by (x & 1023):
    x + 128 clamped to [0, 255] for |x| < 512, wrapping beyond as the
    table does (``prepare_range_limit_table``)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(0, 128)
    return t


_RANGE_LIMIT = _range_limit()


def _idct_islow(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-DCT coefficient blocks [N, 64] (zigzag order)
    with quantization table ``q`` [64] (natural order) -> samples [N, 8, 8]
    uint8, as ``jpeg_idct_islow`` computes them."""
    nat = np.empty_like(blocks, dtype=np.int64)
    nat[:, _ZIGZAG] = blocks
    x = (nat * q.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.stack(_idct_pass([x[:, k, :] for k in range(8)], 11), axis=1)
    out = np.stack(_idct_pass([ws[:, :, k] for k in range(8)], 18), axis=2)
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2v1(x: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample``: each sample becomes (3*near + far) / 4 to
    the left and right, rounding biases 1 then 2, edges replicated."""
    x = x.astype(np.int32)
    lft = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    rgt = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + lft + 1) >> 2
    out[:, 1::2] = (3 * x + rgt + 2) >> 2
    return out


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample``: a triangle filter in both directions over
    column sums 3*near row + far row, rounding biases 8 then 7, edge rows
    and columns replicated."""
    x = x.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    dn = np.concatenate([x[1:], x[-1:]], axis=0)
    rows = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    rows[0::2] = 3 * x + up
    rows[1::2] = 3 * x + dn
    lft = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    rgt = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int32)
    out[:, 0::2] = (3 * rows + lft + 8) >> 4
    out[:, 1::2] = (3 * rows + rgt + 7) >> 4
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int, path: str) -> np.ndarray:
    """A component plane at its own resolution to the full one: fancy for
    2x1 and 2x2 (box replication where the plane is at most 2 wide, as
    libjpeg decides), identity for 1x1."""
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) not in ((2, 1), (2, 2)):
        raise ValueError(f"{path}: chroma subsampling {fh}x{fv} is not "
                         "supported (4:4:4, 4:2:2 and 4:2:0 are)")
    if plane.shape[1] <= 2:
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    return _fancy_h2v1(plane) if fv == 1 else _fancy_h2v2(plane)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                ) -> np.ndarray:
    """``ycc_rgb_convert`` with libjpeg's 16-bit fixed-point tables."""
    def fix(v):
        return int(v * 65536 + 0.5)
    xs = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (fix(1.40200) * xs + half) >> 16
    cb_b = (fix(1.77200) * xs + half) >> 16
    cr_g = -fix(0.71414) * xs
    cb_g = -fix(0.34414) * xs + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _segments(blob: bytes, path: str):
    """(marker, payload offset, payload length) of each marker segment up
    to and including the next SOS (the scan's data follows its header)."""
    if not blob.startswith(b"\xff\xd8"):
        raise ValueError(f"{path} is not a JPEG file")
    pos = 2
    while pos + 4 <= len(blob):
        if blob[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG (no marker at byte {pos})")
        m = blob[pos + 1]
        if m == 0xFF:                 # fill byte
            pos += 1
            continue
        if m == 0xD9:
            return
        n = struct.unpack(">H", blob[pos + 2:pos + 4])[0]
        yield m, pos + 4, n - 2
        if m == 0xDA:                 # entropy-coded data follows
            return
        pos += 2 + n


def jpeg_orientation(path: str) -> int:
    """The EXIF orientation tag (0x0112) of a JPEG's APP1 segment, 1 (as
    stored) when there is none."""
    with open(path, "rb") as f:
        blob = f.read()
    for m, off, n in _segments(blob, path):
        if m == 0xDA:
            break
        body = blob[off:off + n]
        if m != 0xE1 or not body.startswith(b"Exif\0\0"):
            continue
        tiff = body[6:]
        end = "<" if tiff[:2] == b"II" else ">"
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        (count,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for e in range(count):
            ent = tiff[ifd + 2 + 12 * e: ifd + 14 + 12 * e]
            tag, typ = struct.unpack(end + "HH", ent[:4])
            if tag == 0x0112 and typ == 3:
                return struct.unpack(end + "H", ent[8:10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn an image [H, W(, C)] upright from its EXIF orientation, as
    OpenCV's ``ExifTransform`` does in ``cv2.imread``."""
    flips = {1: (), 2: ("h",), 3: ("h", "v"), 4: ("v",), 5: ("t",),
             6: ("t", "h"), 7: ("t", "h", "v"), 8: ("t", "v")}
    out = img
    for op in flips.get(orientation, ()):
        if op == "t":
            out = np.swapaxes(out, 0, 1)
        elif op == "h":
            out = out[:, ::-1]
        else:
            out = out[::-1]
    return np.ascontiguousarray(out)


def read_jpeg(path: str) -> np.ndarray:
    """The baseline JPEG at ``path`` as ``imageio.imread`` returns it:
    uint8 [H, W] (one component) or [H, W, 3] (RGB), bit for bit Pillow over
    libjpeg's default decode (ISLOW IDCT, fancy upsampling, fixed-point
    colour). The EXIF orientation is ignored, as imageio ignores it."""
    with open(path, "rb") as f:
        blob = f.read()
    qt: dict[int, np.ndarray] = {}
    ht: dict[tuple[int, int], list] = {}
    frame = None
    restart = 0
    adobe = jfif = False
    coefs, plan = None, None
    pos_end = None
    segs = list(_segments(blob, path))
    i_seg = 0
    while i_seg < len(segs):
        m, off, n = segs[i_seg]
        i_seg += 1
        body = blob[off:off + n]
        if m in _SOF_NAMES:
            raise ValueError(f"{path}: {_SOF_NAMES[m]} JPEG (marker "
                             f"0x{m:02X}) is not supported: baseline "
                             "sequential Huffman only")
        if m in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG (marker "
                                 f"0x{m:02X}) is not supported: 8-bit only")
            if h == 0:
                raise ValueError(f"{path}: a JPEG with its height in a DNL "
                                 "marker is not supported")
            if nc not in (1, 3):
                raise ValueError(f"{path}: {nc}-component JPEG (marker "
                                 f"0x{m:02X}) is not supported: 1 or 3")
            comps = []
            for c in range(nc):
                cid, hv, tq = body[6 + 3 * c: 9 + 3 * c]
                comps.append((cid, hv >> 4, hv & 15, tq))
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            frame = (h, w, comps, hmax, vmax, mcux, mcuy)
            coefs = [array.array("i", bytes(4 * mcuy * c[2] * mcux * c[1]
                                            * 64)) for c in comps]
            plan = coefs
        elif m == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq:
                    vals = struct.unpack(">64H", body[p + 1:p + 129])
                    p += 129
                else:
                    vals = list(body[p + 1:p + 65])
                    p += 65
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG] = np.asarray(vals, np.int64)
                qt[tq] = nat
        elif m == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                counts = body[p + 1:p + 17]
                k = sum(counts)
                syms = body[p + 17:p + 17 + k]
                ht[(tc, th)] = _huffman_lookup(counts, syms, ac=tc == 1)
                p += 17 + k
        elif m == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif m == 0xE0 and body.startswith(b"JFIF\0"):
            jfif = True
        elif m == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            h, w, comps, hmax, vmax, mcux, mcuy = frame
            ns = body[0]
            slots, dcs, acs = [], [], []
            for c in range(ns):
                cid, tab = body[1 + 2 * c], body[2 + 2 * c]
                slot = [cc[0] for cc in comps].index(cid)
                slots.append(slot)
                dcs.append(ht[(0, tab >> 4)])
                acs.append(ht[(1, tab & 15)])
            units = _scan_units(comps, slots, hmax, vmax, mcux, mcuy, w, h)
            seg_list, end = _scan_segments(blob, off + n)
            per = restart * (len(units) // _n_mcus(comps, slots, hmax, vmax,
                                                   mcux, mcuy, w, h)) \
                if restart else len(units)
            outs = [coefs[s] for s in slots]
            for j, seg in enumerate(seg_list):
                chunk = units[j * per:(j + 1) * per]
                if not chunk:
                    break
                _decode_segment(seg, chunk, dcs, acs, outs)
            # the segments after the scan: re-read from its end marker
            segs = list(_segments(b"\xff\xd8" + blob[end:], path))
            blob = b"\xff\xd8" + blob[end:]
            i_seg = 0
            pos_end = end
    if frame is None or pos_end is None:
        raise ValueError(f"{path}: no JPEG frame or scan")
    h, w, comps, hmax, vmax, mcux, mcuy = frame
    planes = []
    for c, (cid, hc, vc, tq) in enumerate(comps):
        bh, bw = mcuy * vc, mcux * hc
        blocks = np.frombuffer(plan[c], np.int32).reshape(-1, 64)
        px = _idct_islow(blocks, qt[tq])
        px = px.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)
        cw, ch = -(-w * hc // hmax), -(-h * vc // vmax)
        px = _upsample(px[:ch, :cw], hmax // hc, vmax // vc, path)
        planes.append(px[:h, :w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c[0] for c in comps)
    rgb = (not jfif) and (adobe is not False and adobe == 0
                          or (adobe is False and ids == (82, 71, 66)))
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _n_mcus(comps, slots, hmax, vmax, mcux, mcuy, w, h) -> int:
    """MCUs in a scan: a single-component scan's MCU is one block."""
    if len(slots) > 1:
        return mcux * mcuy
    _, hc, vc, _ = comps[slots[0]]
    return (-(-(-(-w * hc // hmax)) // 8)) * (-(-(-(-h * vc // vmax)) // 8))


def _scan_units(comps, slots, hmax, vmax, mcux, mcuy, w, h) -> list:
    """(slot index within the scan, coefficient offset) of each block of a
    scan in stream order: interleaved MCUs (each component's v x h blocks
    in raster order), or a single component's blocks in raster order over
    its own (unpadded) block grid."""
    units = []
    if len(slots) > 1:
        for my in range(mcuy):
            for mx in range(mcux):
                for si, s in enumerate(slots):
                    _, hc, vc, _ = comps[s]
                    bw = mcux * hc
                    for by in range(vc):
                        row = (my * vc + by) * bw + mx * hc
                        for bx in range(hc):
                            units.append((si, (row + bx) * 64))
        return units
    _, hc, vc, _ = comps[slots[0]]
    bw_alloc = mcux * hc
    nbw = -(-(-(-w * hc // hmax)) // 8)
    nbh = -(-(-(-h * vc // vmax)) // 8)
    for by in range(nbh):
        for bx in range(nbw):
            units.append((0, (by * bw_alloc + bx) * 64))
    return units


def _is_jpeg(path: str) -> bool:
    if path.lower().endswith((".jpg", ".jpeg")):
        return True
    with open(path, "rb") as f:
        return f.read(3) == b"\xff\xd8\xff"


def read_image(path: str) -> np.ndarray:
    """An image file as ``imageio.imread`` returns it: PNG or JPEG."""
    if _is_jpeg(path):
        return read_jpeg(path)
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
