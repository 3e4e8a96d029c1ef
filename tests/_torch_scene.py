"""A tiny synthetic Blender scene for the port's CLI tests: the ray-traced
coloured unit sphere of ``.claude/skills/verify/gen_scene.py`` (seed 0,
32x32 by default, 6 train / 1 val / 3 test), written as RGBA PNGs with the
standard library, so the JAX package's loader (imageio) and the port's
(its own decoder) read the same files. Imports neither JAX nor an image
package: the GPU tests use it too."""
from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from r2l_tpu_torch.rays import pose_spherical

CAMERA_ANGLE_X = 0.6911112070083618


def write_png_rgba(path: str, img: np.ndarray) -> None:
    """[H, W, 4] uint8 as an 8-bit RGBA PNG (filter 0 on every row)."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 4)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def render_sphere(c2w: np.ndarray, H: int, W: int, focal: float
                  ) -> np.ndarray:
    """[H, W, 4] float32 RGBA: the unit sphere coloured by its surface
    point, white and transparent elsewhere."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                     -np.ones_like(i)], -1)
    rd = dirs @ c2w[:3, :3].T
    ro = np.broadcast_to(c2w[:3, 3], rd.shape)
    b = np.sum(ro * rd, -1)
    a = np.sum(rd * rd, -1)
    c = np.sum(ro * ro, -1) - 1.0
    disc = b * b - a * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0))) / a
    col = np.clip((ro + rd * t[..., None]) * 0.5 + 0.5, 0, 1)
    img = np.ones((H, W, 4), np.float32)
    img[..., :3] = np.where(hit[..., None], col, 1.0)
    img[..., 3] = hit.astype(np.float32)
    return img


def write_scene(base: str, side: int = 32,
                splits=(("train", 6), ("val", 1), ("test", 3)),
                seed: int = 0) -> str:
    """The scene under ``base`` (transforms_*.json and PNGs); returns
    ``base``."""
    focal = 0.5 * side / np.tan(0.5 * CAMERA_ANGLE_X)
    rng = np.random.default_rng(seed)
    for split, n in splits:
        os.makedirs(os.path.join(base, split), exist_ok=True)
        frames = []
        for k in range(n):
            c2w = pose_spherical(rng.uniform(-180, 180),
                                 rng.uniform(-60, -20), 4.0)
            img = render_sphere(c2w, side, side, focal)
            write_png_rgba(os.path.join(base, f"{split}/r_{k}.png"),
                           (img * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(base, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return base
