"""The JPEG fixtures under ``tests/fixtures/jpeg/`` and how they were made.

``python tests/_torch_jpeg_fixtures.py`` rewrites them with Pillow (the
files are checked in, so a machine without Pillow or imageio can use them):

* ``s444.jpg``, ``s422.jpg``, ``s420.jpg``: the sphere of
  ``tests/_torch_scene.py`` at 61x47, quality 90, each chroma sampling;
* ``grey.jpg``: one component; ``restart.jpg``: 4:2:0 with a restart
  marker every 2 MCU rows' worth of blocks; ``odd_37x53.jpg``: odd sizes,
  quality 50; ``exif6.jpg``: 20x30 tagged EXIF orientation 6 (``cv2.imread``
  turns it to 30x20, ``imageio.imread`` does not);
* ``progressive.jpg``: SOF2, which the port refuses, naming the file;
* ``full_4032x3024.jpg``: the sphere at a phone camera's full size (LLFF's
  ``images/`` sources), quality 75, for the decoder's time beside the card
  (``chip_smoke.py`` phase 18; its digest is checked there, the CPU tests
  leave it out: the pure-Python Huffman decode takes seconds);
* ``llff/``: a synthetic LLFF scene (8 forward-facing views of the sphere,
  ``poses_bounds.npy``, the JPEGs at 504x378 in ``images_8/`` as LLFF's
  ``images_8`` sit, and the same files in ``images/`` so that the loaders'
  cache check finds as many there).

``digests.json`` holds, per file, the shape and sha256 of
``imageio.imread``'s array (and ``cv2.imread``'s, RGB, where it differs):
``chip_smoke.py`` and the GPU tests check the port's decoder against them.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "jpeg")
LLFF_HW = (378, 504)
LLFF_VIEWS = 8
FULL = "full_4032x3024.jpg"


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def sphere_rgb(h: int, w: int, seed: int = 0) -> np.ndarray:
    """An [h, w, 3] uint8 view of the coloured unit sphere."""
    from _torch_scene import render_sphere

    from r2l_tpu_torch.rays import pose_spherical
    rng = np.random.default_rng(seed)
    c2w = pose_spherical(rng.uniform(-180, 180), rng.uniform(-60, -20), 4.0)
    focal = 0.5 * w / np.tan(0.5 * 0.6911112070083618)
    return (render_sphere(c2w, h, w, focal)[..., :3] * 255).astype(np.uint8)


def llff_poses(n: int = LLFF_VIEWS) -> tuple[list, np.ndarray]:
    """(c2w [3, 4] in the [right, up, back] convention, poses_bounds rows
    [n, 17]) of n cameras 4 units in front of the sphere, jittered in x and
    y, looking at it; stored as LLFF stores them: [down, right, back]
    columns, hwf at full resolution (8x the images_8 size), near/far."""
    h8, w8 = LLFF_HW
    f8 = 0.5 * w8 / np.tan(0.5 * 0.9)
    rng = np.random.default_rng(5)
    c2ws, rows = [], []
    for _ in range(n):
        t = np.array([rng.uniform(-0.6, 0.6), rng.uniform(-0.4, 0.4), 4.0])
        back = t / np.linalg.norm(t)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, t], 1)
        c2ws.append(c2w)
        llff = np.stack([-up, right, back, t,
                         np.array([8 * h8, 8 * w8, 8 * f8])], 1)
        d = float(np.linalg.norm(t))
        rows.append(np.concatenate([llff.ravel(), [d - 1.2, d + 1.2]]))
    return c2ws, np.stack(rows)


def write_fixtures(out: str = FIXTURES) -> dict:
    import cv2
    import imageio.v2 as imageio
    from PIL import Image

    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    from _torch_scene import render_sphere
    os.makedirs(out, exist_ok=True)
    files = {}
    rgb = sphere_rgb(47, 61)
    for name, ss in (("s444", 0), ("s422", 1), ("s420", 2)):
        Image.fromarray(rgb).save(os.path.join(out, f"{name}.jpg"),
                                  quality=90, subsampling=ss)
    Image.fromarray(rgb).convert("L").save(os.path.join(out, "grey.jpg"),
                                           quality=90)
    Image.fromarray(sphere_rgb(64, 80, 1)).save(
        os.path.join(out, "restart.jpg"), quality=85, subsampling=2,
        restart_marker_blocks=2)
    Image.fromarray(sphere_rgb(37, 53, 2)).save(
        os.path.join(out, "odd_37x53.jpg"), quality=50, subsampling=2)
    ex = Image.Exif()
    ex[0x0112] = 6
    Image.fromarray(sphere_rgb(20, 30, 3)).save(
        os.path.join(out, "exif6.jpg"), quality=90, exif=ex.tobytes())
    Image.fromarray(sphere_rgb(24, 32, 4)).save(
        os.path.join(out, "progressive.jpg"), quality=90, progressive=True)
    Image.fromarray(sphere_rgb(3024, 4032, 5)).save(
        os.path.join(out, FULL), quality=75)

    base = os.path.join(out, "llff")
    h8, w8 = LLFF_HW
    f8 = 0.5 * w8 / np.tan(0.5 * 0.9)
    c2ws, rows = llff_poses()
    for d in ("images", "images_8"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for k, c2w in enumerate(c2ws):
        img = (render_sphere(c2w, h8, w8, f8)[..., :3] * 255).astype(np.uint8)
        for d in ("images", "images_8"):
            Image.fromarray(img).save(
                os.path.join(base, d, f"IMG_{k:04d}.JPG"), quality=90)
    np.save(os.path.join(base, "poses_bounds.npy"), rows)

    for root, _, names in os.walk(out):
        for n in sorted(names):
            if not n.lower().endswith((".jpg", ".jpeg")) or \
                    n == "progressive.jpg":
                continue
            p = os.path.join(root, n)
            rel = os.path.relpath(p, out)
            entry = digest(imageio.imread(p))
            c = cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1]
            if c.shape != tuple(entry["shape"]):
                entry["cv2"] = digest(c)
            files[rel] = entry
    with open(os.path.join(out, "digests.json"), "w") as f:
        json.dump(files, f, indent=1, sort_keys=True)
    return files


if __name__ == "__main__":
    print(json.dumps(write_fixtures(), indent=1))
