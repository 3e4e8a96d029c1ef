"""Port parity: the baseline JPEG decoder (r2l_tpu_torch/data/imageio_.py
``read_jpeg``) against ``imageio.imread`` (Pillow over libjpeg-turbo) bit
for bit, cv2's EXIF orientation, and the LLFF loader on a JPEG scene
against r2l_tpu/data/llff.py (tests/fixtures/jpeg/, written by
tests/_torch_jpeg_fixtures.py)."""
import json
import os
import shutil

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from _torch_jpeg_fixtures import FIXTURES, FULL, digest, sphere_rgb
from r2l_tpu.data.llff import load_llff_data as jax_llff
from r2l_tpu_torch.data import imageio_ as IO
from r2l_tpu_torch.data.llff import load_llff_data

with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)


@pytest.mark.parametrize("name", sorted(set(DIGESTS) - {FULL}))
def test_fixture_is_imageios_bit_for_bit(name):
    """Every fixture decodes to imageio's array, and to its recorded
    digest (what the GPU checks compare, with no image package); cv2's
    BGR read, turned to RGB, is the same pixels where it keeps the shape
    (a grey file comes back from cv2 as three equal channels)."""
    path = os.path.join(FIXTURES, name)
    got = IO.read_image(path)
    want = imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert digest(got) == {k: v for k, v in DIGESTS[name].items()
                           if k != "cv2"}
    c = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    if got.ndim == 2:
        np.testing.assert_array_equal(c, np.repeat(got[..., None], 3, -1))
    elif c.shape == got.shape:
        np.testing.assert_array_equal(c, got)


def _random_image(rng, h, w):
    """Smooth content plus noise: both the DC path and long AC runs."""
    yy, xx = np.mgrid[:h, :w]
    ph = rng.uniform(0, 6, 3)
    smooth = np.stack([np.sin(xx / rng.uniform(2, 9) + p)
                       * np.cos(yy / rng.uniform(2, 9) - p) for p in ph], -1)
    noise = rng.normal(0, rng.uniform(0, 60), (h, w, 3))
    return np.clip(smooth * 110 + 128 + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_random_pil_jpegs_are_imageios(tmp_path, quality, subsampling):
    """Pillow-written JPEGs of random sizes (odd ones and ones under an
    MCU), grey among them, some with restart intervals or optimized
    Huffman tables: bit for bit imageio's array."""
    rng = np.random.default_rng(quality * 10 + subsampling)
    for k in range(6):
        h, w = (int(v) for v in rng.integers(1, 72, 2))
        img = Image.fromarray(_random_image(rng, h, w))
        kw = dict(quality=quality)
        if k == 5:
            img = img.convert("L")
        else:
            kw["subsampling"] = subsampling
        if k % 3 == 1:
            kw["restart_marker_blocks"] = int(rng.integers(1, 4))
        if k % 3 == 2:
            kw["optimize"] = True
        p = str(tmp_path / f"r{k}.jpg")
        img.save(p, **kw)
        got, want = IO.read_jpeg(p), imageio.imread(p)
        assert got.shape == want.shape, (k, kw)
        np.testing.assert_array_equal(got, want, err_msg=str((k, h, w, kw)))


def test_unsupported_jpegs_raise_naming_the_file(tmp_path):
    """Progressive and CMYK files raise with the file and the marker or
    the count; so does a file that is not a JPEG at all."""
    prog = os.path.join(FIXTURES, "progressive.jpg")
    with pytest.raises(ValueError,
                       match=r"progressive\.jpg: progressive \(SOF2\).*0xC2"):
        IO.read_image(prog)
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(sphere_rgb(16, 16)).convert("CMYK").save(cmyk)
    with pytest.raises(ValueError, match=r"cmyk\.jpg: 4-component"):
        IO.read_jpeg(cmyk)
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"\x89PNG not a jpeg")
    with pytest.raises(ValueError, match="bad.jpg is not a JPEG"):
        IO.read_jpeg(bad)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_applies_it(tmp_path, orientation):
    """``read_image`` ignores the tag (imageio's array); turning that array
    with ``apply_orientation`` gives cv2.imread's."""
    ex = Image.Exif()
    ex[0x0112] = orientation
    p = str(tmp_path / "o.jpg")
    Image.fromarray(sphere_rgb(20, 30, orientation)).save(
        p, quality=90, exif=ex.tobytes())
    raw = IO.read_image(p)
    np.testing.assert_array_equal(raw, imageio.imread(p))
    assert IO.jpeg_orientation(p) == orientation
    turned = IO.apply_orientation(raw, IO.jpeg_orientation(p))
    np.testing.assert_array_equal(
        turned, cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1])


def test_llff_jpeg_scene_matches_jax():
    """The checked-in LLFF JPEG scene at fern's factor 8 (images_8/ read
    directly): images, poses, bounds and the spiral equal JAX's."""
    base = os.path.join(FIXTURES, "llff")
    j = jax_llff(base, factor=8, n_pose_video=12)
    t = load_llff_data(base, factor=8, n_pose_video=12)
    assert (t.H, t.W) == (378, 504) and t.images.shape[0] == 8
    assert (t.H, t.W, t.focal, t.i_test) == (j.H, j.W, j.focal, j.i_test)
    for name in ("images", "poses", "bds", "render_poses"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


@pytest.mark.parametrize("rotated", [False, True])
def test_minify_jpeg_sources_match_cv2(tmp_path, rotated):
    """Each package builds images_2 from JPEG sources (JAX: cv2.imread and
    INTER_AREA; the port: its decoder, the EXIF turn and its area resize):
    the caches and the loaded scenes agree. ``rotated`` stores every view
    sideways with EXIF orientation 6, which cv2 (and so the cache) turns
    back upright."""
    src = os.path.join(FIXTURES, "llff")
    a = str(tmp_path / "a")
    os.makedirs(os.path.join(a, "images"))
    shutil.copy(os.path.join(src, "poses_bounds.npy"), a)
    for n in sorted(os.listdir(os.path.join(src, "images"))):
        p = os.path.join(src, "images", n)
        if rotated:
            ex = Image.Exif()
            ex[0x0112] = 6
            img = np.ascontiguousarray(np.rot90(imageio.imread(p), 1))
            Image.fromarray(img).save(os.path.join(a, "images", n),
                                      quality=90, exif=ex.tobytes())
        else:
            shutil.copy(p, os.path.join(a, "images", n))
    b = str(tmp_path / "b")
    shutil.copytree(a, b)
    j = jax_llff(a, factor=2, n_pose_video=6)
    t = load_llff_data(b, factor=2, n_pose_video=6)
    assert (t.H, t.W) == (189, 252)
    for n in sorted(os.listdir(os.path.join(a, "images_2"))):
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(b, "images_2", n)),
            imageio.imread(os.path.join(a, "images_2", n)), err_msg=n)
    for name in ("images", "poses", "bds", "render_poses"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
