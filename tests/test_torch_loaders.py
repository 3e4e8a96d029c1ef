"""Port parity: the dataset loaders, the PNG decoder and the area resize
(r2l_tpu_torch/data/{blender,llff,deepvoxels,imageio_}.py against
r2l_tpu/data/*.py, imageio and cv2)."""
import os
import shutil

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from _torch_scene import write_scene
from r2l_tpu.data.blender import load_blender_data as jax_blender
from r2l_tpu.data.deepvoxels import load_dv_data as jax_dv
from r2l_tpu.data.llff import load_llff_data as jax_llff
from r2l_tpu_torch.data import imageio_ as IO
from r2l_tpu_torch.data.blender import load_blender_data
from r2l_tpu_torch.data.deepvoxels import load_dv_data
from r2l_tpu_torch.data.llff import load_llff_data

# The area resize against cv2's INTER_AREA on float32 images: float64 sums
# here, f32 ones in cv2, so a few f32 ulps of [0, 1] apart (measured 1.2e-7
# at worst over the factors below). On uint8 images: equal at integer
# factors (the LLFF minify); at a non-integer factor, which no loader takes
# on uint8, cv2's f32 sums can round a .5 the other way: one step.
TOL_AREA_F32 = 1e-6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("scene")))


@pytest.mark.parametrize("half_res", [False, True])
def test_blender_matches_jax(scene, half_res):
    j = jax_blender(scene, half_res=half_res, testskip=1)
    t = load_blender_data(scene, half_res=half_res, testskip=1)
    assert (t.H, t.W, t.focal) == (j.H, j.W, j.focal)
    assert t.images.dtype == np.float32 and t.images.shape == j.images.shape
    if half_res:
        np.testing.assert_allclose(t.images, j.images, rtol=0,
                                   atol=TOL_AREA_F32)
    else:
        np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.poses, j.poses)
    for a, b in zip(t.i_split, j.i_split):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.white_bkgd_rgb(), t.white_bkgd_rgb())
    np.testing.assert_allclose(t.white_bkgd_rgb(), j.white_bkgd_rgb(),
                               rtol=0, atol=0 if not half_res else 2e-6)


def _png_cases(rng):
    u8 = lambda *s: (rng.uniform(size=s) * 255).astype(np.uint8)  # noqa
    x = np.linspace(0, 1, 40)
    smooth = (np.stack(np.meshgrid(x, x[:30]), -1).sum(-1)[..., None]
              * np.array([60, 90, 120])).astype(np.uint8)
    return {"rgb": u8(20, 30, 3), "rgba": u8(20, 30, 4), "grey": u8(20, 30),
            "grey_alpha": u8(20, 30, 2), "smooth_rgb": smooth,
            "grey16": (rng.uniform(size=(20, 30)) * 65535).astype(np.uint16)}


@pytest.mark.parametrize("case", ["rgb", "rgba", "grey", "grey_alpha",
                                  "smooth_rgb", "grey16"])
def test_png_decode_is_imageios(tmp_path, case):
    img = _png_cases(np.random.default_rng(0))[case]
    path = str(tmp_path / f"{case}.png")
    imageio.imwrite(path, img)
    want, got = imageio.imread(path), IO.read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_every_filter(tmp_path, ftype):
    """One filter type on every row, written by hand: the decode is the
    image (and imageio's)."""
    import struct
    import zlib
    rng = np.random.default_rng(ftype)
    img = (rng.uniform(size=(9, 11, 3)) * 255).astype(np.int64)
    bpp, rows, prior = 3, [], np.zeros(33, np.int64)
    for r in img.reshape(9, 33):
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 4:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
        else:
            pred = {0: 0 * r, 1: left, 2: prior,
                    3: (left + prior) // 2}[ftype]
        rows.append(bytes([ftype]) + ((r - pred) % 256).astype(
            np.uint8).tobytes())
        prior = r

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 9, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))
    np.testing.assert_array_equal(IO.read_png(path), img.astype(np.uint8))
    np.testing.assert_array_equal(IO.read_png(path), imageio.imread(path))


@pytest.mark.parametrize("factor", [2, 8, 2.5, 1.7])
@pytest.mark.parametrize("shape", [(64, 48), (37, 53)])
def test_area_resize_matches_cv2(factor, shape):
    """Factors 2 and 8 (half_res, the LLFF minify) and non-integer
    --render_factor shrinks, as _eval_render_setup computes the size."""
    rng = np.random.default_rng(1)
    h, w = shape
    H, W = int(h / factor), int(w / factor)
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    got = IO.resize_area(img, W, H)
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_AREA_F32)
    u8 = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    got8 = IO.resize_area(u8, W, H).astype(np.int64)
    want8 = cv2.resize(u8, (W, H), interpolation=cv2.INTER_AREA)
    step = 0 if float(factor).is_integer() else 1
    assert np.abs(got8 - want8).max() <= step


def _llff_scene(base, n=6, h=32, w=40, rng=None):
    """Forward-facing cameras with PNG images and poses_bounds.npy, the
    layout the LLFF loaders read."""
    rng = rng or np.random.default_rng(2)
    os.makedirs(os.path.join(base, "images"))
    rows = []
    for k in range(n):
        img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        imageio.imwrite(os.path.join(base, "images", f"im_{k:03d}.png"), img)
        # LLFF's [down, right, back] columns, hwf, then near/far bounds
        a = 0.25 * k
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]])
        c2w = rot @ (np.eye(3)[:, [1, 0, 2]] * np.array([1, -1, 1]))
        pos = rot @ np.array([0.3 * np.cos(k), 0.2 * np.sin(k), 4.0])
        m = np.concatenate([c2w, pos[:, None], np.array([[h], [w], [30.0]])],
                           1)
        rows.append(np.concatenate([m.ravel(), [2.0 + 0.1 * k, 9.0]]))
    np.save(os.path.join(base, "poses_bounds.npy"), np.stack(rows))
    return base


@pytest.mark.parametrize("factor", [1, 2, 8])
@pytest.mark.parametrize("spherify", [False, True])
def test_llff_matches_jax(tmp_path, factor, spherify):
    """Each package builds its own images_<factor> cache (cv2 against the
    area resize, both 8-bit PNGs) in a copy of the scene; the arrays
    agree."""
    a = _llff_scene(str(tmp_path / "a"))
    b = str(tmp_path / "b")
    shutil.copytree(a, b)
    j = jax_llff(a, factor=factor, spherify=spherify, n_pose_video=10)
    t = load_llff_data(b, factor=factor, spherify=spherify, n_pose_video=10)
    assert (t.H, t.W, t.focal, t.i_test) == (j.H, j.W, j.focal, j.i_test)
    for name in ("images", "poses", "bds", "render_poses"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for x, y in zip(t.splits(3), j.splits(3)):
        np.testing.assert_array_equal(x, y)
    assert t.near_far(True) == j.near_far(True)


def test_jpeg_raises_naming_the_file(tmp_path):
    a = _llff_scene(str(tmp_path / "a"), n=2)
    os.makedirs(os.path.join(a, "images_2"))
    for k in range(2):
        img = np.zeros((16, 20, 3), np.uint8)
        imageio.imwrite(os.path.join(a, "images_2", f"im_{k:03d}.JPG"), img,
                        format="JPEG")
    with pytest.raises(NotImplementedError,
                       match=r"im_000\.JPG.*ROADMAP A5"):
        load_llff_data(a, factor=2)
    # a JPEG under a .png name is caught by its first bytes
    p = str(tmp_path / "x.png")
    shutil.copy(os.path.join(a, "images_2", "im_000.JPG"), p)
    with pytest.raises(NotImplementedError, match="x.png"):
        IO.read_image(p)


def _dv_scene(base, side=8, rng=None):
    rng = rng or np.random.default_rng(3)
    for split, n in (("train", 3), ("validation", 2), ("test", 4)):
        d = os.path.join(base, split, "greek")
        os.makedirs(os.path.join(d, "pose"))
        os.makedirs(os.path.join(d, "rgb"))
        if split == "train":
            with open(os.path.join(d, "intrinsics.txt"), "w") as f:
                f.write("300.0 4.0 4.0 0.\n0. 0. 0.\n1.\n1.\n512 512\n")
        for k in range(n):
            m = np.eye(4)
            m[:3, 3] = rng.uniform(-1, 1, 3) + np.array([0, 0, 3.0])
            np.savetxt(os.path.join(d, "pose", f"{k:06d}.txt"),
                       m.reshape(1, 16))
            imageio.imwrite(os.path.join(d, "rgb", f"{k:06d}.png"),
                            (rng.uniform(size=(side, side, 3)) * 255
                             ).astype(np.uint8))
    return base


@pytest.mark.parametrize("testskip", [1, 2])
def test_deepvoxels_matches_jax(tmp_path, testskip):
    base = _dv_scene(str(tmp_path))
    j = jax_dv(base, scene="greek", testskip=testskip)
    t = load_dv_data(base, scene="greek", testskip=testskip)
    assert (t.H, t.W, t.focal) == (j.H, j.W, j.focal)
    for name in ("images", "poses", "render_poses"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for x, y in zip(t.i_split, j.i_split):
        np.testing.assert_array_equal(x, y)
    assert t.near_far() == j.near_far()
