"""Blender synthetic dataset loader (NeRF transforms_*.json format), and
the frame source of images-mode distillation.

Counterpart of ``r2l_tpu/data/blender.py`` (``BlenderData``,
``load_blender_data``, ``ImageFrameDataset``), host-side numpy, copied
because the JAX package is not imported here. It mirrors reference
`dataset/load_blender.py:31-120` minus its debug warts (unconditional
matplotlib scatter dumps), with the DONeRF ``dataset_info.json`` focal
fallback kept. Images are read by ``imageio_.read_image`` (PNG; a JPEG
raises) and ``half_res`` shrinks them with ``imageio_.resize_area`` (cv2's
INTER_AREA), so the loader needs neither imageio nor cv2.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .imageio_ import read_image, resize_area


@dataclasses.dataclass
class BlenderData:
    images: np.ndarray        # [N, H, W, 4] or [N, H, W, 3] float32 in [0,1]
    poses: np.ndarray         # [N, 4, 4]
    H: int
    W: int
    focal: float
    i_split: tuple[np.ndarray, np.ndarray, np.ndarray]  # train/val/test ids
    near: float = 2.0
    far: float = 6.0

    def white_bkgd_rgb(self) -> np.ndarray:
        """Composite RGBA onto white -> [N, H, W, 3]."""
        if self.images.shape[-1] == 3:
            return self.images
        rgb, a = self.images[..., :3], self.images[..., 3:]
        return rgb * a + (1.0 - a)

    def black_bkgd_rgb(self) -> np.ndarray:
        """Without --white_bkgd the reference keeps the RAW rgb channels
        (`main.py:936-937`: images[..., :3] — NO alpha premultiply);
        match it exactly so train/eval targets agree."""
        if self.images.shape[-1] == 3:
            return self.images
        return self.images[..., :3]


def _read_image(path: str) -> np.ndarray:
    return (np.asarray(read_image(path)) / 255.0).astype(np.float32)


def load_blender_data(basedir: str, half_res: bool = False,
                      testskip: int = 1) -> BlenderData:
    """Load the three splits. ``testskip`` subsamples val/test
    (reference `load_blender.py:50-53`)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        frames = meta["frames"][::skip]
        imgs, poses = [], []
        for frame in frames:
            fname = os.path.join(basedir, frame["file_path"])
            if not os.path.splitext(fname)[1]:
                fname += ".png"
            imgs.append(_read_image(fname))
            poses.append(np.asarray(frame["transform_matrix"],
                                    dtype=np.float32))
        all_imgs.append(np.stack(imgs) if imgs else None)
        all_poses.append(np.stack(poses) if poses else None)
        counts.append(counts[-1] + len(frames))

    i_split = tuple(np.arange(counts[i], counts[i + 1]) for i in range(3))
    # Empty splits: use a 0-length placeholder with the REAL H/W/C of
    # the first non-empty split so concatenate succeeds.
    shaped = [a for a in all_imgs if a is not None]
    if not shaped:
        raise ValueError(f"no frames in any split under {basedir}")
    zi = np.zeros((0, *shaped[0].shape[1:]), np.float32)
    zp = np.zeros((0, 4, 4), np.float32)
    imgs = np.concatenate([a if a is not None else zi for a in all_imgs], 0)
    poses = np.concatenate([p if p is not None else zp
                            for p in all_poses], 0)
    H, W = imgs.shape[1:3]

    meta0 = metas["train"]
    if "camera_angle_x" in meta0:
        focal = 0.5 * W / np.tan(0.5 * float(meta0["camera_angle_x"]))
    else:
        # DONeRF layout: intrinsics live in dataset_info.json
        # (reference `load_blender.py:76-81`).
        with open(os.path.join(basedir, "dataset_info.json")) as f:
            info = json.load(f)
        focal = 0.5 * W / np.tan(0.5 * float(info["camera_angle_x"]))

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([resize_area(im, W, H) for im in imgs])

    return BlenderData(images=imgs.astype(np.float32),
                       poses=poses, H=int(H), W=int(W), focal=float(focal),
                       i_split=i_split)


class ImageFrameDataset:
    """Frame source for ``--data_mode images`` student training: the real
    train frames mixed with teacher-rendered pseudo frames.

    The JAX package's rework of the reference ``BlenderDataset``
    (`dataset/load_blender.py:224-254`) + its LLFF branch
    (`main.py:1240-1249`): pseudo frames come from the consolidated
    ``pseudo_images_*.npz`` packs written by
    ``datagen.generate_pseudo_images`` (instead of 1 npy per frame + a
    growing transforms_train.json), loaded once as memory-mapped arrays.

    Mixing semantics (reference `load_blender.py:236-242`): a fixed
    random subset of ``n_pseudo = n_real/(1-pseudo_ratio) - n_real``
    pseudo frames joins the real frames; ``sample()`` draws uniformly
    over the mixture. ``mode='llff'`` instead keeps ALL pseudo frames
    and draws pseudo with probability n_pseudo/(n_real+n_pseudo)
    (reference `main.py:1240-1246`). Rebuild the dataset (i_update_data)
    to re-draw the subset / pick up new packs.

    Pack formats: ``pseudo_images_XXXX.npy`` + ``pseudo_poses_XXXX.npy``
    pairs are memory-mapped (frames load lazily); legacy
    ``pseudo_images_*.npz`` packs are also read but decompress whole on
    first frame access (npz members cannot be mmap'd).
    """

    def __init__(self, images: np.ndarray, poses: np.ndarray,
                 datadir_kd: str | None = None, pseudo_ratio: float = 0.5,
                 mode: str = "blender", seed: int = 0):
        self.real_images = np.asarray(images, np.float32)
        self.real_poses = np.asarray(poses, np.float32)[:, :3, :4]
        self.mode = mode
        self.p_imgs: list[np.ndarray] = []   # per-pack [n, H, W, 3] mmaps
        self.p_poses: list[np.ndarray] = []
        self._index: list[tuple[int, int]] = []
        if datadir_kd and os.path.isdir(datadir_kd):
            names = sorted(os.listdir(datadir_kd))
            pi = 0
            for name in names:
                if not name.startswith("pseudo_images"):
                    continue
                path = os.path.join(datadir_kd, name)
                if name.endswith(".npy"):
                    imgs = np.load(path, mmap_mode="r")
                    poses_p = np.asarray(np.load(path.replace(
                        "pseudo_images_", "pseudo_poses_")), np.float32)
                elif name.endswith(".npz"):
                    with np.load(path) as z:  # close the zip handle: a
                        # reload-churned dataset must not leak one fd
                        # per pack ('Too many open files')
                        imgs = z["images"]  # eager (npz can't mmap)
                        poses_p = np.asarray(z["poses"], np.float32)
                else:
                    continue
                self.p_imgs.append(imgs)
                self.p_poses.append(poses_p)
                self._index += [(pi, j) for j in range(len(poses_p))]
                pi += 1
        rng = np.random.default_rng(seed)
        n_real = len(self.real_images)
        if mode == "blender" and self._index and 0 <= pseudo_ratio < 1:
            n_pseudo = int(n_real / (1.0 - pseudo_ratio) - n_real)
            pick = rng.permutation(len(self._index))[:n_pseudo]
            self._index = [self._index[i] for i in pick]

    @property
    def n_real(self) -> int:
        return len(self.real_images)

    @property
    def n_pseudo(self) -> int:
        return len(self._index)

    def __len__(self) -> int:
        return self.n_real + self.n_pseudo

    def sample(self, rng: np.random.Generator):
        """-> (image [H, W, 3] f32, pose [3, 4] f32, is_pseudo)."""
        i = int(rng.integers(0, len(self)))
        if i < self.n_real:
            return self.real_images[i], self.real_poses[i], False
        pi, j = self._index[i - self.n_real]
        img = np.asarray(self.p_imgs[pi][j], np.float32)
        pose = self.p_poses[pi][j][:3, :4]
        return img, pose, True
