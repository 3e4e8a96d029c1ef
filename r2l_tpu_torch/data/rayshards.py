"""Ray-shard storage and infinite batch loading (the R2L training data).

A copy of ``r2l_tpu/data/rayshards.py:28-316`` (numpy only; the port keeps
its own copy instead of importing the JAX package). Pseudo data is stored
as float32 records ``[o(3), d(3), rgb(3)(, depth...)]``, shuffled at write
time, in a few large ``.npy`` shards that are memory-mapped; batches are
assembled from random contiguous chunks (valid because the rays are
pre-shuffled) by background threads. The same seed gives the same batches
as the JAX package's loader, and shards written by either package are
byte-identical, so either package trains on the other's data.

Files starting with ``train_`` hold *real* rays, anything else *pseudo*
ones; ``pseudo_ratio`` mixes them (-1 = use everything).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

RECORD_DIM_RGB = 9       # o(3) + d(3) + rgb(3)


def shuffle_rays(rng: np.random.Generator, rays: np.ndarray) -> np.ndarray:
    """Double random permutation, as the reference does before sharding
    (`create_data.py:854-860`)."""
    rays = rays[rng.permutation(rays.shape[0])]
    return rays[rng.permutation(rays.shape[0])]


def write_ray_shards(datadir: str, rays: np.ndarray, prefix: str = "pseudo",
                     shard_size: int = 1 << 20,
                     rng: np.random.Generator | None = None,
                     shuffle: bool = True) -> list[str]:
    """Write [N, record_dim] rays as consolidated shuffled shards.

    Appends to existing numbering so data generation is resumable (the
    reference counts existing files the same way, `create_data.py:789-796`).
    """
    os.makedirs(datadir, exist_ok=True)
    if shuffle:
        rng = rng or np.random.default_rng(0)
        rays = shuffle_rays(rng, rays)
    existing = [f for f in os.listdir(datadir)
                if f.startswith(prefix + "_") and f.endswith(".npy")]
    start = len(existing)
    paths = []
    for i, off in enumerate(range(0, rays.shape[0], shard_size)):
        path = os.path.join(datadir, f"{prefix}_{start + i:06d}.npy")
        np.save(path, rays[off:off + shard_size].astype(np.float32))
        paths.append(path)
    return paths


def get_pseudo_ratio(schedule: str, step: int) -> float:
    """Linear pseudo/real mixing schedule, reference format
    ``'1:0.2,500000:0.9'`` (`main.py:811-828`)."""
    (s1, r1), (s2, r2) = [tuple(float(v) for v in part.split(":"))
                          for part in schedule.split(",")]
    t = np.clip((step - s1) / max(s2 - s1, 1e-8), 0.0, 1.0)
    return float(r1 + (r2 - r1) * t)


def _open_image_shard(path: str) -> np.ndarray:
    """Open a ``rand_images`` .npz batch ([n_frame, H, W, D] under key
    'data', `datagen.generate_rand_images`) as a memory-mappable array.

    npz entries cannot be mmapped (zip members), so the first open
    consolidates the stack into a sibling ``<name>.frames.npy`` cache and
    every later open mmaps that — the same few-large-mmapped-files design
    as the flat shards. Falls back to an in-memory array when the data
    dir is not writable.
    """
    cache = path[:-len(".npz")] + ".frames.npy"
    # mtime check: datagen restarts numbering at 0, so a regenerated
    # rand_images_00000.npz must invalidate the stale consolidation.
    if (not os.path.exists(cache)
            or os.path.getmtime(cache) < os.path.getmtime(path)):
        with np.load(path) as z:
            arr = np.asarray(z["data"], dtype=np.float32)
        try:
            # np.save appends '.npy' unless the name already ends with it
            tmp = cache[:-len(".npy")] + f".tmp{os.getpid()}.npy"
            np.save(tmp, arr)
            os.replace(tmp, cache)
        except OSError:
            return arr
    return np.load(cache, mmap_mode="r")


class RayShardDataset:
    """Memory-mapped view over a directory of ray shards.

    Two shard layouts coexist (the reference's BlenderDataset_v2 handles
    both in one class, `dataset/load_blender.py:306-322`):

      * flat ``.npy`` of pre-shuffled records ``[N, record_dim]`` — the
        rays workhorse;
      * image-shaped ``rand_images_*.npz`` batches ``[F, H, W, record_dim]``
        (`datagen.generate_rand_images`). Draws pick a random frame and —
        with ``rand_crop_size > 0`` — a random square crop, the reference's
        ``_square_rand_bbox`` branch (`load_blender.py:306-317`; dead code
        there since nothing ever passes rand_crop_size — implemented live
        here so the rand_images mode has a training consumer).
    """

    def __init__(self, datadir: str, pseudo_ratio: float = -1.0,
                 hold_ratio: float = 0.0,
                 rng: np.random.Generator | None = None,
                 rand_crop_size: int = -1):
        self.datadir = datadir
        self.pseudo_ratio = pseudo_ratio
        self.rand_crop_size = rand_crop_size
        files = sorted(f for f in os.listdir(datadir)
                       if f.endswith(".npy") and not f.endswith(".frames.npy")
                       and ".tmp" not in f)  # consolidation leftovers
        img_files = []
        for f in sorted(os.listdir(datadir)):
            if not f.endswith(".npz"):
                continue
            with np.load(os.path.join(datadir, f)) as z:
                if "data" in z.files:   # rand_images batch (others: patches)
                    img_files.append(f)
        if not files and not img_files:
            raise FileNotFoundError(f"no .npy/.npz ray shards in {datadir}")
        all_files = files + img_files
        real_files = [f for f in all_files if f.startswith("train_")]
        pseudo_files = [f for f in all_files if not f.startswith("train_")]
        if hold_ratio > 0:  # ablation: hold out part of the pseudo set
            rng = rng or np.random.default_rng(0)
            keep = max(1, int(len(pseudo_files) * (1.0 - hold_ratio)))
            pseudo_files = list(rng.permutation(pseudo_files)[:keep])

        def _open(f: str) -> np.ndarray:
            path = os.path.join(datadir, f)
            if f.endswith(".npz"):
                return _open_image_shard(path)
            return np.load(path, mmap_mode="r")

        self.real = [_open(f) for f in real_files]
        self.pseudo = [_open(f) for f in pseudo_files]
        arrs = self.real + self.pseudo
        dims = {int(a.shape[-1]) for a in arrs}
        if len(dims) > 1:
            raise ValueError(f"mixed record dims {sorted(dims)} in {datadir}")
        self.record_dim = dims.pop()
        if rand_crop_size > 0:
            for a in arrs:
                if a.ndim == 4 and (a.shape[1] < rand_crop_size
                                    or a.shape[2] < rand_crop_size):
                    raise ValueError(
                        f"rand_crop_size {rand_crop_size} exceeds frame "
                        f"{a.shape[1]}x{a.shape[2]}")
        self.n_real = sum(self._n_rays(a) for a in self.real)
        self.n_pseudo = sum(self._n_rays(a) for a in self.pseudo)

    @staticmethod
    def _n_rays(a: np.ndarray) -> int:
        return int(np.prod(a.shape[:-1]))

    def __len__(self) -> int:
        return self.n_real + self.n_pseudo

    def _draw_chunk(self, rng: np.random.Generator, arrs: list[np.ndarray],
                    chunk: int) -> np.ndarray:
        sizes = np.asarray([self._n_rays(a) for a in arrs], dtype=np.float64)
        idx = rng.choice(len(arrs), p=sizes / sizes.sum())
        a = arrs[idx]
        if a.ndim == 4:  # image-shaped shard: random frame (+ crop)
            frame = a[int(rng.integers(0, a.shape[0]))]
            s = self.rand_crop_size
            if s and s > 0:
                # reference _square_rand_bbox (`load_blender.py:306-310`)
                y = int(rng.integers(0, frame.shape[0] - s + 1))
                x = int(rng.integers(0, frame.shape[1] - s + 1))
                return np.asarray(frame[y:y + s, x:x + s],
                                  dtype=np.float32).reshape(s * s, -1)
            h, w, d = frame.shape
            if h * w <= chunk:
                return np.asarray(frame, np.float32).reshape(h * w, d)
            # copy only the mmap rows covering the flat window
            off = int(rng.integers(0, h * w - chunk + 1))
            r0, r1 = off // w, (off + chunk - 1) // w
            rows = np.asarray(frame[r0:r1 + 1], np.float32).reshape(-1, d)
            lo = off - r0 * w
            return rows[lo:lo + chunk]
        if a.shape[0] <= chunk:
            return np.asarray(a)
        off = int(rng.integers(0, a.shape[0] - chunk + 1))
        return np.asarray(a[off:off + chunk])

    def sample_batch(self, rng: np.random.Generator, batch_size: int,
                     chunk: int = 4096,
                     pseudo_ratio: float | None = None) -> np.ndarray:
        """Assemble a [batch_size, record_dim] batch from random chunks.

        Equivalent to the reference's "N_rand random 4096-ray shards"
        batching (`main.py:1304-1311`) with pseudo/real mixing.
        """
        pr = self.pseudo_ratio if pseudo_ratio is None else pseudo_ratio
        # Draw until full: image-shard draws yield s*s (crop) or H*W
        # (whole-frame) rows regardless of ``chunk``, so counting
        # ceil(batch/chunk) fixed chunks would silently under-fill and
        # tile duplicates. Tiny datasets still fill by repetition (each
        # loop iteration draws independently, like the old tile-up).
        parts, total = [], 0
        while total < batch_size:
            use_pseudo = bool(self.pseudo) and (
                not self.real or pr < 0 or rng.random() < pr)
            # pr<0 means "use everything": weight by pool size.
            if pr < 0 and self.real and self.pseudo:
                use_pseudo = rng.random() < self.n_pseudo / max(len(self), 1)
            arrs = self.pseudo if use_pseudo else self.real
            part = self._draw_chunk(rng, arrs, chunk)
            parts.append(part)
            total += part.shape[0]
        return np.concatenate(parts, axis=0)[:batch_size]


class RayBatchLoader:
    """Infinite, background-prefetched batch iterator.

    Host-side replacement for the reference's worker-process DataLoader +
    InfiniteSampler (`main.py:759-808`): ``workers`` daemon threads each
    fill their OWN queue and the consumer round-robins across them —
    batch order is a pure function of (seed, workers), deterministic
    regardless of thread timing (like torch DataLoader's in-order worker
    results), and ``workers=1`` reproduces the old single-rng sequence
    exactly. numpy mmap reads/copies release the GIL, so threads scale
    like the reference's worker processes.

    ``start_step`` seats the pseudo-ratio schedule at the true global
    iteration (checkpoint resume, --i_update_data reloads — reference
    `main.py:811-828` uses the global step): worker w's k-th batch is
    consumed at global step ``start_step + k*workers + w``, computed
    exactly, no prefetch skew.
    """

    def __init__(self, dataset: RayShardDataset, batch_size: int,
                 seed: int = 0, chunk: int = 4096,
                 pseudo_ratio_schedule: str | None = None,
                 prefetch: int | None = None, workers: int = 1,
                 start_step: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.chunk = chunk
        self.schedule = pseudo_ratio_schedule
        self._workers = max(1, workers)
        depth = max(2, (prefetch if prefetch is not None
                        else 2 * self._workers) // self._workers)
        self._queues = [queue.Queue(maxsize=depth)
                        for _ in range(self._workers)]
        self._next_q = 0
        self._start = start_step
        self._stop = threading.Event()
        self._errors: list[BaseException] = []
        self._threads = [
            threading.Thread(target=self._worker,
                             args=(w, np.random.default_rng(
                                 seed + 7919 * w)),
                             daemon=True)
            for w in range(self._workers)]
        for t in self._threads:
            t.start()

    def _worker(self, w: int, rng: np.random.Generator):
        try:
            k = 0
            while not self._stop.is_set():
                pr = None
                if self.schedule:
                    step = self._start + k * self._workers + w
                    pr = get_pseudo_ratio(self.schedule, step)
                batch = self.dataset.sample_batch(
                    rng, self.batch_size, self.chunk, pseudo_ratio=pr)
                k += 1
                while not self._stop.is_set():
                    try:
                        self._queues[w].put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface to the consumer
            self._errors.append(e)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        q = self._queues[self._next_q]
        while True:
            if self._errors:
                raise RuntimeError(
                    "ray batch loader worker failed") from self._errors[0]
            try:
                batch = q.get(timeout=1.0)
                break
            except queue.Empty:
                continue
        self._next_q = (self._next_q + 1) % self._workers
        return batch

    def close(self):
        self._stop.set()
        for q in self._queues:  # unblock any put-waiting worker
            try:
                q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
