"""Pseudo-data generation by the NeRF teacher, ``rand`` mode, as
``create_data`` runs it: one ``generate_pseudo_data`` call over the
traffic's ``n_pose`` poses, ``poses_per_batch`` poses a render and a flush
of shards every ``save_every`` poses, into a directory under ``TMPDIR``.
The window is the call's first stretch: it opens with the call, and the
first pose batch due to begin once ``--seconds`` are over is refused (the
benchmark's ``pose_fn`` raises before drawing its pose), so the call writes
every batch it rendered, joins its writer and returns: the window closes
then. The poses, focals and the writer's shuffle come from the call's seed
(``call_seed``); each batch's stratified and inverse-CDF draws are the
benchmark's, made on the card from that seed and the batch's first pose
and handed over through ``draws_fn``.

The check, once the window has closed: a sample of the records on disk,
drawn from the seed, against the plain reference's render of the same rays
with the same draws: the count of records, each record's ray (matched to
one of the window's poses and a pixel of it), and its colour.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import poses, runner, weights
from ..runner import Check, Window
from ..trace import span

RADIUS = 4.0      # generate_pseudo_data's pose sphere (the CLI's default)


class _Closed(Exception):
    """The window has closed: the call stops before its next batch."""


def call_seed(seed: int, k: int) -> int:
    """The seed of call ``k`` (0 the window's, -1 the warm-up's)."""
    return seed * 100_003 + k + 1


def _ncfg(config: dict, traffic: dict):
    from r2l_tpu_torch.models import NeRFConfig
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        traffic.get("compute_dtype", "float32")]
    return NeRFConfig(D=config["D"], W=config["W"],
                      input_ch=config["input_ch"],
                      input_ch_views=config["input_ch_views"],
                      output_ch=config["output_ch"],
                      skips=tuple(config["skips"]),
                      use_viewdirs=config["use_viewdirs"],
                      compute_dtype=dtype)


def _vcfg(config: dict):
    from r2l_tpu_torch.render import VolRenderConfig
    return VolRenderConfig(n_coarse=config["N_samples"],
                           n_fine=config["N_importance"],
                           perturb=config["perturb"],
                           white_bkgd=config["white_bkgd"],
                           raw_noise_std=config["raw_noise_std"],
                           use_viewdirs=config["use_viewdirs"],
                           multires=config["multires"],
                           multires_views=config["multires_views"],
                           near=config["near"], far=config["far"],
                           ray_chunk=config["chunk"])


def draws(config: dict, seed: int, n_rays: int, device) -> tuple:
    """(u_strat [chunks, chunk, N_samples], u_pdf [chunks, chunk,
    N_importance]) of a pose batch's rays in the render's chunks."""
    chunk = config["chunk"]
    n_chunks = -(-n_rays // chunk)
    g = torch.Generator(device).manual_seed(seed)
    u_s = torch.rand((n_chunks, chunk, config["N_samples"]), generator=g,
                     device=device)
    u_p = torch.rand((n_chunks, chunk, config["N_importance"]),
                     generator=g, device=device)
    return u_s, u_p


def setup(job) -> None:
    from r2l_tpu_torch.models import NeRF
    c, t, dev = job.config, job.traffic, job.device
    g = torch.Generator(dev).manual_seed(job.seed)
    job.w_coarse = weights.nerf_weights(c, g)
    job.w_fine = weights.nerf_weights(c, g)
    job.ncfg, job.vcfg = _ncfg(c, t), _vcfg(c)
    job.models = []
    for w in (job.w_coarse, job.w_fine):
        m = NeRF(job.ncfg, torch.device("meta"))
        m.load_state_dict({k: v.clone() for k, v in w.items()}, assign=True)
        job.models.append(m.to(dev))
    job.root = tempfile.mkdtemp(prefix="r2l_bench_datagen_")
    job.done = 0
    # warm-up: one batch of the window's shape, from a seed the window does
    # not use
    _call(job, -1, t["poses_per_batch"], None, None)
    shutil.rmtree(os.path.join(job.root, "call_-1"))


def _gcfg(job, n_pose: int, gseed: int):
    from r2l_tpu_torch.datagen import DataGenConfig
    c, t = job.config, job.traffic
    return DataGenConfig(n_pose=n_pose, H=c["img_H"], W=c["img_W"],
                         focal=c["focal"], use_rand_focal=c["use_rand_focal"],
                         save_every=t["save_every"], seed=gseed,
                         poses_per_batch=t["poses_per_batch"],
                         use_pallas=True, quantize=t.get("quantize", ""))


def _call(job, k: int, n_pose: int, seconds: float | None, tracer
          ) -> tuple[float, list[float], int]:
    """Call ``k`` of ``generate_pseudo_data``, of ``n_pose`` poses or, with
    ``seconds``, of the batches begun before they are over: (its start,
    the host time each pose was done, the poses begun)."""
    from r2l_tpu_torch.datagen import generate_pseudo_data
    from r2l_tpu_torch.rays import get_rand_pose
    gseed = call_seed(job.seed, k)
    ppb, dev = job.traffic["poses_per_batch"], job.device
    begun, done = [0], []
    # the host's part of a batch as spans: "rays" (the poses' rays, their
    # upload) from its first pose to its draws, "render" (the launches,
    # the readback, the records) to its progress, "flush" (the records to
    # the writer) to the next batch's first pose
    spans = contextlib.ExitStack()

    def phase(name: str) -> None:
        spans.close()
        spans.enter_context(span(tracer, name))

    def pose_fn(rng):
        if begun[0] % ppb == 0:           # the first pose of a batch
            now = time.perf_counter()
            if seconds is not None and begun[0] > 0 and \
                    now - t_start >= seconds:
                raise _Closed
            if tracer is not None:
                tracer.maybe_start(t_start, seconds, now)
                tracer.unit_begun()
            phase("rays")
        begun[0] += 1
        return get_rand_pose(rng, radius=RADIUS)

    def progress(n_done, _n):
        now = time.perf_counter()
        done.extend([now] * (n_done - len(done)))
        phase("flush")

    def draws_fn(i, rays_o, rays_d):
        from r2l_tpu_torch.render import ChunkDraws
        phase("render")
        u_s, u_p = draws(job.config, gseed * 1000 + i, rays_o.shape[0], dev)
        return [ChunkDraws(u_strat=u_s[j], u_pdf=u_p[j])
                for j in range(u_s.shape[0])]

    out = os.path.join(job.root, f"call_{k}")
    t_start = time.perf_counter()
    try:
        generate_pseudo_data(job.models[0], job.models[1], job.ncfg,
                             job.vcfg, _gcfg(job, n_pose, gseed), out,
                             radius=RADIUS, progress=progress,
                             pose_fn=pose_fn, device=dev, draws_fn=draws_fn)
    except _Closed:
        pass
    finally:
        spans.close()
    if done:
        done[-1] = time.perf_counter()    # its records on disk
    return t_start, done, begun[0]


def window(job, seconds: float, tracer) -> Window:
    t_start, done, begun = _call(job, 0, job.traffic["n_pose"], seconds,
                                 tracer)
    job.done = len(done)
    return Window(t_start, done[-1], begun, done)


def pose_ops(job) -> float:
    from counts import nerf_render
    c = job.config
    return nerf_render.pose_ops(c, c["img_H"] * c["img_W"], c["N_samples"],
                                c["N_importance"])


def release(job) -> None:
    job.models = None


def _window_cams(job) -> list:
    """The window's poses and focals, drawn as the call draws them."""
    c = job.config
    prng = np.random.default_rng(call_seed(job.seed, 0))
    return [poses.rand_pose_and_focal(prng, c["focal"], c["use_rand_focal"],
                                      RADIUS) for _ in range(job.done)]


def _reference(job, cams: list, rays: np.ndarray,
               tf32: bool = False) -> torch.Tensor:
    """The reference's colours of the window's rays ``rays`` (p*H*W +
    pixel), batch by batch with each batch's draws."""
    from reference import nerf as ref
    from reference.r2l import matmul_precision
    c, dev = job.config, job.device
    H, W, chunk = c["img_H"], c["img_W"], c["chunk"]
    ppb = job.traffic["poses_per_batch"]
    gseed = call_seed(job.seed, 0)
    out = torch.empty((len(rays), 3), device=dev)
    for b in np.unique(rays // (H * W) // ppb):
        sel = np.nonzero(rays // (H * W) // ppb == b)[0]
        first = int(b) * ppb
        n = min(ppb, len(cams) - first)
        u_s, u_p = draws(c, gseed * 1000 + first, n * H * W, dev)
        r = rays[sel]
        o = np.empty((len(r), 3), np.float32)
        d = np.empty((len(r), 3), np.float32)
        for p in np.unique(r // (H * W)):
            at = r // (H * W) == p
            ro, rd = ref.rays(cams[p][0], H, W, cams[p][1])
            o[at], d[at] = ro[r[at] % (H * W)], rd[r[at] % (H * W)]
        it = torch.as_tensor(r - first * H * W, device=dev)
        with matmul_precision(tf32), torch.no_grad():
            out[torch.as_tensor(sel, device=dev)] = ref.render(
                job.w_coarse, job.w_fine, c, torch.as_tensor(o, device=dev),
                torch.as_tensor(d, device=dev), u_s[it // chunk, it % chunk],
                u_p[it // chunk, it % chunk])
        del u_s, u_p
    return out


def _records(job) -> tuple[int, np.ndarray]:
    """(records on disk, a sample of them drawn from the seed)."""
    path = os.path.join(job.root, "call_0")
    files = sorted(f for f in os.listdir(path) if f.endswith(".npy")) \
        if os.path.isdir(path) else []
    shards = [np.load(os.path.join(path, f), mmap_mode="r") for f in files]
    sizes = np.asarray([a.shape[0] for a in shards], np.int64)
    total = int(sizes.sum())
    if total == 0:
        return 0, np.zeros((0, 9), np.float32)
    rng = np.random.default_rng(job.seed * 4 + 5)
    pick = np.sort(rng.choice(total, min(total, job.traffic["check"]["rays"]),
                              replace=False))
    ends = np.cumsum(sizes)
    which = np.searchsorted(ends, pick, side="right")
    rows = [np.asarray(shards[f][pick[which == f] - (ends[f] - sizes[f])])
            for f in np.unique(which)]
    return total, np.concatenate(rows).astype(np.float32)


def check(job, win: Window) -> list[Check]:
    c, dev = job.config, job.device
    lim = runner.limits_of(job)
    H, W = c["img_H"], c["img_W"]
    max_abs, rmse = 0.0, 0.0
    try:
        total, rows = _records(job)
        short = max(job.done * H * W - total, 0)
        cams = _window_cams(job)
        idx, bad = _identify(rows, cams, H, W)
        rows, idx = rows[~bad], idx[~bad]
        job.sampled = idx
        if len(idx):
            want = _reference(job, cams, idx)
            diff = torch.as_tensor(rows[:, 6:9], device=dev).double() - \
                want.double()
            max_abs = float(diff.abs().max())
            rmse = float(diff.pow(2).mean().sqrt())
    finally:
        shutil.rmtree(job.root, ignore_errors=True)
    return [Check("records_short", float(short), lim.get("records_short")),
            Check("rays_off", float(bad.sum()), lim.get("rays_off")),
            Check("rgb_max_abs", max_abs, lim.get("rgb_max_abs")),
            Check("rgb_rmse", rmse, lim.get("rgb_rmse"))]


def control(job) -> dict:
    """``check``'s colour numbers with the reference in the program's
    place, in TF32 (one precision below float32), on the rays the check
    sampled."""
    cams = _window_cams(job)
    want = _reference(job, cams, job.sampled)
    got = _reference(job, cams, job.sampled, tf32=True)
    diff = got.double() - want.double()
    return {"rgb_max_abs": float(diff.abs().max()),
            "rgb_rmse": float(diff.pow(2).mean().sqrt())}


def _identify(rows: np.ndarray, cams: list, H: int, W: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Each record's index p*H*W + j*W + i in the window's rays (pose p,
    pixel (i, j)), from its origin and direction; and which records match
    no pose's pixel ray (origin off by more than 1e-5, direction not a
    pixel's within 1e-5)."""
    o, d = rows[:, 0:3].astype(np.float64), rows[:, 3:6].astype(np.float64)
    origins = np.stack([np.asarray(c2w)[:3, 3] for c2w, _ in cams])
    dist = np.linalg.norm(o[:, None, :] - origins[None], axis=-1)
    p = dist.argmin(1)
    bad = dist[np.arange(len(p)), p] > 1e-5
    idx = np.zeros(len(rows), np.int64)
    for q, (c2w, focal) in enumerate(cams):
        sel = p == q
        R = np.asarray(c2w, np.float64)[:3, :3]
        cam = d[sel] @ R                       # R^T d, row by row
        x = cam[:, 0] / -cam[:, 2] * focal + W * 0.5
        y = -cam[:, 1] / -cam[:, 2] * focal + H * 0.5
        i, j = np.rint(x).astype(np.int64), np.rint(y).astype(np.int64)
        inside = (i >= 0) & (i < W) & (j >= 0) & (j < H)
        i, j = np.clip(i, 0, W - 1), np.clip(j, 0, H - 1)
        want = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                         -np.ones_like(x)], -1) @ R.T
        near = np.abs(want - d[sel]).max(-1) <= 1e-5
        bad[sel] |= ~(inside & near)
        idx[sel] = q * H * W + j * W + i
    return idx, bad
