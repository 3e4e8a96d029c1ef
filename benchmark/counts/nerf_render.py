"""K6: the NeRF teacher's whole volumetric pass over a chunk of rays,
``S`` points a ray (the encoding, the MLP, the compositing).

Operations: a multiply-add of the MLP counts 2, for every point of every
ray (the encoding and compositing run off the tensor cores and are not
counted). Bytes: each ray's origin and direction and its ``S`` depths read
once, its colour, opacity, depth and ``S`` compositing weights written
once (f32), and the network's weights and biases read once per call (f32).
"""
from __future__ import annotations


def point_macs(cfg: dict) -> int:
    """Multiply-adds of the teacher MLP for one point (the published
    widths: D layers of W with the input concatenated after each skip, a
    view branch of W/2)."""
    W, D, cin, cv = cfg["W"], cfg["D"], cfg["input_ch"], cfg["input_ch_views"]
    macs = cin * W + sum((W + cin if i in cfg["skips"] else W) * W
                         for i in range(D - 1))
    if cfg["use_viewdirs"]:
        return macs + W + W * W + (W + cv) * (W // 2) + (W // 2) * 3
    return macs + W * cfg["output_ch"]


def n_params(cfg: dict) -> int:
    W, D, cin, cv = cfg["W"], cfg["D"], cfg["input_ch"], cfg["input_ch_views"]
    n = cin * W + W + sum((W + cin if i in cfg["skips"] else W) * W + W
                          for i in range(D - 1))
    if cfg["use_viewdirs"]:
        return (n + (W + 1) + (W * W + W) + ((W + cv) * (W // 2) + W // 2)
                + ((W // 2) * 3 + 3))
    return n + W * cfg["output_ch"] + cfg["output_ch"]


def k6_counts(cfg: dict, n: int, S: int) -> tuple[float, float]:
    """(operations, bytes) of one K6 call on ``n`` rays of ``S`` points."""
    ops = 2.0 * n * S * point_macs(cfg)
    nbytes = n * (6 + S) * 4 + n * (5 + S) * 4 + n_params(cfg) * 4
    return ops, float(nbytes)


def pose_ops(cfg: dict, rays: int, n_coarse: int, n_fine: int) -> float:
    """The model FLOPs of one pose: the coarse pass on ``n_coarse`` points
    a ray, the fine on ``n_coarse + n_fine``."""
    return 2.0 * rays * (2 * n_coarse + n_fine) * point_macs(cfg)


def k6_launches(cfg: dict, traffic: dict) -> list[tuple[float, float]]:
    """The launches of one pose batch (``poses_per_batch`` poses), a coarse
    and a fine call for each chunk of ``chunk`` rays; each launch's share
    is the batch's work over its launches (the padding of the last chunk
    is not the algorithm's)."""
    rays = cfg["img_H"] * cfg["img_W"] * traffic["poses_per_batch"]
    chunks = -(-rays // cfg["chunk"])
    coarse = k6_counts(cfg, rays, cfg["N_samples"])
    fine = k6_counts(cfg, rays, cfg["N_samples"] + cfg["N_importance"])
    # the weights are read once a call: counted once per launch
    wbytes = n_params(cfg) * 4
    out = []
    for ops, nbytes in (coarse, fine):
        per = (ops / chunks, (nbytes - wbytes) / chunks + wbytes)
        out += [per] * chunks
    return out
