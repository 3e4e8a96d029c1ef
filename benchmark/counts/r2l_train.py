"""K3 and K5: the distillation step's fused forward with its stash, and the
backward through a group of residual blocks.

K3 on ``n`` rays: the frame chain's operations (``r2l_fused.frame_ops``);
bytes: the sample points read, the colour written, the weights read once,
and the stash written once: one activation row per layer whose input the
backward needs (the head's output and every body layer's, 1 + 2 x blocks
rows of ``n`` x W values in the compute dtype).

K5 on ``n`` rays and ``blocks`` blocks: for each of the group's layers
dL/dx (n x W x W multiply-adds) and dL/dW (the same), so 4 n W^2 operations
a layer; bytes: the group's stash rows read once, dL/dh read and written
once (f32), the group's weights read and their gradients written once
(f32).
"""
from __future__ import annotations

from .r2l_fused import frame_ops, n_biases, n_weights


def stash_rows(cfg: dict) -> int:
    return 1 + cfg["num_blocks"] * cfg["n_learnable"]


def k3_counts(cfg: dict, n: int, act_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one K3 call on ``n`` rays; bf16 activations
    and weights by default."""
    W = cfg["netwidth"]
    dim_pts = 3 * cfg["n_sample"]
    nbytes = (n * dim_pts * 4 + n * cfg["output_dim"] * 4
              + n_weights(cfg) * act_bytes + n_biases(cfg) * 4
              + stash_rows(cfg) * n * W * act_bytes)
    return frame_ops(cfg, n), float(nbytes)


def k5_counts(cfg: dict, n: int, blocks: int,
              act_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one K5 call on ``n`` rays over ``blocks``
    residual blocks."""
    W, nl = cfg["netwidth"], cfg["n_learnable"]
    layers = blocks * nl
    ops = 4.0 * n * W * W * layers
    nbytes = (layers * n * W * act_bytes + 2 * n * W * 4
              + layers * (W * W + W) * (act_bytes + 4))
    return ops, float(nbytes)


def k5_walk_calls(cfg: dict, group_blocks: int = 4) -> list[int]:
    """The blocks of each K5 call of one step's walk, top group first."""
    nb = cfg["num_blocks"]
    calls = [group_blocks] * (nb // group_blocks)
    if nb % group_blocks:
        calls.append(nb % group_blocks)
    return calls


_ACT_BYTES = {"float32": 4, "bfloat16": 2}


def k3_launches(cfg: dict, traffic: dict) -> list[tuple[float, float]]:
    """The launches of one step: one K3 call on the step's batch."""
    return [k3_counts(cfg, traffic["batch_rays"],
                      _ACT_BYTES[traffic["compute_dtype"]])]


def k5_launches(cfg: dict, traffic: dict) -> list[tuple[float, float]]:
    """The launches of one step: a K5 call for each group of the walk."""
    return [k5_counts(cfg, traffic["batch_rays"], b,
                      _ACT_BYTES[traffic["compute_dtype"]])
            for b in k5_walk_calls(cfg, traffic["group_blocks"])]
