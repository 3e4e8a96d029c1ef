"""K1 and K2: the student's frame chain on ``n`` rays, the positional
encoding computed inside (the encoding's sin/cos are not counted as
operations: they run off the tensor cores and are a few percent of the
products).

Operations: a multiply-add counts 2, for the head (input_dim x W), every
body layer (W x W) and the tail (W x output_dim). Bytes: each ray's sample
points read once (f32), its colour written once (f32), and the weights,
biases and scales read once per call.
"""
from __future__ import annotations


def chain_macs(cfg: dict) -> int:
    """Multiply-adds of one ray through head, body and tail."""
    W = cfg["netwidth"]
    n_body = cfg["num_blocks"] * cfg["n_learnable"]
    return (cfg["input_dim"] * W + n_body * W * W
            + W * cfg["output_dim"])


def n_weights(cfg: dict) -> int:
    return chain_macs(cfg)


def n_biases(cfg: dict) -> int:
    n_body = cfg["num_blocks"] * cfg["n_learnable"]
    return cfg["netwidth"] * (1 + n_body) + cfg["output_dim"]


def frame_ops(cfg: dict, n: int) -> float:
    """Operations of one frame of ``n`` rays (the model's FLOPs)."""
    return 2.0 * n * chain_macs(cfg)


def k1_counts(cfg: dict, n: int, weight_bytes: int = 4) -> tuple[float,
                                                                  float]:
    """(operations, bytes) of one K1 call on ``n`` rays; f32 weights by
    default (the CLI's frame), 2 for bf16."""
    dim_pts = 3 * cfg["n_sample"]
    nbytes = (n * dim_pts * 4 + n * cfg["output_dim"] * 4
              + n_weights(cfg) * weight_bytes + n_biases(cfg) * 4)
    return frame_ops(cfg, n), float(nbytes)


def k2_counts(cfg: dict, n: int) -> tuple[float, float]:
    """(operations, bytes) of one K2 call on ``n`` rays: int8 weights, and
    per output channel of every layer a scale and a bias (f32)."""
    dim_pts = 3 * cfg["n_sample"]
    nbytes = (n * dim_pts * 4 + n * cfg["output_dim"] * 4
              + n_weights(cfg) + n_biases(cfg) * 4 * 2)
    return frame_ops(cfg, n), float(nbytes)


_WEIGHT_BYTES = {"float32": 4, "bfloat16": 2}


def k1_launches(cfg: dict, traffic: dict) -> list[tuple[float, float]]:
    """The launches of one frame: one K1 call on the frame's rays, the
    weights in the traffic's compute dtype."""
    return [k1_counts(cfg, cfg["H"] * cfg["W"],
                      _WEIGHT_BYTES[traffic["compute_dtype"]])]


def k2_launches(cfg: dict, traffic: dict) -> list[tuple[float, float]]:
    """The launches of one frame: one K2 call on the frame's rays."""
    return [k2_counts(cfg, cfg["H"] * cfg["W"])]
