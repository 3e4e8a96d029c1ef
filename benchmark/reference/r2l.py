"""The R2L student, plain: a pose's rays, their 16 evenly spaced points, the
per-scalar positional encoding and the ResMLP (Wang et al., ECCV 2022;
snap-research/R2L ``NeRF_v3_2``), in float32 with TF32 off.

``frame`` renders a pose in blocks of rays. ``quant_bits`` computes the
same frame with every linear's input and weights fake-quantized
symmetrically to that many bits (per input channel from a calibration, per
output channel of the weights): the lower-precision control of an int8
path.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matmuls in full float32 (``tf32=False``) or in TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def frame_points(c2w: torch.Tensor, H: int, W: int, focal: float,
                 n_sample: int, near: float, far: float) -> torch.Tensor:
    """[H*W, n_sample*3] sample points of pose ``c2w`` [3, 4]: pixel (i, j)
    looks along R [(i - W/2)/f, -(j - H/2)/f, -1] from the pose's origin;
    points at depths near*(1-t) + far*t, t = k/(n_sample-1)."""
    dev = c2w.device
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                        -torch.ones_like(i)], -1)
    R = c2w[:3, :3].float()
    d = (dirs[..., None, :] * R).sum(-1).reshape(-1, 3)
    o = c2w[:3, 3].float().expand(d.shape)
    t = torch.arange(n_sample, dtype=torch.float32, device=dev) * (
        torch.tensor(1.0) / max(n_sample - 1, 1))
    t[-1] = 1.0
    z = near * (1.0 - t) + far * t
    pts = o[:, None, :] + d[:, None, :] * z[None, :, None]
    return pts.reshape(pts.shape[0], -1)


def embed(x: torch.Tensor, L: int) -> torch.Tensor:
    """[n, dim] -> [n, dim*(2L+1)]: per scalar s, sin(2^k s) for k < L, then
    cos(2^k s), then s."""
    y = x[..., None] * (2.0 ** torch.arange(L, dtype=x.dtype,
                                            device=x.device))
    return torch.cat([torch.sin(y), torch.cos(y), x[..., None]],
                     -1).reshape(x.shape[0], -1)


def _layers(weights: dict, cfg: dict) -> tuple:
    head = (weights["head.0.weight"], weights["head.0.bias"])
    body = [[(weights[f"body.{i}.body.{2 * j}.weight"],
              weights[f"body.{i}.body.{2 * j}.bias"])
             for j in range(cfg["n_learnable"])]
            for i in range(cfg["num_blocks"])]
    tail = (weights["tail.0.weight"], weights["tail.0.bias"])
    return head, body, tail


def forward(weights: dict, cfg: dict, x: torch.Tensor,
            lin=None) -> torch.Tensor:
    """The ResMLP on encoded rays x [n, input_dim] -> rgb [n, 3]: a ReLU
    head h; per block t = W2 relu(W1 out + b1) + b2, out = t + out; the
    global residual out + h; a sigmoid tail. ``lin(k, x, w, b)`` replaces
    each linear (k counts them in order) for the quantized control."""
    lin = lin or (lambda k, x, w, b: x @ w.T + b)
    head, body, tail = _layers(weights, cfg)
    k = 0
    h = torch.relu(lin(k, x, *head))
    out = h
    for block in body:
        t = out
        for jj, (w, b) in enumerate(block):
            k += 1
            t = lin(k, t, w, b)
            if jj < len(block) - 1:
                t = torch.relu(t)
        out = t + out
    if cfg["use_residual"]:
        out = out + h
    k += 1
    return torch.sigmoid(lin(k, out, *tail))


def calibrate(weights: dict, cfg: dict, pts: torch.Tensor,
              margin: float = 1.1) -> dict[int, torch.Tensor]:
    """Each linear's per-input-channel max-abs over the encoded points
    ``pts``, times ``margin``."""
    scales: dict[int, torch.Tensor] = {}

    def lin(k, x, w, b):
        scales[k] = x.abs().amax(0).clamp_min(1e-8) * margin
        return x @ w.T + b

    forward(weights, cfg, embed(pts, cfg["embed_L"]), lin)
    return scales


def quantized_linear(bits: int, ranges: dict[int, torch.Tensor]):
    """A ``lin`` that rounds each input channel to ``bits`` (symmetric, its
    calibrated range), absorbs those steps into the weights, rounds each
    output channel of the weights to ``bits``, and sums exactly."""
    qmax = float(2 ** (bits - 1) - 1)

    def lin(k, x, w, b):
        s_x = ranges[k] / qmax
        xq = torch.clamp(torch.round(x / s_x), -qmax, qmax)
        ws = w * s_x[None, :]
        s_w = ws.abs().amax(1).clamp_min(1e-12) / qmax
        wq = torch.round(ws / s_w[:, None])
        return (xq.double() @ wq.double().T).float() * s_w + b

    return lin


def frame(weights: dict, cfg: dict, c2w: torch.Tensor, block: int = 32768,
          lin=None) -> torch.Tensor:
    """The [H, W, 3] frame of pose ``c2w``, rendered ``block`` rays at a
    time."""
    pts = frame_points(c2w, cfg["H"], cfg["W"], cfg["focal"],
                       cfg["n_sample"], cfg["near"], cfg["far"])
    rgb = torch.cat([forward(weights, cfg, embed(pts[s:s + block],
                                                 cfg["embed_L"]), lin)
                     for s in range(0, pts.shape[0], block)])
    return rgb.reshape(cfg["H"], cfg["W"], 3)
