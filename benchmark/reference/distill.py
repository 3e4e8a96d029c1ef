"""R2L distillation steps, plain (snap-research/R2L ``main.py``: rays mode
with hard-ray mining): a batch of fresh rays plus rays from the hard pool,
16 stratified points a ray, the positional encoding, the ResMLP
(``reference.r2l.forward``), the mean of the per-ray colour MSE, autograd,
Adam (betas 0.9, 0.999, eps 1e-8, bias-corrected) at the warm-up and decay
schedule's rate, then the hardest fresh rays written to the pool. float32,
TF32 off unless the caller's ``matmul_precision`` says otherwise. The
draws (the pool's strata and shuffle, the depth jitter) are the
benchmark's, handed to the program too.
"""
from __future__ import annotations

import numpy as np
import torch

from . import r2l


def learning_rate(step: int, lrate: float, decay: int, warmup: str) -> float:
    """The rate of update ``step`` (0 first): linear from the warm-up's
    start to ``lrate`` over its steps, then lrate * 0.1^(step / (decay *
    1000)), in float32."""
    f = np.float32
    w0, w1 = (float(warmup.split(",")[0]), int(warmup.split(",")[1])) \
        if warmup else (0.0, 0)
    s = f(step)
    if w1 > 0 and s < w1:
        return float(f(w0) + f(lrate - w0) * s / f(w1))
    return float(f(lrate) * np.power(f(0.1), s / f(decay * 1000.0)))


def stratified(near: float, far: float, n: int, u: torch.Tensor
               ) -> torch.Tensor:
    """[rays, n] depths jittered in their bins by ``u``."""
    t = torch.arange(n, dtype=torch.float32, device=u.device) / (n - 1)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]])
    lower = torch.cat([z[:1], mids])
    return lower + (upper - lower) * u


def hard_slots(capacity: int, u: torch.Tensor, perm: torch.Tensor
               ) -> torch.Tensor:
    """One slot drawn from each of n contiguous strata of the pool, then
    shuffled."""
    n = u.shape[0]
    base, rem = divmod(capacity, n)
    i = torch.arange(n, device=u.device)
    start = i * base + torch.clamp(i, max=rem)
    size = base + (i < rem).long()
    off = torch.minimum((u * size).long(), size - 1)
    return (start + off)[perm.long()]


class Pool:
    def __init__(self, capacity: int, dim: int, device):
        self.rays = torch.zeros((capacity, dim), device=device)
        self.size = 0
        self.ptr = 0
        self.written = None     # the slots of the last insert

    def sample(self, n: int, fallback: torch.Tensor, u, perm):
        idx = hard_slots(self.rays.shape[0], u, perm)
        full = self.size >= self.rays.shape[0]
        return (self.rays[idx] if full else fallback[:n]), idx

    def insert(self, hard: torch.Tensor, sampled: torch.Tensor) -> None:
        cap, n = self.rays.shape[0], hard.shape[0]
        if self.size >= cap:
            target = sampled.repeat(-(-n // sampled.shape[0]))[:n]
        else:
            target = (self.ptr + torch.arange(n, device=hard.device)) % cap
            self.size = min(self.size + n, cap)
            self.ptr = (self.ptr + n) % cap
        self.rays[target] = hard
        self.written = target


def loss(weights: dict, cfg: dict, batch: torch.Tensor, z_u: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, per-ray MSE) of the student on records [n, 9]."""
    o, d, rgb = batch[:, 0:3], batch[:, 3:6], batch[:, 6:9]
    z = stratified(cfg["near"], cfg["far"], cfg["n_sample"], z_u)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(
        batch.shape[0], -1)
    pred = r2l.forward(weights, cfg, r2l.embed(pts, cfg["embed_L"]))
    per_ray = ((pred - rgb) ** 2).mean(-1)
    return per_ray.mean(), per_ray


class Trainer:
    """The reference's training state: float32 leaves keyed by state_dict
    name, Adam's moments, the hard pool."""

    def __init__(self, weights: dict, cfg: dict, traffic: dict, device):
        self.cfg, self.t = cfg, traffic
        self.w = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.v = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.count = 0
        cap = int(traffic["batch_rays"] * traffic["hard_mul"])
        self.pool = Pool(cap, 9, device)

    @classmethod
    def resume(cls, snap: dict, cfg: dict, traffic: dict, device
               ) -> "Trainer":
        """A trainer from a copy of a state: ``w``, ``m``, ``v`` (by leaf),
        ``count`` (updates made), ``pool``, ``size``, ``ptr``."""
        tr = cls(snap["w"], cfg, traffic, device)
        tr.m = {k: v.detach().float().clone() for k, v in snap["m"].items()}
        tr.v = {k: v.detach().float().clone() for k, v in snap["v"].items()}
        tr.count = int(snap["count"])
        tr.pool.rays = snap["pool"].detach().float().clone()
        tr.pool.size, tr.pool.ptr = int(snap["size"]), int(snap["ptr"])
        return tr

    def step(self, fresh: torch.Tensor, u: torch.Tensor, perm: torch.Tensor,
             z_u: torch.Tensor) -> tuple[float, dict]:
        """One update; returns (loss, the gradient of each leaf)."""
        t = self.t
        n_hard = int(t["hard_ratio"] * t["batch_rays"])
        hard, idx = self.pool.sample(n_hard, fresh, u, perm)
        batch = torch.cat([fresh, hard])
        value, per_ray = loss(self.w, self.cfg, batch, z_u)
        grads = torch.autograd.grad(value, list(self.w.values()))
        lr = learning_rate(self.count, t["lrate"], t["lrate_decay"],
                           t["warmup_lr"])
        self.count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        with torch.no_grad():
            for (k, p), g in zip(self.w.items(), grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.count)
                v_hat = self.v[k] / (1 - b2 ** self.count)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
                out[k] = g
            top = torch.topk(per_ray[:fresh.shape[0]], n_hard).indices
            self.pool.insert(batch[top], idx)
        return float(value.detach()), out


def leaf_gaps(got: dict, want: dict, keep: list[str]) -> float:
    """The worst leaf's gap of norms: |‖got‖ - ‖want‖| over the larger of
    ‖want‖ and the median leaf's ‖want‖, over the leaves ``keep``."""
    norms = {k: float(want[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(float(got[k].double().norm()) - norms[k])
               / max(norms[k], med) for k in keep)


def mined_off(got: torch.Tensor, want: torch.Tensor, n: int) -> float:
    """The largest share, over the steps' blocks of ``n`` mined rows, of
    the reference's rows that the program did not mine (rows compared
    whole, bit for bit)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape:
        return 1.0
    worst = 0.0
    for s in range(0, w.shape[0], n):
        a = {r.tobytes() for r in g[s:s + n]}
        b = {r.tobytes() for r in w[s:s + n]}
        worst = max(worst, 1.0 - len(a & b) / len(b))
    return worst
