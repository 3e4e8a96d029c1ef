"""Hard-example (hard-ray) mining as device state.

Counterpart of ``r2l_tpu/hardmine.py:23-118``. A fixed-size pool of the
highest-MSE rays lives on the device beside the model; each step samples
some of it into the batch and writes the step's hardest fresh rays back:

  * while filling: new hard rays append at a rolling pointer;
  * when full: they overwrite the slots sampled into this batch.

The random draws are explicit (``HardDraws``): passed in (a test hands over
JAX's) or drawn from a ``torch.Generator`` by ``draw_hard``. The pool's rays
are updated in place, which saves a copy of the pool per step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class HardPool(NamedTuple):
    rays: torch.Tensor  # [capacity, record_dim] f32
    size: torch.Tensor  # 0-d int32: number of valid entries
    ptr: torch.Tensor   # 0-d int32: rolling write pointer


class HardDraws(NamedTuple):
    """The draws of one ``sample_hard``: ``stratified`` takes ``u`` [n]
    uniform in [0, 1) and ``perm`` a permutation of range(n); ``permutation``
    takes ``perm`` a permutation of range(capacity) and no ``u``."""
    u: torch.Tensor | None
    perm: torch.Tensor


def init_pool(capacity: int, record_dim: int,
              device: torch.device | str = torch.device("cuda")) -> HardPool:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return HardPool(rays=torch.zeros((capacity, record_dim),
                                     dtype=torch.float32, device=device),
                    size=z, ptr=z.clone())


def draw_hard(n: int, capacity: int, mode: str,
              generator: torch.Generator) -> HardDraws:
    """Fresh draws for ``sample_hard`` from ``generator`` (on its device)."""
    dev = generator.device
    if mode == "stratified":
        return HardDraws(u=torch.rand(n, generator=generator, device=dev),
                         perm=torch.randperm(n, generator=generator,
                                             device=dev))
    if mode == "permutation":
        return HardDraws(u=None, perm=torch.randperm(
            capacity, generator=generator, device=dev))
    raise ValueError(f"unknown hard-sample mode {mode!r}")


def sample_hard(pool: HardPool, n: int, fallback: torch.Tensor,
                mode: str = "stratified",
                draws: HardDraws | None = None,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n`` distinct pool slots; until the pool is full the batch
    keeps ``fallback[:n]`` (the fresh rays) instead. Returns (rays [n, rd],
    idx [n] int64).

    ``stratified``: the capacity is cut into ``n`` contiguous strata and
    one slot is drawn uniformly from each, then the slots are shuffled (so
    that ``update_pool``, which replaces the first n_in sampled slots, does
    not favour low strata). ``permutation``: the first ``n`` of a uniform
    permutation of the pool, the reference's exact uniform subset."""
    capacity = pool.rays.shape[0]
    if draws is None:
        draws = draw_hard(n, capacity, mode, generator)
    dev = pool.rays.device
    if mode == "permutation":
        idx = draws.perm[:n].to(device=dev, dtype=torch.int64)
    elif mode == "stratified":
        base, rem = divmod(capacity, n)
        i = torch.arange(n, dtype=torch.int32, device=dev)
        start = i * base + torch.clamp(i, max=rem)
        size = base + (i < rem).to(torch.int32)
        off = torch.minimum((draws.u.to(dev) * size).to(torch.int32),
                            size - 1)
        idx = (start + off)[draws.perm.to(dev)].to(torch.int64)
    else:
        raise ValueError(f"unknown hard-sample mode {mode!r}")
    rays = torch.where(pool.size >= capacity, pool.rays[idx], fallback[:n])
    return rays, idx


def update_pool(pool: HardPool, hard_rays: torch.Tensor,
                sampled_idx: torch.Tensor) -> HardPool:
    """Insert this step's hardest rays [n_in, rd]; ``sampled_idx`` [n_out]
    are the slots used this batch. Writes ``pool.rays`` in place."""
    capacity = pool.rays.shape[0]
    n_in = hard_rays.shape[0]
    dev = pool.rays.device
    rolling = ((pool.ptr + torch.arange(n_in, dtype=torch.int32,
                                        device=dev)) % capacity)
    reps = -(-n_in // max(sampled_idx.shape[0], 1))
    replace = sampled_idx.to(torch.int32).repeat(reps)[:n_in]
    full = pool.size >= capacity
    target = torch.where(full, replace, rolling).to(torch.int64)
    pool.rays[target] = hard_rays
    size = torch.clamp(pool.size + torch.where(full, 0, n_in),
                       max=capacity).to(torch.int32)
    ptr = torch.where(full, pool.ptr, (pool.ptr + n_in) % capacity)
    return HardPool(rays=pool.rays, size=size, ptr=ptr.to(torch.int32))


def parse_hard_ratio(hard_ratio, batch_size: int) -> tuple[int, int]:
    """Reference semantics: a scalar gives the same in/out count; an
    'in,out' pair distinct counts, the inserted count clamped to the
    sampled one (so each inserted ray replaces a distinct slot)."""
    if hard_ratio in (None, "", 0):
        return 0, 0
    if isinstance(hard_ratio, str):
        parts = [float(x) for x in hard_ratio.split(",")]
    elif isinstance(hard_ratio, (list, tuple)):
        parts = [float(x) for x in hard_ratio]
    else:
        parts = [float(hard_ratio)]
    if len(parts) == 1:
        n = int(parts[0] * batch_size)
        return n, n
    n_in = int(parts[0] * batch_size)
    n_out = int(parts[1] * batch_size)
    return min(n_in, n_out), n_out
