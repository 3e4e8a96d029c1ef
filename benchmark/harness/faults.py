"""Faults planted in the program's timed path, underneath the harness: each
patches one function of the program for the duration of a ``with`` block,
so that a run can be seen to come out not correct (the tests on the CPU;
``control.py --fault`` on the card, for the readings a training cell's
limits are held against). One set a kind of traffic."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(module, name: str, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def view_half_left_out():
    """Each frame's second half of rays never rendered (left at 0)."""
    import r2l_tpu_torch.evaluate as E

    def make(old):
        def half(mesh, fn, arrays, fills):
            x = arrays[0]
            n = x.shape[0] // 2
            out = fn(x[:n])
            return torch.cat([out, out.new_zeros((x.shape[0] - n,
                                                  *out.shape[1:]))])
        return half
    return _patched(E, "_shard_rays", make)


def view_altered(kernel: str):
    """A tile of 512 rays of every frame shifted by 0.25 where the frame's
    kernel (``kernel``: the wrapper's name) produces it."""
    import r2l_tpu_torch.evaluate as E

    def make(old):
        def altered(*a, **k):
            out = old(*a, **k)
            out[:512] += 0.25
            return out
        return altered
    return _patched(E, kernel, make)


def datagen_half_left_out():
    """Half of each unit's records never written."""
    import r2l_tpu_torch.datagen as D

    def make(old):
        def half(datadir, rays, **k):
            return old(datadir, rays[: rays.shape[0] // 2], **k)
        return half
    return _patched(D, "write_ray_shards", make)


def datagen_altered(renderer: str):
    """Every colour shifted by 0.05 where the render (``renderer``: the
    fused or the plain one) produces it."""
    import r2l_tpu_torch.datagen as D

    def make(old):
        def altered(*a, **k):
            out = old(*a, **k)
            out["rgb"] = out["rgb"] + 0.05
            return out
        return altered
    return _patched(D, renderer, make)


def datagen_rays_moved():
    """Every ray's origin moved by 0.01 where the poses' rays are made."""
    import r2l_tpu_torch.datagen as D

    def make(old):
        def moved(*a, **k):
            ro, rd = old(*a, **k)
            return ro + np.float32(0.01), rd
        return moved
    return _patched(D, "_pose_rays", make)


def distill_half_batch():
    """The loss taken over the first half of each step's batch only."""
    import r2l_tpu_torch.train as T

    def make(old):
        def half(model, cfg, dcfg, sampler, batch, z_u, fused_apply=None):
            n = batch.shape[0] // 2
            return old(model, cfg, dcfg, sampler, batch[:n],
                       None if z_u is None else z_u[:n], fused_apply)
        return half
    return _patched(T, "distill_loss_fn", make)


def distill_unchanged():
    """Each step returns its state unchanged: no update is applied."""
    import r2l_tpu_torch.train as T

    def make(old):
        def frozen(state, *a, **k):
            before = [p.detach().clone() for p in state.params.parameters()]
            new, metrics = old(state, *a, **k)
            with torch.no_grad():
                for p, b in zip(new.params.parameters(), before):
                    p.copy_(b)
            return new, metrics
        return frozen
    return _patched(T, "_distill_core", make)


def distill_pool_slots():
    """The pool's slots drawn wrong: each stratum's first slot, whatever
    the draw (the gather and the write both at the wrong slots)."""
    import r2l_tpu_torch.train as T
    from r2l_tpu_torch.hardmine import HardDraws

    def make(old):
        def first(pool, n, fallback, mode="stratified", draws=None,
                  generator=None):
            if draws is not None and draws.u is not None:
                draws = HardDraws(torch.zeros_like(draws.u), draws.perm)
            return old(pool, n, fallback, mode, draws, generator)
        return first
    return _patched(T, "sample_hard", make)


def distill_pool_unread():
    """The full pool never read: the batch keeps the fresh rays in the
    hard rays' place (the slots, and so the pool's writes, unchanged).
    Only a reading (``control.py --fault``): it moves the pool-full step's
    loss 5-8x over bf16's spread there, which no compared number holds."""
    import r2l_tpu_torch.train as T

    def make(old):
        def unread(pool, n, fallback, *a, **k):
            _, idx = old(pool, n, fallback, *a, **k)
            return fallback[:n], idx
        return unread
    return _patched(T, "sample_hard", make)


FAULTS = {
    "view_half_left_out": view_half_left_out,
    "view_altered_int8": lambda: view_altered("fused_r2l_apply_int8_pe"),
    "view_altered_pe": lambda: view_altered("fused_r2l_apply_pe"),
    "datagen_half_left_out": datagen_half_left_out,
    "datagen_altered_fused": lambda: datagen_altered(
        "render_frame_nerf_fused"),
    "datagen_altered_plain": lambda: datagen_altered("render_frame_nerf"),
    "datagen_rays_moved": datagen_rays_moved,
    "distill_half_batch": distill_half_batch,
    "distill_unchanged": distill_unchanged,
    "distill_pool_slots": distill_pool_slots,
    "distill_pool_unread": distill_pool_unread,
}
