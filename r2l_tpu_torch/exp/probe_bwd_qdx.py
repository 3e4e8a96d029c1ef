"""K5 with an int8 dL/dx: can the dx half of the training backward run at
the int8 tensor-core rate?

Port of ``exp/probe_bwd_qdx.py``. ``bwd_group_qdx`` is K5's backward
through a group of blocks on K4's int8 stash, with both dx products in
int8 through the weights the calibration already quantized: for a layer
with int8 weights q (per output column dequant multiplier m, res_scale
folded into block tails) and the gradient g at its output,
  u = g * m;  s = 127 / (max|u| + 1e-30), one scalar per ray tile;
  u_q = clip(round_half_even(u * s), -127, 127);
  dx = (u_q @ q^T in int32) * ((1 / body_inv) / s).
fc2's dx quantizes the raw f32 dh (m holds the res_scale), fc1's the
masked f32 ``dt1r``; dW and db stay bf16 products over the stash, on K5's
own Hopper passes; the ``bf16`` walk it is compared with runs K5 whole.
The tile (512 rays) is a numerical parameter: another tile computes another
function. The hand-written CUDA kernel (``kernels/csrc/r2l_bwd_qdx.cu``)
is K5's Hopper dh walk with both dx products on wgmma s8, reading each
layer's q^T from an image staged once per calibration
(``r2l_train.stage_qdx_weights``, passed as ``staged=``); a tile is one
64-ray warpgroup (64 rays), a block (128), a 2-block cluster (256) or a
4-block cluster (512), whose warps combine their maxima through
distributed shared memory (``tile_members``).

The probe's dequantize is a fault of the reference, computed here as
there (ROADMAP C): the calibration packs w[i, j] ~ q[i, j] m[j] body_inv[i],
so the input gradient needs ``body_inv / s``, and ``(1 / body_inv) / s``
makes dx the true one times the square of the layer's input activation
scale, far below dh. The cosines the driver reports measure that fault,
not int8's error; the times are unaffected.

The driver ``main`` follows ``exp/probe_bwd_qdx.py:194-276`` at its own
size: the canonical bf16 student (W256, 43 blocks), 81,920 random points,
the int8 calibration of 4 poses through a 32x32 ``PointSampler``
(``fold_requant=False``, as the probe calls JAX's default), K4's stash,
dh0 = N(0, 1) * 1e-3, and groups of 4 blocks top-down (10 calls of 4 and
one of 3). It stages each walk's weight image once (``stage_image``,
its ms recorded apart, ``r3_qdx_stage``), and records the cosine of dh and
the smallest cosine of a dW group of the ``qdx`` walk against the ``bf16``
walk (K5), and each walk's ms on its staged image (CUDA events, one
warm-up, the min of 3 calls of 20 walks), beside the card's name and power
limit. JAX's draws (``jax.random.key(0/4/7)``)
cannot be reproduced in torch: the weights, points and dh0 come from torch
generators seeded 0, 4 and 7, so the cosines are those of other random
draws of the same distributions.

``bwd_group_qdx`` runs its plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises, and counts the launch in
``bwd_group_qdx.launches``.

    python -m r2l_tpu_torch.exp.probe_bwd_qdx [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..kernels.r2l_fused import (FusedParamsInt8PE, _check, _dequant, _ptr,
                                  _q8, _raise_on_error,
                                  calibrate_r2l_int8_pe,
                                  stage_int8_train)
from ..kernels.r2l_train import (_group_inputs, _stream, bwd_group,
                                 dw_splits, stage_bwd_weights,
                                 stage_qdx_weights, train_fwd_int8)
from ..models.r2l import R2LConfig, init_r2l
from ..rays import pose_spherical
from ..sampler import PointSampler
from . import _harness

VARIANTS = ("bf16", "qdx")
B = 81920        # rays
TILE = 512       # rays per quantization scale
GB = 4           # blocks per call
DIM_PTS, L = 48, 10
N_WALKS, REPS = 20, 3   # walks per timed call, timed calls
KERNEL_TILES = (64, 128, 256, 512)   # the kernel's tiles (tile_members)
_LAUNCH_OUT_OF_RESOURCES = 701   # cudaErrorLaunchOutOfResources


def _check_tile(n: int, tile: int) -> None:
    if tile <= 0 or n % tile:
        raise ValueError(f"{n} rays are not a whole number of {tile}-ray "
                         "tiles")


def tile_members(n: int, tile: int) -> list[dict]:
    """The kernel's ray tiles over n rays (``csrc/r2l_bwd_qdx.cu``): a block
    of 128 rays is two 64-ray warpgroups, warpgroup w rays [64 w, 64 w +
    64); tile i is warpgroups [G i, G i + G), G = tile / 64, in the cluster
    of blocks [C c, C c + C), C = max(2, tile / 128) (the grid padded to
    whole clusters). -> per tile: 'rays' (first, end), 'warpgroups',
    'blocks', 'cluster' (the cluster's blocks)."""
    if tile not in KERNEL_TILES:
        raise ValueError(f"the kernel takes a tile of {KERNEL_TILES} rays, "
                         f"got {tile}")
    _check_tile(n, tile)
    G, C = tile // 64, max(2, tile // 128)
    out = []
    for i in range(n // tile):
        wgs = list(range(G * i, G * (i + 1)))
        blocks = sorted({w // 2 for w in wgs})
        c = blocks[0] // C
        out.append({"rays": (64 * wgs[0], 64 * wgs[-1] + 64),
                    "warpgroups": wgs, "blocks": blocks,
                    "cluster": list(range(C * c, C * c + C))})
    return out


def _qdx(g: torch.Tensor, m: torch.Tensor, q: torch.Tensor,
         inv: torch.Tensor, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 dx of a layer with int8 weights q [out, in], its dequant
    multiplier m [out] and dequant scale inv [in] (1/body_inv) from the
    gradient g [N, out] at its output: (acc [N/tile, tile, in], the int32
    product in f32, exact; c [N/tile, 1, in] f32, inv / s per tile)."""
    u = (g * m).view(-1, tile, g.shape[1])
    mx = u.abs().amax(dim=(1, 2), keepdim=True) + 1e-30
    s = torch.full_like(mx, 127.0) / mx   # IEEE (127.0 / mx is 127 * (1/mx))
    acc = (_q8(u, s) @ q.double()).float()
    return acc, inv / s


def bwd_group_qdx_ref(body_w: torch.Tensor, body_q: torch.Tensor,
                      body_m: torch.Tensor, stash: torch.Tensor,
                      dh: torch.Tensor, cfg: R2LConfig, b_start: int,
                      b_count: int, tile: int = TILE,
                      body_scale: torch.Tensor | None = None,
                      dts: torch.Tensor | None = None,
                      staged: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``bwd_group_qdx`` (``exp/probe_bwd_qdx.py:96-141``
    written out): shapes and arguments as ``bwd_group_qdx``; ``staged`` is
    not read."""
    if body_scale is None:
        raise ValueError("the qdx probe walks the int8 stash: pass "
                         "body_scale (1/body_inv)")
    n, W = dh.shape
    _check_tile(n, tile)
    cd, nb, rs = body_w.dtype, cfg.num_blocks, cfg.res_scale
    dw = torch.empty((2 * b_count, W, W), dtype=torch.float32,
                     device=dh.device)
    db = torch.empty((2 * b_count, W), dtype=torch.float32, device=dh.device)
    for k in range(b_count - 1, -1, -1):
        b = b_start + k
        l1, l2 = 2 * b, 2 * b + 1
        h_in, t1r, mask = _group_inputs(stash, nb, b, cd, body_scale)
        dt2 = (dh * rs).to(cd)
        dw[2 * k + 1] = dt2.float().T @ t1r.float()
        db[2 * k + 1] = dt2.float().sum(0)
        acc, c = _qdx(dh, body_m[l2], body_q[l2], body_scale[l2], tile)
        g = torch.where(mask, (acc * c).view(n, W), 0.0)
        dt1 = g.to(cd)
        dw[2 * k] = dt1.float().T @ h_in.float()
        db[2 * k] = dt1.float().sum(0)
        acc, c = _qdx(g, body_m[l1], body_q[l1], body_scale[l1], tile)
        # dh + acc * c as one fused multiply-add (XLA's CPU contraction)
        dh = _dequant(acc, c, dh.view(-1, tile, W)).view(n, W)
        if dts is not None:
            dts[2 * k + 1], dts[2 * k] = dt2, dt1
    return dh, dw, db


def bwd_group_qdx(body_w: torch.Tensor, body_q: torch.Tensor,
                  body_m: torch.Tensor, stash: torch.Tensor,
                  dh: torch.Tensor, cfg: R2LConfig, b_start: int,
                  b_count: int, tile: int = TILE,
                  body_scale: torch.Tensor | None = None,
                  dts: torch.Tensor | None = None,
                  staged: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward through blocks [b_start, b_start+b_count) with int8 dx
    products: body_w [2nb, W, W] bf16 (its dtype is the compute dtype; the
    weights enter only through the int8 body_q [2nb, W, W] ``[out, in]``),
    body_m [2nb, W] f32 and body_scale [2nb, W] f32 (1/body_inv) of the
    calibration (``fold_requant=False``), stash [2nb+1, N, W] int8 from
    ``train_fwd_int8(..., stash_q=True)``, dh [N, W] f32 with N a whole
    number of tiles -> (dh [N, W] f32, dW [2b_count, W, W] ``[out, in]``
    f32, db [2b_count, W] f32). ``dts``, optional [2b_count, N, W] bf16,
    receives each layer's output gradient (dt2, dt1), the kernel's scratch.
    ``staged`` is ``stage_qdx_weights(body_q)``, made once per calibration
    by the caller that walks every group; on the card it is required (a
    call without it raises). Deterministic. CPU tensors take the plain
    version; on the card the tile is one of ``KERNEL_TILES``."""
    if dh.device.type == "cpu":
        return bwd_group_qdx_ref(body_w, body_q, body_m, stash, dh, cfg,
                                 b_start, b_count, tile, body_scale, dts)
    from ..kernels import _build
    if body_scale is None:
        raise ValueError("the qdx probe walks the int8 stash: pass "
                         "body_scale (1/body_inv)")
    dev, W, nb, n = dh.device, cfg.netwidth, cfg.num_blocks, dh.shape[0]
    _check_tile(n, tile)
    if tile not in KERNEL_TILES:
        raise ValueError(f"the kernel takes a tile of {KERNEL_TILES} rays, "
                         f"got {tile}")
    if not (0 <= b_start and b_count >= 1 and b_start + b_count <= nb):
        raise ValueError(f"blocks [{b_start}, {b_start + b_count}) outside "
                         f"[0, {nb})")
    f32, bf = torch.float32, torch.bfloat16
    _check(dh, "dh", f32, (n, W), dev)
    for name, t, dt, shape in (
            ("body_w", body_w, bf, (2 * nb, W, W)),
            ("body_q", body_q, torch.int8, (2 * nb, W, W)),
            ("body_m", body_m, f32, (2 * nb, W)),
            ("body_scale", body_scale, f32, (2 * nb, W)),
            ("stash", stash, torch.int8, (2 * nb + 1, n, W))):
        _check(t, name, dt, shape, dev)
    lo, hi = 2 * b_start, 2 * (b_start + b_count)
    if dts is None:
        dts = torch.empty((hi - lo, n, W), dtype=bf, device=dev)
    _check(dts, "dts", bf, (hi - lo, n, W), dev)
    if staged is None:
        raise ValueError("the kernel reads its weights from the "
                         "calibration's image: pass "
                         "staged=stage_qdx_weights(body_q)")
    _check(staged, "staged", torch.uint8, (2 * nb * W * W,), dev)
    m = body_m[lo:hi].contiguous()
    scale = body_scale[lo:hi].contiguous()
    splits = dw_splits(n)
    dbp = torch.empty((splits, hi - lo, W), dtype=f32, device=dev)
    part = torch.empty((splits, hi - lo, W, W), dtype=f32, device=dev)
    dh_out = torch.empty((n, W), dtype=f32, device=dev)
    dw = torch.empty((hi - lo, W, W), dtype=f32, device=dev)
    db = torch.empty((hi - lo, W), dtype=f32, device=dev)
    lib = _build.load("r2l_bwd_qdx")
    with torch.cuda.device(dev):
        bwd_group_qdx.launches += 1
        rc = lib.r2l_bwd_qdx_launch(
            ctypes.c_void_p(staged.data_ptr() + lo * W * W), _ptr(m),
            _ptr(stash[b_start]),
            _ptr(stash[nb + 1 + b_start]), _ptr(scale), _ptr(dh),
            _ptr(dh_out), _ptr(dts), _ptr(dbp), _ptr(part), _ptr(dw),
            _ptr(db), n, W, b_count, float(cfg.res_scale), tile, splits,
            _stream(dev))
    if rc == _LAUNCH_OUT_OF_RESOURCES:
        raise RuntimeError(
            f"r2l_bwd_qdx: a cluster of {max(2, tile // 128)} blocks cannot "
            f"be scheduled at the kernel's shared-memory footprint on "
            f"{torch.cuda.get_device_name(dev)}")
    _raise_on_error(rc, "r2l_bwd_qdx")
    return dh_out, dw, db


bwd_group_qdx.launches = 0


def walk(variant: str, cfg: R2LConfig, body_w: torch.Tensor,
         fp: FusedParamsInt8PE, stash: torch.Tensor, dh0: torch.Tensor,
         gb: int = GB, tile: int = TILE, staged: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The whole top-down group walk (``exp/probe_bwd_qdx.py::walk``): K5
    (``bf16``) or ``bwd_group_qdx`` (``qdx``) on every group of ``gb``
    blocks -> (dh at the body's input, the groups' dW, top group first).
    ``staged``: the variant's weight image (``stage_image``), staged here
    when None."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    body_scale = 1.0 / fp.body_inv
    if staged is None:
        staged = stage_image(variant, body_w, fp)
    dh, dws, b = dh0, [], cfg.num_blocks
    while b > 0:
        cnt = min(gb, b)
        b -= cnt
        if variant == "qdx":
            dh, dw_g, _ = bwd_group_qdx(body_w, fp.body_q, fp.body_m, stash,
                                        dh, cfg, b, cnt, tile=tile,
                                        body_scale=body_scale, staged=staged)
        else:
            dh, dw_g, _ = bwd_group(body_w, stash, dh, cfg, b, cnt,
                                    body_scale=body_scale, staged=staged)
        dws.append(dw_g)
    return dh, dws


def stage_image(variant: str, body_w: torch.Tensor,
                fp: FusedParamsInt8PE) -> torch.Tensor:
    """A variant's weight image, made once per weights: K5's of body_w
    (``bf16``), the probe's of the calibration's body_q (``qdx``)."""
    return (stage_qdx_weights(fp.body_q) if variant == "qdx"
            else stage_bwd_weights(body_w))


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """cos(a, b) of the flattened tensors, in float64."""
    a = a.detach().double().flatten().cpu().numpy()
    b = b.detach().double().flatten().cpu().numpy()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def walk_ops(cfg: R2LConfig, n: int) -> float:
    """Multiply-adds x 2 of one product of a body layer over n rays; a walk
    takes two per layer (dx and dW)."""
    return 2.0 * n * cfg.netwidth * cfg.netwidth


def walk_bound_ms(variant: str, cfg: R2LConfig, n: int,
                  n_blocks: int | None = None) -> float:
    """The least ms ``n_blocks`` blocks' backward (all by default) takes at
    the data-sheet peaks: the dW products in bf16, the dx products in int8
    (``qdx``) or bf16."""
    layers = 2 * (cfg.num_blocks if n_blocks is None else n_blocks)
    ops = layers * walk_ops(cfg, n)
    return (_harness.bound_ms(ops, "bf16")
            + _harness.bound_ms(ops, "int8" if variant == "qdx" else "bf16"))


def setup(device, n: int = B):
    """(cfg, body_w [2nb, W, W] bf16, the int8 calibration, K4's stash, dh0)
    of the driver at ``n`` rays."""
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), device)
    pts = (torch.rand((n, DIM_PTS), generator=torch.Generator().manual_seed(
        4)) * 2.0 - 1.0).to(device)
    sub = PointSampler(H=32, W=32, focal=555.555 / 12.5, n_sample=16,
                       near=2.0, far=6.0)
    calib = torch.cat([sub.sample_test(torch.as_tensor(
        pose_spherical(th, -30.0, 4.0)[:3, :4], dtype=torch.float32,
        device=device)) for th in (0.0, 90.0, 180.0, 270.0)])
    fp = stage_int8_train(calibrate_r2l_int8_pe(
        model, cfg, DIM_PTS, L, calib, fold_requant=False, stage=False),
        cfg, DIM_PTS, L, True)
    _, stash = train_fwd_int8(fp, cfg, pts, DIM_PTS, L, stash_q=True)
    body_w = torch.stack([m.weight.detach() for m in model.linears()[1]]
                         ).to(torch.bfloat16)
    dh0 = torch.randn((n, cfg.netwidth), generator=torch.Generator(
        ).manual_seed(7)).to(device) * 1e-3
    return cfg, body_w, fp, stash, dh0


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m r2l_tpu_torch.exp.probe_bwd_qdx")
    p.add_argument("--out", help="also append the JSON records to this file")
    args = p.parse_args(argv)
    dev = _harness.require_cuda(p.prog)
    log = _harness.Log(args.out)
    recs = [log({**_harness.device_record(), "probe": "bwd_qdx"})]
    cfg, body_w, fp, stash, dh0 = setup(dev)
    n = dh0.shape[0]
    images, stage_ms = {}, {}
    for variant in VARIANTS:   # each image once per weights, timed apart
        stage_image(variant, body_w, fp)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        images[variant] = stage_image(variant, body_w, fp)
        end.record()
        torch.cuda.synchronize()
        stage_ms[variant] = start.elapsed_time(end)
    recs.append(log({"name": "r3_qdx_stage", **{
        f"{v}_ms": stage_ms[v] for v in VARIANTS}}))

    def run(variant):
        return walk(variant, cfg, body_w, fp, stash, dh0, GB, TILE,
                    images[variant])

    dh_b, dws_b = run("bf16")
    dh_q, dws_q = run("qdx")
    recs.append(log({
        "name": "r3_qdx_cosine", "cos_dh": cosine(dh_q, dh_b),
        "min_cos_dw_group": min(cosine(q, b) for q, b in zip(dws_q, dws_b)),
        "tile": TILE, "gb": GB, "rays": n}))
    del dh_b, dws_b, dh_q, dws_q
    for variant in VARIANTS:
        def walks():
            for _ in range(N_WALKS):
                dh, _ = run(variant)
            return dh

        float(walks().sum())
        times = []
        for _ in range(REPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            walks()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / N_WALKS)
        recs.append(log({
            "name": f"r3_qdx_walk_{variant}", "ms": min(times),
            "all_ms": sorted(times), "tile": TILE, "gb": GB, "rays": n,
            "bound_ms": walk_bound_ms(variant, cfg, n)}))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
