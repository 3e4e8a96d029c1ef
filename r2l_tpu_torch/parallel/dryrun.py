"""The sharded training step on n ranks, start to end: the counterpart of
``dryrun_multichip`` (``__graft_entry__.py:67-100``).

``dryrun_multichip(n)`` starts n ranks (gloo on the host; NCCL where n
CUDA cards are visible and ``platform`` is not ``cpu``) on a dp x tp mesh,
tp = 2 when n >= 4 and even, at the JAX dry run's shapes (W128, D6, 256
rays, 32 hard in/out). Each rank runs the rays distillation step, two
steps in one call, the images-mode step, the batched teacher step and a
datagen frame (its rays split over ``data``), and holds the distillation
step against the same step on one process (loss rtol 1e-5, parameters
rtol 1e-4 / atol 1e-6, the JAX sharding tests' bounds). Rank 0 prints
``DRYRUN_OK``.

    python -m r2l_tpu_torch.parallel.dryrun --n 4 [--platform cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TOL_LOSS = 1e-5
TOL_PARAM = (1e-4, 1e-6)


def _rank_main(n: int, platform: str) -> None:
    import torch.distributed as dist

    from ..models.nerf import NeRFConfig, init_nerf
    from ..models.r2l import R2LConfig, init_r2l
    from ..render import VolRenderConfig
    from ..sampler import PointSampler
    from ..train import (DistillConfig, TeacherTrainConfig,
                         clone_train_state, init_teacher_state,
                         init_train_state, make_distill_step,
                         make_distill_step_images, make_teacher_step_batched)
    from .dist import init_distributed
    from .mesh import make_mesh
    rank, world = init_distributed(platform)
    assert world == n, (world, n)
    device = (torch.device("cpu") if platform == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh({"data": n // tp, "model": tp})

    cfg = R2LConfig(input_dim=8 * 3 * 21, netwidth=128, netdepth=6)
    dcfg = DistillConfig(batch_size=256, n_hard_in=32, n_hard_out=32,
                         hard_mul=2.0, embed_L=10)
    sampler = PointSampler(H=8, W=8, focal=10.0, n_sample=8, near=2.0,
                           far=6.0)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), device)
    state = init_train_state(model, dcfg, device=device)
    single = clone_train_state(state)
    fresh = torch.rand((dcfg.batch_size - dcfg.n_hard_out, 9),
                       generator=torch.Generator().manual_seed(2))
    step = make_distill_step(cfg, dcfg, sampler, device=device, mesh=mesh)
    step1 = make_distill_step(cfg, dcfg, sampler, device=device)
    for i in range(2):
        g = torch.Generator(device).manual_seed(3 + i)
        g1 = torch.Generator(device).manual_seed(3 + i)
        state, m = step(state, fresh.to(device), generator=g)
        single, m1 = step1(single, fresh.to(device), generator=g1)
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                                   rtol=TOL_LOSS)
    for a, b in zip(state.params.parameters(), single.params.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().cpu().numpy(),
                                   rtol=TOL_PARAM[0], atol=TOL_PARAM[1])
    torch.testing.assert_close(state.pool.rays, single.pool.rays)

    scan2 = make_distill_step(cfg, dcfg, sampler, scan_steps=2,
                              device=device, mesh=mesh)
    batches = torch.rand((2,) + tuple(fresh.shape),
                         generator=torch.Generator().manual_seed(8))
    state, ms = scan2(state, batches.to(device),
                      generator=torch.Generator(device).manual_seed(9))
    assert ms["loss"].shape == (2,) and bool(torch.isfinite(ms["loss"]).all())

    istate = init_train_state(init_r2l(cfg, torch.Generator().manual_seed(10),
                                       device), dcfg, device=device)
    istep = make_distill_step_images(cfg, dcfg, sampler, 8, 8, 10.0,
                                     device=device, mesh=mesh)
    image = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(12))
    istate, im = istep(istate, image.to(device),
                       torch.eye(4)[:3, :4].to(device),
                       generator=torch.Generator(device).manual_seed(13))
    assert torch.isfinite(im["loss"]), "non-finite images-mode loss"

    ncfg = NeRFConfig(D=2, W=32, skips=(), use_viewdirs=False, input_ch=63,
                      input_ch_views=3)
    mc = init_nerf(ncfg, torch.Generator().manual_seed(4), device)
    vcfg = VolRenderConfig(n_coarse=4, n_fine=0, use_viewdirs=False,
                           ray_chunk=128)
    tcfg = TeacherTrainConfig(n_rand=64)
    tstate = init_teacher_state(mc, None, tcfg)
    tstep = make_teacher_step_batched(ncfg, vcfg, tcfg, device=device,
                                      mesh=mesh)
    pool = torch.rand((512, 9), generator=torch.Generator().manual_seed(5))
    tstate, tm = tstep(tstate, pool.to(device), 0,
                       generator=torch.Generator(device).manual_seed(6))
    assert torch.isfinite(tm["loss"]), "non-finite teacher loss"

    from ..evaluate import make_nerf_frame_fn
    from ..rays import pose_spherical
    frame = make_nerf_frame_fn(mc, None, ncfg, vcfg, sampler, device=device,
                               mesh=mesh)(pose_spherical(30.0, -30.0, 4.0))
    assert frame.shape == (8, 8, 3) and bool(torch.isfinite(frame).all())
    if rank == 0:
        print(f"DRYRUN_OK n={n} mesh={mesh.shape} backend="
              f"{dist.get_backend()} loss={float(m['loss']):.8f} "
              f"teacher_loss={float(tm['loss']):.8f}", flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n: int, platform: str | None = None,
                     timeout: float = 600.0) -> int:
    """Start n ranks running the dry run; their worst exit code. The ranks
    are gloo processes on the host unless n CUDA cards are visible (and
    ``platform`` is not ``'cpu'``)."""
    from .dist import python_entry, spawn_ranks
    if platform is None:
        platform = ("cuda" if torch.cuda.is_available()
                    and torch.cuda.device_count() >= n else "cpu")
    return spawn_ranks(python_entry("r2l_tpu_torch.parallel.dryrun")
                       + ["--n", str(n), "--platform", platform, "--rank"],
                       n, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--platform", default=None, choices=("cpu", "cuda"))
    ap.add_argument("--rank", action="store_true",
                    help="run as one launched rank (set by the launcher)")
    a = ap.parse_args(argv)
    if a.rank:
        _rank_main(a.n, a.platform)
        return 0
    return dryrun_multichip(a.n, a.platform)


if __name__ == "__main__":
    sys.exit(main())
