"""The sharded paths on a one-rank process group (gloo here; one NCCL rank
on the card in tests/test_torch_cuda.py and chip_smoke.py's phase 18).

A mesh backed by a process group takes the sharded path at any world size
(``r2l_tpu_torch.parallel.sharded``): the rows are split and gathered, the
gradients, losses and parameters go through ``all_reduce``, ``all_gather``
and ``broadcast``, each over one rank. Every case checks that those
collectives were issued, and that the result is bit for bit the same call
without a mesh (a collective over one rank copies; a rank's share of the
global mean is 1.0)."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_mesh import counted_collectives
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.datagen import DataGenConfig, generate_pseudo_data
from r2l_tpu_torch.evaluate import make_nerf_frame_fn, make_r2l_frame_fn
from r2l_tpu_torch.models import R2LConfig, init_r2l
from r2l_tpu_torch.models.nerf import NeRFConfig, init_nerf
from r2l_tpu_torch.parallel import (broadcast_value, make_mesh, replicate_,
                                    sharded)
from r2l_tpu_torch.rays import pose_spherical
from r2l_tpu_torch.render import VolRenderConfig
from r2l_tpu_torch.sampler import PointSampler

@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """mesh data:1, model:1 over a one-rank gloo group in this process."""
    rdv = tmp_path_factory.mktemp("rank1") / "rdv"
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        yield make_mesh({"data": 1, "model": 1})
    finally:
        dist.destroy_process_group()


def _student(seed=0, **kw):
    cfg = R2LConfig(**kw)
    return cfg, init_r2l(cfg, torch.Generator().manual_seed(seed), "cpu")


def _distill(mesh):
    cfg, m = _student(input_dim=6 * 21, netwidth=32, netdepth=4)
    dcfg = TR.DistillConfig(batch_size=128, n_hard_in=8, n_hard_out=16,
                            hard_mul=2.0, embed_L=10)
    sampler = PointSampler(H=8, W=8, focal=8.0, n_sample=2, near=2.0,
                           far=6.0)
    state = TR.init_train_state(m, dcfg, device="cpu")
    step = TR.make_distill_step(cfg, dcfg, sampler, device="cpu", mesh=mesh)
    fresh = np.random.default_rng(1).normal(size=(112, 9)).astype(
        np.float32)
    g = torch.Generator().manual_seed(3)
    losses = []
    for _ in range(2):
        state, ms = step(state, fresh, generator=g)
        losses.append(ms["loss"])
    return [*losses, *state.params.parameters(), *state.pool]


def _images(mesh):
    cfg, m = _student(input_dim=2 * 3 * 21, netwidth=32, netdepth=4)
    dcfg = TR.DistillConfig(batch_size=64, n_hard_in=4, n_hard_out=8,
                            hard_mul=2.0, embed_L=10)
    sampler = PointSampler(H=8, W=8, focal=8.0, n_sample=2, near=2.0,
                           far=6.0)
    state = TR.init_train_state(m, dcfg, device="cpu")
    step = TR.make_distill_step_images(cfg, dcfg, sampler, 8, 8, 8.0,
                                       device="cpu", mesh=mesh)
    image = np.random.default_rng(2).uniform(size=(8, 8, 3)).astype(
        np.float32)
    g = torch.Generator().manual_seed(4)
    losses = []
    for _ in range(2):
        state, ms = step(state, image, torch.eye(4)[:3, :4], generator=g)
        losses.append(ms["loss"])
    return [*losses, *state.params.parameters(), *state.pool]


def _teacher(mesh):
    ncfg = NeRFConfig(D=2, W=16, skips=(), use_viewdirs=False, input_ch=63,
                      input_ch_views=0)
    mc = init_nerf(ncfg, torch.Generator().manual_seed(0), "cpu")
    vcfg = VolRenderConfig(n_coarse=4, n_fine=0, use_viewdirs=False)
    tcfg = TR.TeacherTrainConfig(n_rand=64)
    state = TR.init_teacher_state(mc, None, tcfg)
    step = TR.make_teacher_step_batched(ncfg, vcfg, tcfg, device="cpu",
                                        mesh=mesh)
    pool = torch.from_numpy(np.random.default_rng(0).normal(
        size=(256, 9)).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    losses = []
    for i in range(2):
        state, ms = step(state, pool, 64 * i, generator=g)
        losses.append(ms["loss"])
    return [*losses, *state.model_c.parameters()]


def _student_frame(mesh):
    cfg, m = _student(input_dim=12 * 21, netwidth=64, netdepth=4)
    sampler = PointSampler(H=12, W=12, focal=16.0, n_sample=4, near=2.0,
                           far=6.0)
    c2w = pose_spherical(30.0, -40.0, 4.0)[:3, :4].astype(np.float32)
    return [make_r2l_frame_fn(m, cfg, sampler, mesh=mesh, **kw)(c2w)
            for kw in ({"use_pallas": False}, {},
                       {"quantize": "int8", "calib_poses": c2w[None]})]


def _teacher_frame(mesh):
    ncfg = NeRFConfig(D=2, W=16, skips=(), use_viewdirs=True, input_ch=63,
                      input_ch_views=27, output_ch=5)
    mc = init_nerf(ncfg, torch.Generator().manual_seed(1), "cpu")
    mf = init_nerf(ncfg, torch.Generator().manual_seed(2), "cpu")
    vcfg = VolRenderConfig(n_coarse=6, n_fine=4, use_viewdirs=True,
                           white_bkgd=True, multires=10, multires_views=4,
                           ray_chunk=64)
    sampler = PointSampler(H=10, W=10, focal=14.0, n_sample=6, near=2.0,
                           far=6.0)
    c2w = pose_spherical(45.0, -35.0, 4.0)[:3, :4].astype(np.float32)
    return [make_nerf_frame_fn(mc, mf, ncfg, vcfg, sampler, device="cpu",
                               mesh=mesh)(c2w)]


def _datagen(mesh, tmp):
    ncfg = NeRFConfig(D=2, W=16, skips=(), use_viewdirs=False, input_ch=63,
                      input_ch_views=0)
    mc = init_nerf(ncfg, torch.Generator().manual_seed(0), "cpu")
    vcfg = VolRenderConfig(n_coarse=4, n_fine=0, perturb=False,
                           use_viewdirs=False, white_bkgd=True,
                           ray_chunk=512)
    gcfg = DataGenConfig(n_pose=2, H=8, W=8, focal=10.0, save_every=2,
                         shard_size=1 << 12, poses_per_batch=2)
    out = os.path.join(tmp, "mesh" if mesh is not None else "single")
    total = generate_pseudo_data(mc, None, ncfg, vcfg, gcfg, out,
                                 device="cpu", mesh=mesh)
    files = sorted(os.listdir(out))
    return [torch.tensor(total)] + [torch.from_numpy(np.load(
        os.path.join(out, f))) for f in files]


def _replicate(mesh):
    _, m = _student(seed=7, input_dim=12, netwidth=16, netdepth=2)
    if mesh is not None:
        replicate_(m, mesh)
    return [*m.parameters(), torch.tensor(broadcast_value(21.123456789,
                                                          mesh))]


PATHS = {"distill_rays": (_distill, "all_reduce", "all_gather"),
         "distill_images": (_images, "all_reduce", "all_gather"),
         "teacher_batched": (_teacher, "all_reduce"),
         "student_frame": (_student_frame, "all_gather"),
         "teacher_frame": (_teacher_frame, "all_gather"),
         "datagen": (_datagen, "all_gather"),
         "replicate_broadcast": (_replicate, "broadcast")}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_rank_group_runs_collectives_bit_for_bit(mesh, path, tmp_path):
    fn, *issued = PATHS[path]
    kw = {"tmp": str(tmp_path)} if path == "datagen" else {}
    assert sharded(mesh) and not sharded(None)
    with counted_collectives() as calls:
        want = fn(None, **kw)
    assert not calls, (path, dict(calls))      # no mesh: no collective
    with counted_collectives() as calls:
        got = fn(mesh, **kw)
    for name in issued:
        assert calls[name] > 0, (path, name, dict(calls))
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a, b), (path, i)

