"""One rank of the port's multi-process CPU tests (gloo).

Started by ``tests/_torch_mesh.py``'s ``run_ranks`` as N processes of one
group (``r2l_tpu_torch.parallel.spawn_ranks``: a file rendezvous, no TCP
port). Usage:

    python tests/_torch_mesh_worker.py <inputs.npz> <outdir> <case> [...]

Each case reads its numpy inputs (JAX's parameters and draws, written by
the test) from ``inputs.npz`` under ``<case>/``, runs the port's
multi-device function, and writes ``<outdir>/<case>_r<rank>.npz``; an error
is written to ``<case>_r<rank>.err`` and the rank goes on with the next
case. Imports neither JAX nor an image package."""
from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch.distributed as dist  # noqa: E402

from r2l_tpu_torch.models.nerf import (NeRF, NeRFConfig,  # noqa: E402
                                       nerf_params_from_jax,
                                       nerf_params_to_jax)
from r2l_tpu_torch.models.r2l import (R2L, R2LConfig,  # noqa: E402
                                      params_from_jax, params_to_jax)
from r2l_tpu_torch.parallel import (apply_r2l_tp, gather_rows,  # noqa
                                    make_mesh, r2l_param_shardings,
                                    shard_rows, sync_grads)
from r2l_tpu_torch.parallel.dist import init_distributed  # noqa: E402
from r2l_tpu_torch.hardmine import HardDraws  # noqa: E402
from r2l_tpu_torch.render import ChunkDraws, VolRenderConfig  # noqa: E402
from r2l_tpu_torch.sampler import PointSampler  # noqa: E402
from r2l_tpu_torch import train as TR  # noqa: E402

torch.set_num_threads(1)


class Inputs:
    """The arrays of one case: ``inp['x']`` reads ``<case>/x``."""

    def __init__(self, blob, case):
        self.blob, self.case = blob, case

    def __getitem__(self, k):
        return self.blob[f"{self.case}/{k}"]

    def tree(self, prefix):
        """A nested dict of the arrays under ``<case>/<prefix>/``."""
        out: dict = {}
        head = f"{self.case}/{prefix}/"
        for k in self.blob.files:
            if k.startswith(head):
                d = out
                parts = k[len(head):].split("/")
                for p in parts[:-1]:
                    d = d.setdefault(p, {})
                d[parts[-1]] = self.blob[k]
        return listify(out)

    def t(self, k):
        return torch.from_numpy(np.array(self[k]))


def listify(node):
    """Dicts keyed 0..n-1 back into lists (JAX trees hold lists)."""
    if not isinstance(node, dict):
        return node
    node = {k: listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def flat(tree, prefix=""):
    """A nested dict/list of arrays as {'a/0/b': array}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def r2l(inp, cfg_kw):
    cfg = R2LConfig(**cfg_kw)
    m = R2L(cfg, "cpu")
    with torch.no_grad():
        m.load_state_dict(params_from_jax(inp.tree("params"), cfg))
    return cfg, m


def grads_tree(model, cfg):
    """The gradients in the JAX parameter layout."""
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.grad.detach().clone()
    return params_to_jax(model, cfg)


def step_draws(inp, i, hard=True, perturb=True):
    h = (HardDraws(inp.t(f"u{i}"), inp.t(f"perm{i}").long())
         if hard else None)
    return TR.StepDraws(h, inp.t(f"z{i}") if perturb else None)


def state_out(state, cfg, losses):
    out = flat(params_to_jax(state.params, cfg), "params/")
    out["loss"] = np.asarray(losses, np.float64)
    out["pool_rays"] = state.pool.rays.numpy()
    out["pool_meta"] = np.array([int(state.pool.size), int(state.pool.ptr)])
    return out


# ---------------------------------------------------------------- cases

def case_mesh(inp, n):
    m = make_mesh()
    m2 = make_mesh({"data": n // 2, "model": 2})
    m3 = make_mesh({"data": -1, "model": 2})
    return {"world": np.array([dist.get_world_size(), dist.get_rank()]),
            "backend": np.array([dist.get_backend() == "gloo"]),
            "shape1": np.array([m.size("data"), m.size("model")]),
            "shape2": np.array([m2.size("data"), m2.size("model")]),
            "coords2": np.array([m2.index("data"), m2.index("model")]),
            "shape3": np.array([m3.size("data"), m3.size("model")])}


def case_dp_fwd(inp, n):
    cfg, m = r2l(inp, dict(input_dim=24, netwidth=32, netdepth=6))
    mesh = make_mesh()
    x = inp.t("x")
    with torch.no_grad():
        out = gather_rows(m(shard_rows(x, mesh)), mesh, x.shape[0])
    return {"out": out.numpy()}


def case_tp_fwd(inp, n):
    cfg, m = r2l(inp, dict(input_dim=24, netwidth=32, netdepth=6))
    mesh = make_mesh({"data": n // 2, "model": 2})
    roles = r2l_param_shardings(mesh, m)
    x = inp.t("x")
    with torch.no_grad():
        out = gather_rows(apply_r2l_tp(m, shard_rows(x, mesh), mesh), mesh,
                          x.shape[0])
    return {"out": out.numpy(),
            "roles": np.array([roles["body.0.body.0.weight"] == "column",
                               roles["body.0.body.2.weight"] == "row",
                               roles["head.0.weight"] == "column",
                               roles["tail.0.weight"] is None])}


def case_dp_grads(inp, n):
    cfg, m = r2l(inp, dict(input_dim=12, netwidth=16, netdepth=4))
    mesh = make_mesh()
    x, y = inp.t("x"), inp.t("y")
    loss = torch.sum((m(shard_rows(x, mesh)) - shard_rows(y, mesh)) ** 2
                     ) / y.numel()
    loss.backward()
    sync_grads(m, mesh)
    return flat(grads_tree(m, cfg), "grads/")


def case_batch_shards(inp, n):
    mesh = make_mesh()
    x = torch.arange(16.0).reshape(16, 1)
    return {"local": shard_rows(x, mesh).numpy(),
            "back": gather_rows(shard_rows(x, mesh), mesh, 16).numpy()}


def _distill_setup(inp, n_hard):
    cfg, m = r2l(inp, dict(input_dim=6 * 21, netwidth=32, netdepth=4))
    dcfg = TR.DistillConfig(batch_size=128, n_hard_in=8 if n_hard else 0,
                            n_hard_out=n_hard, hard_mul=2.0, embed_L=10)
    sampler = PointSampler(H=8, W=8, focal=8.0, n_sample=2, near=2.0,
                           far=6.0)
    return cfg, m, dcfg, sampler


def _both(run):
    """``run(mesh)`` with the mesh and with None (this process alone): the
    sharded outputs, and the one-process ones under ``single/``."""
    out = run(True)
    out.update({f"single/{k}": v for k, v in run(False).items()})
    return out


def case_distill_dptp(inp, n):
    def run(sharded):
        cfg, m, dcfg, sampler = _distill_setup(inp, 16)
        mesh = make_mesh({"data": n // 2, "model": 2}) if sharded else None
        state = TR.init_train_state(m, dcfg, device="cpu")
        step = TR.make_distill_step(cfg, dcfg, sampler, device="cpu",
                                    mesh=mesh)
        losses = []
        for i in range(2):
            state, ms = step(state, inp.t("fresh"), draws=step_draws(inp, i))
            losses.append(float(ms["loss"]))
        return state_out(state, cfg, losses)
    return _both(run)


def case_distill_dp(inp, n):
    def run(sharded):
        cfg, m, dcfg, sampler = _distill_setup(inp, 0)
        state = TR.init_train_state(m, dcfg, device="cpu")
        step = TR.make_distill_step(cfg, dcfg, sampler, device="cpu",
                                    mesh=make_mesh() if sharded else None)
        state, ms = step(state, inp.t("fresh"),
                         draws=step_draws(inp, 0, hard=False))
        return state_out(state, cfg, [float(ms["loss"])])
    return _both(run)


def case_scan(inp, n):
    def run(sharded):
        cfg, m, dcfg, sampler = _distill_setup(inp, 16)
        mesh = make_mesh({"data": n // 2, "model": 2}) if sharded else None
        state = TR.init_train_state(m, dcfg, device="cpu")
        scan2 = TR.make_distill_step(cfg, dcfg, sampler, scan_steps=2,
                                     device="cpu", mesh=mesh)
        state, ms = scan2(state, inp.t("batches"),
                          draws=[step_draws(inp, i) for i in range(2)])
        return state_out(state, cfg, ms["loss"].tolist())
    return _both(run)


def case_images(inp, n):
    def run(sharded):
        cfg, m = r2l(inp, dict(input_dim=2 * 3 * 21, netwidth=32,
                               netdepth=4))
        dcfg = TR.DistillConfig(batch_size=64, n_hard_in=4, n_hard_out=8,
                                hard_mul=2.0, embed_L=10)
        sampler = PointSampler(H=8, W=8, focal=8.0, n_sample=2, near=2.0,
                               far=6.0)
        state = TR.init_train_state(m, dcfg, device="cpu")
        step = TR.make_distill_step_images(
            cfg, dcfg, sampler, 8, 8, 8.0, device="cpu",
            mesh=make_mesh() if sharded else None)
        losses = []
        for i in range(3):
            draws = TR.ImageStepDraws(inp.t(f"upix{i}"), step_draws(inp, i))
            state, ms = step(state, inp.t("image"), torch.eye(4)[:3, :4],
                             draws=draws)
            losses.append(float(ms["loss"]))
        return state_out(state, cfg, losses)
    return _both(run)


def _nerf(inp, prefix, cfg):
    mdl = NeRF(cfg, device="cpu")
    with torch.no_grad():
        mdl.load_state_dict(nerf_params_from_jax(inp.tree(prefix)))
    return mdl


def case_teacher(inp, n):
    def run(sharded):
        cfg = NeRFConfig(D=2, W=16, skips=(), use_viewdirs=False,
                         input_ch=63, input_ch_views=0)
        mc = _nerf(inp, "pc", cfg)
        vcfg = VolRenderConfig(n_coarse=4, n_fine=0, use_viewdirs=False)
        tcfg = TR.TeacherTrainConfig(n_rand=64)
        state = TR.init_teacher_state(mc, None, tcfg)
        step = TR.make_teacher_step_batched(
            cfg, vcfg, tcfg, device="cpu",
            mesh=make_mesh() if sharded else None)
        losses = []
        for i in range(2):
            d = TR.TeacherStepDraws(None, None, ChunkDraws(
                u_strat=inp.t(f"ustrat{i}")))
            state, ms = step(state, inp.t("pool"), 64 * i, draws=d)
            losses.append(float(ms["loss"]))
        out = flat(nerf_params_to_jax(state.model_c), "pc/")
        out["loss"] = np.asarray(losses)
        return out
    return _both(run)


def case_student_frame(inp, n):
    from r2l_tpu_torch.evaluate import make_r2l_frame_fn
    cfg, m = r2l(inp, dict(input_dim=12 * 21, netwidth=128, netdepth=6))
    sampler = PointSampler(H=16, W=16, focal=20.0, n_sample=4, near=2.0,
                           far=6.0)
    mesh = make_mesh()
    c2w = inp["c2w"]
    out = {}
    for kind, kw in (("jnp", dict(use_pallas=False)),
                     ("pe", dict(use_pallas=True)),
                     ("int8", dict(use_pallas=True, quantize="int8",
                                   calib_poses=c2w[None]))):
        single = make_r2l_frame_fn(m, cfg, sampler, embed_L=10, **kw)(c2w)
        shard = make_r2l_frame_fn(m, cfg, sampler, embed_L=10, mesh=mesh,
                                  **kw)(c2w)
        out[f"{kind}_single"] = single.numpy()
        out[f"{kind}_sharded"] = shard.numpy()
    return out


def case_teacher_frame(inp, n):
    from r2l_tpu_torch.evaluate import make_nerf_frame_fn
    cfg = NeRFConfig(D=3, W=32, skips=(1,), use_viewdirs=True, input_ch=63,
                     input_ch_views=27, output_ch=5)
    mc, mf = _nerf(inp, "pc", cfg), _nerf(inp, "pf", cfg)
    vcfg = VolRenderConfig(n_coarse=6, n_fine=4, use_viewdirs=True,
                           white_bkgd=True, multires=10, multires_views=4,
                           ray_chunk=64)
    sampler = PointSampler(H=12, W=12, focal=16.0, n_sample=6, near=2.0,
                           far=6.0)
    c2w = inp["c2w"]
    single = make_nerf_frame_fn(mc, mf, cfg, vcfg, sampler, device="cpu")
    shard = make_nerf_frame_fn(mc, mf, cfg, vcfg, sampler, device="cpu",
                               mesh=make_mesh())
    return {"single": single(c2w).numpy(), "sharded": shard(c2w).numpy()}


def case_datagen(inp, n):
    from r2l_tpu_torch.datagen import DataGenConfig, generate_pseudo_data
    cfg = NeRFConfig(D=2, W=16, skips=(), use_viewdirs=False, input_ch=63,
                     input_ch_views=0)
    mc = _nerf(inp, "pc", cfg)
    vcfg = VolRenderConfig(n_coarse=4, n_fine=0, perturb=False,
                           use_viewdirs=False, white_bkgd=True,
                           ray_chunk=512)
    gcfg = DataGenConfig(n_pose=2, H=8, W=8, focal=10.0, save_every=2,
                         shard_size=1 << 12, poses_per_batch=2)
    outdir = str(inp["outdir"])
    total = generate_pseudo_data(mc, None, cfg, vcfg, gcfg, outdir,
                                 device="cpu", mesh=make_mesh())
    return {"total": np.array([total]),
            "files": np.array(sorted(os.listdir(outdir))
                              if os.path.isdir(outdir) else [])}


CASES = {k[5:]: v for k, v in dict(globals()).items()
         if k.startswith("case_")}


def main(argv):
    inputs, outdir, cases = argv[0], argv[1], argv[2:]
    init_distributed("cpu")
    rank, n = dist.get_rank(), dist.get_world_size()
    blob = np.load(inputs)
    for case in cases:
        stem = os.path.join(outdir, f"{case}_r{rank}")
        try:
            out = CASES[case](Inputs(blob, case), n)
            np.savez(stem + ".npz", **out)
        except Exception:
            with open(stem + ".err", "w") as f:
                f.write(traceback.format_exc())
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
