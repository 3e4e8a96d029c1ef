"""One rank of tests/test_torch_multihost.py (two gloo processes).

``multihost``: the command line's init (``app.apply_platform`` with
``--multihost --platform cpu --num_cpu_devices 2`` inside a launched rank),
a mesh over both processes, one data-parallel distillation step on JAX's
draws, the batch-checksum contract (agreeing and skewed batches), and a
checkpoint with the hard pool. ``rebuild``: the command line's rays
distillation in which rank 1's loader, rebuilt at ``--i_update_data``,
reads other shards than rank 0's (a per-rank ``--datadir_kd`` drift). Each
rank writes ``<outdir>/r<rank>.json``. Usage:

    python tests/_torch_multihost_worker.py multihost <inputs.npz> <outdir>
    python tests/_torch_multihost_worker.py rebuild <other dir> <outdir> \\
        -- <main_cuda.py flags>
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from r2l_tpu_torch import app  # noqa: E402
from r2l_tpu_torch import checkpoint as ckpt  # noqa: E402
from r2l_tpu_torch import train as TR  # noqa: E402
from r2l_tpu_torch.hardmine import HardDraws  # noqa: E402
from r2l_tpu_torch.models.r2l import R2L, R2LConfig  # noqa: E402
from r2l_tpu_torch.models.r2l import params_from_jax  # noqa: E402
from r2l_tpu_torch.parallel import make_mesh  # noqa: E402
from r2l_tpu_torch.sampler import PointSampler  # noqa: E402

torch.set_num_threads(1)


class _Quiet:
    def print(self, *a, **k):
        pass


def _tree(blob, prefix):
    out: dict = {}
    for k in blob.files:
        if k.startswith(prefix + "/"):
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = blob[k]
    return out


def multihost(inputs: str, outdir: str) -> dict:
    args = SimpleNamespace(platform="cpu", num_cpu_devices=2, multihost=True)
    device = app.apply_platform(args)
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2 and device.type == "cpu"
    blob = np.load(inputs)
    cfg = R2LConfig(input_dim=4 * 3 * 21, netwidth=16, netdepth=4)
    sampler = PointSampler(H=4, W=4, focal=5.0, n_sample=4, near=2.0,
                           far=6.0)
    mesh = make_mesh({"data": 2})
    rec = torch.from_numpy(blob["rec"])

    def model():
        m = R2L(cfg, "cpu")
        with torch.no_grad():
            m.load_state_dict(params_from_jax(_tree(blob, "params"), cfg))
        return m

    dcfg = TR.DistillConfig(batch_size=32, perturb=True)
    state = TR.init_train_state(model(), dcfg, device="cpu")
    step = TR.make_distill_step(cfg, dcfg, sampler, device="cpu", mesh=mesh)
    state, ms = step(state, rec, draws=TR.StepDraws(
        None, torch.from_numpy(blob["z"])))
    out = {"rank": rank, "loss": float(ms["loss"]),
           "psnr": float(ms["psnr"])}

    app.assert_batch_identical(blob["rec"], mesh, _Quiet())
    out["contract_ok"] = True
    try:
        app.assert_batch_identical(blob["rec"] + np.float32(rank), mesh,
                                   _Quiet())
        out["skew_caught"] = False
    except RuntimeError:
        out["skew_caught"] = True

    dcfg2 = TR.DistillConfig(batch_size=32, perturb=True, n_hard_in=8,
                             n_hard_out=8, hard_mul=2.0)
    state2 = TR.init_train_state(model(), dcfg2, device="cpu")
    step2 = TR.make_distill_step(cfg, dcfg2, sampler, device="cpu",
                                 mesh=mesh)
    state2, _ = step2(state2, rec[:24], draws=TR.StepDraws(
        HardDraws(torch.from_numpy(blob["u2"]),
                  torch.from_numpy(blob["perm2"]).long()),
        torch.from_numpy(blob["z2"])))
    path = os.path.join(tempfile.mkdtemp(prefix=f"mhpool{rank}_"),
                        "ck.msgpack")
    ckpt.save(path, state2, 1, 1.0, 1, save_pool=True)
    raw, _ = ckpt.load_checkpoint(path)
    ckpt.drop_cached_checkpoint()
    pool = np.asarray(raw["pool"]["rays"])
    out.update(pool_shape=list(pool.shape), pool_sum=float(pool.sum()),
               pool_meta=[int(raw["pool"]["size"]), int(raw["pool"]["ptr"])])
    dist.destroy_process_group()
    return out


def rebuild(other: str, argv: list[str]) -> dict:
    """The command line with rank 1's rebuilt loader on ``other``."""
    rank = int(os.environ["RANK"])
    made = [0]
    orig = app.RayShardDataset

    def dataset(datadir, *a, **k):
        made[0] += 1
        if rank == 1 and made[0] > 1:
            datadir = other
        return orig(datadir, *a, **k)

    app.RayShardDataset = dataset
    try:
        app.train(app_parse(argv))
    except RuntimeError as e:
        return {"rank": rank, "error": str(e), "loaders": made[0]}
    return {"rank": rank, "error": "", "loaders": made[0]}


def app_parse(argv):
    from r2l_tpu_torch.configs import parse_args
    return parse_args(argv)


def main(argv):
    mode, outdir = argv[0], argv[2]
    if mode == "multihost":
        out = multihost(argv[1], outdir)
    else:
        out = rebuild(argv[1], argv[argv.index("--") + 1:])
    with open(os.path.join(outdir, f"r{out['rank']}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
