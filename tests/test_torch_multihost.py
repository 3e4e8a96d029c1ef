"""Two processes through the port's command-line init (the counterpart of
tests/test_multihost.py and tests/multihost_worker.py), the two-rank CLI
against one process, and the batch checksum after a loader rebuild.

The ranks are gloo processes started by ``r2l_tpu_torch.parallel``'s
launcher (a file rendezvous: no TCP port), joined with a timeout and killed
on expiry. The two-process loss is held to JAX's one-process step at
rtol 2e-5 (tests/test_multihost.py's bound), the CLI's two-rank run to the
one-process run at the same bound."""
import glob
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_mesh import flat
from _torch_parity import jax_step_draws, np_tree
from _torch_scene import write_scene
from r2l_tpu.models.r2l import R2LConfig, init_r2l
from r2l_tpu.sampler import PointSampler
from r2l_tpu.train import DistillConfig, init_train_state, make_distill_step
from r2l_tpu_torch.data.rayshards import write_ray_shards
from r2l_tpu_torch.parallel.dist import spawn_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOL_LOSS = 2e-5
TIMEOUT_S = 240
STUDENT = ("--model_name R2L --n_sample_per_ray 8 --netwidth 64 "
           "--netdepth 12 --use_residual --trial.ON --trial.body_arch "
           "resmlp").split()


def _jax_case():
    """JAX's one-process step (tests/test_multihost.py's configuration) and
    the port's inputs: its parameters, records and draws."""
    cfg = R2LConfig(input_dim=4 * 3 * 21, netwidth=16, netdepth=4)
    sampler = PointSampler(H=4, W=4, focal=5.0, n_sample=4, near=2.0,
                           far=6.0)
    params = init_r2l(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    rec = np.concatenate([np.zeros((32, 3), np.float32),
                          rng.normal(size=(32, 3)).astype(np.float32),
                          rng.uniform(0, 1, (32, 3)).astype(np.float32)], 1)
    inp = dict(flat(np_tree(params), "params"), rec=rec)
    dcfg = DistillConfig(batch_size=32, perturb=True)
    state, tx = init_train_state(jax.random.key(0), params, dcfg)
    key = jax.random.key(1)
    inp["z"] = jax_step_draws(key, dcfg, 4).z_u.numpy()
    _, ms = make_distill_step(cfg, dcfg, sampler, tx)(state, rec, key)
    dcfg2 = DistillConfig(batch_size=32, perturb=True, n_hard_in=8,
                          n_hard_out=8, hard_mul=2.0)
    d2 = jax_step_draws(key, dcfg2, 4)
    inp.update(u2=d2.hard.u.numpy(), perm2=d2.hard.perm.numpy(),
               z2=d2.z_u.numpy())
    state2, tx2 = init_train_state(jax.random.key(0), params, dcfg2)
    state2, _ = make_distill_step(cfg, dcfg2, sampler, tx2)(
        state2, rec[:24], key)
    return inp, float(ms["loss"]), np.asarray(state2.pool.rays)


def _ranks(mode, args, tmp, n=2):
    out = str(tmp / "out")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, os.path.join(HERE, "_torch_multihost_worker.py"),
           mode, args[0], out] + list(args[1:])
    rc = spawn_ranks(cmd, n, timeout=TIMEOUT_S)
    res = []
    for r in range(n):
        p = os.path.join(out, f"r{r}.json")
        assert os.path.exists(p), f"rank {r} wrote nothing (exit {rc})"
        with open(p) as f:
            res.append(json.load(f))
    return rc, res


def test_two_process_multihost_distill_step(tmp_path):
    """Both processes compute the same global loss, JAX's one-process
    step's; identical batches pass the checksum and a per-rank skew is
    caught; the hard pool each rank saves is the whole pool, JAX's."""
    inp, want, pool = _jax_case()
    inputs = str(tmp_path / "in.npz")
    np.savez(inputs, **inp)
    rc, res = _ranks("multihost", [inputs], tmp_path)
    assert rc == 0
    assert [r["rank"] for r in res] == [0, 1]
    assert res[0]["loss"] == res[1]["loss"]
    np.testing.assert_allclose(res[0]["loss"], want, rtol=TOL_LOSS)
    for r in res:
        assert r["contract_ok"] and r["skew_caught"]
        assert r["pool_shape"] == [64, 9]
        assert r["pool_sum"] == res[0]["pool_sum"]
        np.testing.assert_allclose(r["pool_sum"], float(pool.sum()),
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """A 32x32 scene and two ray-shard dirs of random records."""
    d = tmp_path_factory.mktemp("cli")
    scene = write_scene(str(d / "scene"))
    for name, seed in (("rays", 0), ("other", 1)):
        rng = np.random.default_rng(seed)
        rec = np.concatenate([rng.normal(size=(4096, 3)) * 0.1 + [0, 0, 4],
                              rng.normal(size=(4096, 3)),
                              rng.uniform(size=(4096, 3))], 1)
        write_ray_shards(str(d / name), rec.astype(np.float32),
                         shard_size=2048, rng=rng)
    return d, scene


def _cli(argv, n=1, timeout=TIMEOUT_S):
    cmd = [sys.executable, os.path.join(REPO, "main_cuda.py")] + argv
    if n > 1:
        cmd += ["--num_cpu_devices", str(n), "--mesh", f"data:{n}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=REPO)
    return p.returncode, p.stdout + p.stderr


def _train_argv(d, scene, name, extra=()):
    return (["--dataset_type", "blender", "--datadir", scene, "--white_bkgd",
             "--testskip", "1", "--platform", "cpu", "--experiments_dir",
             str(d / "exp"), "--experiment_name", name] + STUDENT
            + ["--data_mode", "rays", "--datadir_kd", str(d / "rays"),
               "--N_rand", "1024", "--N_iters", "20", "--i_print", "10",
               "--i_testset", "20", "--hard_ratio", "0.1,0.2", "--hard_mul",
               "4"] + list(extra))


def test_cli_two_ranks_match_one_process(cli_scene):
    """main_cuda.py --num_cpu_devices 2 --mesh data:2 (two gloo ranks): the
    [TRAIN] losses and the [TEST] PSNR of the one-process run; rank 0 alone
    logs and writes the checkpoints."""
    d, scene = cli_scene
    rc1, log1 = _cli(_train_argv(d, scene, "one"))
    rc2, log2 = _cli(_train_argv(d, scene, "two"), n=2)
    assert rc1 == 0 and rc2 == 0, log2[-3000:]
    assert "mesh: {'data': 2} over 2 processes (gloo)" in log2
    assert "batch checksums agree across 2 ranks" in log2

    def nums(log, pat):
        return [float(x) for x in re.findall(pat, log)]

    for pat in (r"\[TRAIN\].* loss ([0-9.]+)", r"TestPSNR ([0-9.]+)"):
        a, b = nums(log1, pat), nums(log2, pat)
        assert len(a) == len(b) > 0, (pat, a, b)
        np.testing.assert_allclose(b, a, rtol=TOL_LOSS)
    assert log2.count("[TEST]") == 1      # one console: rank 0's
    (run,) = glob.glob(str(d / "exp" / "two-*"))
    assert os.path.exists(os.path.join(run, "weights", "ckpt_best.msgpack"))
    assert not glob.glob(os.path.join(run, "OtherRanks", "*", "weights",
                                      "*.msgpack"))


def test_batch_checksum_after_loader_rebuild(cli_scene, tmp_path):
    """The ranks' data contract is checked again after --i_update_data
    rebuilds the loader: rank 1's rebuilt loader reading other shards
    stops both ranks with the contract error, after the first step's check
    passed; with the same shards the run ends normally."""
    d, scene = cli_scene
    argv = _train_argv(d, scene, "rb", ["--i_update_data", "10",
                                        "--num_cpu_devices", "2"])
    rc, res = _ranks("rebuild", [str(d / "other"), "--"] + argv, tmp_path)
    for r in res:
        assert r["loaders"] == 2
        assert "data contract violated" in r["error"], r
    rc, res = _ranks("rebuild", [str(d / "rays"), "--"] + argv,
                     tmp_path / "same")
    assert rc == 0 and all(r["error"] == "" for r in res), res
