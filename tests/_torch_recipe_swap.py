"""The verify recipe's teacher (step 2) with the initial weights swapped
between the packages: is a teacher's miss the seed's initial weights, or
the training?

    python tests/_torch_recipe_swap.py --out DIR [--seeds 0 2]

For each seed, each package's teacher at that ``--seed`` is built as its
CLI builds it (``build_teacher``: JAX's ``init_nerf`` from
``jax.random.key(seed)``, the port's from ``torch.Generator().manual_seed
(seed)``) and written as a step-0 teacher checkpoint (the shared msgpack
format). Then each package trains from the OTHER's weights on the CPU
through its own command line at ``tests/_torch_recipe.py``'s teacher flags
(``--N_samples 24 --N_importance 0 --N_iters 2000``, ``--N_rand 256``,
``--teacher_ckpt`` the swapped weights, no ``--resume``: step 0, fresh
Adam, the package's own draws from ``--seed``). The runs go one after
another (each uses every core). Prints a JSON line per run as it ends,
then one with all: each run's TestPSNR and TestPSNRv2 and its wall
seconds. A package that trains the other's weights to the other's
number, and its own seed's miss repeated by the other package, points at
the weights; the reverse at the training."""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)

from _torch_recipe import TEACHER, last  # noqa: E402


class _Quiet:
    def print(self, *a, **k):
        pass


def write_inits(scene: str, seed: int, out: str) -> dict:
    """{'jax': path, 'port': path}: each package's seed-``seed`` teacher
    as a step-0 checkpoint."""
    import r2l_tpu.checkpoint as jckpt
    from r2l_tpu.app import build_teacher as jax_build
    from r2l_tpu.configs import parse_args as jax_args
    from r2l_tpu_torch.app import build_teacher as port_build
    from r2l_tpu_torch.configs import parse_args as port_args
    from r2l_tpu_torch.models.nerf import nerf_params_to_jax
    argv = [*TEACHER, "--dataset_type", "blender", "--datadir", scene,
            "--white_bkgd", "--seed", str(seed)]
    _, _, pc, pf, _ = jax_build(jax_args(argv), _Quiet())
    _, _, mc, mf, _ = port_build(port_args(argv), _Quiet(), "cpu")
    assert pf == {} and mf is None
    paths = {}
    for who, coarse in (("jax", pc), ("port", nerf_params_to_jax(mc))):
        paths[who] = os.path.join(out, f"init_{who}_seed{seed}.msgpack")
        jckpt.save_checkpoint(paths[who], {"coarse": coarse, "fine": {}},
                              meta={"global_step": 0})
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    a = ap.parse_args(argv)
    from _torch_scene import write_scene
    out = os.path.abspath(a.out)
    shutil.rmtree(out, ignore_errors=True)
    scene = write_scene(os.path.join(out, "tinyscene"))
    clis = {"port": os.path.join(REPO, "main_cuda.py"),
            "jax": os.path.join(REPO, "main.py")}
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = {}
    for seed in a.seeds:
        inits = write_inits(scene, seed, out)
        for who, other in (("port", "jax"), ("jax", "port")):
            name = f"{who}_from_{other}_seed{seed}"
            cmd = [sys.executable, clis[who], *TEACHER, "--dataset_type",
                   "blender", "--datadir", scene, "--white_bkgd",
                   "--testskip", "1", "--platform", "cpu", "--seed",
                   str(seed), "--experiments_dir",
                   os.path.join(out, "Experiments"), "--N_rand", "256",
                   "--N_iters", "2000", "--i_print", "500", "--i_testset",
                   "2000", "--i_weights", "2000", "--teacher_ckpt",
                   inits[other], "--experiment_name", name]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                               text=True)
            text = p.stdout + p.stderr
            with open(os.path.join(out, name + ".log"), "w") as f:
                f.write(text)
            if p.returncode != 0:
                sys.stderr.write(text[-3000:])
                raise SystemExit(f"{name} exited {p.returncode}")
            res[name] = {"psnr": float(last(r"TestPSNR ([0-9.]+)", text)),
                         "psnr_v2": float(last(r"TestPSNRv2 ([0-9.]+)",
                                               text)),
                         "wall_s": time.perf_counter() - t0}
            print(json.dumps({name: res[name]}), flush=True)
    print(json.dumps({"swap": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
