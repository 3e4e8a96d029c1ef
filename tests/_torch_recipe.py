"""The verify skill's real-content recipe (steps 2-9) through the port's
command line, at the recipe's lengths, on the checked-in ``gen_scene.py``
scene (32x32 sphere, seed 0, 6 train / 1 val / 3 test; written here by
``tests/_torch_scene.py``, the same formula and draws).

    python tests/_torch_recipe.py --out DIR [--platform cpu] [--seed S]

Runs ``main_cuda.py`` and ``python -m r2l_tpu_torch.tools.create_data`` as
a user does: the teacher at ``--N_samples 24 --N_importance 0 --N_iters
2000``; ``create_data rand`` of 12 poses with ``--test_teacher``;
``convert_rays``; rays distillation at ``--N_iters 500 --pseudo_ratio -1``;
``--render_only`` from ckpt_best (f32 weights' frames through K1 on the
card; its PSNR must equal the training eval); ``--convert_to_onnx``; the
spiral pseudo images and images-mode distillation at ``--N_iters 500
--precrop_iters 50``; ``--quantize int8`` (K2) and ``--benchmark``. Prints
one JSON line with every PSNR, the wall seconds of each step and the
device (with ``nvidia-smi``'s name and power limit on the card); exits
non-zero if a step fails or the render differs from the eval. Imports
neither JAX nor an image package."""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)

STUDENT = ("--model_name R2L --n_sample_per_ray 8 --netwidth 64 "
           "--netdepth 12 --use_residual --trial.ON --trial.body_arch "
           "resmlp --compute_dtype bfloat16").split()
TEACHER = ("--model_name nerf --N_samples 24 --N_importance 0 "
           "--use_viewdirs --chunk 1024").split()


def run(cmd: list, log: str) -> tuple[str, float]:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable] + cmd, cwd=REPO, capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    with open(log, "w") as f:
        f.write(p.stdout + p.stderr)
    if p.returncode != 0:
        sys.stderr.write(p.stdout[-3000:] + p.stderr[-3000:])
        raise SystemExit(f"{' '.join(cmd[:4])} exited {p.returncode}")
    return p.stdout, wall


def last(pattern: str, text: str) -> str:
    got = re.findall(pattern, text)
    if not got:
        raise SystemExit(f"no {pattern!r} in the output")
    return got[-1]


def weights(exps: str, name: str, file: str) -> str:
    for d in sorted(os.listdir(exps)):
        p = os.path.join(exps, d, "weights", file)
        if d.startswith(name + "-") and os.path.exists(p):
            return p
    raise SystemExit(f"no {file} of {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--platform", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    from _torch_scene import write_scene
    out = os.path.abspath(a.out)
    shutil.rmtree(out, ignore_errors=True)
    scene = write_scene(os.path.join(out, "tinyscene"))
    exps, logs = os.path.join(out, "Experiments"), os.path.join(out, "logs")
    os.makedirs(logs)
    base = ["--dataset_type", "blender", "--datadir", scene, "--white_bkgd",
            "--testskip", "1", "--platform", a.platform, "--seed",
            str(a.seed), "--experiments_dir", exps]
    main_py = os.path.join(REPO, "main_cuda.py")
    cd = ["-m", "r2l_tpu_torch.tools.create_data"]
    res: dict = {"platform": a.platform, "seed": a.seed}
    if a.platform != "cpu":
        import torch
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        res["device"] = f"{torch.cuda.get_device_name(0)} | {smi}"
    walls = res.setdefault("wall_s", {})

    def step(name, cmd):
        text, walls[name] = run(cmd, os.path.join(logs, name + ".log"))
        return text

    # 2. teacher
    t = step("teacher", [main_py, *base, *TEACHER, "--N_rand", "256",
                         "--N_iters", "2000", "--i_print", "500",
                         "--i_testset", "2000", "--i_weights", "2000",
                         "--experiment_name", "t"])
    res["teacher_psnr"] = float(last(r"TestPSNR ([0-9.]+)", t))
    res["teacher_psnr_v2"] = float(last(r"TestPSNRv2 ([0-9.]+)", t))
    teacher = weights(exps, "t", "teacher.msgpack")
    # 3. pseudo data, 4. the real rays
    pseudo = os.path.join(out, "pseudo")
    t = step("create_data_rand", cd + [
        *base, *TEACHER, "--teacher_ckpt", teacher, "--create_data", "rand",
        "--n_pose_kd", "12", "--test_teacher", "--datadir_kd", pseudo,
        "--experiment_name", "cd"])
    res["test_teacher_psnr"] = float(last(r"teacher test PSNR ([0-9.]+)", t))
    step("convert_rays", cd + [*base, *TEACHER, "--teacher_ckpt", teacher,
                               "--create_data", "convert_rays",
                               "--datadir_kd", pseudo,
                               "--experiment_name", "cr"])
    # 5. rays distillation
    t = step("distill", [main_py, *base, *STUDENT, "--data_mode", "rays",
                         "--datadir_kd", pseudo, "--N_rand", "2048",
                         "--N_iters", "500", "--i_print", "100",
                         "--i_testset", "500", "--hard_ratio", "0.1,0.2",
                         "--hard_mul", "4", "--warmup_lr", "0.0001,50",
                         "--pseudo_ratio", "-1", "--experiment_name", "d"])
    for k, pat in (("psnr", r"\[TEST\].* TestPSNR ([0-9.]+)"),
                   ("psnr_v2", r"TestPSNRv2 ([0-9.]+)"),
                   ("ssim", r"TestSSIM ([0-9.]+)")):
        res[f"distill_{k}"] = float(last(pat, t))
    ckpt = weights(exps, "d", "ckpt_best.msgpack")
    # 6. render from the checkpoint, 9. int8 and the benchmark
    ro = [main_py, *base, *STUDENT, "--render_only", "--render_test",
          "--pretrained_ckpt", ckpt]
    t = step("render_only", ro + ["--experiment_name", "ro"])
    res["render_psnr"] = float(last(r"render_only: PSNR ([0-9.]+)", t))
    res["render_equals_eval"] = res["render_psnr"] == res["distill_psnr"]
    t = step("render_int8", ro + ["--quantize", "int8", "--pallas_tile",
                                  "512", "--experiment_name", "ro8"])
    res["render_int8_psnr"] = float(last(r"render_only: PSNR ([0-9.]+)", t))
    t = step("benchmark", [main_py, *base, *STUDENT, "--benchmark",
                           "--pretrained_ckpt", ckpt, "--experiment_name",
                           "bm"])
    res["benchmark_ms_per_frame"] = float(last(
        r"benchmark: ([0-9.]+) ms/frame", t))
    # 7. export
    step("export", [main_py, *base, *STUDENT, "--convert_to_onnx",
                    "--pretrained_ckpt", ckpt, "--experiment_name", "ex"])
    # 8. images mode on spiral pseudo images
    pimg = os.path.join(out, "pimg")
    step("create_data_spiral", cd + [
        *base, *TEACHER, "--teacher_ckpt", teacher, "--create_data",
        "spiral_evenly_spaced", "--n_pose_kd", "9", "--datadir_kd", pimg,
        "--experiment_name", "cs"])
    t = step("images_distill", [main_py, *base, *STUDENT, "--data_mode",
                                "images", "--datadir_kd", pimg, "--N_rand",
                                "512", "--precrop_iters", "50",
                                "--pseudo_ratio", "0.5", "--N_iters", "500",
                                "--i_print", "100", "--i_testset", "500",
                                "--experiment_name", "im"])
    res["images_psnr"] = float(last(r"\[TEST\].* TestPSNR ([0-9.]+)", t))
    res["images_psnr_v2"] = float(last(r"TestPSNRv2 ([0-9.]+)", t))
    res["pseudo_img_ratio"] = float(last(r"pseudo_img_ratio ([0-9.]+)", t))
    print(json.dumps({"recipe": res}), flush=True)
    return 0 if res["render_equals_eval"] else 1


if __name__ == "__main__":
    sys.exit(main())
