"""Port parity: the released-checkpoint harness
(r2l_tpu_torch/tools/verify_released_ckpt.py against
tools/verify_released_ckpt.py) on a synthetic torch ``.tar`` in the
reference's save_ckpt schema and a Blender scene of the model's own
renders, both on the CPU."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_scene import write_png_rgba
from r2l_tpu import checkpoint as jckpt
from r2l_tpu.models.r2l import R2LConfig, init_r2l
from r2l_tpu_torch.tools.verify_released_ckpt import main as torch_main
from tools.verify_released_ckpt import main as jax_main

torch.set_num_threads(2)
L, N_SAMPLE = 10, 4
CFG = R2LConfig(input_dim=N_SAMPLE * 3 * (2 * L + 1), netwidth=64,
                netdepth=6, precision="highest")
# Both harnesses' plain f32 paths on the same frames, f32 sums in other
# orders. The renders are the ground truth up to PNG quantization, ~53 dB:
# an MSE of 5e-6, which a 1e-7 difference in the frames moves by about
# 1e-4 of itself, i.e. 3e-4 dB (measured 3.3e-4); at test_torch_cli.py's
# ~10 dB the same differences read under 1e-4 dB.
TOL_PSNR_DB = 1e-3
# SSIM of the same frames; FLIP's min-max rescale and feature detection
# carry the frames' 1e-7 differences further (measured 1.7e-5).
TOL_SSIM, TOL_FLIP = 1e-5, 1e-4


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """(tar, scene): the .tar of a JAX-initialised student and a scene
    whose test images are its own renders (PNG-quantized)."""
    from r2l_tpu.evaluate import make_r2l_frame_fn
    from r2l_tpu.rays import pose_spherical
    from r2l_tpu.sampler import PointSampler
    base = tmp_path_factory.mktemp("release")
    params = init_r2l(jax.random.key(7), CFG)
    sd = {k: torch.from_numpy(np.array(v, copy=True))
          for k, v in jckpt.params_to_torch_r2l(params, CFG).items()}
    tar = str(base / "lego.tar")
    torch.save({"global_step": 1200000, "best_psnr": 31.87,
                "network_fn_state_dict": sd}, tar)
    H = W = 16
    cax = 0.6911112070083618
    sampler = PointSampler(H=H, W=W, focal=0.5 * W / np.tan(0.5 * cax),
                           n_sample=N_SAMPLE, near=2.0, far=6.0)
    frame_fn = make_r2l_frame_fn(params, CFG, sampler, embed_L=L,
                                 use_pallas=False)
    rng = np.random.default_rng(3)
    scene = str(base / "scene")
    for split, n in (("train", 1), ("val", 1), ("test", 2)):
        os.makedirs(os.path.join(scene, split))
        frames = []
        for k in range(n):
            c2w = pose_spherical(rng.uniform(-180, 180),
                                 rng.uniform(-60, -20), 4.0)
            img = np.asarray(frame_fn(c2w.astype(np.float32)[:3, :4]))
            rgba = np.concatenate([img, np.ones((H, W, 1))], -1)
            write_png_rgba(os.path.join(scene, f"{split}/r_{k}.png"),
                           (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": cax, "frames": frames}, f)
    return tar, scene


def _report(capsys):
    return json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("{")][-1])


def test_xla_path_matches_jax_harness(release, capsys):
    tar, scene = release
    argv = ["--ckpt", tar, "--datadir", scene, "--paths", "xla",
            "--expect_psnr", "45.0", "--platform", "cpu"]
    assert jax_main(argv) == 0
    want = _report(capsys)
    assert torch_main(argv) == 0
    got = _report(capsys)
    assert got["pass"] is True and want["pass"] is True
    for k, tol in (("psnr", TOL_PSNR_DB), ("psnr_v2", TOL_PSNR_DB),
                   ("ssim", TOL_SSIM), ("flip", TOL_FLIP)):
        assert abs(got["results"]["xla"][k] - want["results"]["xla"][k]) \
            <= tol, k
    assert got["results"]["xla"]["lpips"] is None


def test_kernel_paths_run_and_pass(release, capsys):
    """The pallas (K1 bf16) and int8 (K2) paths, their plain versions
    here: the model's own renders at >= 30 dB (PNG quantization, bf16 and
    int8), PASS against the paper bar minus each path's tolerance."""
    tar, scene = release
    assert torch_main(["--ckpt", tar, "--datadir", scene, "--paths",
                       "xla,pallas,int8", "--expect_psnr", "31.87",
                       "--platform", "cpu"]) == 0
    rep = _report(capsys)
    assert [rep["results"][p]["kind"] for p in ("xla", "pallas", "int8")] \
        == ["jnp", "pe", "int8"]
    assert rep["pass"] is True
    assert min(rep["results"][p]["psnr"] for p in rep["results"]) > 30.0


def test_native_msgpack_and_failures(release, tmp_path, capsys):
    tar, scene = release
    params = jckpt.torch_r2l_to_params(
        jckpt.load_torch_tar(tar)["network_fn_state_dict"], CFG)
    native = str(tmp_path / "ckpt.msgpack")
    jckpt.save_checkpoint(native, {"params": params},
                          meta={"global_step": 5})
    base = ["--datadir", scene, "--platform", "cpu"]
    assert torch_main(["--ckpt", native, "--paths", "xla",
                       "--expect_psnr", "45.0"] + base) == 0
    assert torch_main(["--ckpt", tar, "--paths", "xla",
                       "--expect_psnr", "99.0"] + base) == 1
    assert "FAIL" in capsys.readouterr().out
    assert torch_main(["--ckpt", tar, "--paths", "pallas", "--act",
                       "lrelu"] + base) == 1
    assert _report(capsys)["pass"] is False
    with pytest.raises(SystemExit, match="no inference path"):
        torch_main(["--ckpt", tar, "--paths", " , "] + base)
    with pytest.raises(SystemExit, match="all skipped"):
        torch_main(["--ckpt", tar, "--paths", "pallas", "--act", "lrelu",
                    "--expect_psnr", "30.0"] + base)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            torch_main(["--ckpt", tar, "--datadir", scene])
