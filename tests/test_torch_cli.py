"""The port's command line on the CPU (``--platform cpu``), against the JAX
package's: ``main_cuda.py``'s ``app.train`` and
``r2l_tpu_torch.tools.create_data`` on a 32x32 synthetic scene, a W64/D12
student and a small teacher."""
import glob
import importlib.util
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import r2l_tpu.app as japp
import r2l_tpu.checkpoint as jckpt
import r2l_tpu.configs as JC
from _torch_scene import write_scene
from r2l_tpu.logging_ import Logger as JLogger
from r2l_tpu_torch import app
from r2l_tpu_torch import checkpoint as ckpt
from r2l_tpu_torch.configs import parse_args
from r2l_tpu_torch.evaluate import make_r2l_frame_fn
from r2l_tpu_torch.render import render_frame_nerf
from r2l_tpu_torch.tools import create_data as tcd

torch.set_num_threads(2)   # tier-1 runs six workers on eight cores
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Per-frame PSNR of the two CLIs' --render_only at f32 (the kernels' plain
# versions here, XLA there): f32 sums in other orders.
TOL_PSNR_DB = 1e-4
# A checkpoint written by the port, rendered by JAX and by the port on the
# plain paths (f32 sums in other orders).
TOL_FRAME = 1e-5
# The teachers' rgb (test_torch_datagen.py's bound).
TOL_RGB = 1e-5

STUDENT = ("--model_name R2L --n_sample_per_ray 8 --netwidth 64 "
           "--netdepth 12 --use_residual --trial.ON --trial.body_arch "
           "resmlp").split()
TEACHER = ("--model_name nerf --netdepth 3 --netwidth 32 --netdepth_fine 3 "
           "--netwidth_fine 32 --skips 1 --N_samples 6 --N_importance 4 "
           "--multires 4 --multires_views 2 --use_viewdirs --chunk 256"
           ).split()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("scene")))


def _common(scene, exps, name):
    return ["--dataset_type", "blender", "--datadir", scene, "--white_bkgd",
            "--testskip", "1", "--platform", "cpu", "--experiments_dir",
            str(exps), "--experiment_name", name]


def _log(exps, name) -> str:
    (path,) = glob.glob(os.path.join(str(exps), f"{name}-*", "log",
                                     "log.txt"))
    with open(path) as f:
        return f.read()


def _weights(exps, name, file):
    (path,) = glob.glob(os.path.join(str(exps), f"{name}-*", "weights",
                                     file))
    return path


def _losses(text):
    return [float(x) for x in re.findall(r"\[TRAIN\].* loss ([0-9.]+)",
                                         text)]


@pytest.fixture(scope="module")
def jax_teacher(scene, tmp_path_factory):
    """A teacher written by the JAX package (its own init), with the
    TEACHER flags."""
    d = tmp_path_factory.mktemp("jteacher")
    args = JC.parse_args(_common(scene, d, "jt") + TEACHER)
    _, _, pc, pf, _ = japp.build_teacher(args, JLogger(
        experiment_name="jt", experiments_dir=str(d)))
    path = str(d / "teacher.msgpack")
    jckpt.save_checkpoint(path, {"coarse": pc, "fine": pf})
    return path


@pytest.fixture(scope="module")
def pseudo(scene, jax_teacher, tmp_path_factory):
    """rand shards and spiral pseudo images, by the port's create_data."""
    d = tmp_path_factory.mktemp("pseudo")
    for mode, n in (("rand", "4"), ("spiral_evenly_spaced", "3")):
        assert tcd.main(_common(scene, d, "cd") + TEACHER + [
            "--teacher_ckpt", jax_teacher, "--create_data", mode,
            "--n_pose_kd", n, "--datadir_kd", str(d / mode)]) == 0
    return d


def _jax_render_only(argv):
    args = JC.parse_args(argv)
    logger = JLogger(experiment_name=args.experiment_name,
                     experiments_dir=args.experiments_dir, args=args)
    ns = japp.load_dataset(args, logger)
    return japp.run_render_only(args, ns, logger)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_render_only_matches_jax_cli(scene, tmp_path, compute_dtype):
    """--render_only --render_test of a JAX-written student checkpoint
    through both CLIs: the same frames' PSNR (f32: within TOL_PSNR_DB per
    frame; bf16: K1 bf16's plain version against JAX's, within 0.05 dB)."""
    argv = _common(scene, tmp_path, "r") + STUDENT + [
        "--compute_dtype", compute_dtype]
    jargs = JC.parse_args(argv)
    jcfg = JC.args_to_r2l_config(jargs)
    params = japp.init_r2l(jax.random.key(7), jcfg)
    path = str(tmp_path / "student.msgpack")
    jckpt.save_checkpoint(path, {"params": params})
    argv += ["--render_only", "--render_test", "--pretrained_ckpt", path]
    want = _jax_render_only(argv)
    got = app.train(parse_args(argv))
    assert got.frames.shape == want.frames.shape == (3, 32, 32, 3)
    tol = TOL_PSNR_DB if compute_dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.per_frame_psnr, want.per_frame_psnr,
                               rtol=0, atol=tol)
    assert abs(got.test_psnr - want.test_psnr) <= tol


def test_create_data_rand_matches_jax_entry(scene, jax_teacher, tmp_path,
                                            monkeypatch):
    """create_data --create_data rand --perturb 0 from the JAX-written
    teacher through both entries: the same shard names and rows; rays bit
    for bit, rgb within TOL_RGB."""
    spec = importlib.util.spec_from_file_location(
        "jax_create_data", os.path.join(REPO, "tools", "create_data.py"))
    jcd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcd)
    argv = _common(scene, tmp_path, "cd") + TEACHER + [
        "--teacher_ckpt", jax_teacher, "--create_data", "rand",
        "--perturb", "0", "--n_pose_kd", "3", "--create_data_chunk", "2",
        "--poses_per_batch", "1"]
    monkeypatch.setattr(sys, "argv", ["create_data.py"] + argv + [
        "--datadir_kd", str(tmp_path / "jax")])
    jcd.main()
    assert tcd.main(argv + ["--datadir_kd", str(tmp_path / "torch")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert names == ["pseudo_000000.npy", "pseudo_000001.npy"]
    for n in names:
        a, b = np.load(tmp_path / "jax" / n), np.load(tmp_path / "torch" / n)
        assert a.shape == b.shape
        np.testing.assert_array_equal(b[:, :6], a[:, :6])
        np.testing.assert_allclose(b[:, 6:], a[:, 6:], rtol=0, atol=TOL_RGB)


def _jax_frame(path, argv, pose):
    """The JAX package's plain frame of a port-written checkpoint."""
    from r2l_tpu.evaluate import make_r2l_frame_fn as jframe
    from r2l_tpu.sampler import PointSampler as JSampler
    jargs = JC.parse_args(argv)
    jcfg = JC.args_to_r2l_config(jargs)
    tmpl = japp.init_r2l(jax.random.key(0), jcfg)
    params, _ = jckpt.load_params(path, tmpl)
    jckpt.drop_cached_checkpoint()
    s = JSampler(H=32, W=32, focal=44.44444, n_sample=8, near=2.0, far=6.0)
    return np.asarray(jframe(params, jcfg, s, use_pallas=False)(
        jax.numpy.asarray(pose)))


@pytest.mark.parametrize("kind", ["plain", "fused"])
def test_rays_distill(scene, pseudo, tmp_path, kind):
    """Rays-mode distillation through the CLI: the loss falls; ckpt_best
    loads into r2l_tpu.checkpoint and JAX renders what the port renders;
    --render_only from it reproduces the training-time eval exactly."""
    flags = list(STUDENT)
    if kind == "fused":   # the fused step (K3/K5's plain versions here)
        flags[flags.index("64")] = "128"
        flags += ["--fused_train_vjp"]
    argv = _common(scene, tmp_path, "d") + flags + [
        "--data_mode", "rays", "--datadir_kd", str(pseudo / "rand"),
        "--N_rand", "1024", "--N_iters", "30", "--i_print", "10",
        "--i_testset", "30", "--hard_ratio", "0.1,0.2", "--hard_mul", "4"]
    state, best = app.train(parse_args(argv))
    text = _log(tmp_path, "d")
    assert ("fused (K3 + K5)" if kind == "fused" else "plain autograd") \
        in text
    losses = _losses(text)
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    path = _weights(tmp_path, "d", "ckpt_best.msgpack")
    pose = np.asarray(app.load_dataset(parse_args(argv), _Quiet()).poses[7])
    want = _jax_frame(path, argv, pose)
    cfg = app.args_to_r2l_config(parse_args(argv))
    s = app.PointSampler(H=32, W=32, focal=44.44444, n_sample=8, near=2.0,
                         far=6.0)
    got = make_r2l_frame_fn(state.params, cfg, s, use_pallas=False)(pose)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_FRAME)
    res = app.train(parse_args(
        _common(scene, tmp_path, "ro") + flags + [
            "--render_only", "--render_test", "--pretrained_ckpt", path]))
    assert res.test_psnr_v2 == best


class _Quiet:
    def print(self, *a, **k):
        pass


def test_images_distill(scene, pseudo, tmp_path):
    """Images-mode distillation: on the spiral pseudo images mixed in, the
    pseudo frames are drawn and --render_only reproduces the training-time
    eval; on the real frames alone the loss falls (the random teacher's
    pseudo frames have their own loss level, so a mixed run's smoothed
    loss moves with the draw)."""
    argv = _common(scene, tmp_path, "im") + STUDENT + [
        "--data_mode", "images", "--datadir_kd",
        str(pseudo / "spiral_evenly_spaced"), "--N_rand", "512",
        "--N_iters", "20", "--i_print", "10", "--i_testset", "20",
        "--pseudo_ratio", "0.5"]
    state, best = app.train(parse_args(argv))
    text = _log(tmp_path, "im")
    assert "3 pseudo frames" in text
    ratio = [float(x) for x in re.findall(r"pseudo_img_ratio ([0-9.]+)",
                                          text)]
    assert len(ratio) == 2 and 0 < ratio[-1] < 1, ratio
    res = app.train(parse_args(
        _common(scene, tmp_path, "ro") + STUDENT + [
            "--render_only", "--render_test", "--pretrained_ckpt",
            _weights(tmp_path, "im", "ckpt_best.msgpack")]))
    assert res.test_psnr_v2 == best
    app.train(parse_args(_common(scene, tmp_path, "real") + STUDENT + [
        "--data_mode", "images", "--N_rand", "512", "--N_iters", "60",
        "--i_print", "20", "--i_testset", "60", "--pseudo_ratio", "0"]))
    losses = _losses(_log(tmp_path, "real"))
    assert len(losses) == 3 and losses[-1] < losses[0], losses


@pytest.mark.parametrize("batching", [True, False])
def test_teacher_train(scene, tmp_path, batching):
    """Teacher training through the CLI: the loss falls; teacher.msgpack
    loads into r2l_tpu.checkpoint and JAX's volumetric render of it equals
    the port's."""
    from r2l_tpu.render import VolRenderConfig as JVol
    from r2l_tpu.render import render_frame_nerf as jrender
    argv = _common(scene, tmp_path, "t") + TEACHER + [
        "--N_rand", "256", "--N_iters", "40", "--i_print", "20",
        "--i_testset", "40", "--raw_noise_std", "1", "--lrate", "2e-3"]
    if not batching:
        argv += ["--no_batching"]
    state, best = app.train(parse_args(argv))
    losses = _losses(_log(tmp_path, "t"))
    assert len(losses) == 2 and losses[-1] < losses[0], losses
    path = _weights(tmp_path, "t", "teacher.msgpack")
    raw, meta = jckpt.load_checkpoint(path)
    jckpt.drop_cached_checkpoint()
    assert meta["global_step"] == 40 and sorted(raw) == [
        "coarse", "fine", "opt_state"]
    jargs = JC.parse_args(argv + ["--teacher_ckpt", path])
    jncfg, jfine, pc, pf, _ = japp.build_teacher(jargs, _Quiet())
    jckpt.drop_cached_checkpoint()
    rng = np.random.default_rng(0)
    ro = rng.uniform(-1, 1, (100, 3)).astype(np.float32) + [0, 0, 4.0]
    rd = rng.normal(size=(100, 3)).astype(np.float32)
    vkw = dict(n_coarse=6, n_fine=4, perturb=False, use_viewdirs=True,
               multires=4, multires_views=2, white_bkgd=True, ray_chunk=64)
    want = jrender(pc, pf, jncfg, JVol(**vkw),
                   jax.numpy.asarray(ro), jax.numpy.asarray(rd),
                   ncfg_fine=jfine)["rgb"]
    got = render_frame_nerf(state.model_c, state.model_f, state.model_c.cfg,
                            app.VolRenderConfig(**vkw), torch.from_numpy(ro),
                            torch.from_numpy(rd))["rgb"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_RGB)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", ["rays", "teacher"])
def test_steps_per_dispatch_equals_single_steps(scene, pseudo, tmp_path,
                                                mode):
    """--steps_per_dispatch 4 (a loop of 4 steps per call) writes the same
    checkpoint, bit for bit, as 4 single steps a call."""
    if mode == "rays":
        flags = STUDENT + ["--data_mode", "rays", "--datadir_kd",
                           str(pseudo / "rand"), "--N_rand", "1024",
                           "--hard_ratio", "0.1,0.2", "--hard_mul", "4"]
        file = "ckpt.msgpack"
    else:
        flags = TEACHER + ["--N_rand", "128", "--no_batching",
                           "--precrop_iters", "2"]
        file = "teacher.msgpack"
    trees = []
    for k in ("1", "4"):
        name = f"k{k}"
        app.train(parse_args(_common(scene, tmp_path, name) + flags + [
            "--N_iters", "8", "--i_print", "100", "--i_testset", "100",
            "--steps_per_dispatch", k]))
        raw, meta = ckpt.load_checkpoint(_weights(tmp_path, name, file))
        ckpt.drop_cached_checkpoint()
        assert meta["global_step"] == 8
        trees.append(raw)
    _tree_equal(trees[0], trees[1])


@pytest.mark.parametrize("flag", [["--mesh", "data:2"], ["--multihost"],
                                  ["--num_cpu_devices", "2"],
                                  ["--platform", "tpu"],
                                  ["--trans_origin", "fixed"]])
def test_unported_flags_raise(scene, tmp_path, flag):
    argv = _common(scene, tmp_path, "x") + STUDENT + flag
    with pytest.raises(SystemExit, match="ROADMAP|port"):
        app.train(parse_args(argv))


def test_no_card_without_platform_cpu_raises(scene, tmp_path):
    """Without --platform cpu and with no CUDA device, the CLI and the tool
    exit with an error (in process, and as the entries run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = _common(scene, tmp_path, "x")
    argv.remove("--platform")
    argv.remove("cpu")
    with pytest.raises(SystemExit, match="no CUDA device"):
        app.train(parse_args(argv + STUDENT))
    env = dict(os.environ, PYTHONPATH=REPO)
    for cmd in ([sys.executable, "main_cuda.py"],
                [sys.executable, "-m", "r2l_tpu_torch.tools.create_data"]):
        out = subprocess.run(cmd + argv, cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "no CUDA device" in out.stderr, (
            out.returncode, out.stderr[-500:])
        assert out.stdout == ""
