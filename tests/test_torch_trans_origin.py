"""Port parity of ``--trans_origin`` (r2l_tpu_torch/rays.py's module
default, set by ``app.load_dataset``) against r2l_tpu/rays.py's: 'fixed'
(30 units) and a number slide every ``get_rays``/``get_rays_np`` origin
along its unit direction, in the step and datagen paths that make rays with
them; the samplers' frame rays do not read it, in either package. Each test
puts both packages' defaults back to '' when it ends."""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.app as japp
import r2l_tpu.checkpoint as jckpt
import r2l_tpu.configs as JC
import r2l_tpu.datagen as JD
import r2l_tpu.rays as JR
from _torch_scene import write_scene
from r2l_tpu.logging_ import Logger as JLogger
from r2l_tpu.sampler import PointSampler as JSampler
from r2l_tpu_torch import app, datagen
from r2l_tpu_torch import rays as R
from r2l_tpu_torch.configs import parse_args
from r2l_tpu_torch.sampler import PointSampler
from r2l_tpu_torch.tools import create_data as tcd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The origins: a unit direction (a norm and a quotient) times the scale,
# added to the camera centre; the two frameworks' norms and quotients round
# differently by an ulp (rays of size ~30 here).
TOL_RAYS = 1e-5
TOL_PSNR_DB = 1e-4     # tests/test_torch_cli.py's per-frame bound at f32
TOL_RGB = 1e-5
TEACHER = ("--model_name nerf --netdepth 3 --netwidth 32 --netdepth_fine 3 "
           "--netwidth_fine 32 --skips 1 --N_samples 6 --N_importance 4 "
           "--multires 4 --multires_views 2 --use_viewdirs --chunk 256"
           ).split()
STUDENT = ("--model_name R2L --n_sample_per_ray 8 --netwidth 64 "
           "--netdepth 12 --use_residual --trial.ON --trial.body_arch "
           "resmlp").split()
C2W = JR.pose_spherical(30.0, -40.0, 4.0)[:3, :4].astype(np.float32)


@pytest.fixture(autouse=True)
def reset_defaults():
    yield
    R.set_default_trans_origin("")
    JR.set_default_trans_origin("")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("scene")))


def _common(scene, exps, name):
    return ["--dataset_type", "blender", "--datadir", scene, "--white_bkgd",
            "--testskip", "1", "--platform", "cpu", "--experiments_dir",
            str(exps), "--experiment_name", name]


@pytest.mark.parametrize("value", ["fixed", "2.5"])
def test_get_rays_read_the_default(value):
    """Both packages' get_rays and get_rays_np under the same default: the
    same rays; an explicit '' turns it off; the origins moved by the
    scale along the unit direction."""
    R.set_default_trans_origin(value)
    JR.set_default_trans_origin(value)
    jo, jd = JR.get_rays(12, 10, 9.0, jnp.asarray(C2W))
    to, td = R.get_rays(12, 10, 9.0, C2W, device="cpu")
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=TOL_RAYS)
    no, nd = JR.get_rays_np(12, 10, 9.0, C2W)
    po, pd = R.get_rays_np(12, 10, 9.0, C2W)
    np.testing.assert_array_equal(pd, nd)
    np.testing.assert_allclose(po, no, rtol=0, atol=TOL_RAYS)
    base, _ = R.get_rays(12, 10, 9.0, C2W, trans_origin="", device="cpu")
    shift = np.linalg.norm(to.numpy() - base.numpy(), axis=-1)
    scale = 30.0 if value == "fixed" else float(value)
    np.testing.assert_allclose(shift, scale, rtol=1e-5)


def test_sampler_frame_rays_do_not_read_it():
    """PointSampler's frame rays (the student's frames and the teacher's
    eval) build their own rotation in both packages: the default moves
    nothing there."""
    R.set_default_trans_origin("fixed")
    JR.set_default_trans_origin("fixed")
    kw = dict(H=8, W=8, focal=9.0, n_sample=4, near=2.0, far=6.0)
    want = np.asarray(JSampler(**kw).sample_test(jnp.asarray(C2W)))
    got = PointSampler(**kw).sample_test(torch.from_numpy(C2W)).numpy()
    R.set_default_trans_origin("")
    off = PointSampler(**kw).sample_test(torch.from_numpy(C2W)).numpy()
    np.testing.assert_array_equal(got, off)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_images_to_ray_records_follow_it():
    """The teacher's ray pool (``images_to_ray_records``, use_batching)
    is built with get_rays_np: JAX's records under the same default."""
    R.set_default_trans_origin("fixed")
    JR.set_default_trans_origin("fixed")
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, 6, 5, 3)).astype(np.float32)
    poses = np.stack([C2W, JR.pose_spherical(90.0, -30.0, 4.0)[:3, :4]]
                     ).astype(np.float32)
    want = JD.images_to_ray_records(imgs, poses, 6, 5, 7.0)
    got = datagen.images_to_ray_records(imgs, poses, 6, 5, 7.0,
                                        device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL_RAYS)
    assert np.abs(got[:, :3] - C2W[:, 3]).max() > 25.0


@pytest.fixture(scope="module")
def jax_teacher(scene, tmp_path_factory):
    d = tmp_path_factory.mktemp("jteacher")
    args = JC.parse_args(_common(scene, d, "jt") + TEACHER)
    _, _, pc, pf, _ = japp.build_teacher(args, JLogger(
        experiment_name="jt", experiments_dir=str(d)))
    path = str(d / "teacher.msgpack")
    jckpt.save_checkpoint(path, {"coarse": pc, "fine": pf})
    return path


def test_create_data_rand_matches_jax_entry(scene, jax_teacher, tmp_path,
                                            monkeypatch):
    """create_data --create_data rand --trans_origin fixed through both
    entries: the flag reaches the pose loop's rays (origins 30 units out
    along each ray), the shards' rays agree, rgb within TOL_RGB."""
    spec = importlib.util.spec_from_file_location(
        "jax_create_data", os.path.join(REPO, "tools", "create_data.py"))
    jcd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcd)
    argv = _common(scene, tmp_path, "cd") + TEACHER + [
        "--teacher_ckpt", jax_teacher, "--create_data", "rand",
        "--perturb", "0", "--n_pose_kd", "2", "--create_data_chunk", "2",
        "--poses_per_batch", "1", "--trans_origin", "fixed"]
    monkeypatch.setattr(sys, "argv", ["create_data.py"] + argv + [
        "--datadir_kd", str(tmp_path / "jax")])
    jcd.main()
    assert tcd.main(argv + ["--datadir_kd", str(tmp_path / "torch")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    for n in names:
        a, b = np.load(tmp_path / "jax" / n), np.load(tmp_path / "torch" / n)
        np.testing.assert_allclose(b[:, :6], a[:, :6], rtol=0,
                                   atol=TOL_RAYS)
        np.testing.assert_allclose(b[:, 6:], a[:, 6:], rtol=0, atol=TOL_RGB)
        assert np.linalg.norm(b[:, :3], axis=-1).min() > 25.0


def test_render_only_matches_jax_cli(scene, tmp_path):
    """--render_only --render_test --trans_origin fixed of a JAX-written
    student through both CLIs, at f32: the same per-frame PSNR (the frames'
    sampler does not read the flag in either package), and the load sets
    the port's default as JAX's."""
    argv = _common(scene, tmp_path, "r") + STUDENT + [
        "--trans_origin", "fixed"]
    jargs = JC.parse_args(argv)
    params = japp.init_r2l(jax.random.key(7),
                           JC.args_to_r2l_config(jargs))
    path = str(tmp_path / "student.msgpack")
    jckpt.save_checkpoint(path, {"params": params})
    argv += ["--render_only", "--render_test", "--pretrained_ckpt", path]
    jargs = JC.parse_args(argv)
    logger = JLogger(experiment_name="r", experiments_dir=str(tmp_path),
                     args=jargs)
    want = japp.run_render_only(jargs, japp.load_dataset(jargs, logger),
                                logger)
    got = app.train(parse_args(argv))
    assert R._DEFAULT_TRANS_ORIGIN == JR._DEFAULT_TRANS_ORIGIN == "fixed"
    np.testing.assert_allclose(got.per_frame_psnr, want.per_frame_psnr,
                               rtol=0, atol=TOL_PSNR_DB)
