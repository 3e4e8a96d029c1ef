"""Port parity: the eval loop (r2l_tpu_torch/evaluate.py: render_path,
render_path_given_rays, load_given_render_path_rays, write_video, to8b and
the PNG writer) against r2l_tpu.evaluate on the same frames, ground truth
and LPIPS weights; the PNG files decoded with imageio and compared with
JAX's."""
import os
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.evaluate as JE
import r2l_tpu.lpips_jax as JL
from _torch_parity import n, t
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import evaluate as TE
from r2l_tpu_torch.lpips import lpips_params_from_jax
from r2l_tpu_torch.sampler import PointSampler
from test_torch_frame import H, POSES, SAMPLER, TOL, W, _cfgs
from test_torch_metrics import RTOL_FLIP, RTOL_LPIPS, RTOL_SSIM

# The summaries of one set of frames: PSNR from an f32 mean in another sum
# order (a few ulp), SSIM/FLIP/LPIPS at the metric tests' bounds.
RTOL_PSNR = 1e-5
FIELDS = {"test_psnr": RTOL_PSNR, "test_psnr_v2": RTOL_PSNR,
          "test_ssim": RTOL_SSIM, "test_flip": RTOL_FLIP,
          "test_lpips": RTOL_LPIPS}


def _frames_and_gt(k=3, h=33, w=35, seed=0):
    rng = np.random.default_rng(seed)
    gts = rng.uniform(0.1, 0.9, (k, h, w, 3)).astype(np.float32)
    frames = np.clip(gts + rng.normal(0, 0.05, gts.shape), 0,
                     1).astype(np.float32)
    return frames, gts


def _lpips_both():
    jp = JL.init_lpips(jax.random.key(0), net="alex")
    np_p = {k: v if k == "net" else jax.tree.map(np.asarray, v)
            for k, v in jp.items()}
    return jp, lpips_params_from_jax(np_p, device="cpu")


def _assert_same_result(got, want, frame_tol=0.0):
    assert got.frames.shape == want.frames.shape
    np.testing.assert_allclose(got.frames, want.frames, rtol=0,
                               atol=frame_tol)
    for field, rtol in FIELDS.items():
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=field)
    np.testing.assert_allclose(got.per_frame_psnr, want.per_frame_psnr,
                               rtol=RTOL_PSNR)
    assert got.ms_per_frame is not None and got.ms_per_frame >= 0


def _assert_same_pngs(dir_t, dir_j):
    names = sorted(os.listdir(dir_j))
    assert sorted(os.listdir(dir_t)) == names and names
    for name in names:
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(dir_t, name)),
            imageio.imread(os.path.join(dir_j, name)), err_msg=name)


@pytest.mark.parametrize("rescale", ["standard", "minmax"])
def test_render_path_matches_jax(rescale, tmp_path):
    """The same frames through both loops: EvalResult's fields and the
    NNN.png / NNN_err.png / NNN_gt.png files."""
    frames, gts = _frames_and_gt()
    jp, tp = _lpips_both()
    jframes, tframes = iter(map(jnp.asarray, frames)), iter(map(t, frames))
    poses = [np.eye(4)[:3, :4]] * len(frames)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = JE.render_path(lambda c2w: next(jframes), poses, gt_images=gts,
                          savedir=str(tmp_path / "j"), lpips_params=jp,
                          lpips_rescale=rescale, flip_rescale=rescale)
    got = TE.render_path(lambda c2w: next(tframes), poses, gt_images=gts,
                         savedir=str(tmp_path / "t"), lpips_params=tp,
                         lpips_rescale=rescale, flip_rescale=rescale)
    _assert_same_result(got, want)
    _assert_same_pngs(tmp_path / "t", tmp_path / "j")
    assert len(os.listdir(tmp_path / "t")) == 3 * len(frames)


def test_render_path_without_ground_truth_and_with_disp(tmp_path):
    """No ground truth: frames and NNN.png only; a frame function that
    returns (rgb, disp) fills disp_frames; one frame times that frame."""
    frames, _ = _frames_and_gt(k=2)
    disps = frames[..., 0] * 3.0
    it = iter(zip(frames, disps))
    res = TE.render_path(lambda c2w: tuple(map(t, next(it))),
                         [t(np.eye(4))] * 2, savedir=str(tmp_path))
    np.testing.assert_array_equal(res.frames, frames)
    np.testing.assert_array_equal(res.disp_frames, disps)
    assert res.test_psnr is None and res.per_frame_psnr == []
    assert sorted(os.listdir(tmp_path)) == ["000.png", "001.png"]
    one = TE.render_path(lambda c2w: t(frames[0]), [np.eye(4)])
    assert one.ms_per_frame is not None


def test_render_path_given_rays_matches_jax(tmp_path):
    """The DONeRF path end to end (f32 jnp frames, TOL's 1e-5), the ground
    truth cut to [:, :H, :W], with FLIP and the logger's path line."""
    jcfg, params, cfg, model = _cfgs(jnp.float32)
    js = JaxPointSampler(**SAMPLER)
    pairs = [js.frame_rays(jnp.asarray(p)) for p in POSES]
    ros = np.stack([np.asarray(o) for o, _ in pairs])
    rds = np.stack([np.asarray(d) for _, d in pairs])
    rng = np.random.default_rng(1)
    gts = rng.uniform(0, 1, (len(POSES), H + 2, W + 3, 3)).astype(np.float32)

    class Log:
        def __init__(self):
            self.lines = []

        def print(self, msg):
            self.lines.append(msg)

    logs = Log(), Log()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = JE.render_path_given_rays(params, jcfg, js, ros, rds, H, W,
                                     gt_images=gts,
                                     savedir=str(tmp_path / "j"),
                                     use_pallas=False, logger=logs[0])
    got = TE.render_path_given_rays(model, cfg, PointSampler(**SAMPLER),
                                    ros, rds, H, W, gt_images=gts,
                                    savedir=str(tmp_path / "t"),
                                    use_pallas=False, logger=logs[1])
    frame_tol = TOL[("jnp", "f32")][0]
    _assert_same_result(got, want, frame_tol)
    assert logs[0].lines[0] == logs[1].lines[0] == \
        "given-rays inference path: jnp"
    assert len(logs[1].lines) == len(POSES) + 1
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    # a prebuilt frame function is used as given
    fn = TE.make_r2l_givenrays_frame_fn(model, cfg, PointSampler(**SAMPLER),
                                        H, W, use_pallas=False)
    again = TE.render_path_given_rays(None, None, None, ros, rds, H, W,
                                      frame_fn=fn, compute_flip=False)
    np.testing.assert_array_equal(again.frames, got.frames)


@pytest.mark.parametrize("suffix,with_gt", [(".npz", True), (".pt", True),
                                            (".npz", False)])
def test_load_given_render_path_rays_matches_jax(suffix, with_gt,
                                                 tmp_path):
    rng = np.random.default_rng(2)
    data = {"all_rays_o": rng.normal(size=(2, 12, 3)),
            "all_rays_d": rng.normal(size=(2, 12, 3)).astype(np.float32)}
    if with_gt:
        data["gt_imgs"] = rng.uniform(size=(2, 3, 4, 3))
    path = str(tmp_path / ("rays" + suffix))
    if suffix == ".npz":
        np.savez(path, **data)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in data.items()}, path)
    want, got = JE.load_given_render_path_rays(path), \
        TE.load_given_render_path_rays(path)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_to8b_and_png_writer():
    x = np.linspace(-0.5, 1.5, 7 * 5 * 3, dtype=np.float32).reshape(7, 5, 3)
    np.testing.assert_array_equal(TE.to8b(x), JE.to8b(x))
    assert TE.to8b(x).dtype == np.uint8


def test_write_png_decodes_to_its_input(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (13, 7, 3), np.uint8)
    TE.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "a.png")),
                                  img)
    for bad in (img[..., :2], img.astype(np.float32), img[..., 0]):
        with pytest.raises(ValueError):
            TE.write_png(str(tmp_path / "b.png"), bad)


def test_write_video_with_imageio_matches_jax(tmp_path):
    frames, _ = _frames_and_gt(k=3, h=16, w=16)
    want = JE.write_video(str(tmp_path / "j.mp4"), frames)
    got = TE.write_video(str(tmp_path / "t.mp4"), frames)
    assert os.path.splitext(got)[1] == os.path.splitext(want)[1]
    np.testing.assert_array_equal(np.asarray(imageio.mimread(got)),
                                  np.asarray(imageio.mimread(want)))


def test_write_video_without_imageio_writes_pngs(tmp_path, monkeypatch,
                                                 capsys):
    frames, _ = _frames_and_gt(k=3, h=16, w=16)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    out = TE.write_video(str(tmp_path / "v.mp4"), frames)
    monkeypatch.undo()
    assert out == str(tmp_path / "v_frames")
    assert "WARNING: imageio is not installed" in capsys.readouterr().err
    assert sorted(os.listdir(out)) == ["000.png", "001.png", "002.png"]
    for i, f in enumerate(TE.to8b(frames)):
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(out, f"{i:03d}.png")), f)
