"""Port parity: the datagen modes other than ``rand`` (rand_tworays,
3x3rays, rand_images, 16x16patches, spiral_evenly_spaced;
r2l_tpu_torch/datagen.py against r2l_tpu/datagen.py, both on the CPU, the
same small teacher carried across with the layout converter)."""
import dataclasses
import os

import numpy as np
import pytest

import r2l_tpu.datagen as jdatagen
import r2l_tpu.render as jrender
from _torch_parity import jax_chunk_draws, nerf_models
from r2l_tpu.encoding import nerf_embed_dim
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu_torch import datagen, render

Lp, Lv = 4, 2
# test_torch_datagen.py's bounds: the rays, neighbour offsets and shuffles
# are numpy on both sides (bit for bit); rgb is the two teachers' render,
# f32 sums in other orders.
TOL_RGB = 1e-5

MODES = {   # name: (JAX function, port function, side)
    "rand_tworays": ("generate_tworays", 8),
    "3x3rays": ("generate_3x3rays", 8),
    "rand_images": ("generate_rand_images", 8),
    "16x16patches": ("generate_patches", 32),
    "spiral_evenly_spaced": ("generate_pseudo_images", 8),
}


def _teacher():
    jcfg = JNeRFConfig(D=3, W=32, skips=(1,), use_viewdirs=True,
                       input_ch=nerf_embed_dim(3, Lp),
                       input_ch_views=nerf_embed_dim(3, Lv), output_ch=5)
    pc, cfg, mc = nerf_models(jcfg, seed=0)
    pf, _, mf = nerf_models(jcfg, seed=1)
    return jcfg, (pc, pf), cfg, (mc, mf)


def _configs(side, perturb, **gkw):
    vcfg = jrender.VolRenderConfig(
        n_coarse=6, n_fine=4, perturb=perturb, use_viewdirs=True,
        multires=Lp, multires_views=Lv, near=2.0, far=6.0, white_bkgd=True,
        ray_chunk=40)
    kw = dict(n_pose=3, H=side, W=side, focal=1.2 * side, save_every=2,
              shard_size=70, seed=3)
    kw.update(gkw)
    return (vcfg, jdatagen.DataGenConfig(**kw),
            render.VolRenderConfig(**dataclasses.asdict(vcfg)),
            datagen.DataGenConfig(**kw))


def _run(mode, tmp_path, perturb, **gkw):
    """Both packages' mode into tmp/jax and tmp/torch; the port takes
    JAX's per-pose draws when perturbing."""
    fn, side = MODES[mode]
    jcfg, (pc, pf), cfg, (mc, mf) = _teacher()
    vj, gj, vt, gt = _configs(side, perturb, **gkw)
    extra = {"n_pose": 3} if mode == "spiral_evenly_spaced" else {}

    def draws_fn(i, ro, rd):
        return jax_chunk_draws(jdatagen._pose_key(gj.seed, i), vj,
                               ro.shape[0])

    n_j = getattr(jdatagen, fn)(pc, pf, jcfg, vj, gj,
                                str(tmp_path / "jax"), **extra)
    n_t = getattr(datagen, fn)(mc, mf, cfg, vt, gt, str(tmp_path / "torch"),
                               device="cpu",
                               draws_fn=draws_fn if perturb else None,
                               **extra)
    assert n_t == n_j
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    return names, [(_load(tmp_path / "jax" / n), _load(tmp_path / "torch" / n))
                   for n in names]


def _load(p):
    if str(p).endswith(".npz"):
        with np.load(p) as z:
            return {k: z[k] for k in z.files}
    return {"": np.load(p)}


def _split_check(a, b, exact):
    """Columns [:exact] bit for bit, the rest (rgb) within TOL_RGB."""
    assert a.shape == b.shape and b.dtype == np.float32
    np.testing.assert_array_equal(b[..., :exact], a[..., :exact])
    np.testing.assert_allclose(b[..., exact:], a[..., exact:], rtol=0,
                               atol=TOL_RGB)


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_jax(tmp_path, mode, perturb):
    """The same file names, shapes and row order; rays bit for bit, rgb
    within TOL_RGB; 3 poses flushed every 2 (two shard batches or two
    .npz batches)."""
    names, pairs = _run(mode, tmp_path, perturb)
    if mode == "rand_tworays":
        assert names[0] == "pseudo2ray_000000.npy"
        for a, b in pairs:
            assert b[""].shape[1] == 15
            _split_check(a[""], b[""], 9)
        assert sum(b[""].shape[0] for _, b in pairs) == 3 * 64
    elif mode == "3x3rays":
        assert names[0] == "pseudo3x3_000000.npy"
        for a, b in pairs:
            assert b[""].shape[1] == 57
            _split_check(a[""], b[""], 30)
        assert sum(b[""].shape[0] for _, b in pairs) == 3 * 36
    elif mode == "rand_images":
        assert names == ["rand_images_00000.npz", "rand_images_00001.npz"]
        assert [b["data"].shape for _, b in pairs] == [(2, 8, 8, 9),
                                                       (1, 8, 8, 9)]
        for a, b in pairs:
            _split_check(a["data"], b["data"], 6)
    elif mode == "16x16patches":
        assert names == ["patches_00000.npz", "patches_00001.npz"]
        assert [b["patches"].shape for _, b in pairs] == [
            (2, 4, 16, 16, 6), (1, 4, 16, 16, 6)]
        for a, b in pairs:
            np.testing.assert_array_equal(b["rays_o"], a["rays_o"])
            _split_check(a["patches"], b["patches"], 3)
    else:
        assert names == ["pseudo_images_0000.npy", "pseudo_poses_0000.npy"]
        (ai, bi), (ap, bp) = pairs
        assert bi[""].shape == (3, 8, 8, 3)
        np.testing.assert_allclose(bi[""], ai[""], rtol=0, atol=TOL_RGB)
        np.testing.assert_array_equal(bp[""], ap[""])


def test_patches_wrap_at_max_save(tmp_path):
    """Batch numbers wrap modulo max_save, as JAX's (bounded file
    count): 3 poses, one per batch, max_save 2 -> 00000 rewritten."""
    names, pairs = _run("16x16patches", tmp_path, False, save_every=1,
                        max_save=2)
    assert names == ["patches_00000.npz", "patches_00001.npz"]
    np.testing.assert_array_equal(pairs[0][1]["rays_o"],
                                  pairs[0][0]["rays_o"])


def test_int8_request_warns_outside_rand(tmp_path):
    _, _, cfg, (mc, mf) = _teacher()
    _, _, vt, gt = _configs(8, False, quantize="int8", n_pose=1)
    with pytest.warns(UserWarning, match="only wired into the 'rand'"):
        datagen.generate_tworays(mc, mf, cfg, vt, gt, str(tmp_path),
                                 device="cpu")


def test_neighbor_offsets_match_jax():
    for seed in range(3):
        a = jdatagen._rand_neighbor_offsets(np.random.default_rng(seed), 5, 7)
        b = datagen._rand_neighbor_offsets(np.random.default_rng(seed), 5, 7)
        np.testing.assert_array_equal(a, b)
        h = np.arange(5)[:, None] + b[..., 0]
        w = np.arange(7)[None, :] + b[..., 1]
        assert h.min() >= 0 and h.max() < 5 and w.min() >= 0 and w.max() < 7
