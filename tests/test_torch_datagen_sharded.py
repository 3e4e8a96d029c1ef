"""Port parity of pose-batched and mesh-sharded pseudo-data generation
(r2l_tpu_torch/datagen.py ``generate_pseudo_data(mesh=)``,
``generate_tworays``) against r2l_tpu/datagen.py: the counterpart of
tests/test_datagen_sharded.py's four tests. The mesh runs on 2 and 4 gloo
ranks (tests/_torch_mesh_worker.py); rank 0 writes the shards, which are
one process's files row for row and JAX's in its row order (rays bit for
bit, rgb within TOL_RGB: test_torch_datagen.py's teacher bound)."""
import os

import numpy as np
import pytest

import r2l_tpu.datagen as JD
from _torch_mesh import flat, ok, run_ranks
from _torch_parity import nerf_models, np_tree
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.render import VolRenderConfig as JVol
from r2l_tpu_torch import datagen
from r2l_tpu_torch.render import VolRenderConfig

TOL_RGB = 1e-5


def _teacher():
    jcfg = JNeRFConfig(D=2, W=16, skips=(), use_viewdirs=False, input_ch=63,
                       input_ch_views=0)
    pc, cfg, mc = nerf_models(jcfg, seed=0)
    return jcfg, pc, cfg, mc


def _vcfg(cls, **kw):
    base = dict(n_coarse=4, n_fine=0, perturb=False, use_viewdirs=False,
                white_bkgd=True, ray_chunk=512)
    base.update(kw)
    return cls(**base)


def _load(d):
    (name,) = os.listdir(d)
    return np.load(os.path.join(d, name))


def _sorted_rows(a, key_cols):
    return a[np.lexsort(a[:, :key_cols].T)]


def test_batched_generation_matches_single(tmp_path):
    """poses_per_batch=4 writes the rays of 4 single-pose batches (rows in
    another shuffle, compared sorted by the ray columns), and JAX's."""
    jcfg, pc, cfg, mc = _teacher()
    kw = dict(n_pose=4, H=8, W=8, focal=10.0, save_every=4,
              shard_size=1 << 12, seed=3, use_rand_focal=True)
    a = datagen.generate_pseudo_data(
        mc, None, cfg, _vcfg(VolRenderConfig), datagen.DataGenConfig(**kw),
        str(tmp_path / "a"), device="cpu")
    b = datagen.generate_pseudo_data(
        mc, None, cfg, _vcfg(VolRenderConfig),
        datagen.DataGenConfig(poses_per_batch=4, **kw), str(tmp_path / "b"),
        device="cpu")
    j = JD.generate_pseudo_data(pc, None, jcfg, _vcfg(JVol),
                                JD.DataGenConfig(**kw), str(tmp_path / "j"))
    assert a == b == j == 4 * 64
    ra, rb, rj = (_sorted_rows(_load(tmp_path / d), 6) for d in "abj")
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(ra[:, :6], rj[:, :6])
    np.testing.assert_allclose(ra[:, 6:], rj[:, 6:], rtol=0, atol=TOL_RGB)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_sharded_generation(tmp_path, n):
    """Each pose batch's 128 rays over n ranks (rank 0 writes): the same
    shard, row for row, as one process, and JAX's one-device run's."""
    jcfg, pc, cfg, mc = _teacher()
    gkw = dict(n_pose=2, H=8, W=8, focal=10.0, save_every=2,
               shard_size=1 << 12, poses_per_batch=2)
    out = str(tmp_path / "m")
    res = run_ranks(n, {"datagen": dict(flat(np_tree(pc), "pc"),
                                        outdir=np.asarray(out))},
                    str(tmp_path / "ranks"))
    ranks = ok(res["datagen"])
    assert [int(r["total"][0]) for r in ranks] == [2 * 64] * n
    rec = _load(out)
    assert rec.shape == (128, 9)
    one = datagen.generate_pseudo_data(
        mc, None, cfg, _vcfg(VolRenderConfig), datagen.DataGenConfig(**gkw),
        str(tmp_path / "s"), device="cpu")
    assert one == 128
    np.testing.assert_array_equal(rec, _load(tmp_path / "s"))
    JD.generate_pseudo_data(pc, None, jcfg, _vcfg(JVol),
                            JD.DataGenConfig(**gkw), str(tmp_path / "j"))
    want = _load(tmp_path / "j")
    np.testing.assert_array_equal(rec[:, :6], want[:, :6])
    np.testing.assert_allclose(rec[:, 6:], want[:, 6:], rtol=0, atol=TOL_RGB)


def test_perturbed_generation_varies(tmp_path):
    """With perturb the pose's generator drives the stratified depths: the
    same poses give the same rays and other rgb than without."""
    _, _, cfg, mc = _teacher()
    g = datagen.DataGenConfig(n_pose=1, H=8, W=8, focal=10.0, save_every=1,
                              shard_size=1 << 12, seed=3,
                              use_rand_focal=False)
    for d, p in (("a", True), ("b", False)):
        datagen.generate_pseudo_data(
            mc, None, cfg, _vcfg(VolRenderConfig, n_fine=2, perturb=p), g,
            str(tmp_path / d), device="cpu")
    a, b = _load(tmp_path / "a"), _load(tmp_path / "b")
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert a[:, 6:9].min() >= 0.0 and a[:, 6:9].max() <= 1.0
    a_s, b_s = _sorted_rows(a, 6), _sorted_rows(b, 6)
    np.testing.assert_array_equal(a_s[:, :6], b_s[:, :6])
    assert np.abs(a_s[:, 6:9] - b_s[:, 6:9]).max() > 1e-6


def test_tworays_mode_with_perturb(tmp_path):
    _, _, cfg, mc = _teacher()
    g = datagen.DataGenConfig(n_pose=1, H=8, W=8, focal=10.0, save_every=1,
                              shard_size=1 << 12)
    for d, p in (("t", True), ("u", False)):
        n = datagen.generate_tworays(
            mc, None, cfg, _vcfg(VolRenderConfig, perturb=p), g,
            str(tmp_path / d), device="cpu")
        assert n == 64
    a, b = _load(tmp_path / "t"), _load(tmp_path / "u")
    assert a.shape[1] == 15 and np.isfinite(a).all()
    a_s, b_s = _sorted_rows(a, 9), _sorted_rows(b, 9)
    np.testing.assert_array_equal(a_s[:, :9], b_s[:, :9])
    assert np.abs(a_s[:, 9:] - b_s[:, 9:]).max() > 1e-6

