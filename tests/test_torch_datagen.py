"""Port parity: pseudo-data generation, the ``rand`` mode
(r2l_tpu_torch/datagen.py against r2l_tpu/datagen.py, both on the CPU)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.datagen as jdatagen
import r2l_tpu.render as jrender
from _torch_parity import nerf_models
from r2l_tpu.encoding import nerf_embed_dim
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu_torch import datagen, render

Lp, Lv = 4, 2


def _teacher(seed=0):
    jcfg = JNeRFConfig(D=3, W=32, skips=(1,), use_viewdirs=True,
                       input_ch=nerf_embed_dim(3, Lp),
                       input_ch_views=nerf_embed_dim(3, Lv), output_ch=5)
    pc, cfg, mc = nerf_models(jcfg, seed=seed)
    pf, _, mf = nerf_models(jcfg, seed=seed + 1)
    return jcfg, (pc, pf), cfg, (mc, mf)


def _configs(perturb=False, **gkw):
    vcfg = jrender.VolRenderConfig(
        n_coarse=6, n_fine=4, perturb=perturb, use_viewdirs=True,
        multires=Lp, multires_views=Lv, near=2.0, far=6.0, white_bkgd=True,
        ray_chunk=40)
    kw = dict(n_pose=2, H=8, W=8, focal=10.0, save_every=2, shard_size=50,
              seed=3)
    kw.update(gkw)
    return (vcfg, jdatagen.DataGenConfig(**kw),
            render.VolRenderConfig(**dataclasses.asdict(vcfg)),
            datagen.DataGenConfig(**kw))


def _shards(d):
    names = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    return names, [np.load(os.path.join(d, f)) for f in names]


@pytest.mark.parametrize("learn_depth", ["", "depth", "surface"])
def test_shards_match_jax(tmp_path, learn_depth):
    """Perturb off, the same configs: the same file names and shapes, the
    o/d columns and the writer's row order bit for bit (numpy rays and
    shuffles on both sides), rgb within 1e-5, depth columns within 1e-4."""
    jcfg, (pc, pf), cfg, (mc, mf) = _teacher()
    vj, gj, vt, gt = _configs(learn_depth=learn_depth)
    n_j = jdatagen.generate_pseudo_data(pc, pf, jcfg, vj, gj,
                                        str(tmp_path / "jax"))
    n_t = datagen.generate_pseudo_data(mc, mf, cfg, vt, gt,
                                       str(tmp_path / "torch"), device="cpu")
    assert n_j == n_t == 2 * 64
    names_j, arrs_j = _shards(tmp_path / "jax")
    names_t, arrs_t = _shards(tmp_path / "torch")
    assert names_j == names_t == [f"pseudo_{i:06d}.npy" for i in range(3)]
    dim = 9 + {"": 0, "depth": 1, "surface": 3}[learn_depth]
    for a, b in zip(arrs_j, arrs_t):
        assert a.shape == b.shape and b.shape[1] == dim
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b[:, :6], a[:, :6])
        np.testing.assert_allclose(b[:, 6:9], a[:, 6:9], rtol=0, atol=1e-5)
        np.testing.assert_allclose(b[:, 9:], a[:, 9:], rtol=1e-4, atol=1e-4)


def test_int8_calibration_set_matches_jax(monkeypatch, tmp_path):
    """The int8 teacher's calibration points (8 poses from seed + 7, every
    (H*W/256)-th ray, 9 even depths), captured from JAX's own datagen run
    with its fused path forced on."""
    jcfg, (pc, pf), cfg, _ = _teacher()
    vj, gj, vt, gt = _configs(quantize="int8", H=24, W=20, n_pose=1)
    seen = {}

    def fake_fused(*args, int8_calib=None, **kw):
        seen["calib"] = tuple(np.asarray(a) for a in int8_calib)
        n_rays = args[4].shape[0]
        return {"rgb": jnp.zeros((n_rays, 3)), "depth": jnp.zeros(n_rays)}

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jdatagen, "render_frame_nerf_fused", fake_fused)
    jdatagen.generate_pseudo_data(pc, pf, jcfg, vj, gj, str(tmp_path))
    pts, vds = datagen.int8_calibration_set(gt, vt)
    np.testing.assert_array_equal(pts, seen["calib"][0])
    np.testing.assert_array_equal(vds, seen["calib"][1])
    assert pts.shape == (8 * (24 * 20 // (24 * 20 // 256)) * 9, 3)


def test_int8_request_without_fused_path_warns(tmp_path):
    """On the CPU the fused path is off: --quantize int8 warns and renders
    with the full-precision teacher (datagen.py:125-131)."""
    _, _, cfg, (mc, mf) = _teacher()
    _, _, vt, gt = _configs(quantize="int8", n_pose=1)
    with pytest.warns(UserWarning, match="quantize int8"):
        datagen.generate_pseudo_data(mc, mf, cfg, vt, gt, str(tmp_path),
                                     device="cpu")


def test_perturbed_runs_repeat(tmp_path):
    """Perturb on, the port's own per-pose generators: the JAX package's
    record count and shapes, and the same bits again for one seed."""
    _, _, cfg, (mc, mf) = _teacher()
    _, _, vt, gt = _configs(perturb=True, n_pose=3, save_every=2)
    out = []
    for run in ("a", "b"):
        n_rays = datagen.generate_pseudo_data(
            mc, mf, cfg, vt, gt, str(tmp_path / run), device="cpu")
        assert n_rays == 3 * 64
        out.append(_shards(tmp_path / run))
    (names_a, arrs_a), (names_b, arrs_b) = out
    assert names_a == names_b
    assert [a.shape for a in arrs_a] == [(50, 9), (50, 9), (28, 9), (50, 9),
                                          (14, 9)]
    for a, b in zip(arrs_a, arrs_b):
        np.testing.assert_array_equal(a, b)
    _, _, vt0, gt0 = _configs(perturb=False, n_pose=3, save_every=2)
    datagen.generate_pseudo_data(mc, mf, cfg, vt0, gt0, str(tmp_path / "c"),
                                 device="cpu")
    assert not np.array_equal(np.concatenate(arrs_a)[:, 6:9],
                              np.concatenate(_shards(tmp_path / "c")[1])
                              [:, 6:9])


def test_draws_fn_and_progress(tmp_path):
    """``draws_fn`` replaces the generator's draws (given all-0.5 draws the
    perturbed run equals a hand-made render of the same rays); ``progress``
    sees every pose batch."""
    _, _, cfg, (mc, mf) = _teacher()
    _, _, vt, gt = _configs(perturb=True, n_pose=2, save_every=1,
                            poses_per_batch=2)
    calls, seen = [], []

    def draws_fn(i, ro, rd):
        seen.append((i, ro.shape[0]))
        n_chunks = -(-ro.shape[0] // vt.ray_chunk)
        return [render.ChunkDraws(
            u_strat=torch.full((vt.ray_chunk, vt.n_coarse), 0.5),
            u_pdf=torch.full((vt.ray_chunk, vt.n_fine), 0.5))] * n_chunks

    datagen.generate_pseudo_data(mc, mf, cfg, vt, gt, str(tmp_path),
                                 device="cpu", draws_fn=draws_fn,
                                 progress=lambda i, k: calls.append((i, k)))
    assert seen == [(0, 128)] and calls == [(2, 2)]
    rng = np.random.default_rng(gt.seed)
    rays = [datagen._pose_rays(rng, gt, 4.0) for _ in range(2)]
    ro = torch.from_numpy(np.concatenate([r[0].reshape(-1, 3) for r in rays]))
    rd = torch.from_numpy(np.concatenate([r[1].reshape(-1, 3) for r in rays]))
    want = render.render_frame_nerf(mc, mf, cfg, vt, ro, rd,
                                    draws=draws_fn(0, ro, rd))["rgb"]
    recs = np.concatenate(_shards(tmp_path)[1])
    order = np.lexsort(recs[:, 3:6].T)
    ref = np.concatenate([ro.numpy(), rd.numpy(), want.numpy()], 1)
    np.testing.assert_array_equal(recs[order], ref[np.lexsort(ref[:, 3:6].T)])
