"""Port parity of the distillation step's inputs: ``stratify_z``
(r2l_tpu_torch/sampler.py), the hard-ray pool (r2l_tpu_torch/hardmine.py)
and the ray shards and batch loader (r2l_tpu_torch/data/rayshards.py),
against r2l_tpu on the same inputs and draws."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from r2l_tpu import hardmine as JH
from r2l_tpu import sampler as JS
from r2l_tpu.data import rayshards as JD
from r2l_tpu_torch import hardmine as H
from r2l_tpu_torch import sampler as S
from r2l_tpu_torch.data import rayshards as D

# stratify_z: lower + (upper - lower) * u, where XLA may contract the last
# multiply-add into an FMA: an ulp of the depths (about 5e-7 at z <= 6).
TOL_Z = 1e-6


@pytest.mark.parametrize("n_sample,shape", [(16, (5,)), (2, (3, 4))])
def test_stratify_z_matches_jax_draws(n_sample, shape):
    z_vals = JS.even_z_vals(2.0, 6.0, n_sample)
    key = jax.random.key(7)
    want = np.asarray(JS.stratify_z(key, z_vals, shape))
    u = jax.random.uniform(key, (*shape, n_sample))
    got = S.stratify_z(S.even_z_vals(2.0, 6.0, n_sample, "cpu"), shape,
                       u=t(u))
    np.testing.assert_allclose(n(got), want, rtol=0, atol=TOL_Z)
    drawn = S.stratify_z(S.even_z_vals(2.0, 6.0, n_sample, "cpu"), shape,
                         generator=torch.Generator().manual_seed(0))
    lo, hi = (n(b) for b in S._strat_bounds(
        S.even_z_vals(2.0, 6.0, n_sample, "cpu").expand(*shape, n_sample)))
    assert drawn.shape == want.shape
    assert np.all(n(drawn) >= lo) and np.all(n(drawn) <= hi)


def test_jax_permutation_of_array_is_index_permutation():
    """So a test may hand JAX's draws over as plain index permutations."""
    arr = jnp.arange(37, dtype=jnp.int32) * 3 + 5
    for seed in range(4):
        k = jax.random.key(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(k, arr)),
            np.asarray(arr)[np.asarray(jax.random.permutation(k, 37))])


def _pools(capacity, rd, size, rng):
    rays = rng.normal(size=(capacity, rd)).astype(np.float32)
    jpool = JH.HardPool(rays=jnp.asarray(rays), size=jnp.int32(size),
                        ptr=jnp.int32(size % capacity))
    pool = H.HardPool(rays=t(rays), size=torch.tensor(size, dtype=torch.int32),
                      ptr=torch.tensor(size % capacity, dtype=torch.int32))
    return jpool, pool


def _jax_draws(key, n, capacity, mode):
    """The draws JAX's sample_hard makes from ``key``."""
    if mode == "permutation":
        return H.HardDraws(None, torch.from_numpy(np.asarray(
            jax.random.permutation(key, capacity), np.int64)))
    k_off, k_shuf = jax.random.split(key)
    return H.HardDraws(t(jax.random.uniform(k_off, (n,))),
                       torch.from_numpy(np.asarray(
                           jax.random.permutation(k_shuf, n), np.int64)))


@pytest.mark.parametrize("mode", ["stratified", "permutation"])
@pytest.mark.parametrize("capacity,n_out,size", [(100, 16, 100),
                                                 (103, 16, 103),
                                                 (100, 16, 40)])
def test_sample_hard_matches_jax(mode, capacity, n_out, size):
    rng = np.random.default_rng(capacity + size)
    jpool, pool = _pools(capacity, 9, size, rng)
    fresh = rng.normal(size=(32, 9)).astype(np.float32)
    key = jax.random.key(3)
    want_rays, want_idx = JH.sample_hard(jpool, key, n_out,
                                         jnp.asarray(fresh), mode=mode)
    rays, idx = H.sample_hard(pool, n_out, t(fresh), mode=mode,
                              draws=_jax_draws(key, n_out, capacity, mode))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(n(rays), np.asarray(want_rays))
    assert len(set(idx.tolist())) == n_out   # distinct slots


@pytest.mark.parametrize("size", [0, 90, 100])
def test_update_pool_matches_jax(size):
    capacity, n_in, n_out = 100, 12, 16
    rng = np.random.default_rng(size)
    jpool, pool = _pools(capacity, 9, size, rng)
    hard = rng.normal(size=(n_in, 9)).astype(np.float32)
    sampled = rng.permutation(capacity)[:n_out].astype(np.int32)
    want = JH.update_pool(jpool, jnp.asarray(hard), jnp.asarray(sampled))
    got = H.update_pool(pool, t(hard), torch.from_numpy(sampled.astype(
        np.int64)))
    np.testing.assert_array_equal(n(got.rays), np.asarray(want.rays))
    assert int(got.size) == int(want.size) and int(got.ptr) == int(want.ptr)


@pytest.mark.parametrize("ratio", [None, "", 0, 0.2, "0.1,0.2", "0.3,0.1",
                                   (0.25, 0.5), [0.05]])
def test_parse_hard_ratio_matches_jax(ratio):
    for batch in (64, 81920):
        assert H.parse_hard_ratio(ratio, batch) == JH.parse_hard_ratio(
            ratio, batch)


def test_draw_hard_from_a_generator():
    g = torch.Generator().manual_seed(0)
    d = H.draw_hard(16, 100, "stratified", g)
    assert d.u.shape == (16,) and sorted(d.perm.tolist()) == list(range(16))
    d = H.draw_hard(16, 100, "permutation", g)
    assert d.u is None and sorted(d.perm.tolist()) == list(range(100))
    with pytest.raises(ValueError):
        H.draw_hard(16, 100, "sorted", g)


@pytest.mark.parametrize("shuffle", [True, False])
def test_write_ray_shards_byte_identical(tmp_path, shuffle):
    rays = np.random.default_rng(0).normal(size=(2500, 9)).astype(np.float32)
    kw = dict(prefix="pseudo", shard_size=1000, shuffle=shuffle)
    want = JD.write_ray_shards(str(tmp_path / "jax"), rays,
                               rng=np.random.default_rng(5), **kw)
    got = D.write_ray_shards(str(tmp_path / "port"), rays,
                             rng=np.random.default_rng(5), **kw)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("workers,start_step", [(1, 0), (2, 7)])
def test_batch_loader_matches_jax(tmp_path, workers, start_step):
    rng = np.random.default_rng(1)
    JD.write_ray_shards(str(tmp_path), rng.normal(size=(3000, 9)).astype(
        np.float32), prefix="pseudo", shard_size=700)
    JD.write_ray_shards(str(tmp_path), rng.normal(size=(900, 9)).astype(
        np.float32), prefix="train", shard_size=300)
    kw = dict(batch_size=256, seed=5, chunk=128, workers=workers,
              start_step=start_step,
              pseudo_ratio_schedule="0:0.2,10:0.9")
    want_ds = JD.RayShardDataset(str(tmp_path), pseudo_ratio=0.5)
    got_ds = D.RayShardDataset(str(tmp_path), pseudo_ratio=0.5)
    assert (got_ds.n_real, got_ds.n_pseudo, got_ds.record_dim) == (
        want_ds.n_real, want_ds.n_pseudo, want_ds.record_dim)
    jl, pl_ = JD.RayBatchLoader(want_ds, **kw), D.RayBatchLoader(got_ds, **kw)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(next(pl_), next(jl))
    finally:
        jl.close()
        pl_.close()
    for step in (0, 3, 10, 50):
        assert D.get_pseudo_ratio("0:0.2,10:0.9", step) == \
            JD.get_pseudo_ratio("0:0.2,10:0.9", step)
