"""Port parity: ray geometry, point sampling and positional encoding
(r2l_tpu_torch/rays.py, sampler.py, encoding.py against r2l_tpu)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import r2l_tpu.encoding as jenc
import r2l_tpu.rays as jrays
import r2l_tpu.sampler as jsamp
from _torch_parity import n, t
from r2l_tpu_torch import encoding, rays, sampler

# f32 geometry: the two frameworks round the same formulas at slightly
# different points (linspace, einsum vs elementwise rotation), a few ulp
# at coordinates of size ~10.
TOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _pose(theta, phi, radius=4.0):
    return jrays.pose_spherical(theta, phi, radius)[:3, :4]


@pytest.mark.parametrize("H,W,focal", [(8, 8, 10.0), (12, 16, 14.5)])
def test_camera_ray_dirs(H, W, focal):
    want = np.asarray(jrays.camera_ray_dirs(H, W, focal))
    got = n(rays.camera_ray_dirs(H, W, focal))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("theta,phi,radius", [(0.0, -30.0, 4.0),
                                              (75.0, -60.0, 3.5),
                                              (-140.0, -10.0, 4.0)])
def test_pose_spherical_matches(theta, phi, radius):
    np.testing.assert_array_equal(rays.pose_spherical(theta, phi, radius),
                                  jrays.pose_spherical(theta, phi, radius))


def test_plucker():
    rng = np.random.default_rng(0)
    o, d = rng.normal(size=(2, 10, 3)).astype(np.float32)
    want = np.asarray(jrays.plucker(jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_allclose(n(rays.plucker(t(o), t(d))), want,
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("n_sample", [2, 16])
def test_sample_test(n_sample):
    js = jsamp.PointSampler(H=8, W=8, focal=10.0, n_sample=n_sample,
                            near=2.0, far=6.0)
    ts = sampler.PointSampler(H=8, W=8, focal=10.0, n_sample=n_sample,
                              near=2.0, far=6.0)
    c2w = _pose(30.0, -30.0)
    want = np.asarray(js.sample_test(jnp.asarray(c2w)))
    got = n(ts.sample_test(t(c2w)))
    assert got.shape == want.shape == (64, 3 * n_sample)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(n(ts.z_vals()), np.asarray(js.z_vals),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(n(ts.sample_test_plucker(t(c2w))),
                               np.asarray(js.sample_test_plucker(
                                   jnp.asarray(c2w))), rtol=0, atol=TOL)


def test_sample_train_given_z():
    """Stratified depths drawn once with numpy and given to both sides
    (the JAX side takes them through ``ray_points``, as ``sample_train``
    does with its own draw)."""
    rng = np.random.default_rng(1)
    ro = rng.normal(size=(20, 3)).astype(np.float32)
    rd = rng.normal(size=(20, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, size=(20, 8)), axis=1).astype(
        np.float32)
    ts = sampler.PointSampler(H=4, W=5, focal=5.0, n_sample=8, near=2.0,
                              far=6.0)
    js = jsamp.PointSampler(H=4, W=5, focal=5.0, n_sample=8, near=2.0,
                            far=6.0)
    want = np.asarray(jsamp.ray_points(jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(z))).reshape(20, -1)
    np.testing.assert_allclose(n(ts.sample_train(t(ro), t(rd), t(z))),
                               want, rtol=0, atol=TOL)
    # z=None is the even (unperturbed) sampling of the JAX key=None path
    np.testing.assert_allclose(
        n(ts.sample_train(t(ro), t(rd))),
        np.asarray(js.sample_train(jnp.asarray(ro), jnp.asarray(rd))),
        rtol=0, atol=TOL)


def test_frame_rays_match_golden_fixture():
    """``frame_rays`` against the original torch ``get_rays`` output frozen
    in tests/fixtures/geometry_golden.npz."""
    fx = np.load(os.path.join(FIXTURES, "geometry_golden.npz"))
    H, W, focal = int(fx["H"]), int(fx["W"]), float(fx["focal"])
    ts = sampler.PointSampler(H=H, W=W, focal=focal, n_sample=2, near=2.0,
                              far=6.0)
    ro, rd = ts.frame_rays(t(fx["c2w"]))
    np.testing.assert_allclose(n(ro), fx["rays_o"].reshape(-1, 3),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(n(rd), fx["rays_d"].reshape(-1, 3),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("L,include_input", [(10, True), (4, True),
                                             (4, False)])
def test_r2l_embed(L, include_input):
    x = np.random.default_rng(2).uniform(-3, 3, size=(7, 48)).astype(
        np.float32)
    want = np.asarray(jenc.r2l_embed(jnp.asarray(x), L, include_input))
    got = n(encoding.r2l_embed(t(x), L, include_input))
    assert got.shape == want.shape
    # sin(x*2^9) at |x|<=3: f32 arguments up to ~1.5e3, where the two
    # libraries' range reductions differ by a few ulp of the argument
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n_sample", [1, 2, 16, 64])
def test_even_z_vals_bitwise(n_sample):
    """near*(1-t)+far*t with jnp.linspace's own t, bit for bit."""
    got = n(sampler.even_z_vals(2.0, 6.0, n_sample))
    np.testing.assert_array_equal(got, np.asarray(
        jsamp.even_z_vals(2.0, 6.0, n_sample)))
    assert got[0] == 2.0 and (n_sample == 1 or got[-1] == 6.0)
