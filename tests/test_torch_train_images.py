"""Port parity of the images data mode of distillation
(r2l_tpu_torch/train.py: ``make_distill_step_images``, ``_patch_dims``,
the pixel selection) against r2l_tpu/train.py, step for step from the same
params, image, pose and JAX's own draws of each step's key, at the config of
tests/test_torch_train_step.py (W32, D8, 6-d points, L=4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_step_draws, models, n, np_tree, t
from r2l_tpu import train as JTR
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.models import params_from_jax
from r2l_tpu_torch.sampler import PointSampler

DIM, L, H, W, FOCAL = 6, 4, 12, 10, 11.0
# Losses: f32 the same arithmetic in another order (the rays' rotation
# rounds a few ulp apart: einsum against three products); bf16 the plain
# module's and XLA's bf16 dots round differently (test_torch_train_step).
TOL_LOSS = {"f32": 1e-5, "bf16": 2e-3}
TOL_PARAMS_F32 = 1e-5


def _dcfg():
    return dict(batch_size=64, n_hard_in=8, n_hard_out=16, hard_mul=2.0,
                embed_L=L, perturb=True, warmup_lr="0.0001,3")


def _jax_image_draws(key, dcfg, mode):
    """The draws of JAX's images step from its key: the pixels' from
    k_coord, then the rays-mode step's from k_core."""
    k_coord, k_core = jax.random.split(key)
    n_fresh = dcfg.batch_size - dcfg.n_hard_out
    u = jax.random.uniform(k_coord, (2,) if mode == "rand_patch"
                           else (n_fresh, 2))
    return TR.ImageStepDraws(t(u), jax_step_draws(k_core, dcfg, 2))


@pytest.mark.parametrize("mode", ["rand_pixel", "rand_patch"])
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_distill_step_images_matches_jax(cd, mode):
    """Three steps, the first two inside the precrop box: losses, PSNR and
    (f32) the parameters against JAX's."""
    jcd = jnp.float32 if cd == "f32" else jnp.bfloat16
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=8, netwidth=32,
                        compute_dtype=jcd,
                        precision="highest" if cd == "f32" else "default")
    params, cfg, model = models(jcfg, seed=0)
    jdcfg, dcfg = JTR.DistillConfig(**_dcfg()), TR.DistillConfig(**_dcfg())
    kw = dict(H=H, W=W, focal=FOCAL, n_sample=2, near=2.0, far=6.0)
    jsampler, sampler = JaxPointSampler(**kw), PointSampler(**kw)
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(3, H, W, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(th, -30.0, 4.0)[:3, :4]
                      for th in (10.0, 130.0, 250.0)])
    jstate, tx = JTR.init_train_state(jax.random.key(4),
                                      jax.tree.map(jnp.array, params), jdcfg)
    step_kw = dict(precrop_iters=2, precrop_frac=0.5, select_pixel_mode=mode)
    jstep = JTR.make_distill_step_images(jcfg, jdcfg, jsampler, tx, H, W,
                                         FOCAL, **step_kw)
    state = TR.init_train_state(model, dcfg, device="cpu")
    step = TR.make_distill_step_images(cfg, dcfg, sampler, H, W, FOCAL,
                                       device="cpu", **step_kw)
    for i in range(3):
        key = jax.random.key(20 + i)
        jstate, jm = jstep(jstate, jnp.asarray(images[i]),
                           jnp.asarray(poses[i]), key)
        state, m = step(state, images[i], t(poses[i]),
                        draws=_jax_image_draws(key, dcfg, mode))
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=TOL_LOSS[cd], err_msg=(i, k))
    assert state.step == int(jstate.step) == 3
    if cd == "f32":
        want = params_from_jax(np_tree(jstate.params), cfg)
        for name, p in state.params.named_parameters():
            np.testing.assert_allclose(n(p), want[name].numpy(), rtol=0,
                                       atol=TOL_PARAMS_F32, err_msg=name)


@pytest.mark.parametrize("H_,W_,n_", [(12, 10, 48), (400, 400, 1024),
                                      (8, 100, 90), (100, 8, 90),
                                      (378, 504, 4096), (5, 5, 25)])
def test_patch_dims_match_jax(H_, W_, n_):
    assert TR._patch_dims(H_, W_, n_) == JTR._patch_dims(H_, W_, n_)
    ph, pw = TR._patch_dims(H_, W_, n_)
    assert ph * pw >= n_ and ph <= H_ and pw <= W_


@pytest.mark.parametrize("crop", [True, False])
def test_patch_coords_match_jax(crop):
    """The patch's pixels from JAX's draws, in and out of the precrop box."""
    H_, W_, n_ = 40, 30, 100
    ph, pw = TR._patch_dims(H_, W_, n_)
    dH, dW = int(H_ // 2 * 0.5), int(W_ // 2 * 0.5)
    box = TR._precrop_box(H_, W_, dH, dW, crop)
    for seed in range(5):
        k = jax.random.key(seed)
        want = JTR._patch_coords(k, *box, H_, W_, n_, ph, pw)
        got = TR._pixel_coords(t(jax.random.uniform(k, (2,))), box, H_, W_,
                               n_, "rand_patch")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_images_step_draws_from_a_generator_repeat():
    """Without draws the step draws from the generator: the same seed, the
    same state."""
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=4, netwidth=16)
    _, cfg, model = models(jcfg, seed=1)
    dcfg = TR.DistillConfig(**_dcfg())
    sampler = PointSampler(H=H, W=W, focal=FOCAL, n_sample=2, near=2.0,
                           far=6.0)
    image = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(
        np.float32)
    pose = t(pose_spherical(40.0, -30.0, 4.0)[:3, :4])
    step = TR.make_distill_step_images(cfg, dcfg, sampler, H, W, FOCAL,
                                       scan_steps=2, device="cpu")
    outs = []
    for _ in range(2):
        s0 = TR.init_train_state(TR.clone_train_state(TR.init_train_state(
            model, dcfg, device="cpu")).params, dcfg, device="cpu")
        s, ms = step(s0, np.stack([image] * 2), torch.stack([pose] * 2),
                     generator=torch.Generator().manual_seed(7))
        assert s.step == 2 and ms["loss"].shape == (2,)
        outs.append([p.detach().clone() for p in s.params.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
