"""Port parity of NeRF teacher training (r2l_tpu_torch/train.py:
``make_teacher_step``, ``make_teacher_step_batched``, ``init_teacher_state``;
r2l_tpu_torch/render.py's differentiable ``render_rays_nerf``) against
r2l_tpu/train.py, step for step from the same coarse and fine networks,
images, poses or ray pool and JAX's own draws of each step's key (the sigma
noise regularizer on), and of ``datagen.images_to_ray_records`` against
r2l_tpu/datagen.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.encoding as jenc
import r2l_tpu.render as jrender
from _torch_parity import jax_ray_draws, n, nerf_models, np_tree, t
from r2l_tpu import datagen as JD
from r2l_tpu import train as JTR
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu_torch import datagen, render
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.models import nerf_params_from_jax

H, W, FOCAL, N_IMG = 10, 12, 11.0, 3
# f32 throughout: the same arithmetic with sums in another order (XLA's and
# torch's CPU exp/sigmoid differ by an ulp; tests/test_torch_teacher.py).
TOL_LOSS, TOL_PARAMS = 1e-5, 1e-5
STEPS = 3


def _configs(n_fine=6, noise=1.0):
    jcfg = JNeRFConfig(D=4, W=32, skips=(2,), use_viewdirs=True,
                       input_ch=jenc.nerf_embed_dim(3, 6),
                       input_ch_views=jenc.nerf_embed_dim(3, 3),
                       output_ch=5, compute_dtype=jnp.float32)
    jv = jrender.VolRenderConfig(n_coarse=8, n_fine=n_fine, perturb=True,
                                 use_viewdirs=True, multires=6,
                                 multires_views=3, near=2.0, far=6.0,
                                 white_bkgd=True, raw_noise_std=noise)
    return jcfg, jv, render.VolRenderConfig(**dataclasses.asdict(jv))


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(N_IMG, H, W, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(th, -30.0, 4.0)[:3, :4]
                      for th in (0.0, 120.0, 240.0)])
    return images, poses


def _models(jcfg, n_fine):
    pc, cfg, mc = nerf_models(jcfg, seed=4)
    pf, _, mf = nerf_models(jcfg, seed=5)
    if not n_fine:
        return pc, {}, cfg, mc, None
    return pc, pf, cfg, mc, mf


def _compare_params(jstate, state):
    for jp, model in ((jstate.params_coarse, state.model_c),
                      (jstate.params_fine, state.model_f)):
        if model is None:
            continue
        want = nerf_params_from_jax(np_tree(jp))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(n(p), want[name].numpy(), rtol=0,
                                       atol=TOL_PARAMS, err_msg=name)


def _check_metrics(m, jm, i):
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL_LOSS,
                                   err_msg=(i, k))


@pytest.mark.parametrize("mode", ["rand_pixel", "rand_patch"])
@pytest.mark.parametrize("n_fine", [6, 0])
def test_teacher_step_matches_jax(mode, n_fine):
    """no_batching: a random image, its pixels (precrop box for the first
    two steps), the render with the sigma noise, fine + coarse MSE, Adam."""
    jcfg, jv, tv = _configs(n_fine)
    pc, pf, cfg, mc, mf = _models(jcfg, n_fine)
    images, poses = _scene()
    kw = dict(n_rand=32, precrop_iters=2, precrop_frac=0.5,
              select_pixel_mode=mode)
    jt, tt = JTR.TeacherTrainConfig(**kw), TR.TeacherTrainConfig(**kw)
    jstate, tx = JTR.init_teacher_state(pc, pf, jt)
    jstep = JTR.make_teacher_step(jcfg, jv, jt, tx, H, W, FOCAL)
    state = TR.init_teacher_state(mc, mf, tt)
    step = TR.make_teacher_step(cfg, tv, tt, H, W, FOCAL, device="cpu")
    for i in range(STEPS):
        key = jax.random.key(30 + i)
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(poses),
                           key)
        k_img, k_coord, k_render = jax.random.split(key, 3)
        draws = TR.TeacherStepDraws(
            torch.tensor(int(jax.random.randint(k_img, (), 0, N_IMG))),
            t(jax.random.uniform(k_coord, (2,) if mode == "rand_patch"
                                 else (32, 2))),
            jax_ray_draws(k_render, jv, 32))
        state, m = step(state, images, poses, draws=draws)
        _check_metrics(m, jm, i)
    assert state.step == int(jstate.step) == STEPS
    _compare_params(jstate, state)


def _ray_pool(n_rays=160, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 + 0.2 * rng.normal(size=(n_rays, 3))
    rgb = rng.uniform(size=(n_rays, 3))
    return np.concatenate([o, d, rgb], 1).astype(np.float32)


def test_teacher_step_batched_matches_jax():
    """use_batching: the n_rand records at the offset (the last one past the
    pool's end, clamped as dynamic_slice clamps), sigma noise on."""
    jcfg, jv, tv = _configs()
    pc, pf, cfg, mc, mf = _models(jcfg, 6)
    pool = _ray_pool()
    jt, tt = (c(n_rand=64, lrate=1e-3) for c in (JTR.TeacherTrainConfig,
                                                  TR.TeacherTrainConfig))
    jstate, tx = JTR.init_teacher_state(pc, pf, jt)
    jstep = JTR.make_teacher_step_batched(jcfg, jv, jt, tx)
    state = TR.init_teacher_state(mc, mf, tt)
    step = TR.make_teacher_step_batched(cfg, tv, tt, device="cpu")
    for i, offset in enumerate((0, 64, 128)):
        key = jax.random.key(40 + i)
        jstate, jm = jstep(jstate, jnp.asarray(pool), jnp.int32(offset), key)
        state, m = step(state, pool, offset, draws=TR.TeacherStepDraws(
            None, None, jax_ray_draws(key, jv, 64)))
        _check_metrics(m, jm, i)
    _compare_params(jstate, state)


def test_teacher_scan_steps_equal_single_steps():
    """scan_steps=3 is three single steps (batched: offsets advance by
    n_rand), with the same draws."""
    jcfg, _, tv = _configs()
    _, _, cfg, mc, mf = _models(jcfg, 6)
    pool = _ray_pool()
    tt = TR.TeacherTrainConfig(n_rand=32)
    draws = [TR.TeacherStepDraws(None, None, render.draw_chunk(
        tv, 32, torch.Generator().manual_seed(i))) for i in range(3)]

    def fresh():
        c, f = (nerf_models(jcfg, seed=s)[2] for s in (4, 5))
        return TR.init_teacher_state(c, f, tt)

    one = TR.make_teacher_step_batched(cfg, tv, tt, device="cpu")
    three = TR.make_teacher_step_batched(cfg, tv, tt, scan_steps=3,
                                         device="cpu")
    s1, losses = fresh(), []
    for i in range(3):
        s1, m = one(s1, pool, 32 * i, draws=draws[i])
        losses.append(m["loss"])
    s3, ms = three(fresh(), pool, 0, draws=draws)
    assert torch.equal(torch.stack(losses), ms["loss"]) and s3.step == 3
    for a, b in zip(TR._teacher_params(s1.model_c, s1.model_f),
                    TR._teacher_params(s3.model_c, s3.model_f)):
        assert torch.equal(a, b)


def test_teacher_step_draws_from_a_generator():
    """Without draws, images mode draws the image, the pixels and the
    render's draws from the generator: the same seed, the same loss."""
    jcfg, _, tv = _configs()
    _, _, cfg, _, _ = _models(jcfg, 6)
    images, poses = _scene()
    tt = TR.TeacherTrainConfig(n_rand=16, select_pixel_mode="rand_patch")
    step = TR.make_teacher_step(cfg, tv, tt, H, W, FOCAL, scan_steps=2,
                                device="cpu")
    losses = []
    for _ in range(2):
        c, f = (nerf_models(jcfg, seed=s)[2] for s in (4, 5))
        s, ms = step(TR.init_teacher_state(c, f, tt), t(images), t(poses),
                     generator=torch.Generator().manual_seed(3))
        assert s.step == 2 and torch.isfinite(ms["loss"]).all()
        losses.append(ms["loss"])
    assert torch.equal(*losses)


def test_render_rays_nerf_stops_gradients_where_jax_does():
    """The fine samples are placed without a gradient: the coarse network's
    gradient of the fine MSE alone is zero; the frame render keeps no
    graph."""
    jcfg, _, tv = _configs(noise=0.0)
    _, _, cfg, mc, mf = _models(jcfg, 6)
    o, d = (t(a) for a in np.split(_ray_pool(20)[:, :6], 2, axis=1))
    draws = render.draw_chunk(tv, 20, torch.Generator().manual_seed(0))
    out = render.render_rays_nerf(mc, mf, cfg, tv, o, d, draws)
    out.rgb_map.sum().backward()
    assert all(p.grad is None for p in mc.parameters())
    assert any(p.grad is not None and p.grad.abs().sum() > 0
               for p in mf.parameters())
    frame = render.render_frame_nerf(mc, mf, cfg, tv, o, d)
    assert not frame["rgb"].requires_grad


@pytest.mark.parametrize("ndc,donerf", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_images_to_ray_records_matches_jax(ndc, donerf):
    """o and d bit for bit (the rotation rounds as XLA's einsum), rgb
    copied, in the same order."""
    images, poses = _scene(2)
    want = JD.images_to_ray_records(images, poses, H, W, FOCAL, ndc=ndc,
                                    donerf=donerf)
    got = datagen.images_to_ray_records(images, poses, H, W, FOCAL,
                                        ndc=ndc, donerf=donerf, device="cpu")
    assert got.shape == want.shape == (N_IMG * H * W, 9)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    import inspect
    assert inspect.signature(datagen.images_to_ray_records).parameters[
        "device"].default == torch.device("cuda")


@pytest.mark.parametrize("fn", [TR.make_teacher_step,
                                TR.make_teacher_step_batched,
                                TR.make_distill_step_images])
def test_training_entry_points_default_to_the_card(fn):
    """They run on the card unless told otherwise; without one, a step
    called without device='cpu' raises instead of running on the CPU."""
    import inspect
    assert inspect.signature(fn).parameters["device"].default == \
        torch.device("cuda")
    if torch.cuda.is_available():
        return
    jcfg, _, tv = _configs()
    _, _, cfg, mc, mf = _models(jcfg, 6)
    tt = TR.TeacherTrainConfig(n_rand=8)
    images, poses = _scene()
    state = TR.init_teacher_state(mc, mf, tt)
    step = (TR.make_teacher_step(cfg, tv, tt, H, W, FOCAL)
            if fn is TR.make_teacher_step
            else TR.make_teacher_step_batched(cfg, tv, tt))
    with pytest.raises((RuntimeError, AssertionError)):
        if fn is TR.make_teacher_step_batched:
            step(state, _ray_pool(), 0)
        else:
            step(state, images, poses)
