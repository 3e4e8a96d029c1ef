"""Port parity of the distillation step (r2l_tpu_torch/train.py) against
r2l_tpu/train.py: the learning-rate schedule, Adam against optax, and
make_distill_step (plain and fused, from the same params, fresh batch and
JAX's own draws of each step's key) step for step, at the config of
tests/test_train_pallas.py:14-17."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import jax_step_draws, models, n, np_tree, t
from r2l_tpu import train as JTR
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.models import params_from_jax
from r2l_tpu_torch.sampler import PointSampler

DIM, L = 6, 4
# The schedule and one Adam update: both in f32 with the same formulas;
# numpy's pow and XLA's, and torch's and optax's order of the Adam
# arithmetic, differ by ulps.
TOL_LR, TOL_ADAM = 1e-6, 1e-6
# Losses of a step. f32: the same arithmetic in another summation order.
# bf16: the plain kind's torch and XLA round the bf16 dots differently, the
# fused kind's plain versions and the Pallas kernels agree to a flipped
# bf16 rounding here and there (tests/test_train_pallas.py:119 bounds the
# fused-vs-XLA loss at 2e-2).
TOL_LOSS = {"f32": 1e-5, "bf16": 2e-3}


def _dcfg(**kw):
    return dict(batch_size=64, n_hard_in=8, n_hard_out=16, hard_mul=2.0,
                embed_L=L, perturb=True, warmup_lr="0.0001,3", **kw)


def _samplers():
    kw = dict(H=8, W=8, focal=8.0, n_sample=2, near=2.0, far=6.0)
    return JaxPointSampler(**kw), PointSampler(**kw)


def _jax_draws(key, dcfg):
    """The draws JAX's _distill_core makes from a step's key."""
    return jax_step_draws(key, dcfg, 2)


@pytest.mark.parametrize("warmup", [None, "0.0001,200", (1e-5, 37)])
def test_lr_schedule_matches_jax(warmup):
    want = JTR.make_lr_schedule(5e-4, 250, warmup)
    got = TR.make_lr_schedule(5e-4, 250, warmup)
    for step in range(301):
        np.testing.assert_allclose(got(step), float(want(step)),
                                   rtol=TOL_LR, err_msg=str(step))


def test_adam_matches_optax():
    """Three updates with a warm-up schedule: torch Adam with the learning
    rate set from the schedule at the count before the update equals
    optax.adam, whose schedule reads the count before its increment, and
    both put eps outside the square root."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * 10.0 ** -k
             for k in range(3)]
    tx = JTR.make_optimizer(5e-4, 250, "0.0001,2")
    w, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(w)
    param = torch.nn.Parameter(t(w0))
    opt = TR.make_optimizer([param], 5e-4)
    sched = TR.make_lr_schedule(5e-4, 250, "0.0001,2")
    for step, g in enumerate(grads):
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = optax.apply_updates(w, upd)
        param.grad = t(g)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        np.testing.assert_allclose(n(param), np.asarray(w), rtol=TOL_ADAM,
                                   atol=1e-9)


def _run_both(cd, fused, quantize="", steps=4, stash_q=True, **step_kw):
    """(JAX losses, port losses, JAX state, port state) of ``steps`` steps
    from the same params, batch and draws."""
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=8,
                        netwidth=32, compute_dtype=cd,
                        precision="highest" if cd == jnp.float32
                        else "default")
    params, cfg, model = models(jcfg, seed=0)
    jdcfg = JTR.DistillConfig(**_dcfg())
    dcfg = TR.DistillConfig(**_dcfg())
    jsampler, sampler = _samplers()
    rng = np.random.default_rng(3)
    fresh = rng.uniform(size=(48, 9)).astype(np.float32)
    calib = rng.uniform(-2.0, 2.0, (32, DIM)).astype(np.float32)
    jstate, tx = JTR.init_train_state(jax.random.key(4),
                                      jax.tree.map(jnp.array, params), jdcfg)
    jstep = JTR.make_distill_step(
        jcfg, jdcfg, jsampler, tx, fused_vjp=fused, fused_tile=32,
        fused_group_blocks=2, fused_quantize=quantize,
        fused_calib_pts=jnp.asarray(calib) if quantize else None,
        fused_stash_q=stash_q)
    state = TR.init_train_state(model, dcfg, device="cpu")
    step = TR.make_distill_step(
        cfg, dcfg, sampler, fused_vjp=fused, fused_group_blocks=2,
        fused_quantize=quantize, fused_calib_pts=t(calib) if quantize
        else None, fused_stash_q=stash_q, device="cpu", **step_kw)
    jl, pl_, pools = [], [], []
    for i in range(steps):
        key = jax.random.key(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(fresh), key)
        state, m = step(state, fresh, draws=_jax_draws(key, dcfg))
        jl.append(float(jm["loss"]))
        pl_.append(float(m["loss"]))
        # copies: the JAX step donates its state, the port's updates the
        # pool in place
        pools.append((np.array(jstate.pool.rays), n(state.pool.rays).copy(),
                      int(jstate.pool.size), int(state.pool.size)))
    return jl, pl_, pools, jstate, state, cfg


@pytest.mark.parametrize("kind", ["xla", "fused"])
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_distill_step_matches_jax(kind, cd):
    jl, pl_, pools, jstate, state, cfg = _run_both(
        jnp.float32 if cd == "f32" else jnp.bfloat16, kind == "fused")
    np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS[cd])
    assert pl_[-1] < pl_[0]
    want_pool, got_pool, want_size, got_size = pools[0]
    assert got_size == want_size == 8
    np.testing.assert_array_equal(got_pool, want_pool)   # after step 1
    assert state.step == int(jstate.step) == 4
    if cd == "f32":
        want = params_from_jax(np_tree(jstate.params), cfg)
        for name, p in state.params.named_parameters():
            np.testing.assert_allclose(n(p), want[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_distill_step_int8_matches_jax():
    jl, pl_, _, _, _, _ = _run_both(jnp.bfloat16, True, quantize="int8",
                                    steps=3)
    np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS["bf16"])


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_distill_step_int8_bf16_stash_matches_jax(cd):
    """fused_stash_q=False: three steps of the int8 forward with the bf16
    stash (K8 + K5) against JAX's, with either compute dtype."""
    jl, pl_, _, jstate, state, _ = _run_both(
        jnp.float32 if cd == "f32" else jnp.bfloat16, True, quantize="int8",
        steps=3, stash_q=False)
    np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS["bf16"])
    assert state.step == int(jstate.step) == 3


def test_scan_steps_equal_single_steps():
    """scan_steps=3 over batches [3, B, D] is three single steps."""
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=8,
                        netwidth=32, compute_dtype=jnp.float32)
    _, cfg, model = models(jcfg, seed=0)
    dcfg = TR.DistillConfig(**_dcfg())
    _, sampler = _samplers()
    batches = np.random.default_rng(5).uniform(size=(3, 48, 9)).astype(
        np.float32)
    draws = [TR.draw_step(dcfg, 2, torch.Generator().manual_seed(i))
             for i in range(3)]
    s1 = TR.init_train_state(model, dcfg, device="cpu")
    s3 = TR.clone_train_state(s1)
    one = TR.make_distill_step(cfg, dcfg, sampler, device="cpu")
    three = TR.make_distill_step(cfg, dcfg, sampler, scan_steps=3,
                                 device="cpu")
    losses = []
    for i in range(3):
        s1, m = one(s1, batches[i], draws=draws[i])
        losses.append(m["loss"])
    s3, ms = three(s3, batches, draws=draws)
    assert torch.equal(torch.stack(losses), ms["loss"]) and s3.step == 3
    for a, b in zip(s1.params.parameters(), s3.params.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(s1.pool.rays, s3.pool.rays)


def test_distill_step_calib_every(monkeypatch):
    """fused_calib_every=2 with scan_steps=3 (test_distill_step_calib_every
    of the JAX package): a calibration at the call's entry and one at step 2;
    step 1 equals one step of the every-step path with the same draws, bit
    for bit; the three losses follow JAX's scanned step."""
    calls = []
    real = T.calibrate_r2l_int8_pe
    monkeypatch.setattr(T, "calibrate_r2l_int8_pe",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=8,
                        netwidth=32, compute_dtype=jnp.bfloat16)
    params, cfg, model = models(jcfg, seed=0)
    jdcfg, dcfg = JTR.DistillConfig(**_dcfg()), TR.DistillConfig(**_dcfg())
    jsampler, sampler = _samplers()
    rng = np.random.default_rng(3)
    fresh = rng.uniform(size=(48, 9)).astype(np.float32)
    calib = rng.uniform(-2.0, 2.0, (32, DIM)).astype(np.float32)
    jstate, tx = JTR.init_train_state(jax.random.key(4),
                                      jax.tree.map(jnp.array, params), jdcfg)
    jscan = JTR.make_distill_step(
        jcfg, jdcfg, jsampler, tx, fused_vjp=True, fused_tile=32,
        fused_group_blocks=2, fused_quantize="int8",
        fused_calib_pts=jnp.asarray(calib), scan_steps=3,
        fused_calib_every=2)
    _, jms, _ = jscan(jstate, jnp.stack([jnp.asarray(fresh)] * 3),
                      jax.random.key(10))
    key, draws = jax.random.key(10), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, dcfg))
    kw = dict(fused_vjp=True, fused_group_blocks=2, fused_quantize="int8",
              fused_calib_pts=t(calib), device="cpu")
    state = TR.init_train_state(model, dcfg, device="cpu")
    first = TR.clone_train_state(state)
    scan = TR.make_distill_step(cfg, dcfg, sampler, scan_steps=3,
                                fused_calib_every=2, **kw)
    state, ms = scan(state, np.stack([fresh] * 3), draws=draws)
    assert len(calls) == 2 and state.step == 3
    np.testing.assert_allclose(n(ms["loss"]), np.asarray(jms["loss"]),
                               rtol=TOL_LOSS["bf16"])
    _, m1 = TR.make_distill_step(cfg, dcfg, sampler, **kw)(
        first, fresh, draws=draws[0])
    assert float(m1["loss"]) == float(ms["loss"][0])


@pytest.mark.parametrize("flags,ok", [
    (dict(), True), (dict(n_devices=2), False), (dict(plucker_=True), False),
    (dict(netwidth=192), False), (dict(n_learnable=3), False),
    (dict(body_arch="mlp"), False), (dict(fused_train_vjp=False), False)])
def test_fused_vjp_gate(flags, ok):
    """The rule of r2l_tpu/app.py:815-824, with its warning."""
    cfg = TR.R2LConfig(input_dim=48 * 21, netdepth=8, netwidth=256)
    cfg = dataclasses.replace(cfg, **{k: v for k, v in flags.items()
                                      if k in ("netwidth", "n_learnable",
                                               "body_arch")})
    logs = []
    got = TR.fused_vjp_gate(flags.get("fused_train_vjp", True), cfg,
                            flags.get("plucker_", False),
                            flags.get("n_devices", 1), log=logs.append)
    assert got == ok
    assert bool(logs) == (not ok and flags.get("fused_train_vjp", True))


def test_fused_int8_calib_points_match_app():
    """The sub-sampler and pose pick of r2l_tpu/app.py:831-839."""
    poses = np.stack([pose_spherical(th, -30.0, 4.0)
                      for th in np.linspace(0, 360, 9, endpoint=False)])
    H, W, focal = 40, 24, 30.0
    sub = JaxPointSampler(H=max(H // 8, 4), W=max(W // 8, 4),
                          focal=focal / 8.0, n_sample=3, near=2.0, far=6.0)
    pick = np.linspace(0, len(poses) - 1, min(len(poses), 6)).astype(int)
    want = np.concatenate([np.asarray(sub.sample_test(jnp.asarray(
        poses[i][:3, :4]))) for i in pick])
    got = TR.fused_int8_calib_points(H, W, focal, 3, 2.0, 6.0, poses,
                                     device="cpu")
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-6)


def test_distill_config_checks():
    with pytest.raises(ValueError):
        TR.DistillConfig(batch_size=64, n_hard_out=40)
    with pytest.raises(ValueError):
        TR.DistillConfig(batch_size=64, n_hard_out=16, hard_mul=0.1)
