"""Port parity of the fused training kernels' module
(r2l_tpu_torch/kernels/r2l_train.py) against
r2l_tpu/kernels/r2l_train_pallas.py with its Pallas kernels in interpret
mode, at the config of tests/test_train_pallas.py:14-17 (W32, D8, 6-d
points, L=4, 64 rays): the plain versions of train_fwd, train_fwd_int8 and
bwd_group (the wrappers take them for CPU tensors), and the gradients of
the autograd Function against make_fused_train_apply's custom VJP."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import models, n, np_tree, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.kernels import r2l_train_pallas as JT
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.models import params_from_jax

DIM, L, N, TILE = 6, 4, 64, 32
# f32: the same chain, sums in another order.
TOL_F32 = 1e-5
# bf16 (tests/test_train_pallas.py:35, 88-92): a one-ulp difference in an
# f32 sum can flip a bf16 rounding, which propagates. Forward: max-abs 2e-2
# (stash rows relative to their largest value); gradients: norm-relative
# 5e-2 and under 2e-3 of the entries off by more than 5e-2 of the max.
TOL_BF16, TOL_GRAD_BF16, MAX_BAD = 2e-2, 5e-2, 2e-3
# int8 (tests/test_pallas_int8_pe.py:45-46): exact int32 sums, the same
# epilogue; an ulp of XLA's sin against torch's can flip a requantize: rgb
# within 2.5e-2 max / 2.5e-3 RMS, stash q-values one step apart on under
# 0.1% of the values.
TOL_INT8_MAX, TOL_INT8_RMS, MAX_Q_SHARE = 2.5e-2, 2.5e-3, 1e-3


def _case(cd):
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=8,
                        netwidth=32, compute_dtype=cd,
                        precision="highest" if cd == jnp.float32
                        else "default")
    params, cfg, model = models(jcfg, seed=0)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2.0, 2.0, (N, DIM)).astype(np.float32)
    tgt = rng.uniform(size=(N, 3)).astype(np.float32)
    return jcfg, params, cfg, model, pts, tgt


def _grad_ok(got, want, f32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    if f32:
        return rel < TOL_F32, rel
    bad = np.mean(np.abs(got - want) / max(np.abs(want).max(), 1e-12) > 5e-2)
    return rel < TOL_GRAD_BF16 and bad < MAX_BAD, (rel, bad)


@pytest.mark.parametrize("cd", [jnp.float32, jnp.bfloat16])
def test_train_fwd_ref_matches_pallas(cd):
    jcfg, params, cfg, model, pts, _ = _case(cd)
    jfp = JP.prepare_fused_params_pe(params, jcfg, DIM, L, weight_dtype=cd)
    jrgb, jstash = JT.train_fwd(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                tile=TILE, interpret=True)
    fp = F.prepare_fused_params_pe(model, cfg, DIM, L,
                                   weight_dtype=cfg.compute_dtype)
    rgb, stash = T.train_fwd(fp, cfg, t(pts), DIM, L)
    want = np.asarray(jstash, np.float32)
    assert stash.shape == want.shape and stash.dtype == cfg.compute_dtype
    row = np.abs(n(stash) - want).max(axis=(1, 2))
    if cd == jnp.float32:
        np.testing.assert_allclose(n(rgb), np.asarray(jrgb), atol=TOL_F32)
        assert row.max() < TOL_F32
    else:
        np.testing.assert_allclose(n(rgb), np.asarray(jrgb), atol=TOL_BF16)
        assert (row / np.maximum(np.abs(want).max(axis=(1, 2)), 1)).max() \
            < TOL_BF16


def test_train_fwd_int8_ref_matches_pallas():
    jcfg, params, cfg, model, pts, _ = _case(jnp.bfloat16)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM, L,
                                   calib_pts=jnp.asarray(pts))
    jrgb, jstash = JT.train_fwd_int8(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                     tile=TILE, interpret=True, stash_q=True)
    fp = F.calibrate_r2l_int8_pe(model, cfg, DIM, L, t(pts),
                                 fold_requant=False)
    rgb, stash = T.train_fwd_int8(fp, cfg, t(pts), DIM, L, stash_q=True)
    d = n(rgb) - np.asarray(jrgb)
    assert np.abs(d).max() < TOL_INT8_MAX
    assert np.sqrt(np.mean(d * d)) < TOL_INT8_RMS
    assert stash.dtype == torch.int8
    dq = np.abs(stash.numpy().astype(np.int32) - np.asarray(jstash, np.int32))
    assert dq.max() <= 1 and np.mean(dq > 0) < MAX_Q_SHARE


@pytest.mark.parametrize("cd", [jnp.float32, jnp.bfloat16])
def test_train_fwd_int8_bf16_stash_ref_matches_pallas(cd):
    """stash_q=False, the default of both: int8 matmuls, the bf16 stash of
    train_fwd's rows (the residual stream rounded to bf16 each block). The
    stash is bf16 whatever the compute dtype, as in JAX."""
    jcfg, params, cfg, model, pts, _ = _case(cd)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM, L,
                                   calib_pts=jnp.asarray(pts))
    jrgb, jstash = JT.train_fwd_int8(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                     tile=TILE, interpret=True)
    fp = F.calibrate_r2l_int8_pe(model, cfg, DIM, L, t(pts),
                                 fold_requant=False)
    rgb, stash = T.train_fwd_int8(fp, cfg, t(pts), DIM, L)
    d = n(rgb) - np.asarray(jrgb)
    assert np.abs(d).max() < TOL_INT8_MAX
    assert np.sqrt(np.mean(d * d)) < TOL_INT8_RMS
    want = np.asarray(jstash, np.float32)
    assert stash.dtype == torch.bfloat16 and stash.shape == want.shape
    row = np.abs(n(stash) - want).max(axis=(1, 2))
    assert (row / np.maximum(np.abs(want).max(axis=(1, 2)), 1)).max() \
        < TOL_BF16


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b_start,b_count", [(0, 3), (1, 2)])
def test_bwd_group_ref_matches_pallas(kind, b_start, b_count):
    cd = jnp.float32 if kind == "f32" else jnp.bfloat16
    jcfg, params, cfg, model, pts, _ = _case(cd)
    nb, W = cfg.num_blocks, cfg.netwidth
    if kind == "int8":
        jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM, L,
                                       calib_pts=jnp.asarray(pts))
        _, jstash = JT.train_fwd_int8(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                      tile=TILE, interpret=True,
                                      stash_q=True)
        jscale = 1.0 / jfp.body_inv
        stash = torch.from_numpy(np.array(jstash, np.int8))
        scale = t(jscale)
    else:
        jfp = JP.prepare_fused_params_pe(params, jcfg, DIM, L,
                                         weight_dtype=cd)
        _, jstash = JT.train_fwd(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                 tile=TILE, interpret=True)
        jscale = scale = None
        stash = t(np.asarray(jstash, np.float32)).to(cfg.compute_dtype)
    dh = np.random.default_rng(2).normal(size=(N, W)).astype(np.float32)
    jbody = params["body"]["w"].reshape(2 * nb, W, W).astype(cd)
    want = JT.bwd_group(jbody, jstash, jnp.asarray(dh), jcfg, b_start,
                        b_count, tile=TILE, interpret=True,
                        body_scale=jscale)
    body_w = F.prepare_fused_params_pe(
        model, cfg, DIM, L, weight_dtype=cfg.compute_dtype).body_w
    got = T.bwd_group(body_w, stash, t(dh), cfg, b_start, b_count,
                      body_scale=scale)
    assert got[1].shape == (2 * b_count, W, W)
    for g, w, what in zip(got, (want[0], np.swapaxes(np.asarray(want[1]),
                                                     -1, -2), want[2]),
                          ("dh", "dW", "db")):
        ok, err = _grad_ok(n(g), w, kind == "f32")
        assert ok, (what, err)


@pytest.mark.parametrize("cd", [jnp.float32, jnp.bfloat16])
def test_bwd_group_bf16_stash_ref_matches_pallas(cd):
    """K5 on the int8 forward's bf16 stash: with f32 weights JAX walks the
    bf16 rows in f32 (the pairing K5 takes on the card as well)."""
    jcfg, params, cfg, model, pts, _ = _case(cd)
    nb, W = cfg.num_blocks, cfg.netwidth
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM, L,
                                   calib_pts=jnp.asarray(pts))
    _, jstash = JT.train_fwd_int8(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                  tile=TILE, interpret=True)
    assert jstash.dtype == jnp.bfloat16
    stash = t(np.asarray(jstash, np.float32)).to(torch.bfloat16)
    dh = np.random.default_rng(2).normal(size=(N, W)).astype(np.float32)
    jbody = params["body"]["w"].reshape(2 * nb, W, W).astype(cd)
    want = JT.bwd_group(jbody, jstash, jnp.asarray(dh), jcfg, 0, nb,
                        tile=TILE, interpret=True)
    body_w = F.prepare_fused_params_pe(
        model, cfg, DIM, L, weight_dtype=cfg.compute_dtype).body_w
    got = T.bwd_group(body_w, stash, t(dh), cfg, 0, nb)
    for g, w, what in zip(got, (want[0], np.swapaxes(np.asarray(want[1]),
                                                     -1, -2), want[2]),
                          ("dh", "dW", "db")):
        ok, err = _grad_ok(n(g), w, cd == jnp.float32)
        assert ok, (what, err)


def _jax_grads(fused_apply, params, pts, tgt):
    return jax.value_and_grad(lambda p: jnp.mean(
        (fused_apply(p, jnp.asarray(pts)) - tgt) ** 2))(params)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_fused_apply_grads_match_jax(kind):
    """The autograd Function's gradients, in the R2L module's parameters,
    against jax.grad through make_fused_train_apply's custom VJP."""
    cd = jnp.float32 if kind == "f32" else jnp.bfloat16
    jcfg, params, cfg, model, pts, tgt = _case(cd)
    q = dict(quantize="int8") if kind == "int8" else {}
    japply = JT.make_fused_train_apply(
        jcfg, DIM, L, tile=TILE, group_blocks=2, compute_dtype=cd,
        interpret=True, calib_pts=jnp.asarray(pts) if q else None, **q)
    jloss, jgrads = _jax_grads(japply, params, pts, tgt)
    apply = T.make_fused_train_apply(cfg, DIM, L, group_blocks=2,
                                     compute_dtype=cfg.compute_dtype,
                                     calib_pts=t(pts) if q else None, **q)
    loss = torch.mean((apply(model, t(pts)) - t(tgt)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=TOL_F32 if kind == "f32" else 1e-3)
    want = params_from_jax(np_tree(jgrads), cfg)
    for name, p in model.named_parameters():
        ok, err = _grad_ok(n(p.grad), want[name].numpy(), kind == "f32")
        assert ok, (name, err)


@pytest.mark.parametrize("cd", [jnp.float32, jnp.bfloat16])
def test_fused_apply_bf16_stash_grads_match_jax(cd):
    """stash_q=False: the int8 forward K8, K5 on its bf16 stash (with f32 or
    bf16 weights), and the tail edge rebuilt from the stashed bf16 rows
    (JAX's straight-through edge): loss and gradients against JAX's."""
    jcfg, params, cfg, model, pts, tgt = _case(cd)
    japply = JT.make_fused_train_apply(
        jcfg, DIM, L, tile=TILE, group_blocks=2, compute_dtype=cd,
        interpret=True, quantize="int8", calib_pts=jnp.asarray(pts),
        stash_q=False)
    jloss, jgrads = _jax_grads(japply, params, pts, tgt)
    apply = T.make_fused_train_apply(cfg, DIM, L, group_blocks=2,
                                     compute_dtype=cfg.compute_dtype,
                                     quantize="int8", calib_pts=t(pts),
                                     stash_q=False)
    loss = torch.mean((apply(model, t(pts)) - t(tgt)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    want = params_from_jax(np_tree(jgrads), cfg)
    for name, p in model.named_parameters():
        ok, err = _grad_ok(n(p.grad), want[name].numpy(), False)
        assert ok, (name, err)


def test_external_calib_matches_internal():
    """``external_calib`` with a calibration of the same weights gives the
    in-call calibration's output and gradients bit for bit."""
    _, _, cfg, model, pts, tgt = _case(jnp.bfloat16)
    inner = T.make_fused_train_apply(cfg, DIM, L, group_blocks=2,
                                     quantize="int8", calib_pts=t(pts))
    outer, calibrate = T.make_fused_train_apply(
        cfg, DIM, L, group_blocks=2, quantize="int8", calib_pts=t(pts),
        external_calib=True)
    grads = []
    for run in (lambda: inner(model, t(pts)),
                lambda: outer(model, t(pts), calibrate(model))):
        model.zero_grad()
        torch.mean((run() - t(tgt)) ** 2).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_unsupported_configs_raise():
    _, _, cfg, _, pts, _ = _case(jnp.bfloat16)
    with pytest.raises(NotImplementedError):
        T.make_fused_train_apply(dataclasses.replace(cfg, n_learnable=3),
                                 DIM, L)
    with pytest.raises(ValueError):
        T.make_fused_train_apply(cfg, DIM, L, quantize="int8")
    with pytest.raises(ValueError):
        T.make_fused_train_apply(cfg, DIM, L, external_calib=True)
