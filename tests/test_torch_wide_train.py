"""The wide form of the training kernels (K3, K4/K8 and K5 at every
netwidth the chain kernels do not take: r2l_tpu_torch/kernels/csrc/
r2l_wide_train.cu, r2l_wide_bwd.cu) on the CPU.

The gate: over W 128-2176 (and W96, W192, W257), even D 4-120, bf16 / f32 /
int8 at L 4 and 10, ``fused_train_supported`` holds exactly where the JAX
package's ``--fused_train_vjp`` gate (``r2l_tpu/app.py``, its expression
read from the source) holds with ReLU bodies. On the CPU the wrappers run
their plain versions: those, called through the wide wrappers at W384 and
W512, against JAX's ``train_fwd``, ``train_fwd_int8`` (both stash kinds)
and ``bwd_group`` in interpret mode at the tolerances of
tests/test_torch_train_kernels.py; a plain emulation of the wide dW pass's
order (ray ranges, 32-ray stages, each k8 step summed apart) against the
plain version; the wide images' round trips; and a W384/D6 fused step
against JAX's fused step on the same draws. tests/test_torch_cuda.py holds
the CUDA kernels to the plain versions on the card.
"""
import ast
import functools
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_step_draws, models, n, t
from r2l_tpu import train as JTR
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.kernels import r2l_train_pallas as JT
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.models import R2L, R2LConfig
from r2l_tpu_torch.sampler import PointSampler
from test_torch_train_kernels import (MAX_Q_SHARE, TOL_BF16, TOL_F32,
                                      TOL_INT8_MAX, TOL_INT8_RMS, _grad_ok)
from test_torch_train_step import TOL_LOSS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, L, N_RAYS, DEPTH = 6, 4, 512, 6
WIDTHS = [96, 192, 257] + list(range(128, 2201, 128))
DEPTHS = range(4, 121, 2)
DTYPES = {"f32": (jnp.float32, torch.float32, False),
          "bf16": (jnp.bfloat16, torch.bfloat16, False),
          "int8": (jnp.bfloat16, torch.bfloat16, True)}


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_gate():
    """JAX's ``fused_vjp = bool(...)`` expression of r2l_tpu/app.py,
    compiled: it reads ``args``, ``mesh`` and ``cfg``."""
    with open(os.path.join(REPO, "r2l_tpu", "app.py")) as f:
        tree = ast.parse(f.read())
    found = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign) and len(node.targets) == 1
             and isinstance(node.targets[0], ast.Name)
             and node.targets[0].id == "fused_vjp"]
    assert len(found) == 1
    return compile(ast.Expression(found[0]), "app.py", "eval")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L_", [4, 10])
def test_train_gate_is_jaxs(dtype, L_):
    jd, td, int8 = DTYPES[dtype]
    args = SimpleNamespace(fused_train_vjp=True, plucker=False)
    gate = _jax_gate()
    admitted = []
    for W in WIDTHS:
        for D in DEPTHS:
            jcfg = JaxR2LConfig(input_dim=48 * (2 * L_ + 1), netdepth=D,
                                netwidth=W, compute_dtype=jd)
            cfg = R2LConfig(input_dim=48 * (2 * L_ + 1), netdepth=D,
                            netwidth=W, compute_dtype=td)
            want = eval(gate, {"bool": bool},
                        {"args": args, "mesh": None, "cfg": jcfg})
            assert T.fused_train_supported(cfg, int8, L_) == want, (W, D)
            if want:
                admitted.append(W)
                assert T.wide_train_form(W, int8, L_) == (W > 256)
    assert sorted(set(admitted)) == list(range(128, 2201, 128))


# ---------------------------------------------------------------------------
# The plain versions of the wide forms against JAX's kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(W: int, cd):
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=DEPTH,
                        netwidth=W, compute_dtype=cd,
                        precision="highest" if cd == jnp.float32
                        else "default")
    params, cfg, model = models(jcfg, seed=W)
    rng = np.random.default_rng(W + 1)
    pts = rng.uniform(-2.0, 2.0, (N_RAYS, DIM)).astype(np.float32)
    return jcfg, params, cfg, model, pts


@pytest.mark.parametrize("W", [384, 512])
@pytest.mark.parametrize("cd", [jnp.float32, jnp.bfloat16])
def test_train_fwd_wide_matches_pallas(W, cd):
    jcfg, params, cfg, model, pts = _case(W, cd)
    assert T.wide_train_form(W)
    jfp = JP.prepare_fused_params_pe(params, jcfg, DIM, L, weight_dtype=cd)
    jrgb, jstash = JT.train_fwd(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                interpret=True)
    fp = F.prepare_fused_params_pe(model, cfg, DIM, L,
                                   weight_dtype=cfg.compute_dtype, pad=False)
    rgb, stash = T.train_fwd_wide(fp, cfg, t(pts), DIM, L)
    want = np.asarray(jstash, np.float32)
    assert stash.shape == want.shape == (2 * cfg.num_blocks + 1, N_RAYS, W)
    row = np.abs(n(stash) - want).max(axis=(1, 2))
    if cd == jnp.float32:
        np.testing.assert_allclose(n(rgb), np.asarray(jrgb), atol=TOL_F32)
        assert row.max() < TOL_F32
    else:
        np.testing.assert_allclose(n(rgb), np.asarray(jrgb), atol=TOL_BF16)
        assert (row / np.maximum(np.abs(want).max(axis=(1, 2)), 1)).max() \
            < TOL_BF16


@pytest.mark.parametrize("W", [384, 512])
@pytest.mark.parametrize("stash_q", [True, False])
def test_train_fwd_int8_wide_matches_pallas(W, stash_q):
    jcfg, params, cfg, model, pts = _case(W, jnp.bfloat16)
    assert T.wide_train_form(W, True, L)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM, L,
                                   calib_pts=jnp.asarray(pts))
    jrgb, jstash = JT.train_fwd_int8(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                     interpret=True, stash_q=stash_q)
    fp = F.calibrate_r2l_int8_pe(model, cfg, DIM, L, t(pts),
                                 fold_requant=False, stage=False, pad=False)
    rgb, stash = T.train_fwd_int8_wide(fp, cfg, t(pts), DIM, L,
                                       stash_q=stash_q)
    d = n(rgb) - np.asarray(jrgb)
    assert np.abs(d).max() < TOL_INT8_MAX
    assert np.sqrt(np.mean(d * d)) < TOL_INT8_RMS
    if stash_q:
        assert stash.dtype == torch.int8
        dq = np.abs(stash.numpy().astype(np.int32)
                    - np.asarray(jstash, np.int32))
        assert dq.max() <= 1 and np.mean(dq > 0) < MAX_Q_SHARE
    else:
        want = np.asarray(jstash, np.float32)
        assert stash.dtype == torch.bfloat16 and stash.shape == want.shape
        row = np.abs(n(stash) - want).max(axis=(1, 2))
        assert (row / np.maximum(np.abs(want).max(axis=(1, 2)), 1)).max() \
            < TOL_BF16


@pytest.mark.parametrize("W", [384, 512])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_bwd_group_wide_matches_pallas(W, kind):
    cd = jnp.float32 if kind == "f32" else jnp.bfloat16
    jcfg, params, cfg, model, pts = _case(W, cd)
    nb = cfg.num_blocks
    if kind == "int8":
        jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM, L,
                                       calib_pts=jnp.asarray(pts))
        _, jstash = JT.train_fwd_int8(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                      interpret=True, stash_q=True)
        jscale = 1.0 / jfp.body_inv
        stash = torch.from_numpy(np.array(jstash, np.int8))
        scale = t(np.asarray(jscale)[:2 * nb, :W])
    else:
        jfp = JP.prepare_fused_params_pe(params, jcfg, DIM, L,
                                         weight_dtype=cd)
        _, jstash = JT.train_fwd(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                 interpret=True)
        jscale = scale = None
        stash = t(np.asarray(jstash, np.float32)).to(cfg.compute_dtype)
    dh = np.random.default_rng(2).normal(size=(N_RAYS, W)).astype(np.float32)
    jbody = params["body"]["w"].reshape(2 * nb, W, W).astype(cd)
    want = JT.bwd_group(jbody, jstash, jnp.asarray(dh), jcfg, 0, nb,
                        interpret=True, body_scale=jscale)
    body_w = F.prepare_fused_params_pe(
        model, cfg, DIM, L, weight_dtype=cfg.compute_dtype, stage=False,
        pad=False).body_w
    got = T.bwd_group_wide(body_w, stash, t(dh), cfg, 0, nb,
                           body_scale=scale,
                           staged=T.stage_bwd_weights(body_w))
    assert got[1].shape == (2 * nb, W, W)
    for g, w, what in zip(got, (want[0], np.swapaxes(np.asarray(want[1]),
                                                     -1, -2), want[2]),
                          ("dh", "dW", "db")):
        ok, err = _grad_ok(n(g), w, kind == "f32")
        assert ok, (what, err)


# ---------------------------------------------------------------------------
# The wide dW pass's order (csrc/r2l_wide_bwd.cu, wide_dw and sum_splits)
# ---------------------------------------------------------------------------

# The wide dW pass's rays a stage (csrc/r2l_wide_bwd.cu, kDwRays).
DW_RAYS = int(re.search(r"constexpr int kDwRays = (\d+);", open(os.path.join(
    REPO, "r2l_tpu_torch", "kernels", "csrc", "r2l_wide_bwd.cu")).read())[1])


def _dw_ranges(nr: int) -> int:
    """Rays of each of the wide dW pass's ``dw_splits(nr)`` ranges, whole
    stages of ``DW_RAYS`` (r2l_wide_bwd_launch's ``rays_per_split``)."""
    per = -(-nr // T.dw_splits(nr))
    return -(-per // DW_RAYS) * DW_RAYS


def _dw_in_kernel_order(g: torch.Tensor, a: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """dW = g^T a and db = sum g (f32 [n, W] each) as the wide dW pass sums
    them: ``dw_splits(n)`` ranges (``_dw_ranges``), each in stages of
    ``DW_RAYS`` rays of k8 steps whose products are summed apart (the tensor
    cores' own sum of one step replaced by an f32 product) and added in
    f32; db per column over the first and the second half of every stage,
    the two halves then added; the ranges added in order."""
    nr, per = g.shape[0], _dw_ranges(g.shape[0])
    dws, dbs = [], []
    for r0 in range(0, nr, per):
        gg, aa = g[r0:r0 + per], a[r0:r0 + per]
        acc = torch.zeros((g.shape[1], a.shape[1]))
        half = [torch.zeros(g.shape[1]), torch.zeros(g.shape[1])]
        for s in range(0, gg.shape[0], DW_RAYS):
            for k in range(s, min(s + DW_RAYS, gg.shape[0]), 8):
                acc = acc + gg[k:k + 8].T @ aa[k:k + 8]
            for r in range(s, min(s + DW_RAYS, gg.shape[0])):
                h = (r - s) // (DW_RAYS // 2)
                half[h] = half[h] + gg[r]
        dws.append(acc)
        dbs.append(half[0] + half[1])
    dw, db = dws[0], dbs[0]
    for x, y in zip(dws[1:], dbs[1:]):
        dw, db = dw + x, db + y
    return dw, db


def test_wide_dw_order_keeps_the_f32_limit():
    """At 20,500 rays (two ranges, the last stage part-filled), the wide
    dW pass's order against the plain version's dW and db, held to the f32
    limit of the gradients (norm-relative)."""
    nr, W = 20_500, 384
    assert T.dw_splits(nr) == 2 and _dw_ranges(nr) * 2 > nr
    rng = np.random.default_rng(5)
    g = t(rng.normal(size=(nr, W)))
    a = torch.relu(t(rng.normal(size=(nr, W))))
    dw, db = _dw_in_kernel_order(g, a)
    ok, err = _grad_ok(n(dw), n(g.T @ a), True)
    assert ok, err
    ok, err = _grad_ok(n(db), n(g.sum(0)), True)
    assert ok, err


@pytest.mark.parametrize("nr", [1, 31, 10_240, 20_479, 20_480, 81_920,
                                200_001])
def test_wide_dw_ranges_cover_the_rays(nr):
    """The entry point's ranges over ``dw_splits(nr)`` cover the rays in
    whole stages, none of them empty, which it checks."""
    per, splits = _dw_ranges(nr), T.dw_splits(nr)
    assert per % DW_RAYS == 0 and splits * per >= nr
    assert (splits - 1) * per < nr
    src = open(os.path.join(REPO, "r2l_tpu_torch", "kernels", "csrc",
                            "r2l_wide_bwd.cu")).read()
    assert "(long long)(splits - 1) * rays_per_split >= n" in src


# ---------------------------------------------------------------------------
# The wide images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [384, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_image_round_trip(W, dtype):
    """``stage_bwd_weights`` on the wide form: every layer's transpose in
    the wide form's tiles (tile (o, k) of layer l at l * W * W * es + (o *
    W * es / 128 + k) * 16 KB, its 128 rows in order), and back."""
    body_w = torch.randn((4, W, W), generator=torch.Generator().manual_seed(
        W)).to(dtype)
    img = T.stage_bwd_weights(body_w)
    es = body_w.element_size()
    assert img.dtype == torch.uint8 and img.numel() == 4 * W * W * es
    (back,) = T.unstage_bwd_weights(img, (4, W, W), dtype)
    assert torch.equal(back, body_w)
    # layer 1, tile (o=1, k=0): output channels 128.. of W^T, i.e. input
    # channels 128.. of body_w, its first 128 bytes of output channels
    kt = W * es // 128
    off = W * W * es + (1 * kt + 0) * 128 * 128
    tile = img[off:off + 128 * 128].view(128, 128).contiguous().view(dtype)
    assert torch.equal(tile, body_w[1].T[128:256, :128 // es].contiguous())


@pytest.mark.parametrize("W", [384, 512])
def test_training_images_are_the_wide_forms(W):
    """K3's image (the step's packing, ``pad=False``) and K4/K8's
    (``stage_int8_train``) on the wide form are ``stage_wide_chain``'s, and
    give the fields back; both int8 kinds read the same one."""
    jcfg, params, cfg, model, pts = _case(W, jnp.bfloat16)
    fp = F.prepare_fused_params_pe(model, cfg, DIM, L, pad=False)
    assert fp.staged.numel() == F.wide_stage_plan(cfg, torch.bfloat16)[
        "nbytes"]
    back = F.unstage_wide_chain(fp.staged, cfg, torch.bfloat16)
    assert torch.equal(back["head_w"], fp.head_w)
    assert torch.equal(back["body_w"], fp.body_w)
    fp8 = F.calibrate_r2l_int8_pe(model, cfg, DIM, L, t(pts),
                                  fold_requant=False, stage=False, pad=False)
    imgs = [F.stage_int8_train(fp8, cfg, DIM, L, q) for q in (True, False)]
    assert all(f.staged_for == "wide" for f in imgs)
    assert torch.equal(imgs[0].staged, imgs[1].staged)
    back = F.unstage_wide_chain(imgs[0].staged, cfg, torch.int8)
    for name in ("head_q", "body_q", "head_m", "head_b", "body_m", "body_b"):
        assert torch.equal(back[name], getattr(fp8, name)), name


def test_int8_head_slice_overflow_goes_wide():
    """An int8 step at W128 whose 2L+1 encoding parts overflow K4's head
    slice (2W) runs on the wide form, which stages it; within the slice it
    keeps K4's own image."""
    assert not T.wide_train_form(128, True, 127)
    assert T.wide_train_form(128, True, 128)
    assert not T.wide_train_form(128, False, 128)
    for Lx, form in ((127, "K4"), (128, "wide")):
        cfg = R2LConfig(input_dim=DIM * (2 * Lx + 1), netdepth=4,
                        netwidth=128)
        model = R2L(cfg, device="cpu")
        pts = torch.rand((64, DIM))
        fp8 = F.calibrate_r2l_int8_pe(model, cfg, DIM, Lx, pts,
                                      fold_requant=False, stage=False,
                                      pad=False)
        assert F.stage_int8_train(fp8, cfg, DIM, Lx, True).staged_for == form


@pytest.mark.parametrize("stash_q,res", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_wide_train_scratch(stash_q, res):
    nr, W = 1000, 384
    e = nr * W
    want = (4 * e if stash_q else 2 * e) + (4 * e if res else 0)
    assert T.wide_train_scratch_bytes(nr, W, True, stash_q, res) == want
    assert T.wide_train_scratch_bytes(nr, W, False, stash_q, res) == 0


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------

def _step_dcfg():
    return dict(batch_size=128, n_hard_in=16, n_hard_out=32, hard_mul=2.0,
                embed_L=L, perturb=True, warmup_lr="0.0001,3")


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_wide_fused_step_matches_jax(quantize):
    """A W384/D6 ``make_distill_step(fused_vjp=True)`` (``fused`` and
    ``fused_int8``) on the CPU against JAX's fused step (its kernels in
    interpret mode) from the same params, batch and JAX's own draws: two
    steps' losses at the step tests' bf16 bound, the hard-sample pool
    equal after the first."""
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=DEPTH,
                        netwidth=384, compute_dtype=jnp.bfloat16)
    params, cfg, model = models(jcfg, seed=7)
    assert TR.fused_vjp_gate(True, cfg, False)
    assert T.fused_train_supported(cfg, quantize == "int8", L)
    jdcfg, dcfg = JTR.DistillConfig(**_step_dcfg()), TR.DistillConfig(
        **_step_dcfg())
    kw = dict(H=8, W=8, focal=8.0, n_sample=2, near=2.0, far=6.0)
    jsampler, sampler = JaxPointSampler(**kw), PointSampler(**kw)
    rng = np.random.default_rng(3)
    fresh = rng.uniform(size=(96, 9)).astype(np.float32)
    calib = rng.uniform(-2.0, 2.0, (32, DIM)).astype(np.float32)
    jstate, tx = JTR.init_train_state(jax.random.key(4),
                                      jax.tree.map(jnp.array, params), jdcfg)
    jstep = JTR.make_distill_step(
        jcfg, jdcfg, jsampler, tx, fused_vjp=True, fused_tile=64,
        fused_group_blocks=2, fused_quantize=quantize,
        fused_calib_pts=jnp.asarray(calib) if quantize else None)
    state = TR.init_train_state(model, dcfg, device="cpu")
    step = TR.make_distill_step(
        cfg, dcfg, sampler, fused_vjp=True, fused_group_blocks=2,
        fused_quantize=quantize, fused_calib_pts=t(calib) if quantize
        else None, device="cpu")
    jl, pl_ = [], []
    for i in range(2):
        key = jax.random.key(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(fresh), key)
        state, m = step(state, fresh, draws=jax_step_draws(key, dcfg, 2))
        jl.append(float(jm["loss"]))
        pl_.append(float(m["loss"]))
        if i == 0:
            np.testing.assert_array_equal(n(state.pool.rays),
                                          np.array(jstate.pool.rays))
    np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS["bf16"])
