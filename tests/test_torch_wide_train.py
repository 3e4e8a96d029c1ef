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
order (ray ranges, 32-ray stages summed apart) against the plain version;
K5 wide's f32 sum routes at W512/D88 (the dh walk's 32-channel stages and
the dW pass's 32-ray stages, each summed apart by emulated tensor cores,
which truncate) within half of K5's f32 limit, and K3 wide's (each k8
step apart) on every stash row; the frame's wide f32 route (K1 at
W512/D12, K9 at W512/D24, one running sum) within a quarter of its limit
on rgb; the wide forward's encoding kernel's plain twin bit for bit the
plain versions' head input; the wide images' round trips; the scratch a
call takes; and a W384/D6 fused step against JAX's fused step on the same
draws. tests/test_torch_cuda.py holds the CUDA kernels to the plain
versions on the card.
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
from r2l_tpu_torch.encoding import r2l_embed
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.kernels.staging import tf32_split
from r2l_tpu_torch.models import R2L, R2LConfig, init_r2l
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
# The wide dW pass's order (csrc/r2l_wide_bwd.cu, dw_tf32 and sum_splits)
# ---------------------------------------------------------------------------

_BWD_SRC = open(os.path.join(REPO, "r2l_tpu_torch", "kernels", "csrc",
                             "r2l_wide_bwd.cu")).read()
# The rays a range of the wide dW pass is a multiple of (kDwRays), and the
# f32 pass's rays a stage (kTfRays), from csrc/r2l_wide_bwd.cu.
DW_RAYS = int(re.search(r"constexpr int kDwRays = (\d+);", _BWD_SRC)[1])
DW_STAGE = int(re.search(r"kTfRays = (\d+);", _BWD_SRC)[1])


def _dw_ranges(nr: int) -> int:
    """Rays of each of the wide dW pass's ``dw_splits(nr)`` ranges, whole
    multiples of ``DW_RAYS`` (r2l_wide_bwd_launch's ``rays_per_split``)."""
    per = -(-nr // T.dw_splits(nr))
    return -(-per // DW_RAYS) * DW_RAYS


def _dw_in_kernel_order(g: torch.Tensor, a: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """dW = g^T a and db = sum g (f32 [n, W] each) as the wide f32 dW pass
    sums them: ``dw_splits(n)`` ranges (``_dw_ranges``), each in stages of
    ``DW_STAGE`` rays whose products are summed apart (the tensor cores'
    own sum of one stage replaced by an f32 product) and added in f32; db
    per column over the first and the second half of every stage, the two
    halves then added; the ranges added in order."""
    nr, per = g.shape[0], _dw_ranges(g.shape[0])
    dws, dbs = [], []
    for r0 in range(0, nr, per):
        gg, aa = g[r0:r0 + per], a[r0:r0 + per]
        acc = torch.zeros((g.shape[1], a.shape[1]))
        half = [torch.zeros(g.shape[1]), torch.zeros(g.shape[1])]
        for s in range(0, gg.shape[0], DW_STAGE):
            acc = acc + gg[s:s + DW_STAGE].T @ aa[s:s + DW_STAGE]
            for r in range(s, min(s + DW_STAGE, gg.shape[0])):
                h = (r - s) // (DW_STAGE // 2)
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
    whole stages of both dW passes, none of them empty, which it checks."""
    per, splits = _dw_ranges(nr), T.dw_splits(nr)
    assert per % DW_RAYS == 0 and DW_RAYS % DW_STAGE == 0
    assert DW_RAYS % int(re.search(r"kBfRays = (\d+)", _BWD_SRC)[1]) == 0
    assert splits * per >= nr and (splits - 1) * per < nr
    assert "(long long)(splits - 1) * rays_per_split >= n" in _BWD_SRC


# ---------------------------------------------------------------------------
# K5 wide's f32 sum routes, with the tensor cores' truncating sums emulated
# ---------------------------------------------------------------------------

# The tensor cores add the products of a step and the sum they add to with
# every term aligned to the largest one's exponent and cut to this many
# bits below it, then truncate the result to f32 (ROADMAP C, "the tensor
# cores truncate"). 21 bits calibrates the emulation on the card's
# readings: it reads the narrow K5 W256 walk on one running sum at 77% of
# the f32 limit (the card 84-86%, PERF.md) and the mma.sync wide walk with
# each k8 step apart at 10% (the card 15%).
TC_BITS = 21
HALF = 0.5   # of K5's f32 limit: a route the emulation holds under it


def _tc_add(acc: torch.Tensor, prods: torch.Tensor) -> torch.Tensor:
    """One tensor-core step: acc (f32 [...]) plus the exact products
    (f64 [..., k]), each term cut to ``TC_BITS`` below the largest, summed,
    truncated to f32."""
    m = torch.maximum(acc.double().abs(), prods.abs().amax(-1))
    e = torch.floor(torch.log2(torch.where(m > 0, m, torch.ones_like(m))))
    q = torch.exp2(e - TC_BITS)[..., None]
    terms = torch.cat([acc.double()[..., None], prods], -1)
    s = (torch.trunc(terms / q) * q).sum(-1)
    f = s.float()
    return torch.where(f.double().abs() > s.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mm_tc(a: torch.Tensor, b: torch.Tensor, group: int) -> torch.Tensor:
    """a [m, K] @ b [K, n] (f32) as 3xTF32 wgmma products (per k8 step
    a_hi b_lo, a_lo b_hi, a_hi b_hi, each one tensor-core step) summed from
    zero over each ``group`` of K, the groups' sums added in f32."""
    ah, al = tf32_split(a)
    bh, bl = (x.T for x in tf32_split(b.T.contiguous()))
    out = torch.zeros((a.shape[0], b.shape[1]))
    for g0 in range(0, a.shape[1], group):
        d = torch.zeros_like(out)
        for k in range(g0, min(a.shape[1], g0 + group), 8):
            s = slice(k, k + 8)
            for x, y in ((ah, bl), (al, bh), (ah, bh)):
                d = _tc_add(d, x[:, s].double()[:, None, :]
                            * y[s].double().T[None])
        out = out + d
    return out


def _w512_d88(rays: int):
    """The W512/D88 f32 student of phase 22 (seeded), its K3 stash on
    ``rays`` seeded points, the body weights and a seeded dh."""
    W, D, dp, L_ = 512, 88, 48, 10
    cfg = R2LConfig(input_dim=dp * (2 * L_ + 1), netdepth=D, netwidth=W,
                    compute_dtype=torch.float32)
    model = init_r2l(cfg, torch.Generator().manual_seed(0),
                     torch.device("cpu"))
    rng = np.random.default_rng(2)
    pts = t(rng.uniform(-2, 2, (rays, dp)))
    fp = F.prepare_fused_params_pe(model, cfg, dp, L_, stage=False,
                                   weight_dtype=torch.float32, pad=False)
    stash = T.train_fwd_ref(fp, cfg, pts, dp, L_)[1]
    return cfg, fp.body_w, stash, t(rng.standard_normal((rays, W)))


def _walk(cfg, body_w, stash, dh, mm):
    """The whole body's dh walk of ``bwd_group_ref`` (f32) with its
    products through ``mm``."""
    nb, rs = cfg.num_blocks, cfg.res_scale
    for b in range(nb - 1, -1, -1):
        _, _, mask = T._group_inputs(stash, nb, b, torch.float32, None)
        dt1 = torch.where(mask, mm(dh * rs, body_w[2 * b + 1]), 0.0)
        dh = dh + mm(dt1, body_w[2 * b])
    return dh


def test_k5_wide_f32_walk_route_keeps_half_the_limit():
    """K5 wide's f32 dh walk at W512/D88 (86 layers, K = 512 a product),
    its products summed by emulated tensor cores in 32-channel stages
    apart (the skeleton's kSplit), against the plain walk: norm-relative
    within half of ``TOL_F32`` (one running sum, the teacher's route, reads
    1.1e-5 in the same emulation: PERF.md)."""
    cfg, body_w, stash, dh = _w512_d88(8)
    plain = _walk(cfg, body_w, stash, dh, lambda a, w: a @ w)
    got = _walk(cfg, body_w, stash, dh, lambda a, w: _mm_tc(a, w, 32))
    rel = float((got - plain).double().norm() / plain.double().norm())
    print(f"K5 wide f32 walk, 32-channel stages apart: {rel:.3e} "
          f"({rel / TOL_F32:.1%} of {TOL_F32:.0e})")
    assert 0 < rel <= HALF * TOL_F32, rel


def test_k5_wide_f32_dw_route_keeps_half_the_limit():
    """K5 wide's f32 dW pass at W512/D88 on the top block's two layers
    (dt2 against t1, dt1 against h_in, as the plain version makes them),
    64 of the outputs and 512 rays: its 3xTF32 products summed by emulated
    tensor cores in stages of ``DW_STAGE`` rays apart, added in f32,
    against the plain f32 product: norm-relative within half of
    ``TOL_F32``."""
    cfg, body_w, stash, dh = _w512_d88(512)
    nb = cfg.num_blocks
    h_in, t1r, mask = T._group_inputs(stash, nb, nb - 1, torch.float32,
                                      None)
    dt2 = dh * cfg.res_scale
    dt1 = torch.where(mask, dt2 @ body_w[2 * nb - 1], 0.0)
    worst = 0.0
    for g, a in ((dt2, t1r), (dt1, h_in)):
        g = g[:, :64].T.contiguous()
        want = g @ a
        got = _mm_tc(g, a, DW_STAGE)
        rel = float((got - want).double().norm() / want.double().norm())
        worst = max(worst, rel)
    print(f"K5 wide f32 dW, {DW_STAGE}-ray stages apart: {worst:.3e} "
          f"({worst / TOL_F32:.1%} of {TOL_F32:.0e})")
    assert 0 < worst <= HALF * TOL_F32, worst


def _k3_rows(cfg, fp, pts, mm):
    """K3's forward (``train_fwd_ref``, f32) with the head's and the body's
    products through ``mm(a [n, K], w [K, W])``: (rgb, stash)."""
    return T.train_fwd_ref(fp, cfg, pts, 48, 10,
                           mm=lambda a, w: mm(a.float(),
                                              w[:, :a.shape[1]].T.float()))


def test_k3_wide_f32_route_keeps_the_limit():
    """K3 wide's f32 forward at W512/D88 (89 products, K = 1008 at the
    head and 512 in the body) on 8 seeded rays, its products summed by
    emulated tensor cores with each k8 step apart (the skeleton's kSplit =
    8), against the plain f32 forward: every stash row within half of
    ``TOL_F32`` (the card reads higher than the emulation: PERF.md). The
    32-channel route (kSplit = 32, K5's), printed beside it, reads more: it
    is why K3 takes the k8 route."""
    W, D, dp, L_ = 512, 88, 48, 10
    cfg = R2LConfig(input_dim=dp * (2 * L_ + 1), netdepth=D, netwidth=W,
                    compute_dtype=torch.float32)
    model = init_r2l(cfg, torch.Generator().manual_seed(0),
                     torch.device("cpu"))
    pts = t(np.random.default_rng(0).uniform(-2, 2, (8, dp)))
    fp = F.prepare_fused_params_pe(model, cfg, dp, L_, stage=False,
                                   weight_dtype=torch.float32, pad=False)
    rgb_p, plain = T.train_fwd_ref(fp, cfg, pts, dp, L_)
    worst = {}
    for group in (8, 32):
        rgb, stash = _k3_rows(cfg, fp, pts,
                              lambda a, b, g=group: _mm_tc(a, b, g))
        rows = (stash - plain).abs().amax(dim=(1, 2))
        worst[group] = max(float(rows.max()), float((rgb - rgb_p).abs()
                                                    .max()))
        print(f"K3 wide f32, {group}-channel sums apart: worst stash row "
              f"{int(rows.argmax())} {float(rows.max()):.3e} "
              f"({worst[group] / TOL_F32:.1%} of {TOL_F32:.0e})")
    assert 0 < worst[8] <= HALF * TOL_F32, worst
    assert worst[32] > worst[8], worst


# K1's and K9's f32 limit on rgb (chip_smoke.py, TOL_PE_F32), and the share
# of it a route may read in the emulation: the card has read up to twice
# the emulation (K3 f32: 34.6% in it, 61-67% on the card; PERF.md).
TOL_FRAME_F32 = 1e-4
QUARTER = 0.25
# the sum routes by kSplit (wide_hopper.cuh), cheapest first: one running
# sum over K, each 32-channel stage apart, each k8 step apart
ROUTES = {0: 1 << 30, 32: 32, 8: 8}


@pytest.mark.parametrize("kernel,depth", [("K1", 12), ("K9", 24)])
def test_frame_wide_f32_route_keeps_a_quarter_of_the_limit(kernel, depth):
    """The frame's wide f32 rgb (phase 21's W512/D12 K1 and W512/D24 K9
    students, their seeded weights; 32 seeded rays, L=10), the head's and
    the body's products summed by emulated tensor cores on each route
    (printed side by side), against the plain f32 frame: the frame's route
    (``csrc/r2l_wide.cu``, kF32Split: one running sum, the cheapest) within
    a quarter of the f32 limit."""
    W, dp, L_ = 512, 48, 10
    cfg = R2LConfig(input_dim=dp * (2 * L_ + 1), netdepth=depth, netwidth=W,
                    compute_dtype=torch.float32)
    model = init_r2l(cfg, torch.Generator().manual_seed(W + depth),
                     torch.device("cpu"))
    pts = t(np.random.default_rng(3).uniform(-2, 2, (32, dp)))
    if kernel == "K1":
        fp = F.prepare_fused_params_pe(model, cfg, dp, L_, stage=False,
                                       weight_dtype=torch.float32, pad=False)

        def frame(mm):
            return F.fused_r2l_apply_pe_ref(fp, cfg, pts, dp, L_, mm=mm)
    else:
        fp = F.prepare_fused_params(model, cfg, torch.float32, pad=False)
        x = r2l_embed(pts, L_)

        def frame(mm):
            return F._chain_ref(fp, cfg, x, torch.float32, mm)
    plain = frame(F._mm_f32)
    worst = {}
    for split, group in ROUTES.items():
        rgb = frame(lambda a, w, g=group: _mm_tc(
            a.float(), w[:, :a.shape[1]].T.float(), g))
        worst[split] = float((rgb - plain).abs().max())
    print(f"{kernel} wide f32 W{W}/D{depth} rgb: " + ", ".join(
        f"kSplit {k} {v:.3e} ({v / TOL_FRAME_F32:.1%})"
        for k, v in worst.items()) + f" of {TOL_FRAME_F32:.0e}")
    src = open(os.path.join(REPO, "r2l_tpu_torch", "kernels", "csrc",
                            "r2l_wide.cu")).read()
    route = int(re.search(r"constexpr int kF32Split = (\d+);", src)[1])
    assert route == next(k for k in ROUTES
                         if worst[k] <= QUARTER * TOL_FRAME_F32), worst
    assert 0 < worst[route], worst


# ---------------------------------------------------------------------------
# The wide forward's encoding (csrc/r2l_wide_train.cu, train_encode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L_", [4, 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_train_encoding_twin_is_the_head_input(L_, dtype, monkeypatch):
    """``train_encoding_ref`` is bit for bit the head input of
    ``train_fwd_ref`` (bf16, f32: the first product's input) and of
    ``train_fwd_int8_ref`` (its codes), zero-padded to 128 columns, in
    JAX's ``_pe_sin_cos_ladder`` order (freq-major: sines by octave, then
    cosines, then the points)."""
    W, nr, in_dim = 384, 64, DIM * (2 * L_ + 1)
    cfg = R2LConfig(input_dim=in_dim, netdepth=4, netwidth=W,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(L_),
                     torch.device("cpu"))
    pts = t(np.random.default_rng(L_).uniform(-2, 2, (nr, DIM)))
    seen = []
    if dtype == torch.int8:
        fp = F.calibrate_r2l_int8_pe(model, cfg, DIM, L_, pts,
                                     fold_requant=False, stage=False,
                                     pad=False)
        mm_int = T._mm_int
        monkeypatch.setattr(T, "_mm_int", lambda q, w: (
            seen.append(q), mm_int(q, w))[1])
        T.train_fwd_int8_ref(fp, cfg, pts, DIM, L_, stash_q=True)
        enc = T.train_encoding_ref(pts, DIM, L_, dtype, fp.head_inv)
        want = seen[0].to(torch.int8)
    else:
        fp = F.prepare_fused_params_pe(model, cfg, DIM, L_, stage=False,
                                       weight_dtype=dtype, pad=False)
        T.train_fwd_ref(fp, cfg, pts, DIM, L_, mm=lambda a, w: (
            seen.append(a), F._mm_f32(a, w))[1])
        enc = T.train_encoding_ref(pts, DIM, L_, dtype)
        want = seen[0]
    assert enc.dtype == dtype and enc.shape == (nr, F._padded_in(in_dim))
    assert torch.equal(enc[:, :in_dim].view(torch.uint8),
                       want.contiguous().view(torch.uint8))
    assert not enc[:, in_dim:].float().any()
    sins, coss = JP._pe_sin_cos_ladder(jnp.asarray(n(pts)), L_)
    jax_x = np.concatenate(sins + coss + [n(pts)], axis=1)
    got = n(T.train_encoding_ref(pts, DIM, L_, torch.float32))[:, :in_dim]
    np.testing.assert_allclose(got, jax_x, rtol=0, atol=2.0 ** L_ * 1e-6)


# ---------------------------------------------------------------------------
# The wide images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [384, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_wide_train_image_round_trip(W, dtype):
    """``stage_wide_train``: the head's weights [W, kpad] then each body
    layer's [W, W], row-major (the pass skeleton's B; f32 a layer's TF32
    high parts, then its low parts), then for int8 the (m, b) table; and
    back (``unstage_wide_train``), f32 as the two parts, which sum to the
    weights within TF32's split."""
    in_dim = DIM * (2 * L + 1)
    cfg = R2LConfig(input_dim=in_dim, netdepth=6, netwidth=W,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(W),
                     torch.device("cpu"))
    if dtype == torch.int8:
        pts = t(np.random.default_rng(W).uniform(-2, 2, (64, DIM)))
        fp = F.calibrate_r2l_int8_pe(model, cfg, DIM, L, pts,
                                     fold_requant=False, stage=False,
                                     pad=False)
        head, body = fp.head_q, fp.body_q
    else:
        fp = F.prepare_fused_params_pe(model, cfg, DIM, L, stage=False,
                                       weight_dtype=dtype, pad=False)
        head, body = fp.head_w, fp.body_w
    img = F.stage_wide_train(fp)
    plan = F.wide_stage_plan(cfg, dtype)
    es = head.element_size()
    parts = 2 if dtype == torch.float32 else 1
    assert img.dtype == torch.uint8 and img.numel() == plan["nbytes"]
    assert plan["head_bytes"] == W * plan["kpad"] * es * parts
    assert plan["layer_bytes"] == W * W * es * parts
    back = F.unstage_wide_train(img, cfg, dtype)
    key = "head_q" if dtype == torch.int8 else "head_w"
    bkey = "body_q" if dtype == torch.int8 else "body_w"
    if dtype == torch.float32:
        for name, w in (("head_w", head), ("body_w", body)):
            hi, lo = tf32_split(w)
            assert torch.equal(back[name], hi)
            assert torch.equal(back[name + "_lo"], lo)
            d = (back[name] + back[name + "_lo"] - w).abs()
            assert float((d / w.abs().clamp(1e-30)).max()) <= 2.0 ** -21
        # layer 1's row 130: its high part at the layer's start, then its
        # low part W rows on
        off = plan["head_bytes"] + plan["layer_bytes"] + 130 * W * 4
        row = img[off:off + W * 4].clone().view(torch.float32)
        assert torch.equal(row, tf32_split(body[1])[0][130])
    else:
        assert torch.equal(back[key], head)
        assert torch.equal(back[bkey], body)
        off = plan["head_bytes"] + plan["layer_bytes"] + 130 * W * es
        row = img[off:off + W * es].clone().view(dtype)
        assert torch.equal(row, body[1][130])
    if dtype == torch.int8:
        for name in ("head_m", "head_b", "body_m", "body_b"):
            assert torch.equal(back[name], getattr(fp, name)), name

@pytest.mark.parametrize("W", [384, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_image_round_trip(W, dtype):
    """``stage_bwd_weights`` on the wide form: every layer's transpose [in,
    out] row-major, the pass skeleton's B (layer l at l * W * W * es *
    parts; f32 its TF32 high parts, then its low parts), and back (f32 as
    the two parts, which sum to the weights within TF32's split)."""
    body_w = torch.randn((4, W, W), generator=torch.Generator().manual_seed(
        W)).to(dtype)
    img = T.stage_bwd_weights(body_w)
    es, f32 = body_w.element_size(), dtype == torch.float32
    parts = 2 if f32 else 1
    assert img.dtype == torch.uint8 and img.numel() == 4 * W * W * es * parts
    back = T.unstage_bwd_weights(img, (4, W, W), dtype)
    want = list(tf32_split(body_w)) if f32 else [body_w]
    assert len(back) == parts
    for b, w in zip(back, want):
        assert torch.equal(b.view(torch.uint8), w.view(torch.uint8))
    if f32:
        d = (back[0] + back[1] - body_w).abs() / body_w.abs().clamp(1e-30)
        assert float(d.max()) <= 2.0 ** -21
    # layer 1, row i = 130 of its [in, out] matrix: body_w[1][:, 130],
    # high part first
    off = W * W * es * parts + 130 * W * es
    row = img[off:off + W * es].contiguous().view(dtype)
    assert torch.equal(row.view(torch.uint8),
                       want[0][1][:, 130].contiguous().view(torch.uint8))


@pytest.mark.parametrize("W", [384, 512])
def test_training_images_are_the_wide_forms(W):
    """K3's image (the step's packing, ``prepare_train_params``) and
    K4/K8's (``stage_int8_train``) on the wide form are the wide forms'
    one image (``stage_wide_train``, staged for "wide"), and give the
    fields back; both int8 kinds read the same one; the frame's packing
    stages the same layout, and on the same weights the same bytes."""
    jcfg, params, cfg, model, pts = _case(W, jnp.bfloat16)
    for wd in (torch.bfloat16, torch.float32):
        fp = T.prepare_train_params(model, cfg, DIM, L, wd)
        assert fp.staged_for == "wide"
        assert fp.staged.numel() == F.wide_stage_plan(cfg, wd)["nbytes"]
        back = F.unstage_wide_train(fp.staged, cfg, wd)
        want = tf32_split(fp.body_w)[0] if wd == torch.float32 else fp.body_w
        assert torch.equal(back["body_w"], want)
        assert back["head_w"].shape == fp.head_w.shape
        frame = F.prepare_fused_params_pe(model, cfg, DIM, L,
                                          weight_dtype=wd, pad=False)
        assert frame.staged_for == "wide"
        assert torch.equal(frame.staged, fp.staged)
    fp8 = F.calibrate_r2l_int8_pe(model, cfg, DIM, L, t(pts),
                                  fold_requant=False, stage=False, pad=False)
    imgs = [F.stage_int8_train(fp8, cfg, DIM, L, q) for q in (True, False)]
    assert all(f.staged_for == "wide" for f in imgs)
    assert torch.equal(imgs[0].staged, imgs[1].staged)
    back = F.unstage_wide_train(imgs[0].staged, cfg, torch.int8)
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
    """The int8 forms' scratch: the head's codes [n, kpad], then K4's f32
    stream or K8's two code buffers, and with the global residual an f32
    h0; K3's the head's input alone, whatever the int8 switches."""
    nr, W, in_dim = 1000, 384, 48 * 21
    e, kp = nr * W, 1024
    want = nr * kp + (4 * e if stash_q else 2 * e) + (4 * e if res else 0)
    assert T.wide_train_scratch_bytes(nr, W, torch.int8, in_dim, stash_q,
                                      res) == want
    for wd, es in ((torch.bfloat16, 2), (torch.float32, 4)):
        assert T.wide_train_scratch_bytes(nr, W, wd, in_dim, stash_q,
                                          res) == nr * kp * es


_TRAIN_SRC = open(os.path.join(REPO, "r2l_tpu_torch", "kernels", "csrc",
                               "r2l_wide_train.cu")).read()


@pytest.mark.parametrize("nr", [1, 127, 128, 81_920])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_wide_train_scratch_bytes(nr, dtype):
    """The scratch of a W512/D88 call at L=10 (in_dim 1008, the head's
    input padded to 1024 columns) for each of the three types, every
    buffer 256-byte aligned, as the entry point's train_scratch counts it
    (its formula read from the source) and checks it."""
    W, in_dim, kp = 512, 48 * 21, 1024
    es = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1}[dtype]

    def al(b):
        return -(-b // 256) * 256
    for stash_q in (True, False):
        for res in (True, False):
            want = al(nr * kp * es)
            if dtype == torch.int8:
                want += (al(4 * nr * W) if stash_q else 2 * al(nr * W)) + (
                    al(4 * nr * W) if res else 0)
            assert T.wide_train_scratch_bytes(nr, W, dtype, in_dim, stash_q,
                                              res) == want
    assert "aligned(n * kp * r2lw::elem_bytes(dtype))" in _TRAIN_SRC
    assert ("(stash_q ? aligned(4 * e) : 2 * aligned(e)) +\n"
            "         (use_residual ? aligned(4 * e) : 0)") in _TRAIN_SRC
    assert "scratch_bytes < train_scratch(" in _TRAIN_SRC


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
