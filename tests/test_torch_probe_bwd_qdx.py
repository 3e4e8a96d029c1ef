"""Port parity: K5 with an int8 dL/dx (r2l_tpu_torch/exp/probe_bwd_qdx.py)
against exp/probe_bwd_qdx.py's bwd_group_qdx, its Pallas kernel in
interpret mode (the probe's default off the TPU), on the same inputs: JAX's
int8 calibration (fold_requant=False, as the probe calls it) carried over
field by field (tests/_torch_parity.py::int8_params_from_jax) and JAX's
stash_q=True stash, at W32 with 4 blocks, 128 rays in tiles of 32 or 64.

The probe dequantizes dx with 1/body_inv (the activation scale) where the
calibration's algebra needs body_inv, so its dx is the true one times the
square of the input's activation scale (test_reference_dx_is_off_by_the_
scale_squared; ROADMAP C): at this size below an ulp of dh. The port
computes the probe's function; to hold every step of it to JAX, the
parity tests also run it with a body_scale of order one (``unit``), where
dx moves most of dh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import (int8_params_from_jax, load_exp_probe, models, n,
                           t)
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.kernels import r2l_train_pallas as JT
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import probe_bwd_qdx as P
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.models import R2LConfig

JQ = load_exp_probe("probe_bwd_qdx")
DIM, L, N, STASH_TILE = 6, 4, 128, 32
# dh: exact int32 dots and the same roundings on both sides (the one-FMA
# add of test_dh_update_is_one_fma), so bit for bit. dW and db: the same
# bf16 dt2/dt1 products summed in another order (JAX accumulates tile by
# tile), norm-relative.
TOL_DW = 1e-5
# The walk's cosines (qdx against the bf16 walk): the qdx walks agree bit
# for bit in dh; the bf16 walks (K5's plain version against JAX's kernel)
# sum in another order.
TOL_COS = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _case(res_scale=1.0, seed=0):
    """(JAX cfg, JAX packing, JAX stash, port cfg, port packing, stash,
    body_w bf16 [out, in] and JAX's [in, out], dh0 [N, W])."""
    jcfg = JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=10,
                        netwidth=32, compute_dtype=jnp.bfloat16,
                        res_scale=res_scale)
    params, cfg, model = models(jcfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform(-2.0, 2.0, (N, DIM)).astype(np.float32)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DIM, L,
                                   calib_pts=jnp.asarray(pts))
    _, jstash = JT.train_fwd_int8(jfp, jcfg, jnp.asarray(pts), DIM, L,
                                  tile=STASH_TILE, interpret=True,
                                  stash_q=True)
    like = F.calibrate_r2l_int8_pe(model, cfg, DIM, L, t(pts),
                                   fold_requant=False)
    fp = int8_params_from_jax(jfp, like)
    stash = torch.from_numpy(np.array(jstash, np.int8))
    nb, W = cfg.num_blocks, cfg.netwidth
    jbody = params["body"]["w"].reshape(2 * nb, W, W).astype(jnp.bfloat16)
    body_w = F.prepare_fused_params_pe(model, cfg, DIM, L).body_w
    dh = (rng.normal(size=(N, W)) * 1e-3).astype(np.float32)
    return jcfg, jfp, jstash, cfg, fp, stash, body_w, jbody, dh


@pytest.fixture(scope="module")
def case():
    return _case()


def _body_scale(c, kind):
    """The probe's body_scale (1/body_inv, f32 as JAX computes it), or a
    ``unit`` one drawn from U[0.5, 2) with numpy."""
    jfp = c[1]
    if kind == "probe":
        return np.asarray(1.0 / jfp.body_inv)
    return np.random.default_rng(9).uniform(
        0.5, 2.0, np.shape(jfp.body_inv)).astype(np.float32)


def _jax_group(c, b_start, b_count, tile, kind="probe"):
    jcfg, jfp, jstash, _, _, _, _, jbody, dh0 = c
    out = JQ.bwd_group_qdx(jbody, jfp.body_q, jfp.body_m, jstash,
                           jnp.asarray(dh0), jcfg, b_start, b_count,
                           tile=tile,
                           body_scale=jnp.asarray(_body_scale(c, kind)))
    return [np.asarray(o) for o in out]


def _port_group(c, b_start, b_count, tile, kind="probe", dts=None):
    _, _, _, cfg, fp, stash, body_w, _, dh0 = c
    return P.bwd_group_qdx(body_w, fp.body_q, fp.body_m, stash, t(dh0), cfg,
                           b_start, b_count, tile=tile,
                           body_scale=t(_body_scale(c, kind)), dts=dts)


def _assert_matches(got, want):
    dh, dw, db = got
    np.testing.assert_array_equal(n(dh), want[0])
    assert dw.shape == (want[1].shape[0],) + want[1].shape[1:]
    assert _rel(n(dw), np.swapaxes(want[1], -1, -2)) <= TOL_DW
    assert _rel(n(db), want[2]) <= TOL_DW


@pytest.mark.parametrize("kind", ["probe", "unit"])
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("b_start,b_count", [(0, 4), (1, 2)])
def test_group_matches_the_jax_probe(case, b_start, b_count, tile, kind):
    got = _port_group(case, b_start, b_count, tile, kind)
    _assert_matches(got, _jax_group(case, b_start, b_count, tile, kind))
    if kind == "unit":   # dx moves dh: the test sees every step
        assert np.mean(n(got[0]) != case[-1]) > 0.9


def test_res_scale_rides_in_the_tail_multiplier():
    """With res_scale 0.5 the block tails' m hold it (fc2's dx quantizes the
    raw dh): still bit for bit."""
    c = _case(res_scale=0.5, seed=3)
    _assert_matches(_port_group(c, 0, 4, 64, "unit"),
                    _jax_group(c, 0, 4, 64, "unit"))


def test_tile_is_a_numerical_parameter(case):
    """One scale per tile: tiles of 32 and 64 rays give different dh and
    dt1, each JAX's at its own tile."""
    outs = {}
    for tile in (32, 64):
        dts = torch.empty((8, N, 32), dtype=torch.bfloat16)
        outs[tile] = n(_port_group(case, 0, 4, tile, "unit", dts)[0]), dts
        np.testing.assert_array_equal(
            outs[tile][0], _jax_group(case, 0, 4, tile, "unit")[0])
    assert np.mean(outs[32][0] != outs[64][0]) > 0.05
    assert torch.equal(outs[32][1][7], outs[64][1][7])    # dt2: no scale
    assert float((outs[32][1][6] != outs[64][1][6]).float().mean()) > 0.05


def test_dh_update_is_one_fma():
    """XLA on the CPU contracts the probe's ``dh + acc * (inv / s)`` into
    one fused multiply-add inside the Pallas kernel; the port's
    ``_dequant`` (one rounding after an exact float64 product) equals it,
    and the two-rounding form differs."""
    r = np.random.default_rng(5)
    acc = r.integers(-200000, 200000, size=(64, 128)).astype(np.int32)
    dh = r.normal(size=(64, 128)).astype(np.float32)
    inv = r.uniform(0.5, 2.0, size=(1, 128)).astype(np.float32)
    s = np.full((1, 1), r.uniform(1e3, 1e4), np.float32)

    def kern(acc_ref, dh_ref, inv_ref, s_ref, o_ref):
        o_ref[...] = dh_ref[...] + acc_ref[...].astype(jnp.float32) * (
            inv_ref[...] / s_ref[0, 0])

    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((64, 128), jnp.float32),
        interpret=True)(acc, dh, inv, s))
    c = t(inv) / t(s)
    got = n(F._dequant(torch.from_numpy(acc).float(), c, t(dh)))
    np.testing.assert_array_equal(got, want)
    two = n(t(dh) + torch.from_numpy(acc).float() * c)
    assert np.mean(two != want) > 0.05


def test_top_layer_is_k5s(case):
    """The group's top layer sees dt2 = (dh * rs).bf16 exactly as K5 does:
    its dW and db equal K5's plain version bit for bit, and the optional
    scratch receives dt2."""
    _, _, _, cfg, fp, stash, body_w, _, dh0 = case
    dts = torch.empty((8, N, cfg.netwidth), dtype=torch.bfloat16)
    dh, dw, db = _port_group(case, 0, 4, 64, dts=dts)
    _, dw5, db5 = T.bwd_group(body_w, stash, t(dh0), cfg, 0, 4,
                              body_scale=1.0 / fp.body_inv)
    assert torch.equal(dw[7], dw5[7]) and torch.equal(db[7], db5[7])
    assert torch.equal(dts[7], (t(dh0) * cfg.res_scale).bfloat16())
    assert not torch.equal(dw[6], dw5[6])   # dt1 is the int8 one


@pytest.mark.parametrize("gb", [3, 4])
def test_walk_matches_the_jax_probe(case, gb):
    """The driver's walk at 4 blocks in groups of gb (a last group of 1 at
    gb = 3): qdx's dh bit for bit, its dW groups within TOL_DW, and the
    cosines against the bf16 walk within TOL_COS of JAX's."""
    jcfg, jfp, jstash, cfg, fp, stash, body_w, jbody, dh0 = case
    want = {v: JQ.walk(v, jcfg, jbody, jfp, jstash, jnp.asarray(dh0), gb, 64)
            for v in P.VARIANTS}
    got = {v: P.walk(v, cfg, body_w, fp, stash, t(dh0), gb, 64)
           for v in P.VARIANTS}
    assert len(got["qdx"][1]) == -(-cfg.num_blocks // gb)
    np.testing.assert_array_equal(n(got["qdx"][0]),
                                  np.asarray(want["qdx"][0]))
    for g, w in zip(got["qdx"][1], want["qdx"][1]):
        assert _rel(n(g), np.swapaxes(np.asarray(w), -1, -2)) <= TOL_DW

    def cosines(r, swap):
        dws = {v: [np.swapaxes(np.asarray(d), -1, -2) if swap else n(d)
                   for d in r[v][1]] for v in P.VARIANTS}
        return (P.cosine(torch.from_numpy(np.asarray(r["qdx"][0])),
                         torch.from_numpy(np.asarray(r["bf16"][0]))),
                min(P.cosine(torch.from_numpy(q), torch.from_numpy(b))
                    for q, b in zip(dws["qdx"], dws["bf16"])))

    cg, cw = cosines(got, False), cosines(want, True)
    assert 0.0 < cg[0] < 1.0 and 0.0 < cg[1] <= 1.0
    assert abs(cg[0] - cw[0]) <= TOL_COS and abs(cg[1] - cw[1]) <= TOL_COS


def test_reference_dx_is_off_by_the_scale_squared(case):
    """The fault the probe carries (ROADMAP C): the calibration packs
    w[i, j] ~ q[i, j] m[j] body_inv[i], so dx = (u_q @ q^T) (body_inv / s);
    the probe multiplies by 1/body_inv instead. On one block, K5's dx
    (bf16) agrees with the int8 dx dequantized by body_inv (cosine above
    0.999, the same size), not with the probe's (a factor of the squared
    activation scale, 1e-3 and below here, smaller)."""
    from r2l_tpu_torch.kernels.r2l_train import _group_inputs
    _, _, _, cfg, fp, stash, body_w, _, dh0 = case
    nb, W, b = cfg.num_blocks, cfg.netwidth, cfg.num_blocks - 1
    dh = t(dh0)
    k5 = T.bwd_group(body_w, stash, dh, cfg, b, 1,
                     body_scale=1.0 / fp.body_inv)[0] - dh
    probe = _port_group(case, b, 1, 64)[0] - dh
    _, _, mask = _group_inputs(stash, nb, b, torch.bfloat16,
                               1.0 / fp.body_inv)
    acc, c = P._qdx(dh, fp.body_m[2 * b + 1], fp.body_q[2 * b + 1],
                    fp.body_inv[2 * b + 1], 64)
    g = torch.where(mask, (acc * c).view(N, W), 0.0)
    acc, c = P._qdx(g, fp.body_m[2 * b], fp.body_q[2 * b],
                    fp.body_inv[2 * b], 64)
    algebra = (acc * c).view(N, W)
    assert P.cosine(algebra, k5) > 0.999
    assert 0.8 < float(algebra.norm() / k5.norm()) < 1.25
    assert float(probe.norm() / k5.norm()) < 1e-3
    assert float((1.0 / fp.body_inv).max()) < 3e-2


def test_refuses_a_ragged_tile_and_the_bf16_stash(case):
    with pytest.raises(ValueError, match="whole number"):
        _port_group(case, 0, 4, 48)
    _, _, _, cfg, fp, stash, body_w, _, dh0 = case
    with pytest.raises(ValueError, match="body_scale"):
        P.bwd_group_qdx(body_w, fp.body_q, fp.body_m, stash, t(dh0), cfg,
                        0, 4, tile=64)
    with pytest.raises(ValueError, match="variant"):
        P.walk("fp8", cfg, body_w, fp, stash, t(dh0))


def test_bounds():
    """At the canonical size a 4-block call's bound is 0.130 ms (int8 dx
    0.043 + bf16 dW 0.087), a whole walk's 1.400 ms against K5's 1.867."""
    cfg = R2LConfig()
    assert P.walk_bound_ms("qdx", cfg, P.B, 4) == pytest.approx(0.1302,
                                                                abs=1e-4)
    assert P.walk_bound_ms("qdx", cfg, P.B) == pytest.approx(1.400,
                                                             abs=1e-3)
    assert P.walk_bound_ms("bf16", cfg, P.B) == pytest.approx(1.867,
                                                              abs=1e-3)
    assert _harness.bound_ms(P.walk_ops(cfg, P.B) * 8, "int8") == \
        pytest.approx(0.0434, abs=1e-4)


def test_runner_needs_a_gpu(capsys):
    """Without CUDA the driver exits non-zero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        P.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
