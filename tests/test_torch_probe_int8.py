"""Port parity: K2's int8 ResMLP body probe (r2l_tpu_torch/exp/probe_int8.py)
against exp/probe_int8.py. The probe's kernel bodies (resmlp_kernel with and
without fold, single and dual; resmlp_kernel_interleaved; bf16_kernel) run
through pl.pallas_call with make_runner's block specs in TPU interpret mode
on the CPU, with N_BLOCKS set to 2-4 (a module global read at trace time);
both packages draw the weights from numpy's default_rng(0) (mk_weights) and
quantize them alike. 64 rays, W = 256."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import load_exp_probe
from r2l_tpu_torch.exp import probe_int8 as P

JM = load_exp_probe("probe_int8")
T, W = 64, 256
# Tolerances against the Pallas bodies on the CPU:
# * int8 bodies: bit for bit. The dots are exact; the epilogues group as
#   XLA's CPU contraction does (found by test_xla_groupings: one FMA for
#   acc*m + b; m*INV_A, b*INV_A, m*RS and b*RS rounded on their own; the
#   residual added after the FMA).
# * bf16 control: XLA's f32 dot sums in another order than torch's, and a
#   flipped bf16 rounding then propagates: K1 bf16's bound (3e-2 max-abs,
#   tests/test_pallas_pe.py:50) with a small share of outputs flipped, as
#   tests/test_torch_probe_mxu.py holds the bf16 chain.
TOL_BF16, MAX_FLIPPED_SHARE = 3e-2, 2e-2


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(T, W)).astype(np.float32)


def _pallas(kern, x, arrays):
    """A body over one 64-ray tile with make_runner's specs."""
    specs = [pl.BlockSpec((T, W), lambda i: (i, 0), memory_space=pltpu.VMEM)]
    for a in arrays:
        specs.append(pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd,
                                  memory_space=pltpu.VMEM))
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kern, grid=(1,), in_specs=specs,
            out_specs=pl.BlockSpec((T, W), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((T, W), jnp.float32))(
                jnp.asarray(x), *arrays)
    return np.asarray(out)


def _jax_arrays(n_blocks, monkeypatch):
    monkeypatch.setattr(JM, "N_BLOCKS", n_blocks)
    wf, bf = JM.mk_weights()
    return wf, bf, JM.quantize(wf, bf, JM.A_SCALE)


def test_weights_and_quantization_match_jax(monkeypatch):
    """mk_weights from the same numpy generator and quantize: every array
    bit for bit (the port's packed [out, in])."""
    wf, bf, (wq, m, b) = _jax_arrays(3, monkeypatch)
    pw, pb = P.mk_weights(0, 3)
    np.testing.assert_array_equal(pw.numpy(),
                                  np.swapaxes(np.asarray(wf), 1, 2))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(bf))
    q, mt, bt = P.quantize(pw, pb, P.A_SCALE)
    np.testing.assert_array_equal(q.numpy(), np.swapaxes(np.asarray(wq), 1, 2))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(m))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(b))
    assert float(np.float32(P.INV_A)) == 63.5


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("fold", [False, True])
def test_int8_body_equals_pallas(fold, n_blocks, monkeypatch):
    wf, bf, arrays = _jax_arrays(n_blocks, monkeypatch)
    x = _x()
    want = _pallas(functools.partial(JM.resmlp_kernel, dual=False, fold=fold),
                   x, arrays)
    weights = P.variant_weights("int8_resmlp", "cpu", n_blocks)
    got = P.resmlp(torch.from_numpy(x), *weights,
                   body="int8_fold" if fold else "int8").numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0


def test_dual_and_interleaved_are_the_single_body(monkeypatch):
    """JAX's dual body (two half tiles, one after the other) and the
    interleaved one (layer by layer) give the single body's output bit for
    bit (rows never mix), and so does the port's dual form."""
    _, _, arrays = _jax_arrays(2, monkeypatch)
    x = _x(1)
    single = _pallas(functools.partial(JM.resmlp_kernel, dual=False,
                                       fold=False), x, arrays)
    for kern in (functools.partial(JM.resmlp_kernel, dual=True, fold=False),
                 JM.resmlp_kernel_interleaved):
        np.testing.assert_array_equal(_pallas(kern, x, arrays), single)
    weights = P.variant_weights("int8_resmlp_dual", "cpu", 2)
    np.testing.assert_array_equal(
        P.make_variant("int8_resmlp_dual", weights)(torch.from_numpy(x)),
        P.make_variant("int8_resmlp", weights)(torch.from_numpy(x)))
    np.testing.assert_array_equal(
        P.resmlp(torch.from_numpy(x), *weights, dual=True).numpy(), single)


@pytest.mark.parametrize("dual", [False, True])
def test_bf16_control_matches_pallas(dual, monkeypatch):
    wf, bf, _ = _jax_arrays(3, monkeypatch)
    x = _x()
    want = _pallas(functools.partial(JM.bf16_kernel, dual=dual), x,
                   (wf.astype(jnp.bfloat16), bf))
    weights = P.variant_weights("bf16_resmlp", "cpu", 3)
    got = P.resmlp(torch.from_numpy(x), *weights, body="bf16",
                   dual=dual).numpy()
    d = np.abs(got - want)
    assert d.max() <= TOL_BF16, d.max()
    assert np.mean(d > 0) <= MAX_FLIPPED_SHARE, np.mean(d > 0)


def test_xla_groupings():
    """How XLA on the CPU groups the int8 epilogues, found on the probe's own
    expressions over 512 x 256 values: each against one FMA (as the port
    computes it) and the product and sum rounded apart, which differ in
    most entries, so only the port's grouping matches."""
    rng = np.random.default_rng(0)
    a = rng.integers(-20000, 20000, size=(512, W)).astype(np.int32)
    m = rng.uniform(1e-5, 1e-3, size=(1, W)).astype(np.float32)
    b = (rng.normal(size=(1, W)) * 0.02).astype(np.float32)
    h = jnp.asarray(rng.normal(size=(512, W)), jnp.float32).astype(
        jnp.bfloat16)
    specs = [pl.BlockSpec(s, lambda i, nd=len(s): (0,) * nd,
                          memory_space=pltpu.VMEM)
             for s in ((512, W), (1, W), (1, W), (512, W))]

    def run(expr):
        def body(a_r, m_r, b_r, h_r, o_r):
            o_r[...] = expr(a_r[...].astype(jnp.float32), m_r[...], b_r[...],
                            h_r[...].astype(jnp.float32))
        with pltpu.force_tpu_interpret_mode():
            return torch.from_numpy(np.array(pl.pallas_call(
                body, grid=(1,), in_specs=specs,
                out_specs=pl.BlockSpec((512, W), lambda i: (0, 0),
                                       memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((512, W), jnp.float32))(
                    a, m, b, h)))

    from r2l_tpu_torch.kernels.r2l_fused import _dequant
    at, mt, bt = (torch.from_numpy(v) for v in (a.astype(np.float32), m, b))
    ht = torch.from_numpy(np.array(h.astype(jnp.float32)))
    inv, rs = torch.tensor(P.INV_A), torch.tensor(P.RS)
    cases = [
        (lambda a, m, b, h: a * m + b, _dequant(at, mt, bt), at * mt + bt),
        (lambda a, m, b, h: a * (m * JM.INV_A) + b * JM.INV_A,
         _dequant(at, mt * inv, bt * inv), at * (mt * inv) + bt * inv),
        (lambda a, m, b, h: a * (m * JM.RS) + b * JM.RS + h,
         _dequant(at, mt * rs, bt * rs) + ht, at * (mt * rs) + bt * rs + ht),
    ]
    for expr, port, apart in cases:
        got = run(expr)
        assert torch.equal(got, port)
        assert float((got != apart).double().mean()) > 0.2


@pytest.mark.parametrize("name", P.VARIANTS)
def test_runner_variant_gives_the_jax_checksum(name, monkeypatch):
    """The runner's variant on the CPU against make_runner's checksum (jnp.sum
    of its output) at 64 rays and 2 blocks, both from mk_weights: the int8
    sums of identical outputs differ by their f32 order (1e-5); the bf16
    control's flipped roundings move a few outputs by one bf16 ulp (1e-3)."""
    monkeypatch.setattr(JM, "N_RAYS", T)
    wf, bf, arrays = _jax_arrays(2, monkeypatch)
    body, dual = P.variant_body(name)
    if body == "bf16":
        kern, arrays = (functools.partial(JM.bf16_kernel, dual=dual),
                        (wf.astype(jnp.bfloat16), bf))
    else:
        kern = functools.partial(JM.resmlp_kernel, dual=dual,
                                 fold=body == "int8_fold")
    x = _x(2)
    with pltpu.force_tpu_interpret_mode():
        want = float(JM.make_runner(kern, T, len(arrays), arrays)(
            jnp.asarray(x)))
    got = float(P.make_variant(name, P.variant_weights(name, "cpu", 2))(
        torch.from_numpy(x)))
    tol = (1e-3 if body == "bf16" else 1e-5) * abs(want)
    assert abs(got - want) <= tol, (got, want)


def test_bounds_are_the_probes():
    """The body's operations: 1.847 T a frame, 0.933 ms at the int8 peak and
    1.867 ms at the bf16 one (the control)."""
    assert P.ops_per_frame() == JM.FPF
    from r2l_tpu_torch.exp import _harness
    assert _harness.bound_ms(P.ops_per_frame(), "int8") == pytest.approx(
        0.933, abs=1e-3)
    assert _harness.bound_ms(P.ops_per_frame(), "bf16") == pytest.approx(
        1.867, abs=1e-3)


def test_runner_needs_a_gpu(capsys):
    """Without CUDA the runner exits non-zero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        P.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
