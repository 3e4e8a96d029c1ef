"""Port parity: the chain probes (r2l_tpu_torch/exp/probe_mxu.py) against
exp/probe_mxu.py. The probe's own kernel bodies (chain_kernel, bign_kernel,
int8_kernel) run through pl.pallas_call with its factories' block specs in
TPU interpret mode on the CPU, on the probe's own weights (_mk_weights from
jax.random.key(0), make_int8's quantization) carried over by
weights_from_jax; the port's plain versions run on the same arrays. 64 rays,
4-8 layers."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import load_exp_probe
from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import probe_mxu as P

JM = load_exp_probe("probe_mxu")
T, W = 64, 256
# Tolerances against the Pallas kernels on the CPU, as max-abs:
# full: XLA's f32 dot sums in another order than torch's, and a flipped bf16
#   rounding then propagates, K1 bf16's bound (tests/test_pallas_pe.py:50);
#   measured 1.95e-3 (one bf16 ulp of [0.25, 0.5)) in 115 of 16,384 outputs
#   at 4 layers.
TOL_FULL, MAX_FLIPPED_SHARE = 3e-2, 2e-2
# lean, none, bigN: the port rounds the f32 sum once; XLA's CPU result for a
#   bf16-output dot followed by the cast to f32 skips the last rounding
#   (its output is not bf16, and equals the port's chain with the last layer
#   unrounded). So one bf16 ulp of the largest output per layer bounds the
#   gap; measured 0 (lean, bigN) and 3.9e-3 (none: half an ulp near 2, the
#   missing last rounding, in every output) at 4 layers.
BF16_ULP = 2.0 ** -7
# the int8 chain: exact, at depths whose output is not zero.


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(T, W)).astype(np.float32)


def _pallas(kern, args, block_shapes):
    """The probe's kernel body over one 64-ray tile with the factory's
    specs: the ray tile, then each whole weight array."""
    specs = [pl.BlockSpec((T, W), lambda i: (i, 0),
                          memory_space=pltpu.VMEM)]
    for shape in block_shapes:
        specs.append(pl.BlockSpec(shape, lambda i, nd=len(shape): (0,) * nd,
                                  memory_space=pltpu.VMEM))
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kern, grid=(1,), in_specs=specs,
            out_specs=pl.BlockSpec((T, W), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((T, W), jnp.float32))(*args)
    return np.asarray(out)


def _jax_int8_weights(n_layers):
    """make_int8's weights and scales (exp/probe_mxu.py:225-232)."""
    wf, _ = JM._mk_weights(jax.random.key(0), n_layers, W, W, jnp.float32)
    ws = jnp.max(jnp.abs(wf), axis=1) / 127.0
    wq = jnp.clip(jnp.round(wf / ws[:, None, :]), -127, 127).astype(jnp.int8)
    return wf, wq, (ws * (4.0 / 127.0)).astype(jnp.float32)


def test_weights_from_jax_packs_out_in():
    w, b = JM._mk_weights(jax.random.key(0), 2, W, 2 * W, jnp.bfloat16)
    wt, bt = P.weights_from_jax(w, b)
    assert wt.dtype == torch.bfloat16 and wt.shape == (2, 2 * W, W)
    np.testing.assert_array_equal(
        wt.float().numpy(), np.swapaxes(np.asarray(w, np.float32), 1, 2))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(b))
    _, wq, _ = _jax_int8_weights(2)
    q, none = P.weights_from_jax(wq)
    assert q.dtype == torch.int8 and none is None
    np.testing.assert_array_equal(q.numpy(), np.swapaxes(np.asarray(wq), 1, 2))


def test_quantize_int8_matches_make_int8():
    """Per-column int8 codes and dequantize scales, bit for bit."""
    wf, wq, s = _jax_int8_weights(4)
    q, st = P.quantize_int8(P.weights_from_jax(wf)[0])
    np.testing.assert_array_equal(q.numpy(), np.swapaxes(np.asarray(wq), 1, 2))
    np.testing.assert_array_equal(st.numpy(), np.asarray(s))


def _chain_case(mode, n_layers, dual=False):
    w, b = JM._mk_weights(jax.random.key(0), n_layers, W, W, jnp.bfloat16)
    kern = functools.partial(JM.chain_kernel, n_layers=n_layers, mode=mode,
                             unroll=True, dual=dual)
    x = _x()
    want = _pallas(kern, (jnp.asarray(x), w, b),
                   [(n_layers, W, W), (n_layers, W)])
    wt, bt = P.weights_from_jax(w, b)
    return x, want, wt, bt


@pytest.mark.parametrize("mode,n_layers", [("full", 4), ("full", 8),
                                           ("lean", 4), ("none", 4)])
def test_chain_ref_matches_pallas(mode, n_layers):
    x, want, wt, bt = _chain_case(mode, n_layers)
    got = P.chain(torch.from_numpy(x), wt, bt, mode).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    if mode == "full":
        assert d.max() <= TOL_FULL, d.max()
        assert np.mean(d > 0) <= MAX_FLIPPED_SHARE, np.mean(d > 0)
    else:
        assert d.max() <= n_layers * BF16_ULP * np.abs(want).max(), d.max()
    if mode == "none":
        # XLA's last layer is the unrounded f32 sum: rounded, it is the
        # port's output bit for bit
        np.testing.assert_array_equal(
            got, torch.from_numpy(want.copy()).bfloat16().float().numpy())


def test_dual_is_the_single_stream():
    """The dual body (two interleaved half-tiles) gives the single stream's
    output in JAX, and the port's dual path is the same function."""
    x, want, wt, bt = _chain_case("lean", 4, dual=True)
    _, single, _, _ = _chain_case("lean", 4)
    np.testing.assert_array_equal(want, single)
    got = P.chain(torch.from_numpy(x), wt, bt, "lean", dual=True).numpy()
    np.testing.assert_array_equal(got, want)


def test_bign_ref_matches_pallas():
    n_pairs = 4
    w1, _ = JM._mk_weights(jax.random.key(0), n_pairs, W, 2 * W,
                           jnp.bfloat16)
    w2, _ = JM._mk_weights(jax.random.key(0), n_pairs, 2 * W, W,
                           jnp.bfloat16)
    x = _x()
    want = _pallas(functools.partial(JM.bign_kernel, n_pairs=n_pairs),
                   (jnp.asarray(x), w1, w2),
                   [(n_pairs, W, 2 * W), (n_pairs, 2 * W, W)])
    got = P.bign(torch.from_numpy(x), P.weights_from_jax(w1)[0],
                 P.weights_from_jax(w2)[0]).numpy()
    d = np.abs(got - want)
    assert d.max() <= 2 * n_pairs * BF16_ULP * np.abs(want).max(), d.max()


@pytest.mark.parametrize("n_layers", [4, 8, 86])
def test_int8_chain_ref_equals_pallas(n_layers):
    """Bit for bit. At 4 and 8 layers the output is not zero; at the
    probe's 86 it is exactly zero on both sides (the chain decays), so only
    the shallow cases check the arithmetic."""
    wf, wq, s = _jax_int8_weights(n_layers)
    x = _x()
    want = _pallas(functools.partial(JM.int8_kernel, n_layers=n_layers,
                                     inv_s=1.0 / (4.0 / 127.0)),
                   (jnp.asarray(x), wq, s), [(n_layers, W, W), (n_layers, W)])
    q, st = P.quantize_int8(P.weights_from_jax(wf)[0])
    got = P.int8_chain(torch.from_numpy(x), q, st).numpy()
    np.testing.assert_array_equal(got, want)
    if n_layers < 86:
        assert np.abs(got).sum() > 0
    else:
        assert not got.any()


@pytest.mark.parametrize("name", P.VARIANTS)
def test_runner_variant_gives_the_jax_checksum(name, monkeypatch):
    """The runner's variant on the CPU against the JAX factory's checksum
    (jnp.sum of make_chain / make_bign / make_int8) at 64 rays, 4 layers (2
    pairs for bigN), the factories' own weights."""
    monkeypatch.setattr(JM, "N_RAYS", T)    # make_bign's and make_int8's grid
    n_layers, x = 4, _x(1)
    key = jax.random.key(0)
    if name == "bigN":
        factory = JM.make_bign(T, n_layers // 2)
        w1, _ = JM._mk_weights(key, n_layers // 2, W, 2 * W, jnp.bfloat16)
        w2, _ = JM._mk_weights(key, n_layers // 2, 2 * W, W, jnp.bfloat16)
        weights = (P.weights_from_jax(w1)[0], P.weights_from_jax(w2)[0])
    elif name == "int8_static":
        factory = JM.make_int8(T, n_layers)
        wf, _, _ = _jax_int8_weights(n_layers)
        weights = P.quantize_int8(P.weights_from_jax(wf)[0])
    else:
        mode = name.removeprefix("dual_")
        factory = JM.make_chain(T, n_layers, mode, True,
                                dual=name.startswith("dual_"), n_rays=T)
        weights = P.weights_from_jax(*JM._mk_weights(
            key, n_layers, W, W, jnp.bfloat16))
    with pltpu.force_tpu_interpret_mode():
        want = float(factory(jnp.asarray(x)))
    out = P.make_variant(name, weights)
    got = float(out(torch.from_numpy(x)))
    # the sums of identical outputs differ by their f32 order (1e-5); full's
    # flipped roundings move about 1% of the outputs by one bf16 ulp (1e-3);
    # none's missing last rounding moves each output by up to half an ulp
    tol = {"full": 1e-3}.get(name, 1e-5) * abs(want)
    if name == "none":
        tol += 2.0 ** -8 * float(P.chain(torch.from_numpy(x), *weights,
                                         mode="none").abs().sum())
    assert abs(got - want) <= tol, (got, want)


def test_ops_per_frame_is_the_probes():
    n, L = JM.N_RAYS, JM.N_LAYERS
    assert P.ops_per_frame("full") == n * L * 2 * W * W
    assert P.ops_per_frame("bigN") == n * (L // 2) * 2 * 2 * W * W * 2
    assert P.ops_per_frame("full") / 989e12 * 1e3 == pytest.approx(1.867,
                                                                   abs=1e-3)


def test_runner_needs_a_gpu(capsys):
    """Without CUDA the runner exits non-zero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        P.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""


def test_log_appends_json_lines(tmp_path, capsys):
    out = tmp_path / "probe.jsonl"
    log = _harness.Log(str(out))
    log({"name": "a", "ms_per_frame": 1.5})
    log({"name": "b"})
    lines = out.read_text().splitlines()
    assert [__import__("json").loads(s)["name"] for s in lines] == ["a", "b"]
    assert capsys.readouterr().out.splitlines() == lines
