"""Port parity: the int8 wall probe (r2l_tpu_torch/exp/probe_wall.py)
against exp/probe_wall.py. The probe's kernel body (kern) runs through
pl.pallas_call with make's block specs in TPU interpret mode on the CPU, on
make's own weights (jax.random.randint from key 0, m = 1e-3) carried over by
weights_from_jax; the port's plain versions run on the same arrays. 64
rays, 4-8 layers. Every mode is exact integer arithmetic with the same
roundings: bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import load_exp_probe
from r2l_tpu_torch.exp import probe_wall as P
from r2l_tpu_torch.exp.probe_mxu import weights_from_jax

JW = load_exp_probe("probe_wall")
T, W = 64, 256


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(T, W)).astype(np.float32)


def _jax_weights(n_layers):
    """make's weights and multipliers (exp/probe_wall.py:74-77)."""
    w = jax.random.randint(jax.random.key(0), (n_layers, W, W), -4, 4,
                           jnp.int32).astype(jnp.int8)
    return w, jnp.full((n_layers, W), 1e-3, jnp.float32)


def _pallas(mode, x, w, m, monkeypatch):
    monkeypatch.setattr(JW, "N_LAYERS", w.shape[0])
    specs = [pl.BlockSpec((T, W), lambda i: (i, 0), memory_space=pltpu.VMEM),
             pl.BlockSpec(w.shape, lambda i: (0, 0, 0),
                          memory_space=pltpu.VMEM),
             pl.BlockSpec(m.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)]
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            functools.partial(JW.kern, mode=mode), grid=(1,), in_specs=specs,
            out_specs=pl.BlockSpec((T, W), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((T, W), jnp.float32))(
                jnp.asarray(x), w, m)
    return np.asarray(out)


@pytest.mark.parametrize("n_layers", [4, 8])
@pytest.mark.parametrize("mode", list(P.MODES))
def test_wall_ref_equals_pallas(mode, n_layers, monkeypatch):
    w, m = _jax_weights(n_layers)
    x = _x()
    want = _pallas(mode, x, w, m, monkeypatch)
    wt, mt = weights_from_jax(w)[0], torch.from_numpy(np.array(m))
    got = P.wall(torch.from_numpy(x), wt, mt, mode).numpy()
    np.testing.assert_array_equal(got, want)
    # realistic decays to exactly 0 by 8 layers (m = 1e-3), as make_int8's
    # chain does at 86; the shallow case checks its arithmetic
    if mode != "realistic" or n_layers == 4:
        assert np.abs(got).sum() > 0


def test_mincast_wraps_as_xla(monkeypatch):
    """mincast's int8 cast wraps modulo 256 (XLA's convert). The probe's
    random sums never leave the int8 range after the shift, so saturated
    inputs and weights of 3 make them: 256 * 127 * 3 >> 8 = 381 wraps to
    125, then 256 * 125 * +-3 >> 8 = +-375 to 119 and -119 (weights of
    both signs)."""
    x = np.full((T, W), 10.0, np.float32)
    w = np.full((2, W, W), 3, np.int8)
    w[1, :, W // 2:] = -3
    m = jnp.full((2, W), 1e-3, jnp.float32)
    want = _pallas("mincast", x, jnp.asarray(w), m, monkeypatch)
    got = P.wall(torch.from_numpy(x), weights_from_jax(w)[0],
                 torch.from_numpy(np.array(m)), "mincast").numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {125.0 * 3 - 256, -(125.0 * 3 - 256)}


def test_mxu_only_sum_is_exact_in_f32():
    """At the probe's 86 layers the int32 sum stays below 2^24, so its f32
    value is exact."""
    assert P.N_LAYERS * W * 127 * 4 < 2 ** 24


@pytest.mark.parametrize("mode", list(P.MODES))
def test_runner_mode_gives_the_jax_checksum(mode, monkeypatch):
    """The runner's mode on the CPU against make's checksum (jnp.sum of its
    output) at 64 rays and 4 layers, make's own weights: the same outputs,
    summed in another f32 order."""
    monkeypatch.setattr(JW, "N_RAYS", T)
    monkeypatch.setattr(JW, "N_LAYERS", 4)
    x = _x(1)
    with pltpu.force_tpu_interpret_mode():
        want = float(JW.make(mode, T)(jnp.asarray(x)))
    w, m = _jax_weights(4)
    got = float(P.wall(torch.from_numpy(x), weights_from_jax(w)[0],
                       torch.from_numpy(np.array(m)), mode).sum())
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_make_weights_are_the_probes_kind():
    w, m = P.make_weights(torch.Generator().manual_seed(0), 2, "cpu")
    assert w.dtype == torch.int8 and w.shape == (2, W, W)
    assert int(w.min()) == -4 and int(w.max()) == 3
    assert m.shape == (2, W) and bool((m == torch.tensor(1e-3)).all())


def test_bound_is_the_probes():
    assert P.ops_per_frame() == JW.FPF
    assert P.ops_per_frame() / 1979e12 * 1e3 == pytest.approx(0.933,
                                                              abs=1e-3)


def test_runner_needs_a_gpu(capsys):
    """Without CUDA the runner exits non-zero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        P.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
