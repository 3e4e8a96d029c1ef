"""Port parity: the R2L student module (r2l_tpu_torch/models/r2l.py)
against r2l_tpu.models.apply_r2l, with weights carried by
params_from_jax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import models, n, np_tree, t
from r2l_tpu.checkpoint import params_to_torch_r2l
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models import apply_r2l
from r2l_tpu.models import init_r2l as jax_init_r2l
from r2l_tpu_torch.models import R2L, R2LConfig, init_r2l, params_from_jax

# f32 at precision="highest" on both sides: the same products summed in a
# different order over a few layers.
TOL_F32 = 1e-5
# bf16: both round the same ops to bf16 (dot cast, then bias in bf16);
# measured one f32 ulp (6e-8) here. The bound leaves room for one flipped
# bf16 rounding of a hidden activation, were XLA on the CPU to keep an
# elementwise chain in f32 where eager PyTorch rounds each op.
TOL_BF16 = 1e-3

BASE = JaxR2LConfig(input_dim=6 * 9, netdepth=8, netwidth=64,
                    precision="highest")
KNOBS = {
    "canonical": {},
    "lrelu_act": {"act": "lrelu", "inact": "lrelu"},
    "outact_relu": {"outact": "relu"},
    "res_scale": {"res_scale": 0.5},
    "n_block": {"n_block": 2},
    "n_learnable_1": {"n_learnable": 1},
    "n_learnable_3": {"n_learnable": 3},
    "no_residual": {"use_residual": False},
    "linear_tail": {"linear_tail": True},
    "learn_depth_out4": {"output_dim": 4},
    "mlp_body": {"body_arch": "mlp"},
    "mlp_layerwise": {"body_arch": "mlp",
                      "layerwise_widths": (64, 32, 48, 64, 40, 56, 64)},
}


def _x(rows=10, dim=54, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, size=(rows, dim)).astype(np.float32)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_r2l_f32_matches_apply_r2l(knob):
    jcfg = dataclasses.replace(BASE, **KNOBS[knob])
    params, cfg, model = models(jcfg, seed=3)
    x = _x()
    want = np.asarray(apply_r2l(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = n(model(t(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("knob", ["canonical", "res_scale", "mlp_body"])
def test_r2l_bf16_close_to_apply_r2l(knob):
    jcfg = dataclasses.replace(BASE, compute_dtype=jnp.bfloat16,
                               precision="default", **KNOBS[knob])
    params, cfg, model = models(jcfg, seed=4)
    x = _x(rows=32)
    want = np.asarray(apply_r2l(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = n(model(t(x)))
    assert float(np.max(np.abs(got - want))) < TOL_BF16


@pytest.mark.parametrize("knob", ["canonical", "linear_tail", "mlp_body",
                                  "n_learnable_3"])
def test_state_dict_names_match_params_to_torch_r2l(knob):
    """Reference naming (head.0, body.<i>.body.<2j>, tail.0 / tail): the
    module's state_dict and the JAX converter agree key for key and value
    for value, so reference checkpoints load with load_state_dict."""
    jcfg = dataclasses.replace(BASE, **KNOBS[knob])
    params = jax.tree.map(np.asarray, jax_init_r2l(jax.random.key(5), jcfg))
    ref = params_to_torch_r2l(params, jcfg)
    cfg = models(jcfg)[1]
    sd = params_from_jax(np_tree(params), cfg)
    assert set(sd) == set(ref) == set(R2L(cfg).state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


def test_init_r2l_is_seeded_and_bounded():
    cfg = R2LConfig(input_dim=54, netdepth=8, netwidth=64)
    a = init_r2l(cfg, torch.Generator().manual_seed(0))
    b = init_r2l(cfg, torch.Generator().manual_seed(0))
    c = init_r2l(cfg, torch.Generator().manual_seed(1))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        assert not torch.equal(va, vc), k
    # U(+-1/sqrt(fan_in)) for weight and bias alike
    head = a.head[0].requires_grad_(False)
    bound = 1.0 / np.sqrt(54)
    assert float(head.weight.abs().max()) <= bound
    assert float(head.bias.abs().max()) <= bound
    assert float(head.weight.abs().max()) > 0.9 * bound


def test_params_from_jax_takes_numpy_only():
    cfg = R2LConfig(input_dim=54, netdepth=8, netwidth=64)
    params = np_tree(models(BASE)[0])
    params["head"]["w"] = jnp.asarray(params["head"]["w"])
    with pytest.raises(TypeError):
        params_from_jax(params, cfg)
