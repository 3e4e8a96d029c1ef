"""Port parity: the encoded-input kernel API (r2l_tpu_torch/kernels/
r2l_fused.py: ``fused_r2l_apply``, ``prepare_fused_params``, K9) against
r2l_tpu/kernels/r2l_pallas.py's ``fused_r2l_apply`` in interpret mode, in
the cases of tests/test_pallas_kernel.py.

On the CPU the wrapper runs its plain version, so these tests hold that
plain version to the Pallas kernel; tests/test_torch_cuda.py holds the CUDA
kernel to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.kernels as JK
import r2l_tpu_torch.kernels as K
from _torch_parity import kernel_layout, models, n, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu_torch.kernels import r2l_fused as F

# f32 weights: the same chain, f32 sums in another order. bf16 weights: a
# one-ulp difference in a dot can flip the bf16 rounding of an activation,
# which propagates (tests/test_pallas_kernel.py:31-32).
TOL_F32, TOL_BF16 = 1e-5, 3e-2

# (input_dim, netwidth, netdepth, rows, knobs): the cases of
# tests/test_pallas_kernel.py: its shape, the canonical W256/D88 at 8 rays,
# a linear tail without the global residual, and a ragged batch (13 rows,
# not a multiple of a tile).
CASES = {
    "w128": (48, 128, 8, 40, {}),
    "canonical": (1008, 256, 88, 8, {}),
    "linear_tail_no_residual": (24, 64, 6, 40, {"linear_tail": True,
                                                "use_residual": False}),
    "ragged": (24, 64, 6, 13, {}),
}


def _case(name, cd, seed=7):
    in_dim, W, D, rows, kw = CASES[name]
    jcfg = JaxR2LConfig(input_dim=in_dim, netwidth=W, netdepth=D,
                        compute_dtype=cd, precision="highest", **kw)
    params, cfg, model = models(jcfg, seed=seed)
    x = (np.random.default_rng(seed).normal(size=(rows, in_dim)) * 0.3
         ).astype(np.float32)
    return jcfg, params, cfg, model, x


def test_the_kernel_api_is_exported():
    assert set(K.__all__) == set(JK.__all__) == {"fused_r2l_apply",
                                                 "prepare_fused_params"}
    assert K.fused_r2l_apply is F.fused_r2l_apply


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_prepare_fused_params_matches_jax(wd):
    """Field for field the JAX packing in the port's layout: weights
    [out, in], the head's rows in r2l_embed's order (no permutation), its
    input padded with zeros to a multiple of 128."""
    jcfg, params, cfg, model, _ = _case("w128", jnp.bfloat16)
    jwd = jnp.float32 if wd == torch.float32 else jnp.bfloat16
    jfp = JP.prepare_fused_params(params, jcfg, weight_dtype=jwd)
    fp = F.prepare_fused_params(model, cfg, weight_dtype=wd)
    assert fp.head_w.shape == (128, 128)
    for name in fp._fields:
        got = getattr(fp, name)
        assert got.dtype == (torch.float32 if name.endswith("_b") else wd)
        np.testing.assert_array_equal(
            n(got), kernel_layout(name, getattr(jfp, name), got).astype(
                np.float32))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("cd", [jnp.float32, jnp.bfloat16])
def test_fused_ref_matches_pallas(name, cd):
    jcfg, params, cfg, model, x = _case(name, cd)
    jfp = JP.prepare_fused_params(params, jcfg, weight_dtype=cd)
    want = np.asarray(JP.fused_r2l_apply(jfp, jcfg, jnp.asarray(x), tile=8,
                                         interpret=True))
    fp = F.prepare_fused_params(model, cfg, weight_dtype=cfg.compute_dtype)
    got = n(F.fused_r2l_apply(fp, cfg, t(x)))
    assert got.shape == want.shape == (x.shape[0], 3)
    assert np.isfinite(got).all()
    tol = TOL_F32 if cd == jnp.float32 else TOL_BF16
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # and the plain version is the wrapper's CPU path, call for call
    np.testing.assert_array_equal(got, n(F.fused_r2l_apply_ref(fp, cfg,
                                                               t(x))))


@pytest.mark.parametrize("x_dtype", ["float16", "bfloat16"])
def test_fused_ref_rounds_x_once(x_dtype):
    """x of another float dtype is cast to the compute dtype once, as JAX's
    ``x.astype(cd)``: the same half-precision values give JAX's output."""
    jcfg, params, cfg, model, x = _case("w128", jnp.bfloat16)
    xt = t(x).to(getattr(torch, x_dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    jfp = JP.prepare_fused_params(params, jcfg)
    want = np.asarray(JP.fused_r2l_apply(jfp, jcfg, jx, tile=8,
                                         interpret=True))
    fp = F.prepare_fused_params(model, cfg)
    got = n(F.fused_r2l_apply(fp, cfg, xt))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BF16)
    np.testing.assert_array_equal(
        got, n(F.fused_r2l_apply_ref(fp, cfg, xt.to(torch.bfloat16))))


def test_prepare_fused_params_pe_is_the_permuted_packing():
    """The PE packing is this packing with the head rows freq-major."""
    _, cfg, model = models(JaxR2LConfig(input_dim=5 * 9, netwidth=64,
                                        netdepth=6), seed=3)
    pe = F.prepare_fused_params_pe(model, cfg, 5, 4)
    plain = F.prepare_fused_params(model, cfg)
    perm = torch.from_numpy(F._pe_row_permutation(5, 4))
    assert torch.equal(pe.head_w[:, :45], plain.head_w[:, perm])
    for name in ("head_b", "body_w", "body_b", "tail_w", "tail_b"):
        assert torch.equal(getattr(pe, name), getattr(plain, name))
