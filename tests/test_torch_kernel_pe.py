"""Port parity: the PE-fused kernel module (r2l_tpu_torch/kernels/
r2l_fused.py, K1) against r2l_tpu/kernels/r2l_pallas.py in interpret mode.

On the CPU the wrapper runs its plain version, so these tests hold that
plain version to the Pallas kernel; tests/test_torch_cuda.py holds the CUDA
kernel to the plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import kernel_layout, models, n, t
from r2l_tpu.encoding import r2l_embed as jax_r2l_embed
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models import apply_r2l
from r2l_tpu_torch.encoding import r2l_embed
from r2l_tpu_torch.kernels import r2l_fused as F

# f32 weights: the same ladder and chain, f32 sums in another order.
TOL_F32 = 1e-5
# bf16 weights: a one-ulp difference in a dot can flip the bf16 rounding of
# an activation (the bound of tests/test_pallas_pe.py:50).
TOL_BF16 = 3e-2


def _case(dim_pts, L, W, D, compute_dtype, rows=24, seed=5):
    jcfg = JaxR2LConfig(input_dim=dim_pts * (2 * L + 1), netwidth=W,
                        netdepth=D, compute_dtype=compute_dtype,
                        precision="highest")
    params, cfg, model = models(jcfg, seed=seed)
    pts = (np.random.default_rng(seed).normal(size=(rows, dim_pts)) * 0.5
           ).astype(np.float32)
    return jcfg, params, cfg, model, pts


def test_pe_row_permutation_and_ladder():
    """The freq-major permutation is the JAX one, and the ladder matches
    the JAX ladder and direct sin/cos (to its own ~2^L ulp)."""
    np.testing.assert_array_equal(F._pe_row_permutation(48, 10),
                                  JP._pe_row_permutation(48, 10))
    p = np.random.default_rng(0).uniform(-6, 6, (64, 48)).astype(np.float32)
    s_t, c_t = F._pe_sin_cos_ladder(t(p), 10)
    s_j, c_j = JP._pe_sin_cos_ladder(jnp.asarray(p), 10)
    # Each ladder is within ~2^(L-1) ulp of direct sin/cos; XLA's sin/cos
    # and its FMA in 1-2s*s differ from PyTorch's by an ulp, which octave j
    # amplifies by up to 2^j: measured 2.5e-4 between the two at L=10
    # for |p| <= 6, the range of the sample points.
    tol = 5e-4
    for a, b in zip(s_t + c_t, s_j + c_j):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=tol)
    emb = n(r2l_embed(t(p), 10))[:, F._pe_row_permutation(48, 10)]
    np.testing.assert_allclose(np.concatenate([n(a) for a in s_t + c_t]
                                              + [p], 1), emb,
                               rtol=0, atol=tol)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_prepare_fused_params_pe_matches_jax(wd):
    jcfg, params, cfg, model, _ = _case(12, 4, 64, 6, jnp.bfloat16)
    jwd = jnp.float32 if wd == torch.float32 else jnp.bfloat16
    jfp = JP.prepare_fused_params_pe(params, jcfg, 12, 4, weight_dtype=jwd)
    fp = F.prepare_fused_params_pe(model, cfg, 12, 4, weight_dtype=wd)
    for name in fp._fields:
        got = getattr(fp, name)
        assert got.dtype == (torch.float32 if name.endswith("_b") else wd)
        np.testing.assert_array_equal(
            n(got), kernel_layout(name, getattr(jfp, name), got).astype(np.float32))


@pytest.mark.parametrize("dim_pts,L,W,D", [(12, 4, 128, 6), (48, 10, 64, 8)])
def test_pe_ref_matches_pallas_interpret_f32(dim_pts, L, W, D):
    jcfg, params, cfg, model, pts = _case(dim_pts, L, W, D, jnp.float32)
    jfp = JP.prepare_fused_params_pe(params, jcfg, dim_pts, L,
                                     weight_dtype=jnp.float32)
    want = np.asarray(JP.fused_r2l_apply_pe(jfp, jcfg, jnp.asarray(pts),
                                            dim_pts, L, tile=16,
                                            interpret=True))
    fp = F.prepare_fused_params_pe(model, cfg, dim_pts, L,
                                   weight_dtype=torch.float32)
    got = n(F.fused_r2l_apply_pe(fp, cfg, t(pts), dim_pts, L))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)
    # and the plain version is the wrapper's CPU path, call for call
    np.testing.assert_array_equal(
        got, n(F.fused_r2l_apply_pe_ref(fp, cfg, t(pts), dim_pts, L)))


def test_pe_ref_matches_pallas_interpret_bf16_and_apply_r2l():
    jcfg, params, cfg, model, pts = _case(48, 10, 64, 6, jnp.bfloat16)
    jfp = JP.prepare_fused_params_pe(params, jcfg, 48, 10)
    want = np.asarray(JP.fused_r2l_apply_pe(jfp, jcfg, jnp.asarray(pts), 48,
                                            10, tile=8, interpret=True))
    fp = F.prepare_fused_params_pe(model, cfg, 48, 10)
    got = n(F.fused_r2l_apply_pe(fp, cfg, t(pts), 48, 10))
    assert float(np.max(np.abs(got - want))) < TOL_BF16
    ref = np.asarray(apply_r2l(params, jcfg, jax_r2l_embed(
        jnp.asarray(pts), 10)))
    assert float(np.max(np.abs(got - ref))) < TOL_BF16


def test_pe_canonical_shape_runs():
    """Canonical D=88/W=256 at 16 rays: the plain path against Pallas."""
    jcfg, params, cfg, model, pts = _case(48, 10, 256, 88, jnp.bfloat16,
                                          rows=16, seed=1)
    jfp = JP.prepare_fused_params_pe(params, jcfg, 48, 10)
    want = np.asarray(JP.fused_r2l_apply_pe(jfp, jcfg, jnp.asarray(pts), 48,
                                            10, tile=16, interpret=True))
    fp = F.prepare_fused_params_pe(model, cfg, 48, 10)
    got = n(F.fused_r2l_apply_pe(fp, cfg, t(pts), 48, 10))
    assert got.shape == (16, 3) and np.isfinite(got).all()
    assert float(np.max(np.abs(got - want))) < TOL_BF16


def test_wrapper_rejects_bad_inputs_before_any_launch():
    """Type and shape checks raise; nothing falls back."""
    jcfg, params, cfg, model, pts = _case(12, 4, 64, 6, jnp.float32)
    fp = F.prepare_fused_params_pe(model, cfg, 12, 4,
                                   weight_dtype=torch.float32)
    with pytest.raises(ValueError):
        F._check(t(pts), "pts", torch.float32, (24, 13), torch.device("cpu"))
    with pytest.raises(TypeError):
        F._check(t(pts).double(), "pts", torch.float32, (24, 12),
                 torch.device("cpu"))
    with pytest.raises(ValueError):
        F._check(t(pts).T, "pts", torch.float32, (12, 24),
                 torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        F.prepare_fused_params_pe(model, cfg.__class__(
            **{**cfg.__dict__, "act": "lrelu"}), 12, 4)
