"""Port parity: K2's ``bf16_resid`` (r2l_tpu_torch/kernels/r2l_fused.py,
``fused_r2l_apply_int8_pe(..., bf16_resid=True)``) against
r2l_tpu/kernels/r2l_pallas.py::fused_r2l_apply_int8_pe in interpret mode,
in each of K2's three forms, with and without the global residual, with a
linear and a sigmoid tail, at W64/D8 and at W384/D6 (a width the port sends
to K2's wide form, whose plain twin is the same plain version).

With ``bf16_resid`` the global residual's copy h0 is the head's output
rounded to bf16, and the tail's input h + h0 is added in bf16. JAX's side
runs in a subprocess with XLA's excess precision off
(tests/_torch_forms_jax.py): under XLA's default the CPU drops those bf16
roundings (``test_default_excess_precision_drops_the_roundings`` counts
what that moves). The port's plain version runs here on JAX's packing of
the same student (carried over field by field). Tolerances: a linear tail
bit for bit; a sigmoid tail within ``TOL_SIGMOID``, one f32 ulp of
[0.5, 1), where torch's and XLA's CPU sigmoid differ on a few outputs
(tests/test_torch_kernel_int8.py). K2's three forms without the flag are
held to the same bounds here too, and so are equal to their values before
the flag existed (tests/test_torch_kernel_int8.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_forms_jax as JX
from _torch_parity import int8_case, int8_params_from_jax, n, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu_torch.kernels import r2l_fused as F

TOL_SIGMOID = 6e-8
# Outputs of JAX's bf16_resid K2 under XLA's default flags that the port's
# plain version (the roundings the Pallas code writes) must differ in, of
# the W64/D8 case's 432: more than a third (measured 329 of 432, 76%,
# deployed form, linear tail, with the global residual).
MIN_DEFAULT_DIFFER = 144


@pytest.fixture(scope="module")
def jax_k2(tmp_path_factory):
    """JAX's packings and outputs of every case, from one subprocess."""
    return JX.run("k2", str(tmp_path_factory.mktemp("k2") / "k2.npz"))


def _port_case(label, W, D, res, lin, jax_k2, fold):
    """(port cfg, JAX's packing in the port's layout, the points)."""
    _, _, cfg, model, calib, pts = int8_case(
        JX.K2_DIM, JX.K2_L, W, D, JX.K2_SIDE, use_residual=res,
        linear_tail=lin)
    like = F.calibrate_r2l_int8_pe(model, cfg, JX.K2_DIM, JX.K2_L, t(calib),
                                   fold_requant=fold, stage=False)
    key = JX.k2_key(label, res, lin)
    jfp = JX.get_tree(jax_k2, f"{key}/fold{int(fold)}")
    return cfg, int8_params_from_jax(jfp, like), t(pts)


@pytest.mark.parametrize("bf16_resid", [True, False])
@pytest.mark.parametrize("form,fold,nobf16", JX.K2_FORMS,
                         ids=[f[0] for f in JX.K2_FORMS])
@pytest.mark.parametrize("res,lin", JX.K2_CFGS,
                         ids=[f"res{int(r)}-lin{int(li)}"
                              for r, li in JX.K2_CFGS])
@pytest.mark.parametrize("label,W,D", JX.K2_WIDTHS,
                         ids=[w[0] for w in JX.K2_WIDTHS])
def test_k2_forms_match_jax_without_excess_precision(
        jax_k2, label, W, D, res, lin, form, fold, nobf16, bf16_resid):
    cfg, fp, pts = _port_case(label, W, D, res, lin, jax_k2, fold)
    assert F.wide_form(W, True, JX.K2_L) == (W > 256)
    key = JX.k2_key(label, res, lin)
    want = jax_k2[f"{key}/{form}/br{int(bf16_resid)}"]
    got = n(F.fused_r2l_apply_int8_pe(fp, cfg, pts, JX.K2_DIM, JX.K2_L,
                                      fold, nobf16, bf16_resid=bf16_resid))
    assert got.shape == want.shape
    if lin:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= TOL_SIGMOID


@pytest.mark.parametrize("res", [True, False])
@pytest.mark.parametrize("label,W,D", JX.K2_WIDTHS,
                         ids=[w[0] for w in JX.K2_WIDTHS])
def test_bf16_resid_changes_the_numbers_with_the_residual(jax_k2, label, W,
                                                          D, res):
    """The flag engages where the global residual is on (JAX's own outputs
    too), and is the parent form without it."""
    cfg, fp, pts = _port_case(label, W, D, res, True, jax_k2, True)
    a, b = (n(F.fused_r2l_apply_int8_pe(fp, cfg, pts, JX.K2_DIM, JX.K2_L,
                                        bf16_resid=br)) for br in (False,
                                                                   True))
    key = JX.k2_key(label, res, True)
    ja, jb = (jax_k2[f"{key}/deployed/br{br}"] for br in (0, 1))
    assert np.array_equal(a, b) == (not res)
    assert np.array_equal(ja, jb) == (not res)


def test_default_excess_precision_drops_the_roundings():
    """Under XLA's default flags (this process), JAX's bf16_resid K2 on the
    CPU keeps h0 and the tail's sum in f32 where the Pallas code rounds them
    to bf16: it differs from the port's plain version in most outputs, the
    parent form in none."""
    label, W, D = JX.K2_WIDTHS[0]
    jcfg, params, cfg, model, calib, pts = int8_case(
        JX.K2_DIM, JX.K2_L, W, D, JX.K2_SIDE, linear_tail=True)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, JX.K2_DIM, JX.K2_L,
                                   calib_pts=jnp.asarray(calib))
    fp = int8_params_from_jax(jfp, F.calibrate_r2l_int8_pe(
        model, cfg, JX.K2_DIM, JX.K2_L, t(calib), stage=False))
    differ = {}
    for br in (False, True):
        want = np.asarray(JP.fused_r2l_apply_int8_pe(
            jfp, jcfg, jnp.asarray(pts), JX.K2_DIM, JX.K2_L, tile=48,
            interpret=True, fold_requant=True, nobf16_inner=True,
            bf16_resid=br))
        got = n(F.fused_r2l_apply_int8_pe(fp, cfg, t(pts), JX.K2_DIM,
                                          JX.K2_L, bf16_resid=br))
        differ[br] = int((got != want).sum())
    print(f"under XLA's default flags: {differ[True]} of {got.size} "
          "bf16_resid outputs differ from the plain version")
    assert differ[False] == 0
    assert differ[True] >= MIN_DEFAULT_DIFFER


def test_form_codes():
    """``bf16_resid`` is a flag on each of K2's epilogue codes, as the
    kernels' kBf16Resid."""
    assert F.int8_form_code(True, True, False) == F.EPILOGUES["deployed"]
    assert [F.int8_form_code(f, b, True) for f, b in (
        (True, True), (True, False), (False, False), (False, True))] == [
        16, 17, 18, 18]
    src = open(F.__file__.replace("r2l_fused.py",
                                  "csrc/r2l_int8_hopper.cuh")).read()
    assert f"constexpr int kBf16Resid = {F.BF16_RESID};" in src
    wide = open(F.__file__.replace("r2l_fused.py",
                                   "csrc/wide_hopper.cuh")).read()
    assert f"kBf16Resid = {F.BF16_RESID} }};" in wide
