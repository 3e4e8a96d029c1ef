"""Port parity: the teacher kernels' number-changing forms
(r2l_tpu_torch/kernels/nerf_render.py, ``fused_nerf_render(...,
pe_ladder=False)`` and ``bf16_requant=True``) against r2l_tpu/kernels/
nerf_render_pallas.py::fused_nerf_render_t in interpret mode with the same
flags, at W64 and at W384 (a width the port sends to the teacher kernels'
wide form, whose plain version is the same), with and without view
directions, L 10 / 4.

* ``pe_ladder=False`` encodes with one sin a value, sin(2^j p) and
  sin(2^j p + pi/2) (``pe_sin``), in f32, bf16 and int8 (folded);
* ``bf16_requant`` (int8, folded and unfolded) dequantizes every layer but
  the heads in bf16, the product rounded before the sum
  (``dequant_bf16``); with ``pe_ladder=False`` too, unfolded.

JAX's side runs in a subprocess with XLA's excess precision off
(tests/_torch_forms_jax.py), which keeps bf16_requant's roundings; the
port's plain version runs here on JAX's int8 packing of the same teacher
(carried over field by field) and on its own f32 and bf16 packing of the
same weights. Tolerances:

* with XLA's exp, sigmoid, sin and cos substituted for torch's (the CPU
  libraries differ by an ulp on some values): int8 bit for bit (exact
  int32 sums, the same roundings); f32 as tests/test_torch_nerf_kernel
  .py's f32 pass (``TOL_F32``: 1e-5, depth 1e-4, the sums in another
  order); bf16 K6 bf16's limits on the card (``TOL_BF16``: the same bf16
  roundings, an f32 sum order apart; bit for bit at W64, 1.2e-7 on rgb at
  W384);
* with torch's own: ``TOL_LIBM``. Measured: an ulp of a sin, cos or exp
  moves f32 and bf16 by 1.2e-7 at most (depth 9.5e-7), but flips a
  requantize of bf16_requant now and then, 2.66e-4 on rgb at most (W64
  without view directions, folded)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_forms_jax as JX
from _torch_parity import n, nerf_int8_params_from_jax, nerf_models, t
from r2l_tpu_torch.kernels import nerf_render as NR

TOL_F32 = {"rgb": 1e-5, "acc": 1e-5, "depth": 1e-4, "weights": 1e-5}
TOL_BF16 = {"rgb": 1e-4, "acc": 1e-4, "depth": 6e-4, "weights": 1e-4}
TOL_LIBM = {"rgb": 6e-4, "acc": 6e-4, "depth": 3e-3, "weights": 6e-4}
OUTS = ("rgb", "acc", "depth", "weights")


@pytest.fixture(scope="module")
def jax_teacher(tmp_path_factory):
    """JAX's int8 packings and every form's outputs, from one subprocess."""
    return JX.run("teacher",
                  str(tmp_path_factory.mktemp("teacher") / "teacher.npz"))


def _xla(f):
    """A torch elementwise function computed by XLA on the CPU."""
    fn = jax.jit(f)
    return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(n(x)))))


def _port(jax_teacher, label, mode):
    """(port cfg, the packing of ``mode`` on the case's weights)."""
    _, W, D, skips, vd = next(c for c in JX.T_CASES if c[0] == label)
    jcfg = JX.teacher_jcfg(W, D, skips, vd)
    _, cfg, model = nerf_models(jcfg, JX.T_SEED)
    if not mode.startswith("int8"):
        return cfg, NR.prepare_fused_nerf(
            model, cfg, JX.T_LP, JX.T_LV,
            weight_dtype=torch.float32 if mode == "f32" else torch.bfloat16)
    o, d, z, pts, vds = JX.teacher_inputs()
    like = NR.prepare_fused_nerf(model, cfg, JX.T_LP, JX.T_LV,
                                 calib=(t(pts), t(vds) if vd else None),
                                 fold_requant=mode == "int8f")
    fp = nerf_int8_params_from_jax(JX.get_tree(jax_teacher,
                                               f"{label}/{mode}"),
                                   jcfg, like, JX.T_LP, JX.T_LV)
    return cfg, fp._replace(fold_requant=like.fold_requant)


def _render(fp, cfg, ladder, brq):
    o, d, z, _, _ = JX.teacher_inputs()
    return NR.fused_nerf_render(fp, cfg, t(o), t(d), t(z), JX.T_LP, JX.T_LV,
                                True, pe_ladder=ladder, bf16_requant=brq)


@pytest.mark.parametrize("form,mode,ladder,brq", JX.T_FORMS,
                         ids=[f"{f[0]}-{f[1]}" for f in JX.T_FORMS])
@pytest.mark.parametrize("label", [c[0] for c in JX.T_CASES])
def test_teacher_forms_match_jax(jax_teacher, monkeypatch, label, form,
                                 mode, ladder, brq):
    cfg, fp = _port(jax_teacher, label, mode)
    assert NR.teacher_wide_form(cfg.W) == (cfg.W > 256)
    want = [jax_teacher[f"{label}/{mode}/{form}/{w}"] for w in OUTS]
    got = _render(fp, cfg, ladder, brq)
    for what, g, w in zip(OUTS, got, want):
        np.testing.assert_allclose(n(g), w, rtol=0, atol=TOL_LIBM[what],
                                   err_msg=what)
    with monkeypatch.context() as m:
        for name, f in (("exp", jnp.exp), ("sigmoid", jax.nn.sigmoid),
                        ("sin", jnp.sin), ("cos", jnp.cos)):
            m.setattr(torch, name, _xla(f))
        exact = _render(fp, cfg, ladder, brq)
    for what, g, w in zip(OUTS, exact, want):
        if mode.startswith("int8"):
            np.testing.assert_array_equal(n(g), w, err_msg=what)
        else:
            tol = (TOL_F32 if mode == "f32" else TOL_BF16)[what]
            np.testing.assert_allclose(n(g), w, rtol=0, atol=tol,
                                       err_msg=what)


@pytest.mark.parametrize("label", [c[0] for c in JX.T_CASES])
def test_forms_change_the_numbers(jax_teacher, label):
    """Each form moves the output away from the parent form, on the port
    and on JAX: pe_ladder=False the f32 pass (whose encoding feeds the
    layers unrounded), bf16_requant the int8 pass."""
    cfg, fp = _port(jax_teacher, label, "f32")
    a, b = (_render(fp, cfg, ladder, False)[0] for ladder in (True, False))
    assert not torch.equal(a, b)
    cfg, fp = _port(jax_teacher, label, "int8f")
    a, b = (_render(fp, cfg, True, brq)[0] for brq in (False, True))
    assert not torch.equal(a, b)
    assert not np.array_equal(
        jax_teacher[f"{label}/int8f/bf16_requant/rgb"],
        jax_teacher[f"{label}/int8f/pe_sin/rgb"])


def test_pe_sin_is_pallas_pe_matrix():
    """``pe_sin``'s columns are sin(A p + b) of Pallas ``_pe_matrix`` in the
    port's order (``_pe_row_map``), the sum 2^j p + b rounded once in f32;
    the wide form's encoding twin computes the same columns."""
    from r2l_tpu.kernels.nerf_render_pallas import _pe_matrix, _pe_row_map
    rng = np.random.default_rng(0)
    p = rng.uniform(-4.0, 4.0, (257, 3)).astype(np.float32)
    for L in (4, 10):
        A, b = (np.asarray(a) for a in _pe_matrix(L))
        y = (p.astype(np.float32) @ A.T.astype(np.float32)
             + b[:, 0]).astype(np.float32)
        want = torch.sin(t(y)).numpy()
        got = n(NR.pe_sin(t(p), L, 3 + 6 * L))
        rm = _pe_row_map(L)
        np.testing.assert_array_equal(got[:, 3:], want[:, rm[3:] - 8])
        np.testing.assert_array_equal(got[:, :3], p)
    o, d, z, _, _ = JX.teacher_inputs()
    E, V = NR.wide_encodings_ref(t(o), t(d), t(z), 10, 4, 64, 64,
                                 torch.float32, pe_ladder=False)
    want = NR.pe_sin(NR.ray_points(t(o), t(d), t(z)), 10, 64).reshape(-1, 64)
    assert torch.equal(E, want)
    assert b[3, 0] == np.float32(NR.HALF_PI_F32)


def test_dequant_bf16_rounds_twice():
    """``dequant_bf16`` is XLA's bf16 arithmetic of acc, m, b: each to bf16,
    the product rounded, then the sum; never the f32 one-FMA dequantize."""
    rng = np.random.default_rng(1)
    acc = t(rng.integers(-40000, 40000, 4096).astype(np.float32))
    m = t(rng.uniform(1e-4, 1e-2, 4096))
    b = t(rng.normal(size=4096))
    bf = torch.bfloat16
    want = ((acc.to(bf).float() * m.to(bf).float()).to(bf).float()
            + b.to(bf).float()).to(bf).float()
    got = NR.dequant_bf16(acc, m, b)
    assert torch.equal(got, want)
    assert torch.equal(got, got.to(bf).float())
    assert not torch.equal(got, NR._dequant(acc, m, b))
