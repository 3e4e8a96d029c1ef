"""Port parity of the student-frame exp drivers (r2l_tpu_torch/exp/
probe_decomp.py, probe_e2e.py, probe_batch.py, probe_epi2.py) against the
JAX drivers exp/probe_decomp.py, probe_e2e.py, probe_batch.py and
probe_epi2.py + probe_epi3.py.

Each driver's constants are read from the JAX file (through
load_exp_probe where it has a main() guard, from its source where it runs
at import) and held equal. The variant bodies run at a small size (W64/D8
students, 32x32 frames, two poses) on the same weights (JAX's, carried
over, each side calibrating itself) against the JAX driver's composition,
its Pallas kernel in interpret mode. K2's outputs are held to K2's int8
frame bounds, max-abs 2.5e-2 and RMS 2.5e-3 per value
(tests/test_pallas_int8_pe.py:45-46, tests/test_torch_kernel_int8.py: at
L = 10 the encoding's sin/cos differ by ulps between torch and XLA, which
moves a requantize by a step; so does an ulp of a calibrated scale); a
checksum of n values within n x 2.5e-3 (the RMS bound summed); sums of the
same f32 values within 1e-6 relative (another summation order).

Without a GPU each driver exits 1 and prints no record."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import exp_assigned, exp_calls, load_exp_probe, models, n
from r2l_tpu.evaluate import _prepare_r2l as jax_prepare
from r2l_tpu.evaluate import make_r2l_bench_fn as jax_bench
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.sampler import PointSampler as JaxSampler
from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.sampler import even_z_vals
from r2l_tpu_torch.exp import probe_batch as XB
from r2l_tpu_torch.exp import probe_decomp as XD
from r2l_tpu_torch.exp import probe_e2e as XE
from r2l_tpu_torch.exp import probe_epi2 as XE2

HW, FOCAL, K, L = 32, 44.4, 2, 10
TOL_MAX, TOL_RMS = 2.5e-2, 2.5e-3
RTOL_SUM = 1e-6


def _case(monkeypatch, mod, seed=0):
    """(JAX params, jcfg, the port's cfg, the JAX sampler and poses [K, 3,
    4], the driver's setup) with JAX's weights carried into the driver."""
    jcfg = JaxR2LConfig(netdepth=8, netwidth=64, compute_dtype=jnp.bfloat16)
    params, cfg, model = models(jcfg, seed)
    monkeypatch.setattr(mod, "init_r2l", lambda c, g, d: model)
    js = JaxSampler(H=HW, W=HW, focal=FOCAL, n_sample=16, near=2.0,
                    far=6.0)
    poses = jnp.asarray(_harness.lego_poses(K))
    return params, jcfg, cfg, js, poses


def _setup(mod, cfg, **kw):
    return mod.setup("cpu", torch.Generator().manual_seed(0), K, cfg,
                     hw=HW, focal=FOCAL, **kw)


def _k2(jfp, jcfg, pts, fold=True, nobf16=True, bf16_resid=False):
    return JP.fused_r2l_apply_int8_pe(jfp, jcfg, pts, 48, L, tile=512,
                                      interpret=True, fold_requant=fold,
                                      nobf16_inner=nobf16,
                                      bf16_resid=bf16_resid)


def _bounds(got, want):
    d = np.abs(n(got) - np.asarray(want))
    assert d.max() < TOL_MAX and np.sqrt(np.mean(d * d)) < TOL_RMS, d.max()


def _sums(got, want, n_values):
    """Checksums of n values: K2's RMS bound summed."""
    assert abs(float(got) - float(want)) <= n_values * TOL_RMS, (got, want)


@pytest.mark.parametrize("name,port", [
    ("probe_decomp", XD), ("probe_e2e", XE), ("probe_batch", XB)])
def test_constants_match_the_jax_drivers(name, port):
    """H, W, FOCAL, K (and probe_batch's L) as the JAX drivers set them;
    the student and sampler of their calls."""
    J = load_exp_probe(name)
    for c in ("H", "W", "FOCAL", "K") + (("L",) if name == "probe_batch"
                                         else ()):
        assert getattr(port, c) == getattr(J, c), c
    assert exp_calls(name, "PointSampler")[0] == dict(
        _args=[], H="<H>", W="<W>", focal="<FOCAL>", n_sample=16, near=2.0,
        far=6.0)
    assert port.L == 10 and port.SEED == 0


def test_epi2_constants_match_the_jax_drivers():
    """exp/probe_epi2.py and probe_epi3.py run at import: their constants
    from the source: the frame, the calibration sampler (50x50 at focal /
    8, every other pose), the forms' flags and the 5 timed calls."""
    for name in ("probe_epi2", "probe_epi3"):
        a = exp_assigned(name)
        for c in ("H", "W", "FOCAL", "K", "L", "DIM"):
            assert getattr(XE2, c) == a[c], (name, c)
        sub = exp_calls(name, "PointSampler")[1]
        assert sub["H"] == sub["W"] == XE2.CALIB_HW
        assert exp_calls(name, "bench")[0].get("reps", 5) == XE2.REPS
    # epi2's four rows (:70-74: base, bf16_resid, fold_requant, both; the
    # folded rows on the folded packing, nobf16_inner at JAX's default)
    # and epi3's fold+nobf16 (:62), each with its packing's fold
    assert [f[0] for f in XE2.EPI2_FORMS] == [
        "base", "bf16_resid", "fold_requant", "both"]
    assert XE2.FORMS == (("base", False, False, False),
                         ("bf16_resid", False, False, True),
                         ("fold_requant", True, False, False),
                         ("both", True, False, True),
                         ("fold+nobf16", True, True, False))


def test_decomp_variants_match_jax(monkeypatch):
    """sampler_only, kernel_only and full (exp/probe_decomp.py:68-86) on
    JAX's weights, each side's packing from _prepare_r2l: K2 per frame
    within its bounds, the checksums within the summed bound, the sampler's
    sums within RTOL_SUM. JAX's driver calls K2 with its default flags on
    the folded packing (a slip of the reference, the module docstring);
    the composition here passes the packing's, as the port does."""
    params, jcfg, cfg, js, poses = _case(monkeypatch, XD)
    cfg, fp, dim_pts, sampler, tposes = _setup(XD, cfg)
    jfp, kind, jdim, _ = jax_prepare(params, jcfg, js, L, False, True,
                                     "int8")
    assert kind == "int8" and jdim == dim_pts == 48
    np.testing.assert_array_equal(n(tposes), np.asarray(poses))
    pts = [js.sample_test(c) for c in poses]
    want = [_k2(jfp, jcfg, p) for p in pts]
    for i in range(K):
        _bounds(XD.k2(fp, cfg, sampler.sample_test(tposes[i]), dim_pts),
                want[i])
    _sums(XD.full(fp, cfg, dim_pts, sampler, tposes),
          jnp.sum(jnp.stack([jnp.sum(w) for w in want])), K * HW * HW * 3)
    scales = even_z_vals(1.0, 1.0001, K, "cpu")
    np.testing.assert_array_equal(n(scales), np.asarray(
        jnp.linspace(1.0, 1.0001, K)))
    _sums(XD.kernel_only(fp, cfg, dim_pts, sampler.sample_test(tposes[0]),
                         scales),
          sum(float(jnp.sum(_k2(jfp, jcfg, pts[0] * s)))
              for s in jnp.linspace(1.0, 1.0001, K)), K * HW * HW * 3)
    want = float(jnp.sum(jax.lax.map(lambda c: jnp.sum(js.sample_test(c)),
                                     poses)))
    assert float(XD.sampler_only(sampler, tposes)) == pytest.approx(
        want, rel=RTOL_SUM)


def test_e2e_matches_jax(monkeypatch):
    """int8r (exp/probe_e2e.py:52-55): the bench function's checksum over
    the frames against JAX's make_r2l_bench_fn, each side calibrating on
    its default cameras."""
    params, jcfg, cfg, js, poses = _case(monkeypatch, XE, seed=1)
    cfg, bench, sampler, tposes = _setup(XE, cfg)
    want = jax_bench(params, jcfg, js, embed_L=L, use_pallas=True,
                     pallas_tile=512, quantize="int8")(poses)
    _sums(bench(tposes), want, K * HW * HW * 3)


def test_batch_matches_jax(monkeypatch):
    """laxmap and batched (exp/probe_batch.py:68-90): the batched input is
    every pose's sample_test in order (vmap + reshape); its rgb within K2's
    bounds of each frame's on the CPU (the plain version's sin/cos
    vectorise by batch size, so not bit for bit here; the card's kernel is
    per ray) and of JAX's one call; the checksums within the summed
    bound of JAX's."""
    params, jcfg, cfg, js, poses = _case(monkeypatch, XB, seed=2)
    cfg, bench, fp, dim_pts, sampler, tposes = _setup(XB, cfg)
    jpts = jax.vmap(js.sample_test)(poses).reshape(-1, dim_pts)
    tpts = XB.batched_points(sampler, tposes)
    np.testing.assert_array_equal(n(tpts), np.asarray(jpts))
    r = XB.compare(fp, cfg, dim_pts, sampler, tposes)
    assert r["max_abs_err_vs_frames"] < TOL_MAX
    assert r["rms_err_vs_frames"] < TOL_RMS
    jfp = jax_prepare(params, jcfg, js, L, False, True, "int8")[0]
    want = _k2(jfp, jcfg, jpts)
    _bounds(XB.k2(fp, cfg, tpts, dim_pts), want)
    _sums(XB.batched(fp, cfg, dim_pts, sampler, tposes), jnp.sum(want),
          jpts.shape[0] * 3)
    _sums(bench(tposes), jnp.sum(want), jpts.shape[0] * 3)


@pytest.mark.parametrize("form", XE2.FORMS, ids=[f[0] for f in XE2.FORMS])
def test_epi2_forms_match_jax(monkeypatch, form):
    """Each form on its packing (exp/probe_epi2.py:32-36, 48-52; probe_epi3
    .py:29-30, 43-45), calibrated on every other pose's sample_test at
    CALIB_HW (focal / 8): on pose 0 within K2's bounds of JAX's kernel in
    that form on JAX's packing of the same points (the bf16_resid rows too:
    here XLA's excess precision drops some of their bf16 roundings, which
    tests/test_torch_bf16_forms.py holds bit for bit without it)."""
    name, fold, nobf16, bf16_resid = form
    params, jcfg, cfg, js, poses = _case(monkeypatch, XE2, seed=3)
    cfg, fps, sampler, tposes = _setup(XE2, cfg, calib_hw=8)
    sub = JaxSampler(H=8, W=8, focal=FOCAL / 8, n_sample=16, near=2.0,
                     far=6.0)
    calib = jnp.concatenate([sub.sample_test(poses[i])
                             for i in range(0, K, 2)])
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, XE2.DIM, L,
                                   calib_pts=calib, fold_requant=fold)
    want = _k2(jfp, jcfg, js.sample_test(poses[0]), fold, nobf16,
               bf16_resid)
    _bounds(XE2.form(fps, cfg, sampler.sample_test(tposes[0]), fold, nobf16,
                     bf16_resid), want)


@pytest.mark.parametrize("mod", [XD, XE, XB, XE2],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_driver_needs_a_gpu(mod, capsys):
    """Without CUDA the driver exits 1 and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
