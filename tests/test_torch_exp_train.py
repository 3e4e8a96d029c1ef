"""Port parity of the training exp drivers (r2l_tpu_torch/exp/_train.py,
probe_train.py, probe_train_int8.py, probe_train_decomp.py,
probe_calib_dispatch.py, probe_strat.py, probe_mine.py,
probe_teacher_step.py) against the JAX drivers of the same names.

Each driver's constants (the distillation config, the samplers, the
variants and their flags, the step counts) are read from the JAX file,
through load_exp_probe and its source, and held equal. The variant bodies
run at a small size (a W64/D8 bf16 student, 128 rays a step with hard
mining, an 8x8 sampler, 4x4 calibration poses; a W32 teacher with 8 + 8
samples and 32 rays a step) on the same weights (JAX's, carried over) and
JAX's own draws of each step's key (``jax_step_draws``) against JAX's
step, its Pallas kernels in interpret mode. Tolerances, those of the
existing parity tests:

* a distillation step's loss: rtol 2e-3 (tests/test_torch_train_step.py's
  bf16 bound; the fused kinds' plain versions and the Pallas kernels agree
  to a flipped bf16 rounding here and there);
* K4's and K2's outputs summed, each side calibrating: n x 2.5e-3, K2's
  int8 RMS bound (tests/test_torch_kernel_int8.py) summed over n values;
* the teacher step's loss: rtol 1e-5 (f32, tests/test_torch_teacher_train
  .py); Adam: rtol 1e-6 (tests/test_torch_train_step.py);
* sampling, top-k and the pool update: bit for bit; a sum of the same f32
  values in another order: 1e-6 relative.

Without a GPU each driver exits 1 and prints no record."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (exp_assigned, exp_calls, jax_ray_draws,
                           jax_step_draws, load_exp_probe, models, n,
                           nerf_models, t)
from r2l_tpu import hardmine as JH
from r2l_tpu import train as JTR
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.kernels import r2l_train_pallas as JT
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.render import VolRenderConfig as JVolRenderConfig
from r2l_tpu.sampler import PointSampler as JaxSampler
from r2l_tpu_torch import hardmine
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.exp import _train
from r2l_tpu_torch.exp import probe_calib_dispatch as XCD
from r2l_tpu_torch.exp import probe_mine as XM
from r2l_tpu_torch.exp import probe_strat as XS
from r2l_tpu_torch.exp import probe_teacher_step as XTS
from r2l_tpu_torch.exp import probe_train as XT
from r2l_tpu_torch.exp import probe_train_decomp as XTD
from r2l_tpu_torch.exp import probe_train_int8 as XT8

B, N_IN, N_OUT = 128, 8, 16
HW, FOCAL, CAL_HW, CAL_FOCAL = 8, 10.0, 4, 5.0
TOL_LOSS = 2e-3
TOL_RMS = 2.5e-3


def _case(seed=0):
    """(JAX params, jcfg, the port's cfg and model with JAX's weights, a
    fresh batch)."""
    jcfg = JaxR2LConfig(netdepth=8, netwidth=64, compute_dtype=jnp.bfloat16)
    params, cfg, model = models(jcfg, seed)
    fresh = np.random.default_rng(seed + 3).uniform(
        size=(B - N_OUT, 9)).astype(np.float32)
    return params, jcfg, cfg, model, fresh


def _dcfgs(**kw):
    return (_train.distill_config(B, N_IN, N_OUT, **kw),
            JTR.DistillConfig(batch_size=B, n_hard_in=N_IN,
                              n_hard_out=N_OUT, hard_mul=_train.HARD_MUL,
                              embed_L=_train.EMBED_L, **kw))


def _jax_sampler():
    return JaxSampler(H=HW, W=HW, focal=FOCAL, n_sample=16, near=2.0,
                      far=6.0)


def _jax_calib():
    """exp/probe_train_int8.py:46-52 at CAL_HW."""
    sub = JaxSampler(H=CAL_HW, W=CAL_HW, focal=CAL_FOCAL, n_sample=16,
                     near=2.0, far=6.0)
    return jnp.concatenate([sub.sample_test(jnp.asarray(np.asarray(
        pose_spherical(th, -30.0, 4.0))[:3, :4]))
        for th in (0.0, 90.0, 180.0, 270.0)])


def _draws(key, dcfg):
    """JAX's draws of a step's key (train.py:212, hardmine.py:61-71)."""
    if dcfg.hard_sample == "stratified":
        return jax_step_draws(key, dcfg, 16)
    k_hard, k_perturb = jax.random.split(key)
    return TR.StepDraws(
        hardmine.HardDraws(None, torch.from_numpy(np.asarray(
            jax.random.permutation(k_hard, dcfg.pool_capacity), np.int64))),
        t(jax.random.uniform(k_perturb, (dcfg.batch_size, 16))))


def _losses(kw, steps=2, scan=1, seed=0, **dkw):
    """The losses of ``steps`` steps (or scanned calls) of the driver's
    variant ``kw`` in JAX and in the port, from the same weights, batch
    and draws."""
    params, jcfg, cfg, model, fresh = _case(seed)
    dcfg, jdcfg = _dcfgs(**dkw)
    jkw = dict(kw)
    if "fused_calib_pts" in kw:
        jkw["fused_calib_pts"] = jnp.asarray(n(kw["fused_calib_pts"]))
    if kw.get("fused_vjp"):
        jkw["fused_tile"] = 32
    jstate, tx = JTR.init_train_state(jax.random.key(1), jax.tree.map(
        jnp.array, params), jdcfg)
    jstep = JTR.make_distill_step(jcfg, jdcfg, _jax_sampler(), tx, **jkw)
    state, step = _train.variant_step(model, cfg, dcfg,
                                      _train.sampler(HW, FOCAL), "cpu", **kw)
    batch = np.stack([fresh] * scan) if scan > 1 else fresh
    jl, pl_ = [], []
    key = jax.random.key(10)
    for i in range(steps):
        if scan > 1:
            jstate, jm, _ = jstep(jstate, jnp.asarray(batch), key)
            draws, k = [], key
            for _ in range(scan):
                k, sub = jax.random.split(k)
                draws.append(_draws(sub, dcfg))
            key = k
        else:
            key, sub = jax.random.split(key)
            jstate, jm = jstep(jstate, jnp.asarray(batch), sub)
            draws = _draws(sub, dcfg)
        state, m = step(state, batch, draws=draws)
        jl += np.asarray(jm["loss"]).reshape(-1).tolist()
        pl_ += n(m["loss"]).reshape(-1).tolist()
    return jl, pl_


def test_shared_setup_matches_the_jax_drivers():
    """exp/probe_train.py:33-39 (and the four drivers that repeat it): the
    distillation config, the sampler, the 50 timed steps; the calibration
    sampler of probe_train_int8.py:46-52 and its four poses, whose points
    are JAX's bit for bit."""
    for name in ("probe_train", "probe_train_int8", "probe_train_decomp",
                 "probe_calib_dispatch", "probe_strat"):
        dc = exp_calls(name, "DistillConfig")[0]
        d = _train.distill_config()
        assert (dc["batch_size"], dc["n_hard_in"], dc["n_hard_out"],
                dc["hard_mul"], dc["embed_L"]) == (
            d.batch_size, d.n_hard_in, d.n_hard_out, d.hard_mul, d.embed_L)
        assert d.warmup_lr is None and d.hard_sample == "stratified"
        ps = exp_calls(name, "PointSampler")
        assert ps[0] == dict(_args=[], H=_train.HW, W=_train.HW,
                             focal=_train.FOCAL, n_sample=_train.N_SAMPLE,
                             near=2.0, far=6.0), name
        if len(ps) > 1:
            assert (ps[1]["H"], ps[1]["focal"]) == (
                _train.CALIB_HW, _train.FOCAL / 12.5), name
    for name in ("probe_train", "probe_train_int8", "probe_strat"):
        assert exp_assigned(name)["N"] == _train.N_STEPS
    np.testing.assert_array_equal(
        n(_train.calib_points("cpu", CAL_HW, CAL_FOCAL)),
        np.asarray(_jax_calib()))


def test_variants_match_the_jax_drivers():
    """Each driver's variants and their flags, as the JAX drivers list
    them (``<calib>`` the calibration points)."""
    calib = "<calib>"
    assert exp_assigned("probe_train")["variants"] == list(XT.VARIANTS)
    assert exp_assigned("probe_train_int8")["variants"] == list(
        XT8.variants(calib))
    assert exp_assigned("probe_strat")["mode"] == XS.MODES
    assert [v[0] for v in exp_assigned("probe_strat")["name,kw"]] == [
        v[0] for v in XS.variants(calib)]
    assert dict(exp_assigned("probe_strat")["name,kw"])["fused_int8"] == \
        dict(XS.variants(calib))["fused_int8"]
    J = load_exp_probe("probe_calib_dispatch")
    assert (XCD.K, XCD.N) == (J.K, J.N)
    builds = [c for c in exp_calls("probe_calib_dispatch", "build")
              if c["_args"][0] != "<every>"]
    assert [J.K if c["_args"][0] == "<K>" else c["_args"][0]
            for c in builds[:3]] == [every for _, every, _ in XCD.VARIANTS[:3]]
    a = exp_assigned("probe_calib_dispatch")
    assert a["gb"] == tuple(gb for _, _, gb in XCD.VARIANTS[3:])
    assert a["tile"] == (256, 1024)     # TPU tiles: not ported


def test_probe_train_steps_match_jax():
    """xla and fused_gb4 (exp/probe_train.py:45-67) step for step against
    JAX's; gb6 and gb8 are K5's group size alone: equal to gb4 bit for bit
    here, on the CPU (one walk in another grouping)."""
    for name in ("xla", "fused_gb4"):
        jl, pl_ = _losses(dict(XT.VARIANTS)[name])
        np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS, err_msg=name)
    params, jcfg, cfg, model, fresh = _case()
    dcfg, _ = _dcfgs()
    losses = {}
    for name in ("fused_gb4", "fused_gb6", "fused_gb8"):
        state, step = _train.variant_step(
            model, cfg, dcfg, _train.sampler(HW, FOCAL), "cpu",
            **dict(XT.VARIANTS)[name])
        g = torch.Generator().manual_seed(0)
        losses[name] = [float(step(state, fresh, generator=g)[1]["loss"])
                        for _ in range(2)]
    assert losses["fused_gb4"] == losses["fused_gb6"] == losses["fused_gb8"]


@pytest.mark.parametrize("name", [n for n, _ in XT8.variants(None)][:2])
def test_probe_train_int8_steps_match_jax(name):
    """The int8 kinds (exp/probe_train_int8.py:57-68: K8's bf16 stash and
    K4's q-value stash, recalibrated every step) step for step."""
    calib = _train.calib_points("cpu", CAL_HW, CAL_FOCAL)
    jl, pl_ = _losses(dict(XT8.variants(calib))[name])
    np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS)


@pytest.mark.parametrize("kind", ["fused_int8", "xla_bf16"])
def test_probe_strat_permutation_matches_jax(kind):
    """hard_sample='permutation' (exp/probe_strat.py:47-59), the JAX draw
    being a permutation of the whole pool; 'stratified' is the other
    drivers' default, held above."""
    calib = _train.calib_points("cpu", CAL_HW, CAL_FOCAL)
    jl, pl_ = _losses(dict(XS.variants(calib))[kind],
                      hard_sample="permutation")
    np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS)


def test_probe_calib_dispatch_matches_jax():
    """A scanned call recalibrating once (``dispatch``, every = k) against
    JAX's scanned step (exp/probe_calib_dispatch.py:82-89), k = 3 here;
    in the port the cadences and group sizes of the other variants are
    flags of the same step: ``instep`` (every 1) equals k single steps bit
    for bit."""
    calib = _train.calib_points("cpu", CAL_HW, CAL_FOCAL)
    jl, pl_ = _losses(XCD.step_kw(calib, 3, 2, 3), steps=1, scan=3)
    np.testing.assert_allclose(pl_, jl, rtol=TOL_LOSS)
    params, jcfg, cfg, model, fresh = _case()
    dcfg, _ = _dcfgs()
    smp = _train.sampler(HW, FOCAL)
    draws = [TR.draw_step(dcfg, 16, torch.Generator().manual_seed(i))
             for i in range(3)]
    s3, scan = _train.variant_step(model, cfg, dcfg, smp, "cpu",
                                   **XCD.step_kw(calib, 1, 4, 3))
    _, ms = scan(s3, np.stack([fresh] * 3), draws=draws)
    kw = XCD.step_kw(calib, 1, 4, 1)
    s1, one = _train.variant_step(model, cfg, dcfg, smp, "cpu", **kw)
    for i in range(3):
        s1, m = one(s1, fresh, draws=draws[i])
        assert float(m["loss"]) == float(ms["loss"][i])


def test_probe_train_decomp_pieces_match_jax():
    """exp/probe_train_decomp.py:96-136's pieces on 128 rows: K4 (its
    q-value stash) and K2 unfolded on uniform points in [-1, 1), their sums
    within the summed RMS bound of JAX's kernels', each side calibrating
    (fold_requant=False) on
    the calibration points; value-and-grad in int8 and bf16 on a batch of
    uniform records with JAX's key's jitter, the loss within TOL_LOSS."""
    params, jcfg, cfg, model, _ = _case(1)
    dcfg, jdcfg = _dcfgs()
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.0, 1.0, (B, 48)).astype(np.float32)
    batch = rng.uniform(size=(B, 9)).astype(np.float32)
    key = jax.random.key(3)
    z_u = jax.random.uniform(key, (B, 16))
    calib = _train.calib_points("cpu", CAL_HW, CAL_FOCAL)
    fns = XTD.pieces(model, cfg, dcfg, _train.sampler(HW, FOCAL), calib,
                     t(pts), t(batch), t(z_u))
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, 48, 10,
                                   calib_pts=_jax_calib())
    jx = jnp.asarray(pts)
    want = JT.train_fwd_int8(jfp, jcfg, jx, 48, 10, tile=32, interpret=True,
                             stash_q=True)[0]
    got = fns["fwd_int8_qstash"]()
    assert abs(float(got) - float(jnp.sum(want))) <= B * 3 * TOL_RMS
    want = JP.fused_r2l_apply_int8_pe(jfp, jcfg, jx, 48, 10, tile=32,
                                      interpret=True)
    got = fns["fwd_int8_nostash"]()
    assert abs(float(got) - float(jnp.sum(want))) <= B * 3 * TOL_RMS
    assert bool(torch.isfinite(fns["recalib"]()))
    for piece, kw in (("value_and_grad", dict(quantize="int8",
                                              calib_pts=_jax_calib(),
                                              stash_q=True)),
                      ("value_and_grad_bf16", {})):
        fused = JT.make_fused_train_apply(jcfg, 48, L=10, tile=32,
                                          group_blocks=4, **kw)
        (jl, _), _ = jax.value_and_grad(JTR.distill_loss_fn, has_aux=True)(
            params, jcfg, jdcfg, _jax_sampler(), jnp.asarray(batch), key,
            fused)
        assert float(fns[piece]()) == pytest.approx(float(jl), rel=TOL_LOSS)


def test_probe_mine_constants_match_jax():
    J = load_exp_probe("probe_mine")
    assert (XM.B, XM.N_OUT, XM.N_IN, XM.CAP, XM.K) == (J.B, J.N_OUT, J.N_IN,
                                                      J.CAP, J.K)
    assert exp_calls("probe_mine", "adam")[0]["_args"] == [XM.LR]
    assert exp_calls("probe_mine", "full_like")[0]["_args"][1] == 1e-6


def test_probe_mine_pieces_match_jax():
    """The pieces of exp/probe_mine.py:87-170 on JAX's draws of
    ``fold_in(key0, i)`` at a small pool (1,280 rays, 64 out, 32 in): the
    sampled rays' sums (1e-6 relative), the top-k's first index, the
    chained pool update (bit for bit), Adam against optax (rtol 1e-6); the
    port's own draws are distinct slots, one per stratum, in range."""
    cap, n_out, n_in, b = 1280, 64, 32, 192
    rng = np.random.default_rng(5)
    rays = rng.uniform(size=(cap, 9)).astype(np.float32)
    key0 = jax.random.key(0)
    acc, jacc = torch.zeros(1), jnp.zeros((1,))
    for i in range(3):
        k = jax.random.fold_in(key0, i)
        for idx in (jax.random.permutation(k, cap)[:n_out],
                    jnp.arange(n_out, dtype=jnp.int32) * (cap // n_out)
                    + jax.random.randint(k, (n_out,), 0, cap // n_out),
                    jax.random.randint(k, (n_out,), 0, cap)):
            acc = XM.pick(t(rays), acc, torch.from_numpy(np.asarray(
                idx, np.int64)))
            jacc = jacc + jnp.sum(jnp.asarray(rays)[idx][:, :1])
    assert float(acc[0]) == pytest.approx(float(jacc[0]), rel=1e-6)
    g = torch.Generator().manual_seed(1)
    perm = XM.draw("sample_perm", g, cap, n_out)
    assert len(set(perm.tolist())) == n_out
    strat = XM.draw("sample_strat", g, cap, n_out)
    assert torch.equal(strat // (cap // n_out), torch.arange(n_out))
    r = XM.draw("sample_randint", g, cap, n_out)
    assert int(r.min()) >= 0 and int(r.max()) < cap
    pr = rng.uniform(size=(b,)).astype(np.float32)
    tpr, jpr = t(pr), jnp.asarray(pr)
    acc, jacc = torch.zeros(1), jnp.zeros((1,))
    for _ in range(3):
        acc = XM.topk(tpr, acc, b - n_out, n_in)
        _, ids = jax.lax.top_k(jpr[:b - n_out], n_in)
        jpr = jpr.at[0].set(jacc[0] * 1e-9)
        jacc = jacc + jnp.sum(ids[:1].astype(jnp.float32))
    assert float(acc[0]) == float(jacc[0])
    hard = rng.uniform(size=(n_in, 9)).astype(np.float32)
    pool = XM.full_pool(t(rays))
    jpool = JH.init_pool(cap, 9)._replace(rays=jnp.asarray(rays),
                                          size=jnp.asarray(cap, jnp.int32))
    slots = XM.fixed_slots(cap, n_out)
    for i in range(3):
        pool = hardmine.update_pool(pool, t(hard) + i * 1e-9, slots)
        jpool = JH.update_pool(jpool, jnp.asarray(hard) + i * 1e-9,
                               jnp.asarray(n(slots).astype(np.int32)))
    np.testing.assert_array_equal(n(pool.rays), np.asarray(jpool.rays))
    params, jcfg, cfg, model, _ = _case(2)
    monkeyed = XM.adam(cfg, "cpu")
    m, opt, grads = monkeyed
    m.load_state_dict(model.state_dict())
    tx = optax.adam(XM.LR)
    jp = jax.tree.map(jnp.array, params)
    st = tx.init(jp)
    jg = jax.tree.map(lambda p: jnp.full_like(p, 1e-6), jp)
    for _ in range(3):
        XM.adam_step(m, opt, grads)
        upd, st = tx.update(jg, st, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(n(m.linears()[2].bias),
                               np.asarray(jp["tail"]["b"]), rtol=1e-6,
                               atol=1e-9)


def test_probe_teacher_step_matches_jax():
    """exp/probe_teacher_step.py:45-50's configs (at W32, 8 + 8 samples,
    32 rays here) and one step of ``make_teacher_step_batched`` on a ray
    pool against JAX's, with JAX's draws of the step's key."""
    nc = exp_calls("probe_teacher_step", "NeRFConfig")[0]
    vc = exp_calls("probe_teacher_step", "VolRenderConfig")[0]
    tc = exp_calls("probe_teacher_step", "TeacherTrainConfig")[0]
    ncfg, vcfg, tcfg = XTS.configs()
    assert (ncfg.D, ncfg.W, ncfg.use_viewdirs) == (nc["D"], nc["W"],
                                                   nc["use_viewdirs"])
    for k, v in vc.items():
        if k != "_args":
            assert getattr(vcfg, k) == v, k
    for k, v in tc.items():
        if k != "_args":
            assert getattr(tcfg, k) == v, k
    assert exp_assigned("probe_teacher_step")["scan"] == XTS.SCANS
    with open(load_exp_probe("probe_teacher_step").__file__) as f:
        assert f"N = {XTS.N_STEPS} // scan" in f.read()
    ncfg, vcfg, tcfg = XTS.configs(W=32, n_coarse=8, n_fine=8, n_rand=32)
    jn = JNeRFConfig(D=8, W=32, use_viewdirs=True)
    jv = JVolRenderConfig(n_coarse=8, n_fine=8, perturb=True,
                          raw_noise_std=1.0, white_bkgd=True, near=2.0,
                          far=6.0, lindisp=False)
    jt = JTR.TeacherTrainConfig(n_rand=32, lrate=5e-4, lrate_decay=500)
    pc, _, mc = nerf_models(jn, 0)
    pf, _, mf = nerf_models(jn, 1)
    pool = np.random.default_rng(6).uniform(size=(64, 9)).astype(np.float32)
    jstate, tx = JTR.init_teacher_state(pc, pf, jt)
    jstep = JTR.make_teacher_step_batched(jn, jv, jt, tx, ncfg_fine=jn)
    state = TR.init_teacher_state(mc, mf, tcfg)
    step = TR.make_teacher_step_batched(ncfg, vcfg, tcfg, ncfg_fine=ncfg,
                                        device="cpu")
    key = jax.random.key(3)
    _, jm = jstep(jstate, jnp.asarray(pool), jnp.int32(0), key)
    _, m = step(state, pool, 0, draws=TR.TeacherStepDraws(
        None, None, jax_ray_draws(key, jv, 32)))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert XTS.step_ops(ncfg, vcfg, 32) > 0


@pytest.mark.parametrize("mod", [XT, XT8, XTD, XCD, XS, XM, XTS],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_driver_needs_a_gpu(mod, capsys):
    """Without CUDA the driver exits 1 and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
