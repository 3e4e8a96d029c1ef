"""Full-state resume of the port (r2l_tpu_torch/checkpoint.py: ``save``,
``native_resume_blob``, ``restore_opt_state``, ``restore_pool``,
``resume_distill``, ``resume_teacher``) against r2l_tpu/app.py's
(``_save`` :1115, ``_native_resume_blob`` :1140, ``_restore_opt_state``
:1165, the pool :779-795) and tests/test_resume.py.

Within the port a resume is bit for bit equal to never stopping (params,
Adam's moments, the pool, the counts), as tests/test_resume.py:53 pins
JAX's. Across the packages a file written by either resumes in the other:
the restored state is the file's bit for bit, and the steps after it are
held at tests/test_torch_train_step.py's f32 tolerances (the loss relative
1e-5; parameters 1e-5 absolute, its parameter bound after steps) and
tests/test_torch_teacher_train.py's for the teacher (1e-5, 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import r2l_tpu.encoding as jenc
import r2l_tpu.render as jrender
from _torch_parity import (jax_ray_draws, jax_step_draws, models, n,
                           nerf_models, np_tree, t)
from r2l_tpu import app as JAPP
from r2l_tpu import checkpoint as JC
from r2l_tpu import train as JTR
from r2l_tpu.hardmine import HardPool as JaxHardPool
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models.nerf import NeRFConfig as JaxNeRFConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import checkpoint as C
from r2l_tpu_torch import render
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.models import (init_nerf, init_r2l, nerf_params_from_jax,
                                  params_from_jax)
from r2l_tpu_torch.sampler import PointSampler

DIM, L = 6, 4
# tests/test_torch_train_step.py:29-35 (f32): the schedule, and a step's
# loss. Parameters after steps: its 1e-5 absolute bound (:141).
TOL_LR, TOL_LOSS, TOL_PARAMS = 1e-6, 1e-5, 1e-5
META = {"global_step": 4, "best_psnr": 12.5, "best_psnr_step": 3,
        "best_metric": "psnr_v2"}
WARMUP = "0.0001,3"


def _dcfg_kw():
    return dict(batch_size=64, n_hard_in=8, n_hard_out=16, hard_mul=2.0,
                embed_L=L, perturb=True, warmup_lr=WARMUP)


def _jcfg():
    return JaxR2LConfig(input_dim=DIM * (2 * L + 1), netdepth=8, netwidth=32,
                        precision="highest")


def _samplers():
    kw = dict(H=8, W=8, focal=8.0, n_sample=2, near=2.0, far=6.0)
    return JaxPointSampler(**kw), PointSampler(**kw)


def _batches(k=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(48, 9)).astype(np.float32) for _ in range(k)]


class _Log(list):
    """A logger for both packages: ``print`` (r2l_tpu) and a call (port)."""

    def print(self, s):
        self.append(s)

    def __call__(self, s):
        self.append(s)


def _port(seed=0, **step_kw):
    """(state, step) of a fresh port run; ``seed`` draws the weights."""
    jcfg = _jcfg()
    cfg = models(jcfg)[1]
    model = init_r2l(cfg, torch.Generator().manual_seed(seed), "cpu")
    dcfg = TR.DistillConfig(**_dcfg_kw())
    step = TR.make_distill_step(cfg, dcfg, _samplers()[1], device="cpu",
                                **step_kw)
    return TR.init_train_state(model, dcfg, device="cpu"), step, dcfg


def _snapshot(state):
    """Params, Adam's moments and counts, the pool, the step counts."""
    opt, out = state.optimizer, {}
    for name, p in state.params.named_parameters():
        st = opt.state[p]
        out[name] = p.detach().clone()
        out[name + ".mu"] = st["exp_avg"].clone()
        out[name + ".nu"] = st["exp_avg_sq"].clone()
        out[name + ".count"] = st["step"].clone()
    for k in state.pool._fields:
        out["pool." + k] = getattr(state.pool, k).clone()
    out["step"] = torch.tensor(state.step)
    out["lr_count"] = torch.tensor(state.lr_count)
    return out


def _assert_bitwise(got, want):
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["xla", "fused"])
def test_resume_equals_continuous(kind, tmp_path):
    """save at step 4 -> restore into a state built afresh (other weights)
    -> 2 more steps == 6 straight steps, bit for bit."""
    kw = {"fused_vjp": True, "fused_group_blocks": 2} if kind == "fused" \
        else {}
    batches = _batches()

    def draws(i):
        return TR.draw_step(TR.DistillConfig(**_dcfg_kw()), 2,
                            torch.Generator().manual_seed(100 + i))

    straight, step, _ = _port(**kw)
    for i in range(6):
        straight, _ = step(straight, batches[i], draws=draws(i))
    half, step, _ = _port(**kw)
    for i in range(4):
        half, _ = step(half, batches[i], draws=draws(i))
    path = str(tmp_path / "ckpt.msgpack")
    C.save(path, half, half.step, 12.5, 3, save_pool=True)
    resumed, step, _ = _port(seed=7, **kw)
    log = _Log()
    resumed, best, best_step = C.resume_distill(resumed, path, log=log)
    assert (resumed.step, resumed.lr_count, best, best_step) == \
        (4, 4, 12.5, 3)
    assert any("restored optimizer state" in m for m in log)
    assert any("restored hard-ray pool" in m for m in log)
    for i in range(4, 6):
        resumed, _ = step(resumed, batches[i], draws=draws(i))
    _assert_bitwise(_snapshot(resumed), _snapshot(straight))


H, W, FOCAL, N_IMG = 10, 12, 11.0, 3


def _teacher_configs(n_fine):
    jcfg = JaxNeRFConfig(D=4, W=32, skips=(2,), use_viewdirs=True,
                         input_ch=jenc.nerf_embed_dim(3, 6),
                         input_ch_views=jenc.nerf_embed_dim(3, 3),
                         output_ch=5, compute_dtype=jnp.float32)
    jv = jrender.VolRenderConfig(n_coarse=8, n_fine=n_fine, perturb=True,
                                 use_viewdirs=True, multires=6,
                                 multires_views=3, near=2.0, far=6.0,
                                 white_bkgd=True, raw_noise_std=1.0)
    return jcfg, jv, render.VolRenderConfig(**dataclasses.asdict(jv))


def _scene():
    images = np.random.default_rng(0).uniform(
        size=(N_IMG, H, W, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(th, -30.0, 4.0)[:3, :4]
                      for th in (0.0, 120.0, 240.0)])
    return images, poses


TCFG = dict(n_rand=32, precrop_iters=2, precrop_frac=0.5,
            warmup_lr=WARMUP)


def _teacher_draws(key, jv):
    """The draws JAX's teacher step makes from its key
    (tests/test_torch_teacher_train.py)."""
    k_img, k_coord, k_render = jax.random.split(key, 3)
    return TR.TeacherStepDraws(
        torch.tensor(int(jax.random.randint(k_img, (), 0, N_IMG))),
        t(jax.random.uniform(k_coord, (32, 2))),
        jax_ray_draws(k_render, jv, 32))


def _port_teacher(cfg, n_fine, seed):
    g = torch.Generator().manual_seed(seed)
    mc = init_nerf(cfg, g, "cpu")
    mf = init_nerf(cfg, g, "cpu") if n_fine else None
    return TR.init_teacher_state(mc, mf, TR.TeacherTrainConfig(**TCFG))


def _teacher_snapshot(state):
    out = {}
    for tag, m in (("c", state.model_c), ("f", state.model_f)):
        if m is None:
            continue
        for name, p in m.named_parameters():
            st = state.optimizer.state[p]
            out[f"{tag}.{name}"] = p.detach().clone()
            for k in ("exp_avg", "exp_avg_sq", "step"):
                out[f"{tag}.{name}.{k}"] = st[k].clone()
    out["step"] = torch.tensor(state.step)
    out["lr_count"] = torch.tensor(state.lr_count)
    return out


@pytest.mark.parametrize("n_fine", [6, 0])
def test_teacher_resume_equals_continuous(n_fine, tmp_path):
    """The teacher step (precrop over the first two steps): 2 steps, save,
    restore into networks built afresh, 1 more == 3 straight, bit for
    bit."""
    jcfg, jv, tv = _teacher_configs(n_fine)
    cfg = nerf_models(jcfg)[1]
    images, poses = _scene()
    step = TR.make_teacher_step(cfg, tv, TR.TeacherTrainConfig(**TCFG), H,
                                W, FOCAL, device="cpu")
    draws = [_teacher_draws(jax.random.key(30 + i), jv) for i in range(3)]
    straight = _port_teacher(cfg, n_fine, 4)
    for i in range(3):
        straight, _ = step(straight, images, poses, draws=draws[i])
    half = _port_teacher(cfg, n_fine, 4)
    for i in range(2):
        half, _ = step(half, images, poses, draws=draws[i])
    path = str(tmp_path / "teacher.msgpack")
    C.save(path, half, 2, -1.0, -1)
    resumed = _port_teacher(cfg, n_fine, 9)
    resumed, _, _ = C.resume_teacher(resumed, path, log=_Log())
    assert (resumed.step, resumed.lr_count) == (2, 2)
    resumed, _ = step(resumed, images, poses, draws=draws[2])
    _assert_bitwise(_teacher_snapshot(resumed), _teacher_snapshot(straight))


def _jax_run(params, steps, keys, batches):
    """A JAX distillation run: (state, tx, step fn, losses)."""
    jcfg = _jcfg()
    jdcfg = JTR.DistillConfig(**_dcfg_kw())
    state, tx = JTR.init_train_state(jax.random.key(4),
                                     jax.tree.map(jnp.array, params), jdcfg)
    jstep = JTR.make_distill_step(jcfg, jdcfg, _samplers()[0], tx)
    losses = []
    for i in range(steps):
        state, m = jstep(state, jnp.asarray(batches[i]), keys[i])
        losses.append(float(m["loss"]))
    return state, jstep, losses


def _jax_tree(state):
    return {"params": state.params, "opt_state": state.opt_state,
            "pool": {"rays": state.pool.rays, "size": state.pool.size,
                     "ptr": state.pool.ptr}}


def _jax_resume(path, params):
    """JAX's resume of a native file, as r2l_tpu/app.py does it
    (build_r2l, run_distill :768-800): params, step, opt_state, pool."""
    jdcfg = JTR.DistillConfig(**_dcfg_kw())
    state, _ = JTR.init_train_state(jax.random.key(4),
                                    jax.tree.map(jnp.array, params), jdcfg)
    p, meta = JC.load_params(path, state.params)
    state = state._replace(params=p, step=jnp.asarray(
        meta["global_step"], jnp.int32))
    log = _Log()
    blob, _ = JC.load_checkpoint(path)
    state = JAPP._restore_opt_state(state, blob, log)
    pool = blob["pool"]
    state = state._replace(pool=JaxHardPool(
        rays=jnp.asarray(pool["rays"]),
        size=jnp.asarray(pool["size"], jnp.int32),
        ptr=jnp.asarray(pool["ptr"], jnp.int32)))
    JC.drop_cached_checkpoint()
    return state, log


def _compare_to_jax(state, jstate, cfg, atol):
    """The port's params and moments against a JAX state's (atol 0: bit for
    bit)."""
    want = {"": np_tree(jstate.params),
            ".mu": np_tree(jstate.opt_state[0].mu),
            ".nu": np_tree(jstate.opt_state[0].nu)}
    for suffix, tree in want.items():
        sd = params_from_jax(tree, cfg)
        for name, p in state.params.named_parameters():
            st = state.optimizer.state[p]
            got = {"": p, ".mu": st["exp_avg"], ".nu": st["exp_avg_sq"]}
            np.testing.assert_allclose(n(got[suffix]), sd[name].numpy(),
                                       rtol=0, atol=atol,
                                       err_msg=name + suffix)


def test_jax_file_resumes_in_port(tmp_path):
    """A file written by r2l_tpu after 4 steps resumes in the port: the
    restored state is the file's bit for bit, and the port's 2 steps after
    it match JAX's own 2 resumed steps."""
    params, cfg, _ = models(_jcfg(), seed=0)
    keys = [jax.random.key(10 + i) for i in range(6)]
    batches = _batches()
    jstate, _, _ = _jax_run(params, 4, keys, batches)
    path = str(tmp_path / "jax.msgpack")
    JC.save_checkpoint(path, _jax_tree(jstate), meta=META)
    jres, jlog = _jax_resume(path, params)
    state, step, dcfg = _port(seed=5)
    state, best, best_step = C.resume_distill(state, path, log=_Log())
    assert (state.step, state.lr_count, best, best_step) == (4, 4, 12.5, 3)
    assert int(jres.opt_state[0].count) == int(jres.opt_state[1].count) == 4
    _compare_to_jax(state, jres, cfg, atol=0.0)
    np.testing.assert_array_equal(n(state.pool.rays),
                                  np.asarray(jres.pool.rays))
    assert int(state.pool.size) == int(jres.pool.size)
    jstep = JTR.make_distill_step(_jcfg(), JTR.DistillConfig(**_dcfg_kw()),
                                  _samplers()[0],
                                  JTR.make_optimizer(5e-4, 250, WARMUP))
    for i in range(4, 6):
        jres, jm = jstep(jres, jnp.asarray(batches[i]), keys[i])
        state, m = step(state, batches[i],
                        draws=jax_step_draws(keys[i], dcfg, 2))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=TOL_LOSS)
    _compare_to_jax(state, jres, cfg, atol=TOL_PARAMS)


def test_port_file_resumes_in_jax(tmp_path):
    """A file written by the port resumes in r2l_tpu: (a) the port's save
    of a state resumed from JAX's file is that file, byte for byte, and
    JAX's ``_restore_opt_state`` reads the same optimizer from both; (b)
    the port's own 4 steps, saved, restore in JAX (counts 4 and 4) close to
    JAX's own 4 steps, and JAX's 2 steps from it match JAX's continuous
    run."""
    params, cfg, _ = models(_jcfg(), seed=0)
    keys = [jax.random.key(10 + i) for i in range(6)]
    batches = _batches()
    jstate, _, jlosses = _jax_run(params, 6, keys, batches)
    j4, _, _ = _jax_run(params, 4, keys, batches)
    jpath = str(tmp_path / "jax.msgpack")
    JC.save_checkpoint(jpath, _jax_tree(j4), meta=META)

    # (a) through the port and back
    state, _, _ = _port(seed=5)
    state, _, _ = C.resume_distill(state, jpath, log=_Log())
    ppath = str(tmp_path / "port.msgpack")
    C.save(ppath, state, 4, 12.5, 3, save_pool=True)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    from_jax, _ = _jax_resume(jpath, params)
    from_port, log = _jax_resume(ppath, params)
    assert any("restored optimizer state" in m for m in log)
    jax.tree.map(np.testing.assert_array_equal,
                 np_tree(from_port.opt_state), np_tree(from_jax.opt_state))

    # (b) the port's own run
    state, step, dcfg = _port(seed=0)
    with torch.no_grad():
        state.params.load_state_dict(params_from_jax(np_tree(params), cfg))
    for i in range(4):
        state, _ = step(state, batches[i],
                        draws=jax_step_draws(keys[i], dcfg, 2))
    C.save(ppath, state, state.step, 12.5, 3, save_pool=True)
    JC.drop_cached_checkpoint()
    res, _ = _jax_resume(ppath, params)
    assert int(res.opt_state[0].count) == int(res.opt_state[1].count) == 4
    assert int(res.step) == 4
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=TOL_PARAMS), np_tree(res.params),
        np_tree(j4.params))
    jstep = JTR.make_distill_step(_jcfg(), JTR.DistillConfig(**_dcfg_kw()),
                                  _samplers()[0],
                                  JTR.make_optimizer(5e-4, 250, WARMUP))
    for i in range(4, 6):
        res, jm = jstep(res, jnp.asarray(batches[i]), keys[i])
        np.testing.assert_allclose(float(jm["loss"]), jlosses[i],
                                   rtol=TOL_LOSS)


@pytest.mark.parametrize("source", ["tar", "no_opt_state"])
def test_first_lr_after_resume_equals_jax(source, tmp_path):
    """After a .tar resume, or a native file without ``opt_state``, JAX
    sets the step to ``global_step`` but starts optax's schedule count at
    0, so the warm-up runs again (r2l_tpu/app.py:227-228, 770-772); the
    port's first learning rate and update equal JAX's, and the step
    (precrop, int8 calibration) goes on from ``global_step``."""
    params, cfg, _ = models(_jcfg(), seed=0)
    jcfg = _jcfg()
    if source == "tar":
        path = str(tmp_path / "ckpt_050.tar")
        torch.save({"global_step": 50, "best_psnr": 20.0,
                    "network_fn_state_dict": {
                        "module." + k: torch.from_numpy(np.array(v))
                        for k, v in JC.params_to_torch_r2l(
                            params, jcfg).items()},
                    "optimizer_state_dict": {"state": {},
                                             "param_groups": []}}, path)
        jparams = JC.torch_r2l_to_params(JC.load_torch_tar(path)[
            "network_fn_state_dict"], jcfg)
        jblob = None
    else:
        path = str(tmp_path / "params_only.msgpack")
        JC.save_checkpoint(path, {"params": params},
                           meta={"global_step": 50})
        jparams = params
        jblob = JC.load_checkpoint(path)[0]
        JC.drop_cached_checkpoint()
    # JAX: build_r2l's params and start step, a fresh opt_state
    jdcfg = JTR.DistillConfig(**_dcfg_kw())
    jstate, tx = JTR.init_train_state(jax.random.key(4),
                                      jax.tree.map(jnp.array, jparams),
                                      jdcfg)
    jstate = jstate._replace(step=jnp.asarray(50, jnp.int32))
    jlog = _Log()
    if jblob is not None:
        jstate = JAPP._restore_opt_state(jstate, jblob, jlog)
    jsched = JTR.make_lr_schedule(5e-4, 250, WARMUP)
    jlr = float(jsched(int(jstate.opt_state[1].count)))
    state, step, dcfg = _port(seed=5)
    log = _Log()
    state, _, _ = C.resume_distill(state, path, log=log)
    assert (state.step, state.lr_count) == (50, 0)
    if source == "tar":
        assert any("restores params + global_step only" in m for m in log)
    else:
        for msgs in (log, jlog):
            assert any("no optimizer state" in m for m in msgs)
    key = jax.random.key(60)
    jstep = JTR.make_distill_step(jcfg, jdcfg, _samplers()[0], tx)
    jstate, jm = jstep(jstate, jnp.asarray(_batches(1)[0]), key)
    state, m = step(state, _batches(1)[0],
                    draws=jax_step_draws(key, dcfg, 2))
    lr = state.optimizer.param_groups[0]["lr"]
    np.testing.assert_allclose(lr, jlr, rtol=TOL_LR)
    assert lr < 0.5 * float(jsched(50))      # the warm-up's, not step 50's
    assert (state.step, state.lr_count) == (51, 1) == (
        int(jstate.step), int(jstate.opt_state[1].count))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=TOL_LOSS)
    want = params_from_jax(np_tree(jstate.params), cfg)
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(n(p), want[name].numpy(), rtol=0,
                                   atol=TOL_PARAMS, err_msg=name)


@pytest.mark.parametrize("teacher", [False, True])
def test_fresh_state_file_equals_jax(teacher, tmp_path):
    """Before the first update torch's Adam holds no state; the port writes
    optax's ``adam().init``: zero moments, counts 0, byte for byte JAX's
    file of the same fresh state (the teacher without a fine network:
    ``fine`` {} in the params and under mu/nu)."""
    want, got = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    if teacher:
        jcfg = _teacher_configs(0)[0]
        pc, cfg, mc = nerf_models(jcfg, seed=4)
        jstate, _ = JTR.init_teacher_state(pc, {},
                                           JTR.TeacherTrainConfig(**TCFG))
        JC.save_checkpoint(want, {"coarse": pc, "fine": {},
                                  "opt_state": jstate.opt_state}, meta=META)
        state = TR.init_teacher_state(mc, None, TR.TeacherTrainConfig(**TCFG))
        C.save(got, state, 4, 12.5, 3)
    else:
        params, _, model = models(_jcfg(), seed=0)
        jstate = _jax_run(params, 0, [], [])[0]
        JC.save_checkpoint(want, _jax_tree(jstate), meta=META)
        state = TR.init_train_state(model, TR.DistillConfig(**_dcfg_kw()),
                                    device="cpu")
        C.save(got, state, 4, 12.5, 3, save_pool=True)
    for suffix in ("", ".meta.json"):
        with open(got + suffix, "rb") as a, open(want + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


def test_restore_opt_state_mismatch_warns_as_jax(tmp_path):
    """An optimizer tree that does not fit (a plain-MLP body's moments for
    a ResMLP student): both packages warn and keep the fresh optimizer
    (tests/test_resume.py:119-148)."""
    mlp = dataclasses.replace(_jcfg(), body_arch="mlp")
    mparams, _, _ = models(mlp, seed=1)
    mstate, _ = JTR.init_train_state(jax.random.key(4), mparams,
                                     JTR.DistillConfig(**_dcfg_kw()))
    blob = serialization.msgpack_restore(serialization.to_bytes(
        jax.tree.map(np.asarray, {"params": mstate.params,
                                  "opt_state": mstate.opt_state})))
    params, _, _ = models(_jcfg(), seed=0)
    jstate, _ = JTR.init_train_state(jax.random.key(4), params,
                                     JTR.DistillConfig(**_dcfg_kw()))
    jlog, log = _Log(), _Log()
    assert JAPP._restore_opt_state(jstate, blob, jlog) is jstate
    state = _port()[0]
    assert C.restore_opt_state(state, blob, log) is state
    for msgs in (jlog, log):
        assert any("does not match the current optimizer" in m
                   for m in msgs), msgs
    assert not state.optimizer.state and state.lr_count == 0


def test_restore_opt_state_missing_key_warns():
    state = _port()[0]
    log = _Log()
    assert C.restore_opt_state(state, {"params": {}}, log) is state
    assert any("no optimizer state" in m for m in log)
    assert C.native_resume_blob("", True, log=log) == (None, {})


def test_pool_shape_change_warns_and_starts_empty(tmp_path):
    state = _port()[0]
    blob = {"pool": {"rays": np.ones((7, 9), np.float32),
                     "size": np.asarray(7, np.int32),
                     "ptr": np.asarray(0, np.int32)}}
    log = _Log()
    out = C.restore_pool(state, blob, log)
    assert out is state and int(state.pool.size) == 0
    assert any("hard-pool shape changed" in m for m in log)


def test_teacher_jax_file_resumes_in_port(tmp_path):
    """A teacher file written by r2l_tpu (teacher layout, after 2 steps)
    resumes in the port bit for bit, the port writes it back byte for
    byte, and one step after it matches JAX's."""
    jcfg, jv, tv = _teacher_configs(6)
    pc, cfg, _ = nerf_models(jcfg, seed=4)
    pf = nerf_models(jcfg, seed=5)[0]
    images, poses = _scene()
    jt = JTR.TeacherTrainConfig(**TCFG)
    jstate, tx = JTR.init_teacher_state(pc, pf, jt)
    jstep = JTR.make_teacher_step(jcfg, jv, jt, tx, H, W, FOCAL)
    for i in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(images), jnp.asarray(poses),
                          jax.random.key(30 + i))
    path = str(tmp_path / "teacher.msgpack")
    JC.save_checkpoint(path, {"coarse": jstate.params_coarse,
                              "fine": jstate.params_fine,
                              "opt_state": jstate.opt_state},
                       meta={"global_step": 2, "best_psnr": -1.0,
                             "best_psnr_step": -1,
                             "best_metric": "psnr_v2"})
    state = _port_teacher(cfg, 6, 9)
    log = _Log()
    state, _, _ = C.resume_teacher(state, path, log=log)
    assert any("restored teacher optimizer state" in m for m in log)
    assert (state.step, state.lr_count) == (2, 2)
    for m, p in ((state.model_c, jstate.params_coarse),
                 (state.model_f, jstate.params_fine)):
        for k, v in nerf_params_from_jax(np_tree(p)).items():
            assert torch.equal(m.state_dict()[k], v), k
    back = str(tmp_path / "port.msgpack")
    C.save(back, state, 2, -1.0, -1)
    with open(back, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    key = jax.random.key(32)
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(poses), key)
    step = TR.make_teacher_step(cfg, tv, TR.TeacherTrainConfig(**TCFG), H,
                                W, FOCAL, device="cpu")
    state, m = step(state, images, poses, draws=_teacher_draws(key, jv))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=TOL_LOSS)
    for model, p in ((state.model_c, jstate.params_coarse),
                     (state.model_f, jstate.params_fine)):
        want = nerf_params_from_jax(np_tree(p))
        for name, q in model.named_parameters():
            np.testing.assert_allclose(n(q), want[name].numpy(), rtol=0,
                                       atol=TOL_PARAMS, err_msg=name)
