"""Port parity of the multi-device paths (r2l_tpu_torch/parallel/, the
``mesh=`` of train.py and evaluate.py) against r2l_tpu's single-device
results: the counterpart of tests/test_sharding.py's 13 tests, each on 2
and 4 gloo ranks (tests/_torch_mesh_worker.py) fed the same numpy inputs
and JAX's draws. The ranks start once per world size for the whole file.

Tolerances are tests/test_sharding.py's: a data-parallel sum runs in
another order (loss rtol 1e-5; parameters and gradients rtol 1e-4, atol
1e-6; frames rtol 1e-5, atol 1e-6). The forward and the gradients are held
to JAX's single-device values; a training step's losses and hard pool to
JAX's single-device step, its parameters to the same step in one process
of the port; a sharded frame to the port's one-process frame (the sharding's
own error, what test_sharding.py measures in JAX: sharded against one
device of the same package). The one-process port is held to JAX by the
step and frame tests (tests/test_torch_train_step.py, test_torch_frame.py,
test_torch_teacher.py): its parameters after a step are not compared to
JAX's there, as Adam's first updates turn a gradient that sums to near 0
into a step of up to the learning rate whose sign the sum order decides
(up to 1e-3 measured here, on 2 of 4,032 head weights)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import r2l_tpu.train as JTR
from _torch_mesh import flat, ok, run_ranks, unflat
from _torch_parity import jax_ray_draws, jax_step_draws, np_tree
from r2l_tpu.evaluate import make_nerf_frame_fn as jax_nerf_frame
from r2l_tpu.evaluate import make_r2l_frame_fn as jax_r2l_frame
from r2l_tpu.models import R2LConfig, apply_r2l, init_r2l
from r2l_tpu.models.nerf import NeRFConfig, init_nerf
from r2l_tpu.rays import pose_spherical
from r2l_tpu.render import VolRenderConfig
from r2l_tpu.sampler import PointSampler

TOL_LOSS = 1e-5
TOL_PARAMS = dict(rtol=1e-4, atol=1e-6)
TOL_FRAME = dict(rtol=1e-5, atol=1e-6)
WORLDS = (2, 4)


def _n(x):
    return np.asarray(x, np.float32)


def _draws(prefix_i, d):
    return {f"u{prefix_i}": d.hard.u.numpy(),
            f"perm{prefix_i}": d.hard.perm.numpy(),
            f"z{prefix_i}": d.z_u.numpy()}


def _distill_jax(n_hard, keys, fresh, scan=False):
    """JAX's single-device distillation (tests/test_sharding.py's
    _mk_distill): (inputs for the ranks, (state, losses))."""
    cfg = R2LConfig(input_dim=6 * 21, netwidth=32, netdepth=4)
    params = init_r2l(jax.random.key(0), cfg)
    dcfg = JTR.DistillConfig(batch_size=128, n_hard_in=8 if n_hard else 0,
                             n_hard_out=n_hard, hard_mul=2.0, embed_L=10)
    sampler = PointSampler(H=8, W=8, focal=8.0, n_sample=2, near=2.0,
                           far=6.0)
    inp = flat(np_tree(params), "params")
    state, tx = JTR.init_train_state(jax.random.key(7), params, dcfg)
    losses = []
    if scan:
        step = JTR.make_distill_step(cfg, dcfg, sampler, tx, scan_steps=2)
        key = keys[0]
        for i in range(2):      # the scan's key chain, step by step
            key, sub = jax.random.split(key)
            inp.update(_draws(i, jax_step_draws(sub, dcfg, 2)))
        state, ms, _ = step(state, jnp.asarray(fresh), keys[0])
        losses = [float(v) for v in np.asarray(ms["loss"])]
        inp["batches"] = fresh
        return inp, (state, losses)
    step = JTR.make_distill_step(cfg, dcfg, sampler, tx)
    for i, k in enumerate(keys):
        d = jax_step_draws(k, dcfg, 2)
        inp[f"z{i}"] = d.z_u.numpy()
        if n_hard:
            inp.update(_draws(i, d))
        state, ms = step(state, jnp.asarray(fresh), k)
        losses.append(float(ms["loss"]))
    inp["fresh"] = fresh
    return inp, (state, losses)


def _images_jax():
    cfg = R2LConfig(input_dim=2 * 3 * 21, netwidth=32, netdepth=4)
    params = init_r2l(jax.random.key(0), cfg)
    dcfg = JTR.DistillConfig(batch_size=64, n_hard_in=4, n_hard_out=8,
                             hard_mul=2.0, embed_L=10)
    sampler = PointSampler(H=8, W=8, focal=8.0, n_sample=2, near=2.0,
                           far=6.0)
    image = _n(jax.random.uniform(jax.random.key(1), (8, 8, 3)))
    inp = flat(np_tree(params), "params")
    inp["image"] = image
    state, tx = JTR.init_train_state(jax.random.key(7), params, dcfg)
    step = JTR.make_distill_step_images(cfg, dcfg, sampler, tx, H=8, W=8,
                                        focal=8.0)
    losses = []
    for i in range(3):
        key = jax.random.key(i)
        k_coord, k_core = jax.random.split(key)
        inp[f"upix{i}"] = _n(jax.random.uniform(k_coord, (56, 2)))
        inp.update(_draws(i, jax_step_draws(k_core, dcfg, 2)))
        state, ms = step(state, jnp.asarray(image), jnp.eye(4)[:3, :4], key)
        losses.append(float(ms["loss"]))
    return inp, (state, losses)


def _teacher_jax():
    ncfg = NeRFConfig(D=2, W=16, skips=(), use_viewdirs=False,
                      input_ch=63, input_ch_views=0)
    pc = init_nerf(jax.random.key(0), ncfg)
    vcfg = VolRenderConfig(n_coarse=4, n_fine=0, use_viewdirs=False)
    tcfg = JTR.TeacherTrainConfig(n_rand=64)
    pool = np.random.default_rng(0).normal(size=(512, 9)).astype(np.float32)
    inp = flat(np_tree(pc), "pc")
    inp["pool"] = pool
    state, tx = JTR.init_teacher_state(pc, {}, tcfg)
    step = JTR.make_teacher_step_batched(ncfg, vcfg, tcfg, tx)
    losses = []
    for i in range(2):
        key = jax.random.key(i)
        d = jax_ray_draws(key, vcfg, 64)
        assert d.noise is None and d.u_pdf is None
        inp[f"ustrat{i}"] = d.u_strat.numpy()
        state, m = step(state, jnp.asarray(pool), jnp.asarray(64 * i,
                                                              jnp.int32), key)
        losses.append(float(m["loss"]))
    return inp, (state, losses)


@pytest.fixture(scope="module")
def jax_ref():
    """Every case's inputs for the ranks and JAX's single-device result."""
    cases, ref = {}, {}
    cfg = R2LConfig(input_dim=24, netwidth=32, netdepth=6)
    params = init_r2l(jax.random.key(0), cfg)
    x = _n(jax.random.normal(jax.random.key(1), (64, 24)))
    cases["dp_fwd"] = dict(flat(np_tree(params), "params"), x=x)
    ref["dp_fwd"] = _n(apply_r2l(params, cfg, jnp.asarray(x)))
    xt = _n(jax.random.normal(jax.random.key(1), (16, 24)))
    cases["tp_fwd"] = dict(flat(np_tree(params), "params"), x=xt)
    ref["tp_fwd"] = _n(apply_r2l(params, cfg, jnp.asarray(xt)))

    gcfg = R2LConfig(input_dim=12, netwidth=16, netdepth=4)
    gp = init_r2l(jax.random.key(0), gcfg)
    gx = _n(jax.random.normal(jax.random.key(2), (32, 12)))
    gy = _n(jax.random.uniform(jax.random.key(3), (32, 3)))
    cases["dp_grads"] = dict(flat(np_tree(gp), "params"), x=gx, y=gy)
    ref["dp_grads"] = np_tree(jax.grad(
        lambda p: jnp.mean((apply_r2l(p, gcfg, jnp.asarray(gx)) - gy) ** 2)
    )(gp))
    cases["mesh"] = {}
    cases["batch_shards"] = {}

    fresh = _n(jax.random.normal(jax.random.key(1), (112, 9)))
    cases["distill_dptp"], ref["distill_dptp"] = _distill_jax(
        16, [jax.random.key(0), jax.random.key(1)], fresh)
    cases["distill_dp"], ref["distill_dp"] = _distill_jax(
        0, [jax.random.key(5)],
        _n(jax.random.normal(jax.random.key(1), (128, 9))))
    cases["scan"], ref["scan"] = _distill_jax(
        16, [jax.random.key(3)],
        _n(jax.random.normal(jax.random.key(1), (2, 112, 9))), scan=True)
    cases["images"], ref["images"] = _images_jax()
    cases["teacher"], ref["teacher"] = _teacher_jax()

    fcfg = R2LConfig(input_dim=12 * 21, netwidth=128, netdepth=6,
                     precision="highest")
    fp = init_r2l(jax.random.key(0), fcfg)
    c2w = pose_spherical(30.0, -40.0, 4.0)[:3, :4].astype(np.float32)
    sampler = PointSampler(H=16, W=16, focal=20.0, n_sample=4, near=2.0,
                           far=6.0)
    cases["student_frame"] = dict(flat(np_tree(fp), "params"), c2w=c2w)
    ref["student_frame"] = _n(jax_r2l_frame(
        fp, fcfg, sampler, embed_L=10, use_pallas=False)(jnp.asarray(c2w)))

    ncfg = NeRFConfig(D=3, W=32, skips=(1,), use_viewdirs=True, input_ch=63,
                      input_ch_views=27, output_ch=5)
    k1, k2 = jax.random.split(jax.random.key(0))
    pc, pf = init_nerf(k1, ncfg), init_nerf(k2, ncfg)
    vcfg = VolRenderConfig(n_coarse=6, n_fine=4, use_viewdirs=True,
                           white_bkgd=True, multires=10, multires_views=4,
                           ray_chunk=64)
    tsampler = PointSampler(H=12, W=12, focal=16.0, n_sample=6, near=2.0,
                            far=6.0)
    tc2w = pose_spherical(45.0, -35.0, 4.0)[:3, :4].astype(np.float32)
    cases["teacher_frame"] = dict(flat(np_tree(pc), "pc"),
                                  **flat(np_tree(pf), "pf"), c2w=tc2w)
    ref["teacher_frame"] = _n(jax_nerf_frame(pc, pf, ncfg, vcfg, tsampler)(
        jnp.asarray(tc2w)))
    return cases, ref


@pytest.fixture(scope="module", params=WORLDS)
def world(request, jax_ref, tmp_path_factory):
    """(n, every case's per-rank outputs, JAX's references) for n ranks."""
    cases, ref = jax_ref
    n = request.param
    out = run_ranks(n, cases, str(tmp_path_factory.mktemp(f"mesh{n}")))
    return n, out, ref


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])


def _compare_params(ranks, prefix):
    """Each rank's parameters and losses against the same steps in one
    process of the port, and the parameters the same on every rank."""
    for r in ranks:
        got = jax.tree.leaves(unflat(r, prefix))
        single = jax.tree.leaves(unflat(r, f"single/{prefix}"))
        assert len(got) == len(single) > 0
        for b, c in zip(got, single):
            np.testing.assert_allclose(b, c, **TOL_PARAMS)
        np.testing.assert_allclose(r["loss"], r["single/loss"],
                                   rtol=TOL_LOSS)
    for k in ranks[0]:
        if k.startswith(prefix + "/"):
            _same_on_every_rank(ranks, k)


def _compare_state(ranks, ref, n_losses):
    state, losses = ref
    for r in ranks:
        assert r["loss"].shape == (n_losses,)
        np.testing.assert_allclose(r["loss"], losses, rtol=TOL_LOSS)
    _compare_params(ranks, "params")
    # the replicated pool: JAX's single-device contents and pointer
    pool = state.pool
    for r in ranks:
        np.testing.assert_allclose(r["pool_rays"], _n(pool.rays),
                                   **TOL_PARAMS)
        assert r["pool_meta"].tolist() == [int(pool.size), int(pool.ptr)]


def test_ranks_join_one_gloo_group(world):
    """test_eight_virtual_devices: N processes, ranks 0..N-1, gloo."""
    n, out, _ = world
    ranks = ok(out["mesh"])
    assert sorted(int(r["world"][1]) for r in ranks) == list(range(n))
    assert all(int(r["world"][0]) == n and bool(r["backend"][0])
               for r in ranks)


def test_make_mesh_shapes(world):
    """data:N by default; data:N/2 x model:2; -1 takes the rest; ranks are
    row-major coordinates, as JAX reshapes its devices."""
    n, out, _ = world
    for rank, r in enumerate(ok(out["mesh"])):
        assert r["shape1"].tolist() == [n, 1]
        assert r["shape2"].tolist() == [n // 2, 2]
        assert r["shape3"].tolist() == [n // 2, 2]
        assert r["coords2"].tolist() == [rank // 2, rank % 2]


def test_data_parallel_forward_matches_single(world):
    _, out, ref = world
    for r in ok(out["dp_fwd"]):
        np.testing.assert_allclose(r["out"], ref["dp_fwd"], **TOL_FRAME)


def test_tensor_parallel_forward_matches_single(world):
    """Megatron over model:2 (data N/2): the body's first linear column-,
    the second row-parallel; the forward equals JAX's single device."""
    _, out, ref = world
    for r in ok(out["tp_fwd"]):
        assert r["roles"].all()
        np.testing.assert_allclose(r["out"], ref["tp_fwd"], **TOL_FRAME)


def test_data_parallel_grads_match_single(world):
    """Summed over data, the gradients are the global batch's, the same on
    every rank (replicated)."""
    _, out, ref = world
    ranks = ok(out["dp_grads"])
    for r in ranks:
        got = unflat(r, "grads")
        for a, b in zip(jax.tree.leaves(ref["dp_grads"]),
                        jax.tree.leaves(got)):
            np.testing.assert_allclose(b, a, **TOL_PARAMS)
    for k in ranks[0]:
        _same_on_every_rank(ranks, k)


def test_batch_sharding_places_shards(world):
    n, out, _ = world
    for rank, r in enumerate(ok(out["batch_shards"])):
        per = 16 // n
        assert r["local"].shape == (per, 1)
        np.testing.assert_array_equal(
            r["local"][:, 0], np.arange(rank * per, (rank + 1) * per))
        np.testing.assert_array_equal(r["back"][:, 0], np.arange(16))


def test_distill_step_on_dp_tp_mesh_matches_single(world):
    """Two hard-mined steps on data x model: the loss, the parameters and
    the (replicated) hard pool are JAX's single-device step's."""
    _, out, ref = world
    _compare_state(ok(out["distill_dptp"]), ref["distill_dptp"], 2)


def test_distill_step_mesh_matches_single_device(world):
    _, out, ref = world
    _compare_state(ok(out["distill_dp"]), ref["distill_dp"], 1)


def test_teacher_batched_step_shards_over_mesh(world):
    """The teacher's batched step with the rays over data: JAX's update."""
    _, out, ref = world
    state, losses = ref["teacher"]
    ranks = ok(out["teacher"])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], losses, rtol=TOL_LOSS)
    _compare_params(ranks, "pc")


def test_scanned_distill_step_on_mesh(world):
    """scan_steps=2 on data x model: the two losses stacked, JAX's scanned
    update."""
    _, out, ref = world
    _compare_state(ok(out["scan"]), ref["scan"], 2)


def test_images_mode_distill_step_mesh_matches_single_device(world):
    _, out, ref = world
    _compare_state(ok(out["images"]), ref["images"], 3)


def test_sharded_student_frame_matches_single(world):
    """16x16 = 256 rays over N ranks in each kind (the kernels' plain
    versions here, K1/K2 per shard on the card): the sharded frame equals
    the one-process frame; the plain kind's is JAX's frame within max abs
    2e-5 (1.17e-5 measured; tests/test_torch_frame.py holds W64 to 1e-5,
    and a W128 layer sums twice the products)."""
    _, out, ref = world
    for r in ok(out["student_frame"]):
        for kind in ("jnp", "pe", "int8"):
            np.testing.assert_allclose(r[f"{kind}_sharded"],
                                       r[f"{kind}_single"], **TOL_FRAME,
                                       err_msg=kind)
        assert np.abs(r["jnp_sharded"] - ref["student_frame"]).max() < 2e-5


def test_sharded_teacher_frame_matches_single(world):
    """The teacher's frame, its rays over N ranks: the one-process frame;
    and JAX's within the plain render's bound against JAX
    (tests/test_torch_teacher.py: rtol 1e-4, atol 2e-4; 1.3e-4 measured)."""
    _, out, ref = world
    for r in ok(out["teacher_frame"]):
        np.testing.assert_allclose(r["sharded"], r["single"], **TOL_FRAME)
        np.testing.assert_allclose(r["sharded"], ref["teacher_frame"],
                                   rtol=1e-4, atol=2e-4)
