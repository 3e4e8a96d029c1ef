"""Port parity of the checkpoint layer (r2l_tpu_torch/checkpoint.py,
_msgpack.py, the model layout tables, tools/export_torch_ckpt.py) against
r2l_tpu/checkpoint.py and tools/export_torch_ckpt.py.

Files are compared byte for byte: the port writes what
``r2l_tpu.checkpoint.save_checkpoint`` writes for the same tree (flax's
msgpack, dict keys sorted, lists keyed "0", "1", ... in index order), and
reads flax's bytes to the same arrays and dtypes. The converters move
arrays without arithmetic (transposes, stacks, f32 casts of f32), so they
are held bit for bit too; a forward through a loaded module is held to
``apply_r2l`` at tests/test_torch_model.py's f32 tolerance, 1e-5.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_parity import models, n, np_tree, t, torch_cfg
from r2l_tpu import checkpoint as JC
from r2l_tpu import train as JTR
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models import apply_r2l, init_r2l
from r2l_tpu.models.nerf import NeRFConfig as JaxNeRFConfig
from r2l_tpu.models.nerf import init_nerf
from r2l_tpu_torch import _msgpack
from r2l_tpu_torch import checkpoint as C
from r2l_tpu_torch.models import (NeRFConfig, R2L, nerf_params_from_jax,
                                  nerf_params_to_jax, params_from_jax,
                                  params_to_jax)
from r2l_tpu_torch.models.nerf import NeRF
from r2l_tpu_torch.tools.export_torch_ckpt import main as port_export
from tools.export_torch_ckpt import main as jax_export

# a forward through a loaded module against apply_r2l, f32
# (tests/test_torch_model.py:21)
TOL_F32 = 1e-5


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _nerf_cfg(D=4, viewdirs=True):
    return JaxNeRFConfig(D=D, W=16, skips=(2,), use_viewdirs=viewdirs,
                         input_ch=9, input_ch_views=6 if viewdirs else 0,
                         output_ch=5 if viewdirs else 4)


def _distill_tree(steps=2):
    """A JAX distillation state after ``steps`` steps (moments and counts
    non-zero, the pool partly filled), in ``_save``'s layout."""
    from r2l_tpu.sampler import PointSampler
    jcfg = JaxR2LConfig(input_dim=6 * 9, netwidth=16, netdepth=6)
    params = init_r2l(jax.random.key(0), jcfg)
    dcfg = JTR.DistillConfig(batch_size=32, n_hard_in=4, n_hard_out=8,
                             hard_mul=2.0, embed_L=4)
    state, tx = JTR.init_train_state(jax.random.key(1), params, dcfg)
    step = JTR.make_distill_step(jcfg, dcfg, PointSampler(
        H=4, W=4, focal=5.0, n_sample=2, near=2.0, far=6.0), tx)
    rng = np.random.default_rng(0)
    for i in range(steps):
        state, _ = step(state, jnp.asarray(rng.uniform(
            size=(24, 9)).astype(np.float32)), jax.random.key(10 + i))
    return {"params": state.params, "opt_state": state.opt_state,
            "pool": {"rays": state.pool.rays, "size": state.pool.size,
                     "ptr": state.pool.ptr}}


def _teacher_tree(fine, viewdirs, D=12):
    """The teacher's save layout (r2l_tpu/app.py:1417-1474) at depth D: 12
    pts_linears puts "10" and "11" after "9"."""
    cfg = _nerf_cfg(D, viewdirs)
    pc = init_nerf(jax.random.key(2), cfg)
    pf = init_nerf(jax.random.key(3), cfg) if fine else {}
    state, _ = JTR.init_teacher_state(pc, pf, JTR.TeacherTrainConfig())
    return {"coarse": pc, "fine": pf, "opt_state": state.opt_state}


def _trees():
    mlp = JaxR2LConfig(input_dim=12, netwidth=8, netdepth=14,
                       body_arch="mlp")
    return {
        "distill_with_pool": _distill_tree,
        "teacher_fine_viewdirs": lambda: _teacher_tree(True, True),
        "teacher_no_fine": lambda: _teacher_tree(False, True),
        "teacher_no_viewdirs": lambda: _teacher_tree(True, False),
        "mlp_body_12_layers": lambda: {
            "params": init_r2l(jax.random.key(4), mlp)},
        "count_0d_int32": lambda: {"count": jnp.asarray(7, jnp.int32),
                                   "x": {"b": jnp.ones((3,)),
                                         "a": jnp.zeros((2, 2))}},
    }


def _equal_trees(got, want, path=""):
    """Same keys in the same order, same dtypes, shapes and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _equal_trees(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("case", list(_trees()))
def test_file_bytes_equal_jax_and_decode_as_flax(case, tmp_path):
    tree = _trees()[case]()
    meta = {"global_step": 3, "best_psnr": 12.5, "best_psnr_step": 2,
            "best_metric": "psnr_v2"}
    want = str(tmp_path / "jax.msgpack")
    JC.save_checkpoint(want, tree, meta=meta)
    host = jax.tree.map(np.asarray, tree)
    # the port's writer takes numpy leaves and torch tensors alike
    as_torch = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), host)
    for name, src in (("numpy", host), ("torch", as_torch)):
        got = str(tmp_path / f"{name}.msgpack")
        C.save_checkpoint(got, src, meta=meta)
        assert _read(got) == _read(want), name
        assert _read(got + ".meta.json") == _read(want + ".meta.json")
        assert not os.path.exists(got + ".tmp")
    C.drop_cached_checkpoint()
    tree_port, meta_port = C.load_checkpoint(want)
    assert meta_port == meta
    _equal_trees(tree_port, serialization.msgpack_restore(_read(want)))


def test_list_keys_keep_index_order(tmp_path):
    """A list of 12 is written "0".."9", "10", "11", not as sorted
    strings: the file's map keys as msgpack reads them."""
    tree = _trees()["mlp_body_12_layers"]()
    path = str(tmp_path / "mlp.msgpack")
    C.save_checkpoint(path, jax.tree.map(np.asarray, tree))
    raw = msgpack.unpackb(_read(path), raw=False,
                          ext_hook=lambda code, data: code)
    assert list(raw["params"]["body"]) == [str(i) for i in range(12)]
    assert list(raw["params"]) == ["body", "head", "tail"]


def test_codec_scalars_and_ext_types_equal_flax():
    """Every leaf kind of the format, in to_bytes's in-place path (keys in
    the order given): the same bytes as flax, and read back as flax reads
    them."""
    state = {"z": np.float32(3.0), "int8": np.arange(-3, 3, dtype=np.int8),
             "i": 5, "neg": -100000, "big": 2 ** 40, "small_neg": -7,
             "f": 2.5, "s": "abc", "long_s": "x" * 40, "b": b"\x00\x01",
             "none": None, "yes": True, "no": False, "c": 1 + 2j,
             "empty": {}, "nested": {"a": np.zeros((0, 3), np.float64),
                                     "u8": np.arange(300, dtype=np.uint8)},
             "many": {f"k{i}": i for i in range(20)}}
    got = _msgpack.serialize(state)
    assert got == serialization.msgpack_serialize(dict(state), in_place=True)
    back = _msgpack.restore(got)
    want = serialization.msgpack_restore(got)
    assert list(back) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            for kk in want[k]:
                np.testing.assert_array_equal(back[k][kk], want[k][kk])
        elif isinstance(want[k], np.ndarray):
            assert back[k].dtype == want[k].dtype
            np.testing.assert_array_equal(back[k], want[k])
        else:
            assert back[k] == want[k] and type(back[k]) is type(want[k]), k


def test_chunked_leaves_encode_and_decode_as_flax(monkeypatch, tmp_path):
    """flax writes a leaf over MAX_CHUNK_SIZE bytes as chunks of its
    flattened array; with the limit made small on both sides the port
    writes the same bytes and reads the leaf back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25),
            "b": np.ones((3,), np.float32)}
    path = str(tmp_path / "chunked.msgpack")
    JC.save_checkpoint(path, tree)
    assert _msgpack.serialize({k: tree[k] for k in sorted(tree)}) == \
        _read(path)
    C.drop_cached_checkpoint()
    got, _ = C.load_checkpoint(path)
    np.testing.assert_array_equal(got["w"], tree["w"])
    assert got["w"].dtype == np.float32


def test_load_checkpoint_memo(tmp_path):
    """One blob memoized by (path, mtime), dropped on request."""
    path = str(tmp_path / "m.msgpack")
    C.save_checkpoint(path, {"a": np.ones(3, np.float32)})
    C.drop_cached_checkpoint()
    first, _ = C.load_checkpoint(path)
    assert C.load_checkpoint(path)[0] is first
    C.drop_cached_checkpoint()
    assert C.load_checkpoint(path)[0] is not first
    os.utime(path, (1, 1))
    assert C.load_checkpoint(path)[0] is not first
    C.drop_cached_checkpoint()


@pytest.mark.parametrize("wrapped", [True, False])
@pytest.mark.parametrize("arch", ["resmlp", "mlp"])
def test_load_params_matches_jax(wrapped, arch, tmp_path):
    """A file written by JAX, params wrapped ({"params", "opt_state"}) or
    bare: the port's tree equals JAX's ``load_params``, and loaded into a
    module its state_dict is ``params_from_jax`` of JAX's params."""
    jcfg = JaxR2LConfig(input_dim=12, netwidth=16, netdepth=6,
                        body_arch=arch)
    params, cfg, _ = models(jcfg, seed=5)
    path = str(tmp_path / "p.msgpack")
    JC.save_checkpoint(path, {"params": params, "opt_state": {}}
                       if wrapped else params, meta={"global_step": 9})
    want, _ = JC.load_params(path, params)
    C.drop_cached_checkpoint()
    got, meta = C.load_params(path)
    assert meta == {"global_step": 9}
    jax.tree.map(np.testing.assert_array_equal, got, np_tree(want))
    model, _ = C.load_params(path, R2L(cfg, "cpu"))
    for k, v in params_from_jax(np_tree(params), cfg).items():
        assert torch.equal(model.state_dict()[k], v), k
    C.drop_cached_checkpoint()


ARCHS = {"resmlp": {}, "mlp": {"body_arch": "mlp"},
         "linear_tail": {"linear_tail": True},
         "layerwise": {"body_arch": "mlp", "layerwise_widths": (16, 8, 12)}}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_r2l_converters_match_jax(arch):
    """params_to_torch_r2l and torch_r2l_to_params (with DataParallel
    ``module.`` prefixes) equal JAX's, and so do the inferred configs."""
    jcfg = JaxR2LConfig(input_dim=12, netwidth=16, netdepth=5,
                        **ARCHS[arch])
    params = np_tree(init_r2l(jax.random.key(6), jcfg))
    cfg = torch_cfg(jcfg)
    sd_want = JC.params_to_torch_r2l(params, jcfg)
    sd_got = C.params_to_torch_r2l(params, cfg)
    assert list(sd_got) == list(sd_want)
    for k in sd_want:
        np.testing.assert_array_equal(sd_got[k], sd_want[k], err_msg=k)
    prefixed = {"module." + k: torch.from_numpy(np.array(v))
                for k, v in sd_want.items()}
    assert list(C.strip_module_prefix(prefixed)) == \
        list(JC.strip_module_prefix(prefixed))
    assert C._torch_body_is_mlp(sd_want) == JC._torch_body_is_mlp(sd_want)
    jax.tree.map(np.testing.assert_array_equal,
                 C.torch_r2l_to_params(prefixed, cfg),
                 JC.torch_r2l_to_params(prefixed, jcfg))
    ignore = ("compute_dtype", "precision")
    for got, want in (
            (C.infer_r2l_config_from_state_dict(prefixed),
             JC.infer_r2l_config_from_state_dict(prefixed)),
            (C.infer_r2l_config_from_params(params),
             JC.infer_r2l_config_from_params(params)),
            (C.infer_r2l_config_from_params(serialization.to_state_dict(
                params)), JC.infer_r2l_config_from_params(
                    serialization.to_state_dict(params)))):
        for f in dataclasses.fields(got):
            if f.name not in ignore:
                assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("viewdirs", [True, False])
def test_nerf_converters_match_jax(viewdirs):
    jcfg = _nerf_cfg(4, viewdirs)
    params = np_tree(init_nerf(jax.random.key(7), jcfg))
    cfg = NeRFConfig(D=4, W=16, skips=(2,), use_viewdirs=viewdirs,
                     input_ch=9, input_ch_views=6 if viewdirs else 0,
                     output_ch=5 if viewdirs else 4)
    sd_want = JC.params_to_torch_nerf(params, jcfg)
    sd_got = C.params_to_torch_nerf(params, cfg)
    assert list(sd_got) == list(sd_want)
    for k in sd_want:
        np.testing.assert_array_equal(sd_got[k], sd_want[k], err_msg=k)
    prefixed = {"module." + k: v for k, v in sd_want.items()}
    jax.tree.map(np.testing.assert_array_equal,
                 C.torch_nerf_to_params(prefixed, cfg),
                 JC.torch_nerf_to_params(prefixed, jcfg))


def _keras_list(host):
    flat = []
    for lin in host["pts_linears"]:
        flat += [lin["w"], lin["b"]]
    for name in ("feature_linear", "views_linears", "rgb_linear",
                 "alpha_linear"):
        lin = host[name][0] if name == "views_linears" else host[name]
        flat += [lin["w"], lin["b"]]
    return flat


def test_keras_converter_matches_jax_and_checks_the_length():
    """The Keras list (reference NeRF.load_weights_from_keras) converts as
    JAX converts it; a list of another length than 2·D + 8 raises, where
    JAX's converter indexes it unchecked; no viewdirs raises in both."""
    jcfg = _nerf_cfg(4, True)
    cfg = NeRFConfig(D=4, W=16, skips=(2,), input_ch=9, input_ch_views=6,
                     output_ch=5)
    flat = _keras_list(np_tree(init_nerf(jax.random.key(8), jcfg)))
    jax.tree.map(np.testing.assert_array_equal,
                 C.keras_nerf_to_params(flat, cfg),
                 JC.keras_nerf_to_params(flat, jcfg))
    for bad in (flat[:-2], flat + flat[:2]):
        with pytest.raises(ValueError, match="2\\*D \\+ 8"):
            C.keras_nerf_to_params(bad, cfg)
    with pytest.raises(ValueError, match="use_viewdirs"):
        C.keras_nerf_to_params(flat, dataclasses.replace(
            cfg, use_viewdirs=False))


@pytest.mark.parametrize("arch", ["resmlp", "mlp"])
def test_params_to_jax_inverts_params_from_jax(arch):
    jcfg = JaxR2LConfig(input_dim=12, netwidth=16, netdepth=6,
                        body_arch=arch)
    params, cfg, model = models(jcfg, seed=9)
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(model, cfg),
                 np_tree(params))
    ncfg = _nerf_cfg(4, True)
    tparams = np_tree(init_nerf(jax.random.key(10), ncfg))
    net = NeRF(NeRFConfig(D=4, W=16, skips=(2,), input_ch=9,
                          input_ch_views=6, output_ch=5), "cpu")
    net.load_state_dict(nerf_params_from_jax(tparams))
    jax.tree.map(np.testing.assert_array_equal, nerf_params_to_jax(net),
                 tparams)


def _reference_tar(path, params, jcfg, **extra):
    """A .tar in the reference's save_ckpt schema (main.py:1516-1542):
    DataParallel prefixes, an optimizer state_dict, the step and PSNR."""
    sd = {"module." + k: torch.from_numpy(np.array(v))
          for k, v in JC.params_to_torch_r2l(params, jcfg).items()}
    torch.save({"global_step": 123456, "best_psnr": 31.87,
                "best_psnr_step": 120000, "network_fn_state_dict": sd,
                "optimizer_state_dict": {"state": {}, "param_groups": []},
                **extra}, path)


@pytest.mark.parametrize("source", ["tar", "msgpack"])
def test_loaded_module_forward_matches_apply_r2l(source, tmp_path):
    """``load_r2l`` of a reference .tar or a JAX-written native file: the
    inferred architecture, and a forward through the loaded module against
    JAX's apply_r2l on the original params."""
    jcfg = JaxR2LConfig(input_dim=8 * 3 * 21, netwidth=32, netdepth=6,
                        precision="highest")
    params = init_r2l(jax.random.key(11), jcfg)
    if source == "tar":
        path = str(tmp_path / "ckpt_123456.tar")
        _reference_tar(path, params, jcfg)
    else:
        path = str(tmp_path / "ckpt.msgpack")
        JC.save_checkpoint(path, {"params": params},
                           meta={"global_step": 123456})
    model, cfg, meta = C.load_r2l(path, device="cpu")
    assert meta["global_step"] == 123456
    assert (cfg.input_dim, cfg.netwidth, cfg.num_blocks) == (504, 32, 2)
    x = np.random.default_rng(0).normal(size=(8, 504)).astype(np.float32)
    with torch.no_grad():
        got = n(model(t(x)))
    want = np.asarray(apply_r2l(params, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


def test_load_torch_tar_refuses_a_pickled_module(tmp_path):
    """A .tar that pickles a whole module (the reference's ``network_fn``)
    does not load with weights_only: the error names the key and says to
    re-save the state_dicts."""
    path = str(tmp_path / "full.tar")
    torch.save({"global_step": 1, "network_fn": torch.nn.Linear(2, 2)}, path)
    with pytest.raises(ValueError, match="network_fn.*state_dicts"):
        C.load_torch_tar(path)


@pytest.mark.parametrize("source", ["tar", "msgpack"])
@pytest.mark.parametrize("fine", [True, False])
def test_load_teacher_matches_jax(source, fine, tmp_path):
    jcfg = _nerf_cfg(4, True)
    pc = init_nerf(jax.random.key(12), jcfg)
    pf = init_nerf(jax.random.key(13), jcfg) if fine else {}
    if source == "tar":
        path = str(tmp_path / "teacher.tar")
        blob = {"global_step": 77, "network_fn_state_dict": {
            k: torch.from_numpy(np.array(v))
            for k, v in JC.params_to_torch_nerf(pc, jcfg).items()}}
        if fine:
            blob["network_fine_state_dict"] = {
                k: torch.from_numpy(np.array(v))
                for k, v in JC.params_to_torch_nerf(pf, jcfg).items()}
        torch.save(blob, path)
    else:
        path = str(tmp_path / "teacher.msgpack")
        JC.save_checkpoint(path, {"coarse": pc, "fine": pf,
                                  "opt_state": {}},
                           meta={"global_step": 77})
    cfg = NeRFConfig(D=4, W=16, skips=(2,), input_ch=9, input_ch_views=6,
                     output_ch=5)
    mc, mf = NeRF(cfg, "cpu"), NeRF(cfg, "cpu") if fine else None
    assert C.load_teacher(path, mc, mf)["global_step"] == 77
    C.drop_cached_checkpoint()
    for model, p in ((mc, pc), (mf, pf)):
        if model is None:
            continue
        for k, v in nerf_params_from_jax(np_tree(p)).items():
            assert torch.equal(model.state_dict()[k], v), k
    if not fine:   # a fine network the file does not hold: an error
        with pytest.raises(KeyError):
            C.load_teacher(path, mc, NeRF(cfg, "cpu"))
        C.drop_cached_checkpoint()


TOOL_CASES = {
    "r2l": ({}, []),
    "r2l_linear_tail": ({"linear_tail": True}, ["--linear_tail"]),
    "r2l_mlp_body": ({"body_arch": "mlp"}, []),
    "nerf_fine_viewdirs": ((True, True), ["--model_name", "nerf"]),
    "nerf_no_fine_no_viewdirs": ((False, False), ["--model_name", "nerf"]),
}


@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_export_tool_matches_jax(case, tmp_path):
    """``python -m r2l_tpu_torch.tools.export_torch_ckpt`` writes a .tar
    with the keys and tensors of ``tools/export_torch_ckpt.py``'s."""
    kw, flags = TOOL_CASES[case]
    native = str(tmp_path / "ckpt.msgpack")
    if case.startswith("nerf"):
        fine, viewdirs = kw
        tree = _teacher_tree(fine, viewdirs, D=3)
    else:
        jcfg = JaxR2LConfig(input_dim=4 * 3 * 21, netwidth=32, netdepth=6,
                            **kw)
        tree = {"params": init_r2l(jax.random.key(14), jcfg)}
    JC.save_checkpoint(native, tree, meta={"global_step": 7,
                                           "best_psnr": 12.5,
                                           "best_psnr_step": 6})
    outs = {}
    for name, fn in (("jax", jax_export), ("port", port_export)):
        outs[name] = str(tmp_path / f"{name}.tar")
        assert fn(["--ckpt", native, "--out", outs[name]] + flags) == 0
    want = torch.load(outs["jax"], weights_only=True)
    got = C.load_torch_tar(outs["port"])
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert list(got[k]) == list(v), k
            for kk in v:
                assert got[k][kk].dtype == v[kk].dtype
                assert torch.equal(got[k][kk], v[kk]), (k, kk)
        else:
            assert got[k] == v, k
