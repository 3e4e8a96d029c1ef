"""Checkpoints: ``r2l_tpu``'s native msgpack files, the reference's torch
``.tar`` files, and full-state resume.

Counterpart of ``r2l_tpu/checkpoint.py`` (``save_checkpoint`` :31,
``load_checkpoint`` :53, ``drop_cached_checkpoint`` :84, ``load_params``
:90, the torch and Keras converters :104-325, ``load_torch_tar`` :329) and
of the resume code of ``r2l_tpu/app.py`` (``build_r2l`` :209, ``build_teacher``
:253, ``_save`` :1115, ``_native_resume_blob`` :1140, ``_restore_opt_state``
:1165, the hard pool's restore :779-795, the teacher's save layout
:1417-1474).

The native file is flax's msgpack of a pytree of numpy arrays, written by
the port's own codec (``_msgpack.py``) byte for byte as ``r2l_tpu`` writes
it: dict keys sorted, lists as ``{"0": ..., "1": ...}`` in index order. So
a file written by either package loads and resumes in the other. The
converters keep JAX's names and return JAX's numpy layout (weights [in,
out]); every source then reaches a module by one route, tree ->
``params_from_jax`` / ``nerf_params_from_jax`` -> ``load_state_dict``.
The kernels never read a loaded tree: their factories pack and stage from
the module, after it is loaded.

Resume layouts, as ``r2l_tpu`` writes them:

* distillation: ``{"params", "opt_state", "pool"?}``, meta ``{global_step,
  best_psnr, best_psnr_step, best_metric}``;
* teacher: ``{"coarse", "fine", "opt_state"}``, ``fine`` ``{}`` without a
  fine network;
* ``opt_state`` is optax's ``adam`` over a schedule: ``{"0": {"count",
  "mu", "nu"}, "1": {"count"}}``. ``mu``/``nu`` are torch Adam's
  ``exp_avg``/``exp_avg_sq`` in the params' JAX layout, ``"0".count`` its
  per-parameter ``step``, and ``"1".count`` the schedule's count, the
  state's ``lr_count``.

A resume sets the state's ``step`` from the file's ``global_step``; the
schedule's count comes only with the optimizer, so after a ``.tar`` or a
file without ``opt_state`` the warm-up starts again, as in ``r2l_tpu``.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from . import _msgpack
from .hardmine import HardPool
from .models._layout import (from_jax, host_tree, map_tree, named,
                             restore_lists, to_jax)
from .models.nerf import NeRF, NeRFConfig, nerf_params_from_jax, nerf_table
from .models.r2l import R2L, R2LConfig, params_from_jax, r2l_table
from .train import TeacherState, TrainState


# ---------------------------------------------------------------------------
# Native checkpoints
# ---------------------------------------------------------------------------

def _state_dict(tree):
    """flax's ``to_state_dict`` of a host tree as ``jax.tree.map`` rebuilds
    it: dict keys sorted, NamedTuples by field, lists and tuples as
    ``{"0": ..., "1": ...}`` in index order."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_checkpoint(path: str, tree, meta: dict | None = None) -> None:
    """Save a pytree (tensors on any device, numpy, scalars) to ``path``
    (+ ``path.meta.json``), each written to a ``.tmp`` file first and moved
    into place, so a crash leaves the old file whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pieces = _msgpack.serialize_pieces(_state_dict(host_tree(tree)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(pieces)
    os.replace(tmp, path)
    if meta is not None:
        mtmp = path + ".meta.json.tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(mtmp, path + ".meta.json")


_last_raw: tuple | None = None   # (abspath, mtime, tree, meta)


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """(tree, meta) of a native checkpoint: nested dicts of numpy arrays
    (lists as ``{"0": ...}`` dicts), and the sidecar's meta or ``{}``.

    One blob is memoized by (path, mtime): a resume reads the same file
    twice, the params and then the optimizer and pool. Call
    ``drop_cached_checkpoint()`` when done to release it."""
    global _last_raw
    ap = os.path.abspath(path)
    mt = os.path.getmtime(ap)
    if _last_raw is not None and _last_raw[:2] == (ap, mt):
        return _last_raw[2], _last_raw[3]
    data = bytearray(os.path.getsize(ap))
    with open(ap, "rb") as f:
        f.readinto(data)
    tree = _msgpack.restore(data)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    _last_raw = (ap, mt, tree, meta)
    return tree, meta


def drop_cached_checkpoint() -> None:
    """Release the load memo (``load_checkpoint``)."""
    global _last_raw
    _last_raw = None


def load_params(path: str, model: R2L | None = None):
    """(params, meta) of a native checkpoint that wraps its params as
    ``{"params", "opt_state", ...}`` (the trainer's layout) or stores them
    bare: the JAX-layout numpy tree, lists restored; with ``model``, loaded
    into it (``load_state_dict``) and the model returned in its place."""
    raw, meta = load_checkpoint(path)
    if isinstance(raw, dict) and "params" in raw:
        raw = raw["params"]
    params = restore_lists(raw)
    if model is None:
        return params, meta
    with torch.no_grad():
        model.load_state_dict(params_from_jax(params, model.cfg))
    return model, meta


# ---------------------------------------------------------------------------
# Torch state-dict conversion (reference naming <-> JAX's numpy layout)
# ---------------------------------------------------------------------------

def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _np_tree(tree):
    return map_tree(tree, np.asarray)


def strip_module_prefix(state_dict: dict) -> dict:
    """Remove DataParallel ``module.`` prefixes (reference
    `helpers:408-425`)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def _torch_body_is_mlp(sd: dict) -> bool:
    """True when the body uses the plain-MLP Sequential naming
    ``body.<even>.weight`` (reference `model/nerf_raybased.py:525-528`)
    rather than the ResMLP nesting ``body.<i>.body.<2j>.weight``."""
    body_keys = [k for k in sd
                 if k.startswith("body.") and k.endswith(".weight")]
    return bool(body_keys) and all(len(k.split(".")) == 3
                                   for k in body_keys)


def _mlp_ids(sd: dict) -> list[int]:
    return sorted(int(k.split(".")[1]) for k in sd
                  if k.startswith("body.") and k.endswith(".weight"))


def torch_r2l_to_params(state_dict: dict, cfg: R2LConfig) -> dict:
    """Reference ``NeRF_v3_2`` state_dict -> the JAX param pytree (numpy
    f32): ``head.0``, ``body.<i>.body.<2j>`` (ResMLP) or ``body.<2k>``
    (plain-MLP body), ``tail.0`` or ``tail`` (``--linear_tail``); torch
    weights [out, in] transposed."""
    sd = strip_module_prefix(state_dict)

    def w(name):
        return _to_np(sd[name + ".weight"]).T.astype(np.float32)

    def b(name):
        return _to_np(sd[name + ".bias"]).astype(np.float32)

    params: dict = {"head": {"w": w("head.0"), "b": b("head.0")}}
    if cfg.body_arch == "mlp" or _torch_body_is_mlp(sd):
        params["body"] = [{"w": w(f"body.{i}"), "b": b(f"body.{i}")}
                          for i in _mlp_ids(sd)]
    else:
        nb, nl = cfg.num_blocks, cfg.n_learnable
        params["body"] = {
            "w": np.stack([np.stack([w(f"body.{i}.body.{2 * j}")
                                     for j in range(nl)])
                           for i in range(nb)]),
            "b": np.stack([np.stack([b(f"body.{i}.body.{2 * j}")
                                     for j in range(nl)])
                           for i in range(nb)])}
    tail_name = "tail" if "tail.weight" in sd else "tail.0"
    params["tail"] = {"w": w(tail_name), "b": b(tail_name)}
    return params


def params_to_torch_r2l(params: dict, cfg: R2LConfig) -> dict:
    """Inverse of ``torch_r2l_to_params`` (numpy arrays, reference
    naming)."""
    host = _np_tree(params)
    sd = {"head.0.weight": host["head"]["w"].T,
          "head.0.bias": host["head"]["b"]}
    if isinstance(host["body"], (list, tuple)):
        # plain-MLP body: Sequential(Linear, act, ...) -> even indices
        for k, lin in enumerate(host["body"]):
            sd[f"body.{2 * k}.weight"] = lin["w"].T
            sd[f"body.{2 * k}.bias"] = lin["b"]
    else:
        for i in range(cfg.num_blocks):
            for j in range(cfg.n_learnable):
                sd[f"body.{i}.body.{2 * j}.weight"] = \
                    host["body"]["w"][i, j].T
                sd[f"body.{i}.body.{2 * j}.bias"] = host["body"]["b"][i, j]
    tail_name = "tail" if cfg.linear_tail else "tail.0"
    sd[tail_name + ".weight"] = host["tail"]["w"].T
    sd[tail_name + ".bias"] = host["tail"]["b"]
    return sd


def torch_nerf_to_params(state_dict: dict, cfg: NeRFConfig) -> dict:
    """Reference ``NeRF`` state_dict -> the JAX teacher pytree (numpy
    f32)."""
    sd = strip_module_prefix(state_dict)

    def lin(name):
        return {"w": _to_np(sd[name + ".weight"]).T.astype(np.float32),
                "b": _to_np(sd[name + ".bias"]).astype(np.float32)}

    params: dict = {
        "pts_linears": [lin(f"pts_linears.{i}") for i in range(cfg.D)]}
    if cfg.use_viewdirs:
        params["views_linears"] = [lin("views_linears.0")]
        params["feature_linear"] = lin("feature_linear")
        params["alpha_linear"] = lin("alpha_linear")
        params["rgb_linear"] = lin("rgb_linear")
    else:
        params["output_linear"] = lin("output_linear")
    return params


def keras_nerf_to_params(weights, cfg: NeRFConfig) -> dict:
    """The original TF-NeRF (Keras) weight list -> the teacher pytree
    (reference ``NeRF.load_weights_from_keras``,
    `model/nerf_raybased.py:403-440`: flat [w0, b0, w1, b1, ...] in the
    order pts_linears*D, feature, views, rgb, alpha). Keras stores weights
    [in, out], JAX's layout: no transpose. A list of another length than
    2·D + 8 raises (``r2l_tpu`` indexes it unchecked)."""
    if not cfg.use_viewdirs:
        raise ValueError("Keras NeRF weights require use_viewdirs "
                         "(reference nerf_raybased.py:404)")
    w = [np.asarray(x, np.float32) for x in weights]
    if len(w) != 2 * cfg.D + 8:
        raise ValueError(f"a Keras NeRF of depth {cfg.D} has 2*D + 8 = "
                         f"{2 * cfg.D + 8} weight arrays, got {len(w)}")

    def lin(i):
        return {"w": w[i], "b": w[i + 1].reshape(-1)}

    return {"pts_linears": [lin(2 * i) for i in range(cfg.D)],
            "feature_linear": lin(2 * cfg.D),
            "views_linears": [lin(2 * cfg.D + 2)],
            "rgb_linear": lin(2 * cfg.D + 4),
            "alpha_linear": lin(2 * cfg.D + 6)}


def params_to_torch_nerf(params: dict, cfg: NeRFConfig) -> dict:
    """Inverse of ``torch_nerf_to_params`` (numpy arrays, reference ``NeRF``
    naming `model/nerf_raybased.py:337-375`)."""
    host = _np_tree(params)
    sd = {}
    for i, lin in enumerate(host["pts_linears"]):
        sd[f"pts_linears.{i}.weight"] = lin["w"].T
        sd[f"pts_linears.{i}.bias"] = lin["b"]
    if cfg.use_viewdirs:
        sd["views_linears.0.weight"] = host["views_linears"][0]["w"].T
        sd["views_linears.0.bias"] = host["views_linears"][0]["b"]
        for name in ("feature_linear", "alpha_linear", "rgb_linear"):
            sd[name + ".weight"] = host[name]["w"].T
            sd[name + ".bias"] = host[name]["b"]
    else:
        sd["output_linear.weight"] = host["output_linear"]["w"].T
        sd["output_linear.bias"] = host["output_linear"]["b"]
    return sd


def infer_r2l_config_from_state_dict(state_dict: dict,
                                     **overrides) -> R2LConfig:
    """The architecture of a torch state_dict from its shapes (ResMLP
    nesting or the plain-MLP Sequential)."""
    sd = strip_module_prefix(state_dict)
    input_dim = int(sd["head.0.weight"].shape[1])
    W = int(sd["head.0.weight"].shape[0])
    linear_tail = "tail.weight" in sd
    tail_w = sd["tail.weight" if linear_tail else "tail.0.weight"]
    if _torch_body_is_mlp(sd):
        ids = _mlp_ids(sd)
        outs = [int(sd[f"body.{i}.weight"].shape[0]) for i in ids]
        kw = dict(input_dim=input_dim, netwidth=W, body_arch="mlp",
                  netdepth=len(ids) + 2, output_dim=int(tail_w.shape[0]),
                  linear_tail=linear_tail)
        if any(o != W for o in outs):
            # a non-uniform body: per-layer widths (--layerwise_netwidths)
            kw["layerwise_widths"] = tuple([W] + outs)
    else:
        nb = len({int(k.split(".")[1]) for k in sd if k.startswith("body.")})
        nl = len({int(k.split(".")[3]) for k in sd
                  if k.startswith("body.0.body.") and k.endswith("weight")})
        kw = dict(input_dim=input_dim, netwidth=W, n_block=nb,
                  n_learnable=nl, netdepth=2 + nl * nb,
                  output_dim=int(tail_w.shape[0]), linear_tail=linear_tail)
    kw.update(overrides)
    return R2LConfig(**kw)


def infer_r2l_config_from_params(params: dict, **overrides) -> R2LConfig:
    """The architecture of a JAX-layout param tree from its shapes (a
    stacked ResMLP body, or a plain-MLP body as a list or a checkpoint's
    "0", "1", ... dict). What shapes cannot say (``use_residual``,
    ``linear_tail``, the activations) comes by ``overrides``."""
    head_w = np.asarray(params["head"]["w"])
    tail_w = np.asarray(params["tail"]["w"])
    W = int(head_w.shape[1])
    body = params["body"]
    if isinstance(body, (list, tuple)) or (
            isinstance(body, dict) and "w" not in body):
        lins = (list(body) if isinstance(body, (list, tuple))
                else [body[k] for k in sorted(body, key=int)])
        outs = [int(np.asarray(lin["w"]).shape[1]) for lin in lins]
        kw = dict(input_dim=int(head_w.shape[0]), netwidth=W,
                  body_arch="mlp", netdepth=len(lins) + 2,
                  output_dim=int(tail_w.shape[1]))
        if any(o != W for o in outs):
            kw["layerwise_widths"] = tuple([W] + outs)
    else:
        body_w = np.asarray(body["w"])
        nb, nl = int(body_w.shape[0]), int(body_w.shape[1])
        kw = dict(input_dim=int(head_w.shape[0]), netwidth=W,
                  n_block=nb, n_learnable=nl, netdepth=2 + nb * nl,
                  output_dim=int(tail_w.shape[1]))
    kw.update(overrides)
    return R2LConfig(**kw)


def load_torch_tar(path: str) -> dict:
    """A reference ``.tar`` (``save_ckpt``'s schema: the state_dicts,
    ``optimizer_state_dict``, ``global_step``, ``best_psnr``), loaded on the
    CPU with ``weights_only=True``: tensors and plain containers only."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} pickles more than tensors, most likely the whole "
            "module under the reference's 'network_fn' key (main.py:"
            "1534-1536), which cannot be read without the reference's "
            "classes; re-save it with only its state_dicts "
            "('network_fn_state_dict', 'network_fine_state_dict', "
            f"'global_step', 'best_psnr'). The loader said: {e}") from e


def _is_tar(path: str, ckpt_format: str = "") -> bool:
    return ckpt_format == "torch" or path.endswith(".tar")


def load_r2l(path: str, device: torch.device | str = torch.device("cuda"),
             ckpt_format: str = "", **overrides
             ) -> tuple[R2L, R2LConfig, dict]:
    """(model, cfg, meta) of a student checkpoint, native or a reference
    ``.tar`` (``build_r2l``'s load): the architecture inferred from the
    shapes, ``overrides`` for what shapes cannot say (``compute_dtype``,
    ``use_residual``, activations), the weights loaded into a new ``R2L``
    on ``device`` (the card unless the caller asks for the CPU). ``meta``
    holds ``global_step`` for a ``.tar``."""
    if _is_tar(path, ckpt_format):
        blob = load_torch_tar(path)
        sd = blob.get("network_fn_state_dict", blob)
        cfg = infer_r2l_config_from_state_dict(sd, **overrides)
        params = torch_r2l_to_params(sd, cfg)
        meta = {"global_step": int(blob.get("global_step", 0))}
    else:
        params, meta = load_params(path)
        drop_cached_checkpoint()
        cfg = infer_r2l_config_from_params(params, **overrides)
    model = R2L(cfg, device)
    with torch.no_grad():
        model.load_state_dict(params_from_jax(params, cfg))
    return model, cfg, meta


def load_teacher(path: str, model_c: NeRF, model_f: NeRF | None,
                 ckpt_format: str = "") -> dict:
    """Load a teacher checkpoint into ``model_c`` (and ``model_f``), native
    (``{"coarse", "fine", ...}``) or a reference ``.tar``
    (``build_teacher``'s load); returns the meta (``global_step``)."""
    if _is_tar(path, ckpt_format):
        blob = load_torch_tar(path)
        coarse = torch_nerf_to_params(blob["network_fn_state_dict"],
                                      model_c.cfg)
        fine = None
        if model_f is not None:
            if "network_fine_state_dict" not in blob:
                raise KeyError(
                    f"{path} has no network_fine_state_dict but the "
                    "configuration has a fine network — use the matching "
                    "hierarchical teacher checkpoint or set --N_importance "
                    "0.")
            fine = torch_nerf_to_params(blob["network_fine_state_dict"],
                                        model_f.cfg)
        meta = {"global_step": int(blob.get("global_step", 0))}
    else:
        raw, meta = load_checkpoint(path)
        coarse, fine = raw["coarse"], raw.get("fine") or None
        if model_f is not None and fine is None:
            raise KeyError(f"{path} holds no fine network")
    with torch.no_grad():
        model_c.load_state_dict(nerf_params_from_jax(coarse))
        if model_f is not None:
            model_f.load_state_dict(nerf_params_from_jax(fine))
    return meta


# ---------------------------------------------------------------------------
# Full-state resume (r2l_tpu/app.py)
# ---------------------------------------------------------------------------

def _parts(state) -> list:
    """(key, module, table) of each network a state trains, in the
    optimizer's parameter order; the key names the network in the saved
    tree and under mu/nu, None for a student (its params sit under
    "params", its mu/nu are the params' tree)."""
    if isinstance(state, TeacherState):
        parts = [("coarse", state.model_c)]
        if state.model_f is not None:
            parts.append(("fine", state.model_f))
        return [(k, m, nerf_table(m.cfg.D, m.cfg.use_viewdirs))
                for k, m in parts]
    return [(None, state.params, r2l_table(state.params.cfg))]


def _opt_tree(state) -> tuple:
    """optax's ``adam`` state of ``state``'s optimizer as a tree of tensors:
    ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``,
    zeros and count 0 before the first update (``optax.adam().init``)."""
    opt = state.optimizer
    count, mu, nu = None, {}, {}
    for key, model, table in _parts(state):
        m, v = {}, {}
        for name, p in model.named_parameters():
            st = opt.state.get(p, {})
            if st and count is None:     # every parameter's step is one
                count = int(st["step"])
            m[name] = st["exp_avg"] if st else torch.zeros_like(p)
            v[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
        if key is None:
            mu, nu = to_jax(m, table), to_jax(v, table)
        else:
            mu[key], nu[key] = to_jax(m, table), to_jax(v, table)
    if isinstance(state, TeacherState) and state.model_f is None:
        mu["fine"], nu["fine"] = {}, {}
    return ({"count": np.asarray(count or 0, np.int32), "mu": mu, "nu": nu},
            {"count": np.asarray(state.lr_count, np.int32)})


def save(path: str, state, step: int, best_psnr: float, best_step: int,
         save_pool: bool = False) -> None:
    """The full training state to ``path`` (``r2l_tpu/app.py::_save`` for a
    ``TrainState``: ``{"params", "opt_state"}`` and, with ``save_pool``, the
    hard pool; the teacher's layout ``{"coarse", "fine", "opt_state"}`` for
    a ``TeacherState``), meta ``{global_step, best_psnr, best_psnr_step,
    best_metric}``."""
    tree = {k or "params": to_jax(named(m), table)
            for k, m, table in _parts(state)}
    tree["opt_state"] = _opt_tree(state)
    if isinstance(state, TeacherState):
        tree.setdefault("fine", {})
    elif save_pool:
        tree["pool"] = {"rays": state.pool.rays, "size": state.pool.size,
                        "ptr": state.pool.ptr}
    save_checkpoint(path, tree, meta={
        "global_step": int(step), "best_psnr": float(best_psnr),
        "best_psnr_step": int(best_step), "best_metric": "psnr_v2"})


def native_resume_blob(path: str, resume: bool = True, ckpt_format: str = "",
                       log=print) -> tuple[dict | None, dict]:
    """On a resume from a native checkpoint, its raw blob and meta, so the
    trainer can restore the optimizer, best PSNR and hard pool; (None, {})
    otherwise. A ``.tar`` resume restores params and ``global_step`` only,
    with ``r2l_tpu``'s note."""
    if not (resume and path):
        return None, {}
    if _is_tar(path, ckpt_format):
        log("NOTE: --resume from a torch .tar restores params + "
            "global_step only — the reference's optimizer_state_dict is "
            "a torch-specific pickle (moment layout does not map to "
            "optax). Adam moments and best_psnr start fresh; use native "
            ".msgpack checkpoints for full-state resume.")
        return None, {}
    return load_checkpoint(path)


def _opt_state_dict(state, tree) -> tuple[dict, int]:
    """(the torch optimizer's state_dict, the schedule's count) of an optax
    ``adam`` tree; raises where the tree does not fit the state's
    networks."""
    if not isinstance(tree, dict) or sorted(tree) != ["0", "1"]:
        raise ValueError(f"opt_state holds {sorted(tree)}, not optax adam's "
                         "two states")
    adam, sched = tree["0"], tree["1"]
    if sorted(adam) != ["count", "mu", "nu"] or sorted(sched) != ["count"]:
        raise ValueError(f"opt_state holds {sorted(adam)} and "
                         f"{sorted(sched)}, not adam's (count, mu, nu) and "
                         "the schedule's (count)")
    count = int(np.asarray(adam["count"]))
    opt = state.optimizer
    index = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    per_param = {}
    for key, model, table in _parts(state):
        mu = from_jax(adam["mu"] if key is None else adam["mu"][key], table)
        nu = from_jax(adam["nu"] if key is None else adam["nu"][key], table)
        for name, p in model.named_parameters():
            m, v = np.asarray(mu[name]), np.asarray(nu[name])
            if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
                raise ValueError(f"{name}: moments {m.shape}/{v.shape}, "
                                 f"parameter {tuple(p.shape)}")
            per_param[index[id(p)]] = {
                "step": torch.tensor(float(count),
                                     dtype=torch.get_default_dtype()),
                "exp_avg": torch.tensor(m, dtype=torch.float32),
                "exp_avg_sq": torch.tensor(v, dtype=torch.float32)}
    if len(per_param) != len(index):
        raise ValueError(f"the moments cover {len(per_param)} of the "
                         f"optimizer's {len(index)} parameters")
    return ({"state": per_param,
             "param_groups": opt.state_dict()["param_groups"]},
            int(np.asarray(sched["count"])))


def restore_opt_state(state, blob, log=print, label: str = ""):
    """The optimizer of a ``TrainState``/``TeacherState`` from a raw
    checkpoint blob: Adam's moments and count, and the schedule's count
    (``lr_count``). Without ``opt_state``, or with one that does not fit,
    it warns as ``r2l_tpu`` does and leaves the state fresh."""
    if not (isinstance(blob, dict) and blob.get("opt_state")):
        log(f"WARNING: checkpoint has no {label}optimizer state "
            "— Adam moments and the LR-schedule step start "
            "fresh (pre-round-4 teacher checkpoints)")
        return state
    try:
        sd, lr_count = _opt_state_dict(state, blob["opt_state"])
    except (KeyError, IndexError, TypeError, ValueError) as e:
        log(f"WARNING: {label}optimizer state in the checkpoint "
            f"does not match the current optimizer ({e!r}) — "
            "reinitialized fresh")
        return state
    state.optimizer.load_state_dict(sd)
    log(f"restored {label}optimizer state "
        "(Adam moments + LR-schedule step)")
    return state._replace(lr_count=lr_count)


def restore_pool(state: TrainState, blob, log=print) -> TrainState:
    """The hard-ray pool from a raw checkpoint blob, where it was saved and
    its shape matches the state's (else ``r2l_tpu``'s warning and an empty
    pool). The restored pool is a copy on the pool's device."""
    saved = blob.get("pool") if isinstance(blob, dict) else None
    if not saved:
        return state
    rays = np.asarray(saved["rays"])
    if rays.shape != tuple(state.pool.rays.shape):
        log(f"WARNING: hard-pool shape changed "
            f"({rays.shape} -> {tuple(state.pool.rays.shape)}: "
            "batch size / hard_mul / record_dim differ) — pool "
            "starts empty")
        return state
    dev = state.pool.rays.device

    def i32(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=dev)
    pool = HardPool(rays=torch.tensor(rays, dtype=torch.float32, device=dev),
                    size=i32(saved["size"]), ptr=i32(saved["ptr"]))
    log(f"restored hard-ray pool (size {int(pool.size)})")
    return state._replace(pool=pool)


def resume_distill(state: TrainState, path: str, log=print,
                   ckpt_format: str = "") -> tuple[TrainState, float, int]:
    """``--resume`` of a distillation run into a fresh state (``build_r2l``
    and ``run_distill``'s resume): the params and ``global_step`` from a
    native file or a ``.tar``, then from a native file the optimizer, the
    hard pool and the best PSNR. Returns (state, best_psnr, best_step)."""
    model = state.params
    if _is_tar(path, ckpt_format):
        blob = load_torch_tar(path)
        params = torch_r2l_to_params(blob.get("network_fn_state_dict", blob),
                                     model.cfg)
        with torch.no_grad():
            model.load_state_dict(params_from_jax(params, model.cfg))
        start = int(blob.get("global_step", 0))
    else:
        _, meta = load_params(path, model)
        start = int(meta.get("global_step", 0))
    log(f"Loaded pretrained ckpt {path} (step {start})")
    state = state._replace(step=start)
    best_psnr, best_step = -1.0, -1
    blob, rmeta = native_resume_blob(path, True, ckpt_format, log)
    if blob is not None:
        state = restore_pool(restore_opt_state(state, blob, log), blob, log)
        best_psnr = float(rmeta.get("best_psnr", -1.0))
        best_step = int(rmeta.get("best_psnr_step", -1))
        if best_psnr > 0:
            log(f"restored best_psnr {best_psnr:.4f} @ step {best_step}")
        drop_cached_checkpoint()
    return state, best_psnr, best_step


def resume_teacher(state: TeacherState, path: str, log=print,
                   ckpt_format: str = "") -> tuple[TeacherState, float, int]:
    """``--resume`` of teacher training into a fresh state (``build_teacher``
    and ``run_teacher_train``'s resume). Returns (state, best_psnr,
    best_step)."""
    meta = load_teacher(path, state.model_c, state.model_f, ckpt_format)
    start = int(meta.get("global_step", 0))
    log(f"Loaded teacher ckpt {path} (step {start})")
    state = state._replace(step=start)
    best_psnr, best_step = -1.0, -1
    blob, rmeta = native_resume_blob(path, True, ckpt_format, log)
    if blob is not None:
        state = restore_opt_state(state, blob, log, label="teacher ")
        best_psnr = float(rmeta.get("best_psnr", -1.0))
        best_step = int(rmeta.get("best_psnr_step", -1))
        if best_psnr > 0:
            log(f"restored teacher best_psnr {best_psnr:.4f}")
        drop_cached_checkpoint()
    return state, best_psnr, best_step
