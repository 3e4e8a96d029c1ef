"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs the ``r2l_tpu``
function on JAX CPU and the ``r2l_tpu_torch`` function on torch CPU, and
compares the two with a stated tolerance. Torch is capped at two threads:
tier-1 runs six test workers on eight cores.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models import init_r2l as jax_init_r2l
from r2l_tpu.models.nerf import NeRFConfig as JaxNeRFConfig
from r2l_tpu.models.nerf import init_nerf as jax_init_nerf
from r2l_tpu_torch.hardmine import HardDraws
from r2l_tpu_torch.models import (NeRF, NeRFConfig, R2L, R2LConfig,
                                  nerf_params_from_jax, params_from_jax)
from r2l_tpu_torch.render import ChunkDraws
from r2l_tpu_torch.train import StepDraws

torch.set_num_threads(2)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def torch_cfg(jcfg: JaxR2LConfig) -> R2LConfig:
    """The port's config for a JAX config (``precision`` has no
    counterpart; ``compute_dtype`` becomes a torch dtype)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(R2LConfig)}
    fields["compute_dtype"] = _DTYPES[jcfg.compute_dtype]
    return R2LConfig(**fields)


def np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def models(jcfg: JaxR2LConfig, seed: int = 0):
    """(JAX params, port cfg, port model) with the same weights."""
    params = jax_init_r2l(jax.random.key(seed), jcfg)
    cfg = torch_cfg(jcfg)
    model = R2L(cfg, device="cpu")
    model.load_state_dict(params_from_jax(np_tree(params), cfg))
    return params, cfg, model


def torch_nerf_cfg(jcfg: JaxNeRFConfig) -> NeRFConfig:
    """The port's teacher config for a JAX one (``precision`` has no
    counterpart; ``compute_dtype`` becomes a torch dtype)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(NeRFConfig)}
    fields["compute_dtype"] = _DTYPES[jcfg.compute_dtype]
    return NeRFConfig(**fields)


def nerf_models(jcfg: JaxNeRFConfig, seed: int = 0):
    """(JAX teacher params, port cfg, port ``NeRF``) with the same
    weights."""
    params = jax_init_nerf(jax.random.key(seed), jcfg)
    cfg = torch_nerf_cfg(jcfg)
    model = NeRF(cfg, device="cpu")
    model.load_state_dict(nerf_params_from_jax(np_tree(params)))
    return params, cfg, model


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def kernel_layout(name: str, jax_field, like: torch.Tensor) -> np.ndarray:
    """A JAX kernel-layout field in the port's kernel layout: weights
    (``*_w``, ``*_q``) transposed to [out, in], 1-d biases and scales, and
    the JAX 128-lane padding cut to the port's shape (the port pads the
    head's input to a multiple of 128 as well, with the same zeros)."""
    a = np.asarray(jax_field)
    if name.endswith(("_w", "_q")):
        a = np.swapaxes(a, -1, -2)
    if a.ndim == 2 and a.shape[0] == 1 and like.ndim == 1:
        a = a[0]
    return a[tuple(slice(0, s) for s in like.shape)]


def jax_ray_draws(kk, vcfg, n, fused=False):
    """The draws JAX's render_rays_nerf makes from a key for n rays: the key
    split into (strat, noise, pdf, noise2) on the plain path (render.py:131)
    and (strat, pdf) on the fused one (render.py:291); the sigma noise is
    drawn where ``raw_noise_std > 0`` (volume.py:50)."""
    n_c, n_f = vcfg.n_coarse, vcfg.n_fine
    noisy = vcfg.raw_noise_std > 0 and not fused
    k_noise = k_noise2 = None
    if fused:
        k_strat, k_pdf = jax.random.split(kk)
    else:
        k_strat, k_noise, k_pdf, k_noise2 = jax.random.split(kk, 4)

    def draw(f, k, m, use=True):
        return t(f(k, (n, m), dtype=jnp.float32)) if use else None

    return ChunkDraws(
        u_strat=draw(jax.random.uniform, k_strat, n_c),
        noise=draw(jax.random.normal, k_noise, n_c, noisy),
        u_pdf=draw(jax.random.uniform, k_pdf, n_f, n_f > 0),
        noise2=draw(jax.random.normal, k_noise2, n_c + n_f,
                    noisy and n_f > 0))


def jax_chunk_draws(key, vcfg, n_rays, fused=False):
    """JAX's per-chunk draws: the keys render_frame_nerf(_fused) splits,
    each chunk's as ``jax_ray_draws``."""
    chunk = min(vcfg.ray_chunk, n_rays)
    n_chunks = -(-n_rays // chunk)
    return [jax_ray_draws(kk, vcfg, chunk, fused)
            for kk in jax.random.split(key, n_chunks)]


def jax_step_draws(key, dcfg, n_sample):
    """The draws JAX's _distill_core makes from a step's key: the hard-pool
    offsets and shuffle (hardmine.sample_hard, stratified), then the depth
    jitter."""
    k_hard, k_perturb = jax.random.split(key)
    k_off, k_shuf = jax.random.split(k_hard)
    hard = HardDraws(
        t(jax.random.uniform(k_off, (dcfg.n_hard_out,))),
        torch.from_numpy(np.asarray(jax.random.permutation(
            k_shuf, dcfg.n_hard_out), np.int64)))
    z_u = t(jax.random.uniform(k_perturb, (dcfg.batch_size, n_sample)))
    return StepDraws(hard, z_u)


def load_exp_probe(name: str):
    """``exp/<name>.py`` as a module. Importing a probe points JAX's
    persistent compilation cache at a fixed directory
    (``exp/probe_mxu.py:32-33``, ``exp/probe_shapes.py:18-19``); both
    settings are restored right after, so no later test writes a cache."""
    prev = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "exp", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"exp_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          prev[1])
    return mod


def int8_params_from_jax(jfp, like):
    """JAX's int8 packing (``FusedParamsInt8PE``) in the port's kernel
    layout, field by field (``kernel_layout``), shaped as the port's packing
    ``like``: so both packages run the same int8 codes and scales."""
    return type(like)(*(
        torch.from_numpy(np.array(kernel_layout(
            name, getattr(jfp, name), getattr(like, name)), order="C"))
        for name in like._fields))


def nerf_int8_params_from_jax(fpj, jcfg, like, Lp: int, Lv: int):
    """JAX's transposed, 8/128-padded, row-remapped int8 teacher parameters
    (``prepare_fused_nerf_t(..., calib=)``, encodings at ``Lp``/``Lv``) in
    the port's layout (``FusedNeRFParams``, the shapes of ``like``)."""
    from r2l_tpu.kernels.nerf_render_pallas import _pe_row_map
    from r2l_tpu_torch.kernels import nerf_render as NR
    W, D = jcfg.W, jcfg.D
    k_pts = fpj.pts_inv[0].shape[0]
    rm_p, rm_v = _pe_row_map(Lp), _pe_row_map(Lv)
    kp, kv, ks = NR.layout(jcfg, Lp, Lv)

    def a(x):
        return np.asarray(x)

    ws, invs = [], [np.ones(W, np.float32)]
    for i in range(D):
        w = a(fpj.pts_w[i])
        if i == 0 or (i - 1) in jcfg.skips:
            pe = np.zeros((W, kp), w.dtype)
            pe[:, :len(rm_p)] = w[:, rm_p]
            w = np.concatenate([pe, w[:, k_pts:]], 1)
        ws.append(w.reshape(-1))
        if i > 0:
            inv = a(fpj.pts_inv[i])[:, 0]
            invs.append(inv[k_pts:] if (i - 1) in jcfg.skips else inv)
    pe_inv = np.ones(kp, np.float32)
    pe_inv[:len(rm_p)] = a(fpj.pts_inv[0])[rm_p, 0]
    f = dict(pts_w=np.concatenate(ws),
             pts_m=np.stack([a(m)[:, 0] for m in fpj.pts_m]),
             pts_b=np.stack([a(b)[:, 0] for b in fpj.pts_b]),
             pe_inv=pe_inv, pts_inv=np.stack(invs), h_inv=a(fpj.h_inv)[:, 0])
    if jcfg.use_viewdirs:
        vw = a(fpj.views_w)[:W // 2]
        views_w = np.zeros((W // 2, kv), vw.dtype)
        views_w[:, :W] = vw[:, :W]
        views_w[:, W:W + len(rm_v)] = vw[:, W + rm_v]
        hv = a(fpj.hv_inv)[:, 0]
        hv_inv = np.ones(kv, np.float32)
        hv_inv[:W] = hv[:W]
        hv_inv[W:W + len(rm_v)] = hv[W + rm_v]
        f.update(alpha_w=a(fpj.alpha_w)[0], alpha_m=a(fpj.alpha_m)[:1, 0],
                 alpha_b=a(fpj.alpha_b)[:1, 0], feat_w=a(fpj.feat_w),
                 feat_m=a(fpj.feat_m)[:, 0], feat_b=a(fpj.feat_b)[:, 0],
                 views_w=views_w, views_m=a(fpj.views_m)[:W // 2, 0],
                 views_b=a(fpj.views_b)[:W // 2, 0], hv_inv=hv_inv,
                 rgb_w=a(fpj.rgb_w)[:3, :W // 2],
                 rgb_m=a(fpj.rgb_m)[:3, 0], rgb_b=a(fpj.rgb_b)[:3, 0],
                 hr_inv=a(fpj.hr_inv)[:W // 2, 0])
    else:
        f.update(out_w=a(fpj.out_w)[:4], out_m=a(fpj.out_m)[:4, 0],
                 out_b=a(fpj.out_b)[:4, 0])
    out = like._asdict()
    for k, v in f.items():
        assert v.shape == tuple(out[k].shape), (k, v.shape, out[k].shape)
        out[k] = torch.from_numpy(np.array(v))
    return NR.FusedNeRFParams(**out)


def int8_case(dim_pts, L, W, D, side, seed=0, n_calib_poses=3, **cfg_kw):
    """A small R2L case for the int8 chain's tests: (JAX cfg, JAX params,
    port cfg, port model, calibration points, one pose's sample points), the
    points as numpy f32 (``sample_test`` of JAX's sampler); ``cfg_kw`` go
    to the config."""
    from r2l_tpu.rays import pose_spherical
    from r2l_tpu.sampler import PointSampler
    jcfg = JaxR2LConfig(input_dim=dim_pts * (2 * L + 1), netdepth=D,
                        netwidth=W, **cfg_kw)
    params, cfg, model = models(jcfg, seed=seed)
    sampler = PointSampler(H=side, W=side, focal=1.2 * side,
                           n_sample=dim_pts // 3, near=2.0, far=6.0)
    calib = np.concatenate([
        np.asarray(sampler.sample_test(jnp.asarray(
            pose_spherical(th, -30.0, 4.0)[:3, :4])))
        for th in np.linspace(0, 360, n_calib_poses, endpoint=False)])
    pts = np.asarray(sampler.sample_test(jnp.asarray(
        pose_spherical(75.0, -40.0, 4.0)[:3, :4])))
    return jcfg, params, cfg, model, calib, pts


def _exp_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "exp", f"{name}.py")


def _literal(node):
    """A node's value where it is made of constants: literals, tuples,
    lists, dicts, ``dict(k=v)`` calls, arithmetic of constants; a name
    reads as ``"<name>"``."""
    import ast
    if isinstance(node, ast.Name):
        return f"<{node.id}>"
    if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict":
        return {k.arg: _literal(k.value) for k in node.keywords}
    if isinstance(node, ast.Tuple):
        return tuple(_literal(e) for e in node.elts)
    if isinstance(node, ast.List):
        return [_literal(e) for e in node.elts]
    if isinstance(node, ast.Dict):
        return {_literal(k): _literal(v) for k, v in zip(node.keys,
                                                          node.values)}
    if any(isinstance(n, ast.Name) for n in ast.walk(node)):
        raise ValueError(ast.dump(node))
    return eval(compile(ast.Expression(node), "<exp>", "eval"), {})


def exp_assigned(name: str) -> dict:
    """``{name: value}`` of every assignment of a constant expression in
    ``exp/<name>.py``, at any scope (``a, b = 1, 2`` too), and of every
    ``for name in <constants>`` (the tuple; ``for a, b in`` under
    ``"a,b"``), the first one of each name kept; read from the source,
    so a driver that runs at import does not run."""
    import ast
    out = {}
    with open(_exp_path(name)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.For)):
            try:
                value = _literal(node.value if isinstance(node, ast.Assign)
                                 else node.iter)
            except (ValueError, SyntaxError, NameError, TypeError):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    out.setdefault(tgt.id, value)
                elif isinstance(node, ast.For) and isinstance(tgt,
                                                              ast.Tuple):
                    out.setdefault(",".join(getattr(e, "id", "_")
                                            for e in tgt.elts), value)
                elif (isinstance(tgt, ast.Tuple) and isinstance(node,
                                                                ast.Assign)
                      and isinstance(value, tuple)
                      and len(value) == len(tgt.elts)):
                    for e, v in zip(tgt.elts, value):
                        if isinstance(e, ast.Name):
                            out.setdefault(e.id, v)
    return out


def exp_calls(name: str, callee: str) -> list[dict]:
    """The constant keyword arguments of each call of ``callee`` in
    ``exp/<name>.py``, in source order (names read as ``"<name>"``; the
    positional ones under ``"_args"``, None where not constant)."""
    import ast
    with open(_exp_path(name)) as f:
        tree = ast.parse(f.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and (
        getattr(n.func, "id", None) == callee
        or getattr(n.func, "attr", None) == callee)]
    out = []
    for n in sorted(calls, key=lambda c: (c.lineno, c.col_offset)):
        kw = {"_args": []}
        for a in n.args:
            try:
                kw["_args"].append(_literal(a))
            except (ValueError, SyntaxError, NameError, TypeError):
                kw["_args"].append(None)
        for k in n.keywords:
            try:
                kw[k.arg] = _literal(k.value)
            except (ValueError, SyntaxError, NameError, TypeError):
                kw[k.arg] = None
        out.append(kw)
    return out
