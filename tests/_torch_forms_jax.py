"""JAX's side of the number-changing forms' parity tests
(tests/test_torch_bf16_forms.py, tests/test_torch_teacher_forms.py), run in
a subprocess of its own:

    XLA_FLAGS=--xla_allow_excess_precision=false \\
        python tests/_torch_forms_jax.py {k2|teacher} OUT.npz

XLA's CPU backend allows excess precision by default: it drops the bf16
roundings of values that feed an f32 consumer, so the Pallas kernels'
bf16 forms (K2's ``bf16_resid``, K7's ``bf16_requant``) compute otherwise
on the CPU than they are written. With the flag off, XLA rounds every bf16
value where the code says bf16. The flag is read when XLA starts, and the
test workers share their processes, so JAX's side runs here, in a process
that starts with it (``run``).

Each case's inputs come from a seed (``int8_case``, ``teacher_inputs``); the
script writes JAX's packing of each case (``put_tree``) and the interpret-
mode outputs of the kernel in each form to OUT.npz, which the tests read
back (``get_tree``) to run the port's plain versions on the same packing.
"""
from __future__ import annotations

import os
import subprocess
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NO_EXCESS = "--xla_allow_excess_precision=false"

# K2: (label, W, D) of the student cases (dim_pts 6, L 4, a 12x12 frame's
# 144 rays): W64 and a width that the port sends to K2's wide form.
K2_WIDTHS = (("W64/D8", 64, 8), ("W384/D6", 384, 6))
K2_DIM, K2_L, K2_SIDE = 6, 4, 12
# each form by (fold_requant, nobf16_inner), on the packing of its fold
K2_FORMS = (("deployed", True, True), ("fold", True, False),
            ("unfolded", False, False))
K2_CFGS = tuple((res, lin) for res in (True, False) for lin in (True, False))

# The teacher: (label, W, D, skips, viewdirs) at L 10 / 4, 24 rays x 7
# samples; W384 is a width that the port sends to the wide form.
T_LP, T_LV = 10, 4
T_SEED = 3   # the weights: jax.random.key(T_SEED), as _torch_parity's
#              nerf_models(jcfg, T_SEED)
T_CASES = (("W64", 64, 4, (2,), True), ("W64_noview", 64, 4, (2,), False),
           ("W384", 384, 3, (1,), True),
           ("W384_noview", 384, 3, (1,), False))
# (label, mode, pe_ladder, bf16_requant): the teacher's forms, each case;
# int8 folded ("int8f") and unfolded
T_FORMS = (("pe_sin", "f32", False, False), ("pe_sin", "bf16", False, False),
           ("pe_sin", "int8f", False, False),
           ("bf16_requant", "int8f", True, True),
           ("bf16_requant", "int8", True, True),
           ("pe_sin+bf16_requant", "int8", False, True))


def put_tree(out: dict, prefix: str, tree) -> None:
    """A NamedTuple of arrays (or of tuples of arrays) into ``out``."""
    for name, v in tree._asdict().items():
        if isinstance(v, (tuple, list)):
            out[f"{prefix}/{name}/n"] = np.asarray(len(v))
            for i, a in enumerate(v):
                out[f"{prefix}/{name}/{i}"] = np.asarray(a)
        else:
            out[f"{prefix}/{name}"] = np.asarray(v)


def get_tree(npz, prefix: str) -> types.SimpleNamespace:
    """``put_tree``'s tree back, as attributes."""
    fields = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        if len(parts) == 1:
            fields[parts[0]] = npz[key]
        elif parts[1] == "n":
            n = int(npz[key])
            fields[parts[0]] = tuple(npz[f"{prefix}/{parts[0]}/{i}"]
                                     for i in range(n))
    return types.SimpleNamespace(**fields)


def k2_key(label, res, lin):
    return f"{label}/res{int(res)}/lin{int(lin)}"


def teacher_inputs(seed: int = 2):
    """(rays_o, rays_d, z [24, 7]) from a seed, and the int8 calibration
    set of their points and view directions."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(24, 3)) * 0.1).astype(np.float32)
    d = rng.normal(size=(24, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (24, 7)), -1).astype(np.float32)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    vds = np.broadcast_to(vd[:, None, :], z.shape + (3,)).reshape(-1, 3)
    return o, d, z, pts.astype(np.float32), vds.astype(np.float32)


def teacher_jcfg(W, D, skips, viewdirs, dtype=None):
    import jax.numpy as jnp
    from r2l_tpu.encoding import nerf_embed_dim
    from r2l_tpu.models.nerf import NeRFConfig
    return NeRFConfig(D=D, W=W, skips=skips, use_viewdirs=viewdirs,
                      input_ch=nerf_embed_dim(3, T_LP),
                      input_ch_views=(nerf_embed_dim(3, T_LV)
                                      if viewdirs else 0),
                      output_ch=5 if viewdirs else 4,
                      compute_dtype=dtype or jnp.float32)


def _k2(out: dict) -> None:
    import jax.numpy as jnp
    from _torch_parity import int8_case
    from r2l_tpu.kernels import r2l_pallas as JP
    for label, W, D in K2_WIDTHS:
        for res, lin in K2_CFGS:
            jcfg, params, _, _, calib, pts = int8_case(
                K2_DIM, K2_L, W, D, K2_SIDE, use_residual=res,
                linear_tail=lin)
            key = k2_key(label, res, lin)
            jfps = {}
            for fold in (True, False):
                jfps[fold] = JP.calibrate_r2l_int8_pe(
                    params, jcfg, K2_DIM, K2_L, calib_pts=jnp.asarray(calib),
                    fold_requant=fold)
                put_tree(out, f"{key}/fold{int(fold)}", jfps[fold])
            for form, fold, nob in K2_FORMS:
                for br in (False, True):
                    out[f"{key}/{form}/br{int(br)}"] = np.asarray(
                        JP.fused_r2l_apply_int8_pe(
                            jfps[fold], jcfg, jnp.asarray(pts), K2_DIM,
                            K2_L, tile=48, interpret=True,
                            fold_requant=fold, nobf16_inner=nob,
                            bf16_resid=br))


def _teacher(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from r2l_tpu.kernels.nerf_render_pallas import (fused_nerf_render_t,
                                                    prepare_fused_nerf_t)
    from r2l_tpu.models.nerf import init_nerf
    o, d, z, pts, vds = teacher_inputs()
    for label, W, D, skips, vd in T_CASES:
        jcfg = teacher_jcfg(W, D, skips, vd)
        params = init_nerf(jax.random.key(T_SEED), jcfg)
        for mode in ("f32", "bf16", "int8", "int8f"):
            calib = (jnp.asarray(pts), jnp.asarray(vds) if vd else None)
            if mode.startswith("int8"):
                fpj = prepare_fused_nerf_t(params, jcfg, T_LP, T_LV,
                                           calib=calib,
                                           fold_requant=mode == "int8f")
                put_tree(out, f"{label}/{mode}", fpj)
            else:
                fpj = prepare_fused_nerf_t(
                    params, jcfg, T_LP, T_LV,
                    weight_dtype=jnp.float32 if mode == "f32"
                    else jnp.bfloat16)
            for form, fmode, ladder, brq in T_FORMS:
                if fmode != mode:
                    continue
                res = fused_nerf_render_t(
                    fpj, jcfg, jnp.asarray(o), jnp.asarray(d),
                    jnp.asarray(z), L_pts=T_LP, L_views=T_LV,
                    white_bkgd=True, tile=8, int8=mode.startswith("int8"),
                    fold_requant=mode == "int8f", interpret=True,
                    pe_ladder=ladder, bf16_requant=brq)
                for what, a in zip(("rgb", "acc", "depth", "weights"), res):
                    out[f"{label}/{mode}/{form}/{what}"] = np.asarray(a)


def run(which: str, path: str) -> types.SimpleNamespace:
    """Run this script for ``which`` ("k2" or "teacher") in a subprocess on
    the CPU with excess precision off; returns OUT.npz's contents."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + NO_EXCESS).strip()
    proc = subprocess.run([sys.executable, __file__, which, path], env=env,
                          cwd=HERE, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{which} failed:\n{proc.stdout}\n{proc.stderr}")
    return np.load(path)


def main(which: str, path: str) -> None:
    if NO_EXCESS not in os.environ.get("XLA_FLAGS", ""):
        raise SystemExit(f"run with XLA_FLAGS={NO_EXCESS}")
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")
    out: dict = {}
    {"k2": _k2, "teacher": _teacher}[which](out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
