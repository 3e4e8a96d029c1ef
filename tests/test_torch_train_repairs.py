"""The port's repairs before its training slice: its entry points default to
the card, and its int8 calibration drifts from exact arithmetic no more than
the JAX package's own (the canary, bit for bit, is in
tests/test_torch_kernel_int8.py)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import kernel_layout, models, n, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.rays import pose_spherical
from r2l_tpu.sampler import PointSampler
from r2l_tpu_torch import hardmine, train
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.models import R2L, R2LConfig, init_r2l

CUDA = torch.device("cuda")


@pytest.mark.parametrize("fn", [R2L, init_r2l, train.init_train_state,
                                train.make_distill_step,
                                train.fused_int8_calib_points,
                                hardmine.init_pool])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == CUDA


def test_no_quiet_move_to_the_cpu():
    """Without a card, an entry point called without device='cpu' raises
    instead of building on the CPU."""
    if torch.cuda.is_available():
        assert next(R2L(R2LConfig(netdepth=4, netwidth=8)).parameters()
                    ).device.type == "cuda"
        return
    cfg = R2LConfig(input_dim=6 * 9, netdepth=4, netwidth=8)
    for make in (lambda: R2L(cfg),
                 lambda: init_r2l(cfg, torch.Generator().manual_seed(0)),
                 lambda: hardmine.init_pool(4, 9)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def _calibrate_f64(params, cfg, dim_pts, L, calib, fold_requant,
                   margin=1.1):
    """``calibrate_r2l_int8_pe``'s scales (r2l_pallas.py:389-470) in float64
    numpy, from the same f32 weights and points: the exact-arithmetic
    reference both f32 implementations round away from."""
    nb, nl, W = cfg.num_blocks, cfg.n_learnable, cfg.netwidth
    rs = float(cfg.res_scale)
    p = np.asarray(calib, np.float64)
    x = np.concatenate([np.sin(p * 2.0 ** j) for j in range(L)]
                       + [np.cos(p * 2.0 ** j) for j in range(L)] + [p], 1)
    perm = JP._pe_row_permutation(dim_pts, L)
    hw = np.asarray(params["head"]["w"], np.float64)[perm]
    hb = np.asarray(params["head"]["b"], np.float64)
    bw = np.asarray(params["body"]["w"], np.float64).reshape(nb * nl, W, W)
    bb = np.asarray(params["body"]["b"], np.float64).reshape(nb * nl, W)
    tw = np.asarray(params["tail"]["w"], np.float64)

    def act(a):
        return np.maximum(np.abs(a).max(0), 1e-6) * (margin / 127.0)

    def col_m(w, s):
        return np.maximum(np.abs(w * s[:, None]).max(0), 1e-12) / 127.0

    s_x = act(x)
    h = h0 = np.maximum(x @ hw + hb, 0.0)
    s_body = []
    for i in range(nb):
        h_in = h
        for j in range(nl):
            s_body.append(act(h))
            h = h @ bw[i * nl + j] + bb[i * nl + j]
            if j < nl - 1:
                h = np.maximum(h, 0.0)
        h = h * rs + h_in
    if cfg.use_residual:
        h = h + h0
    s_tail = act(h)
    ms, bs = [], []
    for idx in range(nb * nl):
        m, b = col_m(bw[idx], s_body[idx]), bb[idx]
        if idx % nl == nl - 1:
            m, b = m * rs, b * rs
        elif fold_requant:
            m, b = m / s_body[idx + 1], b / s_body[idx + 1]
        ms.append(m)
        bs.append(b)
    return {"head_m": col_m(hw, s_x), "head_inv": 1.0 / s_x,
            "body_m": np.stack(ms), "body_b": np.stack(bs),
            "body_inv": 1.0 / np.stack(s_body),
            "tail_m": col_m(tw, s_tail), "tail_inv": 1.0 / s_tail}


@pytest.mark.parametrize("fold_requant", [False, True])
def test_calibration_drift_is_f32_rounding(fold_requant):
    """Canonical D88/W256 on 16 rays: per field, the port's f32 scales sit
    no further from the float64 calibration than about twice the JAX
    package's own f32 scales do (max and RMS relative distance; a floor of
    two f32 ulps for fields both compute almost exactly). So the drift
    between the two packages at depth 88 is f32 rounding of the same size
    as the reference's, not a different algorithm."""
    jcfg = JaxR2LConfig(input_dim=48 * 21, netdepth=88, netwidth=256)
    params, cfg, model = models(jcfg, seed=1)
    sampler = PointSampler(H=4, W=4, focal=4.8, n_sample=16, near=2.0,
                           far=6.0)
    calib = np.asarray(sampler.sample_test(jnp.asarray(
        pose_spherical(0.0, -30.0, 4.0)[:3, :4])))
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, 48, 10,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=fold_requant)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 48, 10, t(calib),
                                 fold_requant=fold_requant)
    exact = _calibrate_f64(params, cfg, 48, 10, calib, fold_requant)
    floor = 2.4e-7
    for name, want in exact.items():
        got = getattr(fp, name)
        dist = {}
        for who, a in (("port", n(got)),
                       ("jax", kernel_layout(name, getattr(jfp, name), got))):
            rel = np.abs(np.asarray(a, np.float64) - want) / np.abs(want)
            dist[who] = (rel.max(), np.sqrt(np.mean(rel ** 2)))
        print(f"fold_requant={fold_requant} {name}: max/RMS relative "
              f"distance from float64, port {dist['port'][0]:.3e} / "
              f"{dist['port'][1]:.3e}, JAX {dist['jax'][0]:.3e} / "
              f"{dist['jax'][1]:.3e}")
        for k in range(2):
            assert dist["port"][k] <= 2.0 * dist["jax"][k] + floor, (
                name, dist)
