"""The port's fused gates against the shapes its kernels take, and against
the JAX package's paths.

One predicate per kernel family (``r2l_fused.fused_frame_supported``,
``r2l_train.fused_train_supported``, ``nerf_render.fused_teacher_supported``)
is held to the launch switches of ``csrc/``, and the frame kernels' wide
form (``csrc/r2l_wide.cu``) to its limits. A student or teacher narrower
than the kernels' widths is packed at the next of them with zero channels,
and computes what the unpadded network does; a wider student or teacher
runs on its kernels' wide form, a deeper teacher on K6/K7 themselves. The
three gates above them (``evaluate._prepare_r2l``,
``evaluate.make_nerf_frame_fn`` with ``datagen``, ``train.fused_vjp_gate``)
take the JAX package's path: its kind and frame where its kernels and the
port's agree, the plain path with a warning where neither takes the shape,
and on the card an error for a shape the port's kernels do not take (a
teacher with a skip at its last layer, which the JAX package's model
cannot build). The wrappers refuse such a shape on a device tensor before
any launch (a meta tensor stands in for the card's here)."""
import ast
import dataclasses
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.evaluate as JE
import r2l_tpu.render as jrender
from _torch_parity import n, nerf_models
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models.nerf import NeRFConfig as JNeRFConfig
from r2l_tpu.sampler import PointSampler as JaxPointSampler
from r2l_tpu_torch import datagen, render
from r2l_tpu_torch import evaluate as TE
from r2l_tpu_torch import train as TR
from r2l_tpu_torch.kernels import nerf_render as NR
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.models import NeRFConfig, R2LConfig
from r2l_tpu_torch.sampler import PointSampler
from test_torch_frame import H, POSES, SAMPLER, TOL, W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "r2l_tpu_torch", "kernels", "csrc")
# A refused student renders through the plain module on both sides. On the
# same sample points, the plain modules' bounds (tests/test_torch_frame.py:
# f32 1e-5, bf16 1e-3; measured 1.8e-7 in f32 at W256/W512). The frames'
# points differ by one f32 ulp where XLA contracts o + d*z into an FMA
# (4.8e-7 here; tests/test_torch_givenrays.py, TOL_PTS), which the L=10
# encoding multiplies by 2^9: measured 1.26e-5 on a W256 f32 frame, so the
# f32 frames are held to 5e-5 and the network to 1e-5 on JAX's points.
TOL_PLAIN = {"f32": TOL[("jnp", "f32")][0], "bf16": TOL[("jnp", "bf16")][0]}
TOL_FRAME = {"f32": 5e-5, "bf16": TOL_PLAIN["bf16"]}
# The kernels' frames against JAX's kernels' frames (tests/test_torch_frame.py:
# PE-fused bf16 and int8, max and RMS); the f32 PE-fused frame sums in f32 as
# the plain module does, so it takes the f32 frame bound.
TOL_KERNEL = {("pe", "bf16"): (TOL[("pe", "bf16")][0], None),
              ("pe", "f32"): (TOL_FRAME["f32"], None),
              ("int8", "bf16"): TOL[("int8", "bf16")],
              ("int8", "f32"): TOL[("int8", "bf16")]}
# The bf16 plain modules at the README's depth (86 body layers): rounding
# flips that the layers carry on, measured 6.9e-3 on a W512 frame and
# 4.2e-3 max, 9.0e-4 RMS on the network alone on JAX's points (1.1e-4 at
# depth 6): the PE-fused bf16 chain's bound, with K2's RMS.
TOL_DEEP_BF16 = (TOL[("pe", "bf16")][0], TOL[("int8", "bf16")][1])
# The plain teacher frame against JAX's: f32, sums in another order.
TOL_TEACHER = 1e-5
K1_WARNING = "WARNING: the fused kernel (K1) takes"
K2_WARNING = "WARNING: the int8 fused kernel (K2) takes"


# ---------------------------------------------------------------------------
# The predicates against the kernels' launch switches
# ---------------------------------------------------------------------------

def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _switch_widths(src: str, after: str) -> list[tuple[int, ...]]:
    """The ``case N:`` labels of every ``switch (W)`` in ``src`` after the
    first line that holds ``after`` (the launch function)."""
    body = src[src.index(after):]
    return [tuple(int(c) for c in re.findall(r"case (\d+):", block))
            for block in re.findall(r"switch \(W\) \{(.*?)\n\s*\}", body,
                                    re.S)]


@pytest.mark.parametrize("name,after,switches,want", [
    ("r2l_hopper.cuh", "cudaError_t launch(const Args& a", 2,
     F.R2L_KERNEL_WIDTHS),
    ("r2l_int8_hopper.cuh", "cudaError_t launch_width(", 1,
     F.R2L_KERNEL_WIDTHS),
    ("r2l_bwd_group.cu", "cudaError_t launch_t(", 1, F.R2L_KERNEL_WIDTHS),
    ("nerf_render.cu", 'extern "C" int nerf_render_launch(', 2,
     NR.NERF_KERNEL_WIDTHS),
    ("nerf_render_int8.cu", 'extern "C" int nerf_render_int8_launch(', 1,
     NR.NERF_KERNEL_WIDTHS),
])
def test_predicate_widths_are_the_launch_switches(name, after, switches,
                                                  want):
    got = _switch_widths(_source(name), after)
    assert got == [tuple(want)] * switches
    # above them the frame kernels' wide form: any multiple of its
    # channels (every pass of the skeleton takes any multiple of 128
    # outputs), one layer a block or more, up to 8 outputs
    wide = _source("r2l_wide.cuh")
    assert re.findall(r"constexpr int kWideChannels = (\d+);", wide) == [
        str(F.WIDE_CHANNELS)]
    assert re.findall(r"p\.N % (\d+) != 0", _source("wide_hopper.cuh")) == [
        str(F.WIDE_CHANNELS)]
    entry = _source("r2l_wide.cu")
    for limit in ("W % kWideChannels != 0", "nl < 1", "out_dim > kMaxOut"):
        assert limit in entry, limit


@pytest.mark.parametrize("name", ["nerf_render.cu", "nerf_render_int8.cu"])
def test_teacher_depth_limit_is_the_kernels(name):
    """No depth limit: the entry point takes D >= 1 with at most D - 1
    concatenated layers, and the kernels read the skip set from the staged
    image, one flag a layer, not from a bit mask."""
    src = _source(name)
    assert "D < 1 || n_skips < 0 || n_skips > D - 1" in src
    assert not re.search(r"D > \d+", src) and "skips >>" not in src
    hopper = _source("nerf_hopper.cuh")
    assert "skips >>" not in hopper
    assert "__ldg(a.skip + l - 1)" in hopper


@pytest.mark.parametrize("name", ["r2l_int8_hopper.cu",
                                  "r2l_train_fwd_int8.cu"])
def test_int8_head_slice_limit_is_the_kernels(name):
    assert "2 * L + 1 > 2 * W" in _source(name)


def test_chain_layer_limit_is_the_kernels():
    assert "a.nl < 1" in _source("r2l_hopper.cuh")
    assert re.search(r"dp <= 0 \|\| L <= 0", _source("r2l_pe_fused.cu"))


def _r2l(**kw) -> R2LConfig:
    return R2LConfig(**{"input_dim": 48 * 21, "netdepth": 8, **kw})


@pytest.mark.parametrize("kw,int8,L,frame,train", [
    (dict(netwidth=256), False, 10, True, True),
    (dict(netwidth=128), True, 10, True, True),
    (dict(netwidth=64), True, 10, True, True),
    (dict(netwidth=96), True, 10, True, False),
    (dict(netwidth=192), False, 10, True, False),
    (dict(netwidth=32), False, 10, True, False),
    (dict(netwidth=64, n_learnable=1), False, 10, True, False),
    (dict(netwidth=128, n_learnable=3), False, 10, True, False),
    (dict(netwidth=256, n_learnable=0), False, 10, False, False),
    (dict(netwidth=512), False, 10, True, True),
    (dict(netwidth=384), True, 10, True, True),
    (dict(netwidth=256, act="lrelu"), False, 10, False, False),
    (dict(netwidth=256, inact="lrelu"), False, 10, False, False),
    (dict(netwidth=256, outact="relu"), False, 10, False, False),
    (dict(netwidth=256, body_arch="mlp"), False, 10, False, False),
    (dict(netwidth=64), True, 64, True, False),
    (dict(netwidth=48), True, 63, True, False),
    (dict(netwidth=64), False, 64, True, True),
    (dict(netwidth=64), False, 0, False, False),
])
def test_student_predicates(kw, int8, L, frame, train):
    cfg = _r2l(**kw)
    assert F.fused_frame_supported(cfg, int8, L) == frame
    assert T.fused_train_supported(cfg, int8, L) == train


@pytest.mark.parametrize("width,want", [
    (8, 64), (32, 64), (64, 64), (65, 128), (96, 128), (128, 128),
    (200, 256), (256, 256), (257, 384), (512, 512)])
def test_kernel_width_is_the_next_kernel(width, want):
    """The frame kernels' width (above 256 their wide form's, at the next
    multiple of 128); the teacher kernels' (above 256 their wide form's
    too)."""
    assert F.kernel_width(width) == want
    assert F.wide_form(width) == (width > 256)
    cfg = _r2l(netwidth=width)
    assert F.kernel_cfg(cfg).netwidth == want
    assert (F.kernel_cfg(cfg) is cfg) == (want == width)
    t_want = want if width > 256 else max(want, 128)
    assert NR.teacher_kernel_width(width) == t_want
    assert NR.teacher_wide_form(width) == (width > 256)
    tcfg = NeRFConfig(W=width)
    assert NR.teacher_kernel_cfg(tcfg).W == t_want


@pytest.mark.parametrize("kw,ok", [
    (dict(), True), (dict(W=128), True), (dict(W=64), True),
    (dict(W=200), True), (dict(W=512), True),
    (dict(D=31, skips=(29,)), True), (dict(D=32), True),
    (dict(D=4, skips=(3,)), False), (dict(D=4, skips=(2,)), True),
    (dict(D=1, skips=()), True), (dict(D=4, skips=(-1,)), False)])
def test_teacher_predicate(kw, ok):
    """Any width and depth (W512 on the wide form, D32 on K6/K7); a skip
    at the last layer or before the first is refused."""
    cfg = NeRFConfig(**kw)
    assert NR.fused_teacher_supported(cfg) == ok
    for cfgs in ((cfg,), (NeRFConfig(), cfg), (cfg, None)):
        if ok:
            NR.check_teacher_supported(*cfgs)
        else:
            with pytest.raises(NotImplementedError,
                               match="every skip before the last layer"):
                NR.check_teacher_supported(*cfgs)


# ---------------------------------------------------------------------------
# Student frames: the JAX package's kind, and its frame
# ---------------------------------------------------------------------------

def _student(width, dtype, depth=6, **kw):
    """(JAX params, JAX cfg, port cfg, port model) of a student (netdepth
    6: two blocks) with the same weights."""
    from _torch_parity import models
    jcfg = JaxR2LConfig(input_dim=48 * 21, netdepth=depth, netwidth=width,
                        compute_dtype=dtype,
                        precision="highest" if dtype == jnp.float32
                        else "default", **kw)
    params, cfg, model = models(jcfg, seed=11)
    return params, jcfg, cfg, model


CASES = {   # name: (width, depth, extra config, warnings of pe, of int8)
    # narrower than a kernel width: K1/K2 at 128, as JAX's kernels
    "w96": (96, 6, {}, [], []),
    # wider than the kernels: JAX's kernels take it, so does the port (on
    # the card the kernels' wide form; here their plain versions)
    "w512": (512, 6, {}, [], []),
    # the README's depth at W512: JAX's kernels do not fit it, both plain
    "w512_d88": (512, 88, {}, [K1_WARNING], [K2_WARNING, K1_WARNING]),
    # non-canonical activations: JAX's silent rule, both plain
    "w256_lrelu": (256, 6, dict(act="lrelu", inact="lrelu"), [], []),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("flags", ["pe", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_student_frame_takes_jaxs_path(case, flags, dtype, capsys):
    """``use_pallas`` (and ``--quantize int8``) off the kernels' native
    widths: the JAX package's kind, the port's warnings where both render
    plain (K2's first, then K1's, in JAX's order; none for non-canonical
    activations), and JAX's frame on the same weights within the kind's
    bound."""
    width, depth, kw, warn_pe, warn_int8 = CASES[case]
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    params, jcfg, cfg, model = _student(width, jd, depth, **kw)
    quantize = "int8" if flags == "int8" else ""
    jsampler = JaxPointSampler(**SAMPLER)
    kind = JE._prepare_r2l(params, jcfg, jsampler, 10, False, True,
                           quantize, calib_poses=POSES)[1]
    capsys.readouterr()
    tfn = TE.make_r2l_frame_fn(model, cfg, PointSampler(**SAMPLER),
                               use_pallas=True, quantize=quantize,
                               calib_poses=POSES)
    err = capsys.readouterr().err
    assert tfn.kind == kind
    warnings = [ln for ln in err.splitlines() if ln.startswith("WARNING")]
    want = warn_int8 if flags == "int8" else warn_pe
    assert len(warnings) == len(want)
    for got, prefix in zip(warnings, want):
        assert got.startswith(prefix), got
        assert f"(netwidth {width} with" in got and "64, 128, 256" in got
        assert "JAX package renders this model" in got
        assert "and so does the port" in got
    jfn = JE.make_r2l_frame_fn(params, jcfg, jsampler, use_pallas=True,
                               quantize=quantize, calib_poses=POSES)
    deep = depth > 6 and dtype == "bf16"
    tol_max, tol_rms = (TOL_KERNEL[(kind, dtype)] if kind != "jnp"
                        else TOL_DEEP_BF16 if deep
                        else (TOL_FRAME[dtype], None))
    for c2w in POSES[:2]:
        want_f = np.asarray(jfn(jnp.asarray(c2w)))
        got_f = n(tfn(c2w))
        assert got_f.shape == want_f.shape == (H, W, 3)
        d = got_f - want_f
        assert np.max(np.abs(d)) < tol_max, np.max(np.abs(d))
        if tol_rms is not None:
            assert np.sqrt(np.mean(d * d)) < tol_rms
    if kind == "jnp":   # the network alone, on JAX's points
        prepared, _, dim_pts = TE._prepare_r2l(
            model, cfg, PointSampler(**SAMPLER), 10, False, True, quantize,
            calib_poses=POSES)
        net = TE._r2l_net_fn(cfg, 10, kind, dim_pts)
        for c2w in POSES[:2]:
            pts = jsampler.sample_test(jnp.asarray(c2w))
            want_n = np.asarray(JE._r2l_net_fn(jcfg, 10, 0, "jnp", dim_pts)(
                params, pts))
            got_n = n(net(prepared, torch.from_numpy(np.array(pts))))
            d = got_n - want_n
            if deep:
                assert np.max(np.abs(d)) < TOL_DEEP_BF16[0]
                assert np.sqrt(np.mean(d * d)) < TOL_DEEP_BF16[1]
            else:
                assert np.max(np.abs(d)) < TOL_PLAIN[dtype]


@pytest.mark.parametrize("case", sorted(CASES))
def test_student_bench_and_givenrays_inherit_the_gate(case, capsys):
    width, depth, kw, warn_pe, _ = CASES[case]
    _, _, cfg, model = _student(width, jnp.bfloat16, depth, **kw)
    sampler = PointSampler(**SAMPLER)
    plain = bool(warn_pe) or "act" in kw
    for fn, kind in (
            (TE.make_r2l_bench_fn(model, cfg, sampler, quantize="int8",
                                  calib_poses=POSES), "int8"),
            (TE.make_r2l_givenrays_frame_fn(model, cfg, sampler, H, W),
             "pe")):
        assert fn.kind == ("jnp" if plain else kind)


@pytest.mark.parametrize("quantize", ["", "int8"])
@pytest.mark.parametrize("depth,on_kernel", [(6, True), (88, False)])
def test_wide_student_on_the_card(depth, on_kernel, quantize, monkeypatch,
                                  capsys):
    """The gate as on the card (the model's device read as CUDA; nothing
    is launched): a W512 student that the JAX package renders on its
    kernels is packed for the frame kernels' wide form (the packer run on
    the CPU at the wide width, ``pad=True``, its image the wide form's);
    one that it renders plain goes plain with the warnings."""
    _, _, cfg, model = _student(512, jnp.bfloat16, depth)
    monkeypatch.setattr(TE, "_model_device", lambda m: torch.device("cuda"))
    packed = []

    def packer(real):
        return lambda *a, **k: packed.append(real(*a, pad=True, **k)) or \
            packed[-1]
    monkeypatch.setattr(TE, "calibrate_r2l_int8_pe",
                        packer(F.calibrate_r2l_int8_pe) if on_kernel
                        else None)
    monkeypatch.setattr(TE, "prepare_fused_params_pe",
                        packer(F.prepare_fused_params_pe) if on_kernel
                        else None)
    monkeypatch.setattr(TE, "_calibration_points", lambda s, p, d: torch.zeros(
        (64, 48)).uniform_(-1.5, 1.5, generator=torch.Generator().manual_seed(
            0)))
    sampler = PointSampler(**SAMPLER)
    if on_kernel:
        prepared, kind, _ = TE._prepare_r2l(model, cfg, sampler, 10, False,
                                            True, quantize)
        assert kind == ("int8" if quantize else "pe")
        assert packed == [prepared] and F.wide_form(512)
        wd = torch.int8 if quantize else torch.bfloat16
        assert prepared.staged.numel() == F.wide_stage_plan(cfg, wd)[
            "nbytes"]
        if quantize:
            assert prepared.staged_for == "wide"
        return
    capsys.readouterr()
    _, kind, _ = TE._prepare_r2l(model, cfg, sampler, 10, False, True,
                                 quantize)
    assert kind == "jnp"
    warnings = [ln for ln in capsys.readouterr().err.splitlines()
                if ln.startswith("WARNING")]
    assert len(warnings) == (2 if quantize else 1)


def test_native_student_shapes_keep_their_kernels():
    """W64/W128/W256 with ReLU, and W96 at its kernel width, pack for K1
    and K2."""
    for width in (64, 96, 128, 256):
        _, _, cfg, model = _student(width, jnp.bfloat16)
        sampler = PointSampler(**SAMPLER)
        for quantize, kind in (("", "pe"), ("int8", "int8")):
            fn = TE.make_r2l_frame_fn(model, cfg, sampler, quantize=quantize,
                                      calib_poses=POSES)
            assert fn.kind == kind


# ---------------------------------------------------------------------------
# The padded packings: the kernels' widths, the unpadded network's outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [32, 96, 192])
@pytest.mark.parametrize("kernel", ["K1", "K9", "K2"])
def test_padded_student_packing_computes_the_network(kernel, width):
    """``pad=True`` (the default for a model on the card) packs at the
    kernel width, with zeros beyond the student's channels; the plain
    versions on it give the unpadded packing's outputs (f32: sums with
    zeros added, 1e-6; int8: the same codes and scales, bit for bit)."""
    from r2l_tpu_torch.encoding import r2l_embed
    _, _, cfg, model = _student(width, jnp.float32)
    Wk = F.kernel_width(width)
    rng = np.random.default_rng(width)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (64, 48)).astype(
        np.float32))
    if kernel == "K2":
        fps = [F.calibrate_r2l_int8_pe(model, cfg, 48, 10, pts, pad=p)
               for p in (False, True)]
        outs = [F.fused_r2l_apply_int8_pe(fp, cfg, pts, 48, 10)
                for fp in fps]
        widths = [fp.body_q.shape[-1] for fp in fps]
        assert torch.equal(fps[1].body_q[:, :width, :width], fps[0].body_q)
        assert not fps[1].body_q[:, width:].any()
        assert torch.isfinite(fps[1].body_m).all()
        tol = 0.0
    else:
        pack, run = ((F.prepare_fused_params_pe,
                      lambda fp: F.fused_r2l_apply_pe(fp, cfg, pts, 48, 10))
                     if kernel == "K1" else
                     (lambda m, c, *a, **k: F.prepare_fused_params(
                         m, c, torch.float32, pad=k["pad"]),
                      lambda fp: F.fused_r2l_apply(fp, cfg,
                                                   r2l_embed(pts, 10))))
        fps = [pack(model, cfg, 48, 10, weight_dtype=torch.float32, pad=p)
               for p in (False, True)]
        outs = [run(fp) for fp in fps]
        widths = [fp.body_w.shape[-1] for fp in fps]
        assert not fps[1].body_w[:, width:].any()
        assert not fps[1].tail_w[:, width:].any()
        tol = 1e-6
    assert widths == [width, Wk]
    np.testing.assert_allclose(n(outs[1]), n(outs[0]), rtol=0, atol=tol)


Lp, Lv = 4, 2


def _teacher(width=64, depth=4, skips=(2,), viewdirs=True):
    jcfg = JNeRFConfig(D=depth, W=width, skips=skips, input_ch=3 * 9,
                       input_ch_views=3 * 5 if viewdirs else 0,
                       use_viewdirs=viewdirs, output_ch=5 if viewdirs else 4)
    pc, cfg, mc = nerf_models(jcfg, seed=21)
    pf, _, mf = nerf_models(jcfg, seed=22)
    jv = jrender.VolRenderConfig(n_coarse=8, n_fine=6,
                                 use_viewdirs=viewdirs, multires=Lp,
                                 multires_views=Lv, near=2.0, far=6.0,
                                 white_bkgd=True, ray_chunk=48)
    tv = render.VolRenderConfig(**dataclasses.asdict(jv))
    return jcfg, pc, pf, jv, cfg, mc, mf, tv


def _teacher_rays(seed=4, n_rays=40):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n_rays, 3)) * 0.1).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("viewdirs", [True, False])
@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("width", [64, 96])
def test_padded_teacher_frame_matches_jaxs_kernel(width, mode, viewdirs):
    """A W64 (or W96) teacher packed at 128 (``pad=True``, the default on
    the card) through K6/K7's plain versions: JAX's fused frame (its
    kernel in interpret mode at the teacher's own width) within the f32
    frame bound (1e-5) or K2's int8 bound, each side calibrating on the
    same points; and the unpadded packing's frame (f32 1e-6; int8 bit for
    bit)."""
    jcfg, pc, pf, jv, cfg, mc, mf, tv = _teacher(width, viewdirs=viewdirs)
    jv = dataclasses.replace(jv, perturb=False)
    tv = dataclasses.replace(tv, perturb=False)
    o, d = _teacher_rays()
    kw, jkw = {}, {}
    if mode == "int8":
        z = np.linspace(2.0, 6.0, 8, dtype=np.float32)
        pts = (o[:, None] + d[:, None] * z[None, :, None]).reshape(-1, 3)
        vd = np.repeat(d / np.linalg.norm(d, axis=-1, keepdims=True), 8, 0)
        calib = (torch.from_numpy(pts), torch.from_numpy(vd)
                 if viewdirs else None)
        kw = dict(calib=calib, fold_requant=True)
        jkw = dict(int8_calib=(jnp.asarray(pts), jnp.asarray(vd)
                               if viewdirs else None), fold_requant=True)
    else:
        kw = dict(weight_dtype=torch.float32)
    packs = {p: tuple(NR.prepare_fused_nerf(m, cfg, Lp, Lv, pad=p, **kw)
                      for m in (mc, mf)) for p in (False, True)}
    assert packs[True][0].pts_b.shape == (4, 128)
    assert packs[False][0].pts_b.shape == (4, width)
    got = {p: render.render_frame_nerf_fused(
        mc, mf, cfg, tv, torch.from_numpy(o), torch.from_numpy(d),
        packed=packs[p]) for p in (False, True)}
    want = jrender.render_frame_nerf_fused(
        pc, pf, jcfg, jv, jnp.asarray(o), jnp.asarray(d), tile=8, **jkw)
    for k in ("rgb", "acc"):
        if mode == "int8":
            err = np.abs(n(got[True][k]) - np.asarray(want[k]))
            assert err.max() < 2.5e-2 and np.sqrt((err ** 2).mean()) < 2.5e-3
        else:
            np.testing.assert_allclose(n(got[True][k]), np.asarray(want[k]),
                                       rtol=0, atol=TOL_TEACHER, err_msg=k)
        np.testing.assert_allclose(n(got[True][k]), n(got[False][k]),
                                   rtol=0, atol=1e-6 if mode == "f32"
                                   else 0.0, err_msg=k)


# ---------------------------------------------------------------------------
# The teacher's gates
# ---------------------------------------------------------------------------

def test_w64_teacher_frame_on_the_cpu_is_jaxs_frame():
    """On the CPU both packages render the teacher plain."""
    jcfg, pc, pf, jv, cfg, mc, mf, tv = _teacher()
    want = JE.make_nerf_frame_fn(pc, pf, jcfg, jv,
                                 JaxPointSampler(**SAMPLER), use_pallas=True)
    got = TE.make_nerf_frame_fn(mc, mf, cfg, tv, PointSampler(**SAMPLER),
                                use_pallas=True, device="cpu")
    assert got.kind == "plain"
    for c2w in POSES[:2]:
        np.testing.assert_allclose(n(got(c2w)),
                                   np.asarray(want(jnp.asarray(c2w))),
                                   rtol=0, atol=TOL_TEACHER)


@pytest.mark.parametrize("width,fine,kind", [
    (64, None, "fused"), (128, None, "fused"), (128, 64, "fused"),
    (512, None, "fused"), (128, 512, "fused"),
    (128, dict(skips=(3,)), "raises")])
def test_teacher_frame_gate_on_the_card(width, fine, kind, monkeypatch):
    """The frame function's gate as on the card (the device check passed
    by a stand-in; the frame is not called): every teacher the JAX
    package's model builds is packed for the kernels (a W512 coarse or fine
    network for their wide form); a network with a skip at its last layer
    raises NotImplementedError before any packing."""
    _, _, _, _, cfg, mc, mf, tv = _teacher(width)
    cfg_f = (None if fine is None else dataclasses.replace(cfg, W=fine)
             if isinstance(fine, int) else dataclasses.replace(cfg, **fine))
    packs = []
    monkeypatch.setattr(TE, "_model_device", lambda m: torch.device("cuda"))
    monkeypatch.setattr(TE, "prepare_fused_teacher",
                        lambda *a, **k: packs.append(a) or (None, None))
    make = functools.partial(TE.make_nerf_frame_fn, mc, mf, cfg, tv,
                             PointSampler(**SAMPLER), use_pallas=True,
                             ncfg_fine=cfg_f, device="cuda")
    if kind == "raises":
        with pytest.raises(NotImplementedError,
                           match="every skip before the last layer"):
            make()
    else:
        assert make().kind == kind
    assert len(packs) == (kind == "fused")


@pytest.mark.parametrize("vkw,gkw,device,reason", [
    ({}, {}, "cuda", None),
    ({}, {}, "cpu", "the cpu device"),
    (dict(raw_noise_std=1.0), {}, "cuda", "sigma noise, raw_noise_std > 0"),
    (dict(multires=0), {}, "cuda", "no positional encoding"),
    ({}, dict(use_pallas=False), "cuda", "--use_pallas 0")])
def test_datagen_gate_keeps_jaxs_conditions(vkw, gkw, device, reason):
    vcfg = render.VolRenderConfig(**{"multires": 10, **vkw})
    gcfg = datagen.DataGenConfig(n_pose=1, H=4, W=4, focal=5.0, **gkw)
    dev = torch.device(device)
    assert datagen._fused_refusal(gcfg, vcfg, dev) == reason
    assert datagen._fused_refusal(gcfg, dataclasses.replace(
        vcfg, raw_noise_std=0.0, multires=10), dev, mesh=object()) == (
        reason if gkw or device == "cpu"
        else "the rays are sharded over a mesh")


@pytest.mark.parametrize("fine", [None, 512])
def test_wide_teacher_datagen_raises_on_the_card(fine, tmp_path):
    """Datagen's fused path (the card): a W512 coarse or fine network
    passes its gate (the wide form takes it), and the same teacher with a
    skip at its last layer raises NotImplementedError before it renders or
    packs anything (the models stay on the CPU: nothing touches the
    card)."""
    _, _, _, _, cfg, mc, mf, tv = _teacher(512 if fine is None else 64)
    cfg_f = dataclasses.replace(cfg, W=fine) if fine else None
    NR.check_teacher_supported(cfg, cfg_f)
    last = dict(skips=(cfg.D - 1,))
    if fine:
        cfg_f = dataclasses.replace(cfg_f, **last)
    else:
        cfg = dataclasses.replace(cfg, **last)
    gcfg = datagen.DataGenConfig(n_pose=1, H=4, W=4, focal=5.0)
    with pytest.raises(NotImplementedError,
                       match="every skip before the last layer"):
        datagen.generate_pseudo_data(mc, mf, cfg, tv, gcfg, str(tmp_path),
                                     ncfg_fine=cfg_f, device="cuda")
    assert not os.listdir(tmp_path)


def test_w64_teacher_datagen_matches_jax(tmp_path):
    """A W64 teacher's rand pseudo data on the CPU: the plain path, the JAX
    package's records (rgb within the datagen tests' 1e-5)."""
    import r2l_tpu.datagen as jdatagen
    jcfg, pc, pf, jv, cfg, mc, mf, tv = _teacher()
    jv = dataclasses.replace(jv, perturb=False)
    tv = dataclasses.replace(tv, perturb=False)
    kw = dict(n_pose=1, H=8, W=8, focal=10.0, save_every=1, shard_size=64,
              seed=3)
    n_j = jdatagen.generate_pseudo_data(pc, pf, jcfg, jv,
                                        jdatagen.DataGenConfig(**kw),
                                        str(tmp_path / "jax"))
    n_t = datagen.generate_pseudo_data(mc, mf, cfg, tv,
                                       datagen.DataGenConfig(**kw),
                                       str(tmp_path / "torch"), device="cpu")
    assert n_j == n_t == 64
    a = np.load(tmp_path / "jax" / "pseudo_000000.npy")
    b = np.load(tmp_path / "torch" / "pseudo_000000.npy")
    np.testing.assert_array_equal(b[:, :6], a[:, :6])
    np.testing.assert_allclose(b[:, 6:], a[:, 6:], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Training: fused_vjp_gate is JAX's rule, and the kernels' activations
# ---------------------------------------------------------------------------

def _jax_gate_warning() -> str:
    """The warning string of JAX's --fused_train_vjp gate
    (r2l_tpu/app.py)."""
    with open(os.path.join(REPO, "r2l_tpu", "app.py")) as f:
        tree = ast.parse(f.read())
    found = {node.value for node in ast.walk(tree)
             if isinstance(node, ast.Constant) and isinstance(node.value, str)
             and node.value.startswith("WARNING: --fused_train_vjp requires")}
    assert len(found) == 1
    return found.pop()


@pytest.mark.parametrize("kw,ok,warning", [
    (dict(netwidth=512), True, None), (dict(netwidth=384), True, None),
    (dict(netwidth=128), True, None), (dict(netwidth=256), True, None),
    (dict(netwidth=64), False, "jax"), (dict(netwidth=96), False, "jax"),
    (dict(netwidth=256, n_learnable=3), False, "jax"),
    (dict(netwidth=256, act="lrelu"), False, "act"),
    (dict(netwidth=256, inact="lrelu"), False, "act"),
    (dict(netwidth=256, outact="relu"), False, "act")])
def test_fused_vjp_gate(kw, ok, warning):
    """JAX's rule, with JAX's warning; and the ReLU activations the
    kernels hardcode (JAX's kernels assert them), with a warning of its
    own. A width JAX's rule admits is the fused step's to refuse on the
    card (below)."""
    cfg = _r2l(**kw)
    logs = []
    assert TR.fused_vjp_gate(True, cfg, False, log=logs.append) == ok
    if warning is None:
        assert logs == []
    elif warning == "jax":
        assert logs == [_jax_gate_warning()]
    else:
        assert len(logs) == 1 and logs[0].startswith(
            "WARNING: --fused_train_vjp: the training kernels take ReLU")
        assert f"act={cfg.act!r} inact={cfg.inact!r}" in logs[0]


@pytest.mark.parametrize("kw,quantize,L", [
    (dict(netwidth=512), "", 10), (dict(netwidth=384), "int8", 10),
    (dict(netwidth=96), "", 10), (dict(netwidth=256, act="lrelu"), "", 10),
    (dict(netwidth=64, input_dim=48 * 129), "int8", 64)])
def test_fused_distill_step_refuses_up_front_on_the_card(kw, quantize, L):
    """``make_distill_step(fused_vjp=True)`` on the card at a shape the
    training kernels do not take (W96, lrelu, and int8 at W64 with 2L+1 >
    2W, which neither K4's head slice nor the wide form's multiples of 128
    hold) raises NotImplementedError before it builds anything; W512 and
    W384 int8, on the wide form, build (nothing here touches the card)."""
    cfg = _r2l(**kw)
    sampler = PointSampler(H=8, W=8, focal=8.0, n_sample=16, near=2.0,
                           far=6.0)
    calib = torch.zeros((4, 48)) if quantize else None
    def build():
        return TR.make_distill_step(
            cfg, TR.DistillConfig(batch_size=64, embed_L=L), sampler,
            fused_vjp=True, fused_quantize=quantize, fused_calib_pts=calib,
            device="cuda")
    if cfg.netwidth in (384, 512):
        assert T.wide_train_form(cfg.netwidth, bool(quantize), L)
        assert callable(build())
        return
    with pytest.raises(NotImplementedError, match="netwidth 64, 128, 256"):
        build()


# ---------------------------------------------------------------------------
# The wrappers refuse before any launch
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


WIDE = _r2l(netwidth=512)
LRELU = _r2l(netwidth=256, act="lrelu")
NARROW = _r2l(netwidth=96)
WRAPPERS = {
    "K1": (lambda cfg: F.fused_r2l_apply_pe(None, cfg, _meta(8, 48), 48, 10),
           lambda: [F.fused_r2l_apply_pe, F.fused_r2l_apply_pe_wide]),
    "K9": (lambda cfg: F.fused_r2l_apply(None, cfg, _meta(8, 1008)),
           lambda: [F.fused_r2l_apply, F.fused_r2l_apply_wide]),
    "K2": (lambda cfg: F.fused_r2l_apply_int8_pe(None, cfg, _meta(8, 48),
                                                 48, 10),
           lambda: [F.fused_r2l_apply_int8_pe,
                    F.fused_r2l_apply_int8_pe_wide]),
    "K3": (lambda cfg: T.train_fwd(None, cfg, _meta(8, 48), 48, 10),
           lambda: [T.train_fwd, T.train_fwd_wide]),
    "K4/K8": (lambda cfg: T.train_fwd_int8(None, cfg, _meta(8, 48), 48, 10),
              lambda: [T.train_fwd_int8, T.train_fwd_int8_wide]),
    "K5": (lambda cfg: T.bwd_group(None, None, _meta(8, cfg.netwidth), cfg,
                                   0, 1),
           lambda: [T.bwd_group, T.bwd_group_wide]),
}


def _counts(fns) -> list[int]:
    return [getattr(f, a) for f in fns
            for a in ("launches", "launches_bf16") if hasattr(f, a)]


@pytest.mark.parametrize("kernel,cfg", [
    (k, c) for c in (WIDE, LRELU) for k in sorted(WRAPPERS)] + [
    (k, NARROW) for k in ("K3", "K4/K8", "K5")],
    ids=lambda x: x if isinstance(x, str) else f"w{x.netwidth}_{x.act}")
def test_student_wrappers_refuse_before_any_launch(kernel, cfg):
    """lrelu: every wrapper; W96: the training kernels, which pad nothing
    (the frame kernels take W96 at 128). W512: every wrapper takes it on
    its wide form, and given no packing stops at its image before any
    launch."""
    call, fns = WRAPPERS[kernel]
    before = _counts(fns())
    if cfg is WIDE:
        assert F.fused_frame_supported(cfg, kernel == "K2")
        assert T.fused_train_supported(cfg, kernel == "K4/K8")
        with pytest.raises(ValueError, match="image of the wide form"):
            call(cfg)
    else:
        with pytest.raises(NotImplementedError, match="64, 128, 256"):
            call(cfg)
    assert _counts(fns()) == before


@pytest.mark.parametrize("kw", [dict(W=512), dict(D=32), dict(D=4,
                                                              skips=(3,))])
def test_teacher_wrapper_refuses_before_any_launch(kw):
    """W512 (the wide form) and D32 (K6/K7) are taken, and given no
    packing stop at the image before any launch; a skip at the last layer
    raises NotImplementedError first."""
    cfg = NeRFConfig(**kw)
    f = NR.fused_nerf_render
    before = (f.launches, f.launches_int8, f.launches_wide,
              f.launches_wide_int8)
    if NR.fused_teacher_supported(cfg):
        with pytest.raises(ValueError, match="no staged weight image"):
            f(None, cfg, _meta(8, 3), _meta(8, 3), _meta(8, 16))
    else:
        with pytest.raises(NotImplementedError,
                           match="every skip before the last layer"):
            f(None, cfg, _meta(8, 3), _meta(8, 3), _meta(8, 16))
    assert (f.launches, f.launches_int8, f.launches_wide,
            f.launches_wide_int8) == before
