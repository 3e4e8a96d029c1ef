"""Port parity: the metrics (r2l_tpu_torch/metrics.py, flip.py, lpips.py)
against r2l_tpu's (metrics.py, flip.py, lpips_jax.py) on the same numpy
images and the same LPIPS weights, and against the reference torch code's
values frozen in tests/fixtures/metrics_golden.npz."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r2l_tpu.flip as JF
import r2l_tpu.lpips_jax as JL
import r2l_tpu.metrics as JM
from _torch_parity import n, t
from r2l_tpu_torch import flip as TF
from r2l_tpu_torch import lpips as TL
from r2l_tpu_torch import metrics as TM

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "metrics_golden.npz")
# Port against JAX, both f32 on the CPU: the same formulas, the
# convolutions' sums in another order. Measured: SSIM 6.3e-8 relative, the
# FLIP map 2.2e-6 max-abs (its mean 1.6e-7 relative), LPIPS 6.7e-7
# relative at worst over the backbones and rescales.
RTOL_SSIM, ATOL_FLIP_MAP, RTOL_FLIP, RTOL_LPIPS = 1e-5, 1e-5, 1e-5, 1e-5
# Against the reference torch code's frozen values: the JAX tests' own
# (tests/test_lpips_flip.py: SSIM rtol 2e-4 atol 2e-5, FLIP rtol 2e-3 atol
# 2e-4).
GOLD_SSIM, GOLD_FLIP = (2e-4, 2e-5), (2e-3, 2e-4)


def _pair(seed, shape=(2, 33, 35, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


def _jax_lpips(net):
    return JL.init_lpips(jax.random.key(0), net=net)


def _np_params(jp):
    return {k: v if k == "net" else jax.tree.map(np.asarray, v)
            for k, v in jp.items()}


@pytest.mark.parametrize("batched", [False, True])
def test_ssim_matches_jax(batched):
    a, b = _pair(0)
    a, b = (a, b) if batched else (a[0], b[0])
    want = float(JM.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(TM.ssim(t(a), t(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL_SSIM)


def test_gaussian_window_equals_jax():
    np.testing.assert_array_equal(TM._gaussian_window(11, 1.5),
                                  JM._gaussian_window(11, 1.5))


def test_frame_metrics_matches_jax():
    a, b = _pair(1)
    want = jax.device_get(JM.frame_metrics(jnp.asarray(a[0]),
                                           jnp.asarray(b[0])))
    got = TM.frame_metrics(t(a[0]), t(b[0]))
    assert sorted(got) == sorted(want) == ["mse", "psnr", "ssim"]
    for k in want:
        assert got[k].ndim == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=RTOL_SSIM, err_msg=k)


def test_metrics_restore_the_precision_flags():
    """The metrics turn TF32 off for their convolutions and give the
    caller's flags back."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    a, b = _pair(2, (16, 16, 3))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with TM.full_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        TM.ssim(t(a), t(b))
        TF.flip(t(a), t(b))
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def test_flip_error_map_matches_jax():
    a, b = _pair(3)
    want = np.asarray(JF.flip_error_map(jnp.asarray(a[0]),
                                        jnp.asarray(b[0])))
    got = n(TF.flip_error_map(t(a[0]), t(b[0])))
    assert got.shape == want.shape == (33, 35)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FLIP_MAP)
    np.testing.assert_allclose(float(TF.flip(t(a[0]), t(b[0]))),
                               float(JF.flip(jnp.asarray(a[0]),
                                             jnp.asarray(b[0]))),
                               rtol=RTOL_FLIP)


def test_flip_kernels_and_colour_transforms_equal_jax():
    for ppd in (TF.DEFAULT_PPD, 20.0):
        c_t, r_t = TF._csf_kernels(ppd)
        c_j, r_j = JF._csf_kernels(ppd)
        np.testing.assert_array_equal(c_t, c_j)
        assert r_t == r_j
        for k_t, k_j in zip(TF._feature_kernels(ppd),
                            JF._feature_kernels(ppd)):
            np.testing.assert_array_equal(k_t, k_j)
    x, _ = _pair(4, (9, 7, 3))
    for name in ("srgb_to_linear", "linear_to_srgb", "srgb_to_ycxcz"):
        np.testing.assert_allclose(
            n(getattr(TF, name)(t(x))),
            np.asarray(getattr(JF, name)(jnp.asarray(x))), rtol=1e-6,
            atol=1e-5, err_msg=name)
    np.testing.assert_allclose(n(TF.linear_to_srgb(TF.srgb_to_linear(t(x)))),
                               x, atol=1e-5)


def test_ssim_and_flip_match_the_golden_fixture():
    """SSIM, FLIP and minmax FLIP (the whole stack rescaled, clipped to
    [0, 1], then per image) against the reference torch code's values."""
    d = np.load(GOLDEN)
    for gt, img, want_flip, want_ssim in zip(d["gts"], d["imgs"], d["flip"],
                                             d["ssim"]):
        np.testing.assert_allclose(float(TM.ssim(t(img), t(gt))), want_ssim,
                                   *GOLD_SSIM)
        np.testing.assert_allclose(float(TF.flip(t(gt), t(img))), want_flip,
                                   *GOLD_FLIP)
    gts = torch.clamp(TL.minmax_rescale(t(d["gts"])), 0.0, 1.0)
    recs = torch.clamp(TL.minmax_rescale(t(d["imgs"])), 0.0, 1.0)
    for i, want in enumerate(d["flip_minmax"]):
        np.testing.assert_allclose(float(TF.flip(gts[i], recs[i])), want,
                                   *GOLD_FLIP)


def test_minmax_rescale_matches_jax():
    x, _ = _pair(5, (2, 8, 8, 3))
    x = 0.2 + 0.5 * x
    np.testing.assert_allclose(n(TL.minmax_rescale(t(x))),
                               np.asarray(JL.minmax_rescale(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
@pytest.mark.parametrize("rescale", ["standard", "minmax", "none"])
def test_lpips_matches_jax(net, rescale):
    """Each backbone and rescale on JAX's init_lpips weights carried
    across (``lpips_params_from_jax``)."""
    jp = _jax_lpips(net)
    tp = TL.lpips_params_from_jax(_np_params(jp), device="cpu")
    a, b = _pair(6)
    if rescale == "none":
        a, b = 2 * a - 1, 2 * b - 1
    want = float(JL.lpips(jp, jnp.asarray(a), jnp.asarray(b),
                          rescale=rescale))
    got = float(TL.lpips(tp, t(a), t(b), rescale=rescale))
    np.testing.assert_allclose(got, want, rtol=RTOL_LPIPS)
    assert abs(float(TL.lpips(tp, t(a[0]), t(a[0]), rescale=rescale))) \
        < 1e-6


def test_init_lpips_shapes_match_jax_and_default_to_the_card():
    import inspect
    for net in ("alex", "vgg", "squeeze"):
        tp = TL.init_lpips(torch.Generator().manual_seed(0), net,
                           device="cpu")
        jp = _jax_lpips(net)
        assert [tuple(c["w"].shape) for c in tp["convs"]] == [
            tuple(np.asarray(c["w"]).transpose(3, 2, 0, 1).shape)
            for c in jp["convs"]]
        assert [tuple(h["w"].shape) for h in tp["lins"]] == [
            (1, np.asarray(h["w"]).shape[2], 1, 1) for h in jp["lins"]]
        a, b = _pair(7, (33, 35, 3))
        assert float(TL.lpips(tp, t(a), t(b))) > float(
            TL.lpips(tp, t(a), t(a))) >= 0.0
    for fn in (TL.init_lpips, TL.load_torch_lpips,
               TL.lpips_params_from_jax):
        assert inspect.signature(fn).parameters["device"].default == \
            torch.device("cuda")


def _alex_state_dict(g):
    sd = {}
    conv_idx = [(1, 0), (2, 3), (3, 6), (4, 8), (5, 10)]
    for (sl, idx), (i, (oc, ic, k, _, _)) in zip(conv_idx,
                                                 enumerate(TL._ALEX)):
        sd[f"net.slice{sl}.{idx}.weight"] = 0.05 * torch.randn(
            oc, ic, k, k, generator=g)
        sd[f"net.slice{sl}.{idx}.bias"] = 0.01 * torch.randn(oc, generator=g)
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, oc, 1, 1, generator=g)
    return sd


def _squeeze_state_dict(g):
    sd = {"net.slice1.0.weight": torch.randn(64, 3, 3, 3, generator=g),
          "net.slice1.0.bias": torch.randn(64, generator=g)}
    # the fires at torchvision feature indices 3,4 | 6,7 | 9 | 10 | 11 | 12
    slices = [(2, [3, 4]), (3, [6, 7]), (4, [9]), (5, [10]), (6, [11]),
              (7, [12])]
    fi = 0
    for sl, idxs in slices:
        for idx in idxs:
            s, e = TL._SQUEEZE_FIRES[fi]
            ic = 64 if fi == 0 else 2 * TL._SQUEEZE_FIRES[fi - 1][1]
            pre = f"net.slice{sl}.{idx}"
            for name, shape in (("squeeze", (s, ic, 1, 1)),
                                ("expand1x1", (e, s, 1, 1)),
                                ("expand3x3", (e, s, 3, 3))):
                sd[f"{pre}.{name}.weight"] = torch.randn(
                    *shape, generator=g) / np.sqrt(np.prod(shape[1:]))
                sd[f"{pre}.{name}.bias"] = torch.randn(shape[0], generator=g)
            fi += 1
    for i, c in enumerate(TL._feat_channels("squeeze")):
        sd[f"lins.{i}.model.1.weight"] = torch.rand(1, c, 1, 1, generator=g)
    return sd


@pytest.mark.parametrize("net", ["alex", "squeeze"])
def test_load_torch_lpips_matches_jax(net):
    """A synthetic pip-lpips state_dict (tests/test_lpips_flip.py's names)
    loads in the JAX package's fire-module order and gives its distance."""
    g = torch.Generator().manual_seed(0)
    sd = (_alex_state_dict if net == "alex" else _squeeze_state_dict)(g)
    tp = TL.load_torch_lpips(sd, net=net, device="cpu")
    jp = JL.load_torch_lpips(sd, net=net)
    assert len(tp["convs"]) == len(jp["convs"])
    for c_t, c_j in zip(tp["convs"], jp["convs"]):
        np.testing.assert_array_equal(
            n(c_t["w"]), np.asarray(c_j["w"]).transpose(3, 2, 0, 1))
    a, b = _pair(8)
    np.testing.assert_allclose(
        float(TL.lpips(tp, t(a), t(b))),
        float(JL.lpips(jp, jnp.asarray(a), jnp.asarray(b))),
        rtol=RTOL_LPIPS)
    del sd[next(k for k in sd if k.startswith("lin"))]
    with pytest.raises(ValueError, match="unrecognized lpips"):
        TL.load_torch_lpips(sd, net=net, device="cpu")
