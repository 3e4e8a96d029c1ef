"""Port parity: K2 with three requantize epilogues
(r2l_tpu_torch/exp/probe_epi.py) against exp/probe_epi.py's apply_variant,
run under pltpu.force_tpu_interpret_mode() (it is built with
interpret=False) on the same int8 packing: JAX's calibration carried over
field by field (tests/_torch_parity.py::int8_params_from_jax), both
packings (fold_requant=True, as the driver uses it, and False), small R2L
configs (width 64 and 256, depth 6-8), 256 rays in 64-ray tiles."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import int8_case, int8_params_from_jax, load_exp_probe, n, t
from r2l_tpu.kernels import r2l_pallas as JP
from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import probe_epi as P
from r2l_tpu_torch.kernels import _build
from r2l_tpu_torch.kernels import r2l_fused as F

JE = load_exp_probe("probe_epi")
DP, L = 6, 4
# Tolerances against the JAX probe on the CPU: bit for bit with a linear
# tail (exact int32 dots, the same one-FMA dequantize, the bf16 products
# rounded as XLA rounds them); one f32 ulp of [0.5, 1) with the sigmoid
# tail, where torch's and XLA's CPU sigmoid differ on a few outputs
# (ROADMAP C; measured 5.96e-8 in 2-4 of 768 outputs).
TOL_SIGMOID = 6e-8


def _case(W, D, fold, linear_tail):
    jcfg, params, cfg, model, calib, pts = int8_case(
        DP, L, W, D, 16, linear_tail=linear_tail)
    jfp = JP.calibrate_r2l_int8_pe(params, jcfg, DP, L,
                                   calib_pts=jnp.asarray(calib),
                                   fold_requant=fold)
    like = F.calibrate_r2l_int8_pe(model, cfg, DP, L, t(calib),
                                   fold_requant=fold)
    return jcfg, jfp, cfg, int8_params_from_jax(jfp, like), pts


def _jax_variant(jfp, jcfg, pts, variant):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(JE.apply_variant(jfp, jcfg, jnp.asarray(pts), DP,
                                           L, 64, variant))


@pytest.mark.parametrize("linear_tail", [True, False])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("W,D", [(64, 8), (256, 6)])
def test_variants_match_the_jax_probe(W, D, fold, linear_tail):
    jcfg, jfp, cfg, fp, pts = _case(W, D, fold, linear_tail)
    outs = {}
    for v in P.VARIANTS:
        want = _jax_variant(jfp, jcfg, pts, v)
        got = outs[v] = n(P.apply_variant(fp, cfg, t(pts), DP, L, v))
        assert got.shape == want.shape == (256, 3)
        if linear_tail:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= TOL_SIGMOID
    # v0 is K2 unfolded; v2 is v1 where every inverse scale is positive
    np.testing.assert_array_equal(outs[0], n(F.fused_r2l_apply_int8_pe(
        fp, cfg, t(pts), DP, L, fold_requant=False, nobf16_inner=False)))
    assert bool((fp.body_inv > 0).all())
    np.testing.assert_array_equal(outs[2], outs[1])
    assert not np.array_equal(outs[1], outs[0])


def test_bf16_quantize_rounds_the_product_as_xla():
    """``jnp.round(t_bf16 * inv.astype(bf16))`` rounds the product to bf16
    first: the port's quantize equals it on a normal(0, 3) bf16 tile with
    inverse scales in U[5, 60), and skipping that rounding would change
    many codes."""
    rng = np.random.default_rng(0)
    tb = jnp.asarray(rng.normal(size=(64, 256)) * 3, jnp.float32).astype(
        jnp.bfloat16)
    inv = jnp.asarray(rng.uniform(5, 60, size=(1, 256)), jnp.float32)

    @jax.jit
    def q(tb, inv):
        return jnp.clip(jnp.round(tb * inv.astype(jnp.bfloat16)), -127.0,
                        127.0).astype(jnp.int8)

    want = np.asarray(q(tb, inv)).astype(np.float64)
    tt = torch.from_numpy(np.array(tb.astype(jnp.float32)))
    it = torch.from_numpy(np.array(inv))
    got = P._q8_bf16(tt, it, -127.0).numpy()
    np.testing.assert_array_equal(got, want)
    unrounded = np.clip(np.round(
        tt.numpy() * it.bfloat16().float().numpy()), -127, 127)
    assert np.mean(unrounded != want) > 0.02


def _epi_enum(header: str) -> dict[str, int]:
    """A header's ``enum Epi {...}``: name -> code."""
    body = re.search(r"enum Epi \{([^}]*)\}",
                     (_build.CSRC / header).read_text()).group(1)
    return {k.strip(): int(v) for k, v in
            (e.split("=") for e in body.split(",") if e.strip())}


def test_epilogue_codes_name_the_hopper_forms():
    """The codes the wrappers pass are the Hopper header's own: each
    epilogue variant's is K2's ``kUnfolded``, ``kEpiV1``, ``kEpiV2``; each
    stream count's ``kStreams1``, K2's ``kDeployed`` (S = 2 is K2's
    ping-pong itself), ``kStreams4``; K2's three forms (``EPILOGUES``) are
    the header's; no two forms share a code, and the only form of other
    blocks a launch (``INT8_FORM_BLOCK_RAYS``) is S = 4's."""
    from r2l_tpu_torch.exp import probe_pipe_lib as PL
    hop = _epi_enum("r2l_int8_hopper.cuh")
    assert P._EPI_CODE == {0: hop["kUnfolded"], 1: hop["kEpiV1"],
                           2: hop["kEpiV2"]}
    assert PL.STREAM_CODE == {1: hop["kStreams1"], 2: hop["kDeployed"],
                              4: hop["kStreams4"]}
    names = {"deployed": "kDeployed", "fold": "kFold",
             "unfolded": "kUnfolded"}
    assert {hop[names[k]]: k for k in names} == {
        v: k for k, v in F.EPILOGUES.items()}
    assert F.INT8_FORM_BLOCK_RAYS == {hop["kStreams4"]: 256}
    assert len(set(hop.values())) == len(hop)


def test_variants_refuse_others():
    _, _, cfg, fp, pts = _case(64, 8, True, True)
    with pytest.raises(ValueError, match="variant"):
        P.apply_variant(fp, cfg, t(pts), DP, L, 3)


def test_runner_checksum_matches_jax():
    """The driver's frame loop on two small frames against JAX's, variant
    1: the same per-frame sums up to their f32 order and the sigmoid's
    ulp."""
    from r2l_tpu.rays import pose_spherical
    from r2l_tpu.sampler import PointSampler as JSampler
    from r2l_tpu_torch.sampler import PointSampler
    jcfg, jfp, cfg, fp, _ = _case(64, 8, True, False)
    kw = dict(H=8, W=8, focal=10.0, n_sample=DP // 3, near=2.0, far=6.0)
    js, ps = JSampler(**kw), PointSampler(**kw)
    want = got = 0.0
    for th in (0.0, 90.0):
        c2w = pose_spherical(th, -30.0, 4.0)[:3, :4]
        want += float(np.sum(_jax_variant(
            jfp, jcfg, np.asarray(js.sample_test(jnp.asarray(c2w))), 1)))
        got += float(P.apply_variant(
            fp, cfg, ps.sample_test(torch.from_numpy(c2w).float()), DP, L,
            1).sum())
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_driver_bound_is_sixteen_frames():
    """The bound of one call of the driver, 16 frames of the canonical
    chain at the data-sheet int8 rate: 15.25 ms."""
    from r2l_tpu_torch.models import R2LConfig
    ops = _harness.chain_ops(R2LConfig(), 400 * 400, 1008)
    assert P.K * _harness.bound_ms(ops, "int8") == pytest.approx(15.25,
                                                                 abs=1e-2)


def test_runner_needs_a_gpu(capsys):
    """Without CUDA the driver exits non-zero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        P.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
