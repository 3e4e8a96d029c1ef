"""Port parity: the shape probe (r2l_tpu_torch/exp/probe_shapes.py) against
exp/probe_shapes.py. The probe's kernel body (unchained_kernel) runs through
pl.pallas_call with run_shape's block specs in TPU interpret mode on the
CPU, on the probe's own inputs (jax.random from keys 0 and 1) carried over by
weights_from_jax; the port's plain version runs on the same arrays. Each of
main()'s shapes in both dtypes and its chained ones, cut to 2 tiles of 8 or
32 rows and a few layers. Then the kernel's side that a CPU can check: its
staged weight image (the stages its ring bulk-copies, in wgmma's B layout)
and an emulation of its sum order, held to the limits ``chip_smoke.py``
holds the card to."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke as cs
from _torch_parity import load_exp_probe
from r2l_tpu_torch.exp import probe_shapes as S
from r2l_tpu_torch.exp.probe_mxu import weights_from_jax
from r2l_tpu_torch.kernels.staging import stage_matrices

JS = load_exp_probe("probe_shapes")
N_TILES = 2
# int8 (free and chained): exact int32 dots, the f32 sums over the layers
#   in JAX's order, and a row sum whose integer terms fit f32 at these sizes
#   (the port sums rows in float64, exact for integers): bit for bit.
# bf16 free: XLA's f32 dots and its f32 row sum add in another order than
#   torch's; relative to the largest output, as a row sum near zero makes a
#   per-row relative error meaningless (measured up to 2.1e-7 at 4 layers).
TOL_BF16_FREE = 1e-6
# bf16 chained: the same bf16 roundings, f32 sums in another order, so a
#   flipped rounding propagates, relative to the largest output, and the
#   share of rows that differ (measured at 4 layers: 2.5e-8 in 1.6% of the
#   rows at K=N=256, 4.9e-4 in 14% at 512, 0 for the non-square shape). A
#   plain version that skipped the bf16 rounding between layers reads
#   2.8e-3..3.8e-3 and differs in every row.
TOL_BF16_CHAINED, MAX_DIFFER_SHARE = 1e-3, 0.5


def _jax_inputs(M, K, N, jdt, n_layers):
    """run_shape's inputs (exp/probe_shapes.py:57-67), n_layers of them."""
    key = jax.random.key(0)
    if jdt == jnp.int8:
        w = jax.random.randint(key, (n_layers, K, N), -127, 127,
                               jnp.int32).astype(jnp.int8)
        x = jax.random.randint(jax.random.key(1), (N_TILES * M, K), -127,
                               127, jnp.int32).astype(jnp.int8)
    else:
        w = (jax.random.normal(key, (n_layers, K, N), jnp.float32) * 0.05
             ).astype(jdt)
        x = jax.random.normal(jax.random.key(1), (N_TILES * M, K),
                              jnp.float32).astype(jdt)
    return x, w


def _case(M, K, N, dtype, chained, n_layers, monkeypatch):
    monkeypatch.setattr(JS, "N_LAYERS", n_layers)
    jdt = jnp.int8 if dtype == torch.int8 else jnp.bfloat16
    x, w = _jax_inputs(M, K, N, jdt, n_layers)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            functools.partial(JS.unchained_kernel, chained=chained),
            grid=(N_TILES,),
            in_specs=[pl.BlockSpec((M, K), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((n_layers, K, N), lambda i: (0, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((M, 1), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((N_TILES * M, 1), jnp.float32),
        )(x, w))
    xt = torch.from_numpy(np.asarray(x).astype(np.float32)).to(dtype)
    got = S.unchained(xt, weights_from_jax(np.asarray(w))[0], chained)
    return got.numpy(), want


def _assert_close(got, want, dtype, chained):
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == torch.int8:
        np.testing.assert_array_equal(got, want)
        return
    tol = TOL_BF16_CHAINED if chained else TOL_BF16_FREE
    d = np.abs(got - want)
    assert d.max() <= tol * np.abs(want).max(), d.max()
    if chained:
        assert np.mean(d > 0) <= MAX_DIFFER_SHARE, np.mean(d > 0)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", S.SHAPES)
def test_free_shapes_match_pallas(M, K, N, dtype, monkeypatch):
    """Every (M, K, N) of main(), 2 tiles of 8 rows, 2 layers."""
    got, want = _case(8, K, N, dtype, False, 2, monkeypatch)
    _assert_close(got, want, dtype, False)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(256, 256), (512, 512), (256, 512)])
def test_chained_matches_pallas(K, N, dtype, monkeypatch):
    """main()'s chained square shapes at 2 tiles of 32 rows, 4 layers, in
    both dtypes; and a non-square one, where h stays x as in JAX. The int8
    output is not zero (the wrap keeps it alive)."""
    got, want = _case(32, K, N, dtype, True, 4, monkeypatch)
    _assert_close(got, want, dtype, True)
    assert np.abs(got).sum() > 0


def test_int8_free_row_sums_exceed_f32_integers():
    """The port's float64 row sum is exact where an f32 one would round: a
    row of integers summing past 2^24."""
    x = torch.full((1, 256), 127, dtype=torch.int8)
    w = torch.full((2, 512, 256), 127, dtype=torch.int8)
    w[1, 0, 0] = 126
    got = float(S.unchained_ref(x, w)[0, 0])
    exact = 2 * 512 * 256 * 127 * 127 - 127
    assert got == float(np.float32(exact))


def test_names_and_inputs_follow_the_probe():
    assert S.shape_name(1024, 256, 256, torch.int8) == \
        "free_int8_M1024_K256_N256"
    assert S.shape_name(1024, 512, 512, torch.bfloat16, chained=True) == \
        "chain_bfloat16_M1024_K512_N512"
    x, w = S.shape_inputs(4, 256, 512, torch.int8,
                          torch.Generator().manual_seed(0), n_tiles=2,
                          n_layers=3, device="cpu")
    assert x.shape == (8, 256) and w.shape == (3, 512, 256)
    assert int(x.min()) >= -127 and int(x.max()) <= 126


@pytest.mark.parametrize("k", [16, 32])
def test_mma_rounding_of_the_plain_version_is_unbiased(k):
    """``mma_rounding`` on the plain version (f32 sums in torch's CPU order):
    where a sum differs from the round-to-nearest of the exact one, it lies
    on either side about equally, within a few ulps of the largest product.
    The card's tensor cores lie on the smaller side (tests/test_torch_cuda.
    py::test_one_mma_truncates_its_f32_sum)."""
    r = S.mma_rounding(k, rows=4096, device="cpu")
    assert r["differ_share"] > 0.05, r
    assert 0.3 < r["smaller_magnitude_share"] < 0.7, r
    assert r["max_err_in_top_ulp"] <= k, r


def test_runner_needs_a_gpu(capsys):
    """Without CUDA the runner exits non-zero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        S.main([])
    assert e.value.code == 1
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_staged_weights_round_trip_in_the_rings_order(dtype, chained):
    """``stage_shape_weights`` unpacks to w bit for bit, and its stage ``it``
    (of CHUNK outputs by STAGE_BYTES of K) is the block the kernel takes at
    ring step ``it``: free, chunk by chunk, each through every layer;
    chained, layer by layer, each through every chunk. Each stage is laid
    out as wgmma reads B: byte (n, b) at ((n // 8) * 8 + b // 16) * 128 +
    (n % 8) * 16 + b % 16."""
    L, N, K = 3, 256, 256 if chained else 512
    x, w = S.shape_inputs(4, K, N, dtype, torch.Generator().manual_seed(3),
                          n_tiles=1, n_layers=L, device="cpu")
    es = w.element_size()
    img = S.stage_shape_weights(w, chained)
    staged = img.data
    assert staged.dtype == torch.uint8 and staged.numel() == w.numel() * es
    assert img.form == chained
    assert torch.equal(S.unstage_shape_weights(img), w)
    ks, slot = S.STAGE_BYTES // es, S.CHUNK * S.STAGE_BYTES
    nst, chunks = K // ks, N // S.CHUNK
    assert staged.numel() == chunks * L * nst * slot
    for it in (0, 1, nst, nst + 1, chunks * L * nst - 1):
        st, blk = it % nst, it // nst
        layer, chunk = (divmod(blk, chunks) if chained
                        else divmod(blk, L)[::-1])
        want = w[layer, chunk * S.CHUNK:(chunk + 1) * S.CHUNK,
                 st * ks:(st + 1) * ks].contiguous()
        got = staged[it * slot:(it + 1) * slot]
        assert torch.equal(got, stage_matrices(want, ks))
        n, b = 9, 17
        assert got[((n // 8) * 8 + b // 16) * 128 + (n % 8) * 16 + b % 16] \
            == want.view(torch.uint8)[n, b]


@pytest.mark.parametrize("case", ["other_form", "other_weights", "stale",
                                  "short", "bare_bytes"])
def test_an_image_of_other_weights_or_form_is_refused(case):
    """``check_image`` (run before every launch) takes only
    ``stage_shape_weights(w, chained)`` of w as it is now: an image in the
    other form's order, of other weights of the same shape, of w before an
    in-place write, cut short, or bare bytes without the tag each raise;
    the image itself passes."""
    _, w = S.shape_inputs(4, 256, 256, torch.int8,
                          torch.Generator().manual_seed(4), n_tiles=1,
                          n_layers=2, device="cpu")
    img = S.stage_shape_weights(w, False)
    S.check_image(img, w, False)
    bad = {"other_form": lambda: S.stage_shape_weights(w, True),
           "other_weights": lambda: S.stage_shape_weights(w.clone(), False),
           "short": lambda: img._replace(data=img.data[:-16]),
           "bare_bytes": lambda: img.data}
    if case == "stale":
        got = img
        w[0, 0, 0] += 1
    else:
        got = bad[case]()
    with pytest.raises(ValueError):
        S.check_image(got, w, False)


def _kernel_order(x: torch.Tensor, w: torch.Tensor,
                  chained: bool) -> torch.Tensor:
    """``unchained``'s kernel, its sums in the kernel's order on the CPU:
    each product's accumulator takes 16 input channels at a time (bf16:
    one wgmma k16 step; int8: exact in any order), each part's sum exact
    and rounded once to f32 as it is added (an IEEE rounding: the card's
    tensor cores truncate, ROADMAP C); free, the products added to the
    running f32 sum in layer order; chained, each layer's output cast
    before the next; the row sums in float64."""
    h = x
    acc_sum = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for i in range(w.shape[0]):
        hd, wd = h.double(), w[i].double()
        acc = torch.zeros((h.shape[0], wd.shape[0]), dtype=torch.float32)
        for k0 in range(0, h.shape[1], 16):
            acc = (acc.double() + hd[:, k0:k0 + 16]
                   @ wd[:, k0:k0 + 16].T).float()
        if not chained:
            acc_sum = acc_sum + acc
        elif x.dtype == torch.int8:    # the int32 wraps modulo 256
            q = acc.double().long()
            h = ((q + 128) % 256 - 128).to(torch.int8)
        else:
            h = acc.to(torch.bfloat16)
    return (h if chained else acc_sum).double().sum(
        dim=1, keepdim=True).float()


@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_kernel_sum_order_keeps_the_probes_limits(dtype, chained):
    """The kernel's sum order (``_kernel_order``) against the plain version
    at chip_smoke's limits: int8 bit for bit in both forms; bf16 free within
    ``TOL_SHAPES_FREE``; bf16 chained at 4 layers within
    ``TOL_SHAPES_CHAINED_SHALLOW`` with at most ``MAX_SHAPES_DIFFER_SHARE``
    of the rows differing, and equal bit for bit to ``chip_smoke.
    staged_chained_ref`` in 16-channel parts, the reference the card's
    share of differing rows is read beside."""
    L = cs.PROBE_SHAPES_SHALLOW if chained else 8
    x, w = S.shape_inputs(128, 256, 256, dtype,
                          torch.Generator().manual_seed(5), n_tiles=4,
                          n_layers=L, device="cpu")
    got, want = _kernel_order(x, w, chained), S.unchained_ref(x, w, chained)
    if dtype == torch.int8:
        assert torch.equal(got, want)
        return
    d = (got - want).double()
    top = float(want.abs().max())
    rel = (float(d.abs().max()) / top, float(d.pow(2).mean().sqrt()) / top)
    if not chained:
        assert rel[0] <= cs.TOL_SHAPES_FREE[0], rel
        assert rel[1] <= cs.TOL_SHAPES_FREE[1], rel
        return
    assert rel[0] <= cs.TOL_SHAPES_CHAINED_SHALLOW[0], rel
    assert rel[1] <= cs.TOL_SHAPES_CHAINED_SHALLOW[1], rel
    assert float((got != want).double().mean()) \
        <= cs.MAX_SHAPES_DIFFER_SHARE
    assert torch.equal(got, cs.staged_chained_ref(x, w, 16))


def test_mma_rounding_reads_either_engine():
    """``mma_rounding`` names its engine; on the CPU both run the plain
    version and read the same; another engine is refused."""
    a = S.mma_rounding(16, rows=1024, device="cpu")
    b = S.mma_rounding(16, rows=1024, device="cpu", engine="wgmma")
    assert (a.pop("engine"), b.pop("engine")) == ("mma.sync", "wgmma")
    assert a == b
    with pytest.raises(ValueError, match="engine"):
        S.mma_rounding(16, rows=64, device="cpu", engine="hmma")
