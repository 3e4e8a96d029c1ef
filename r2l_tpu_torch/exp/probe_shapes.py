"""Tensor-core rate by product shape and dtype on the H100.

Port of ``exp/probe_shapes.py``: a fixed input ``[32*M, K]`` against 64
weight matrices ``[K, N]`` (int8 or bf16), either unchained (the products
summed, so nothing waits on a previous product) or chained (each product
feeds the next), to separate dependency stalls from shape limits. The
kernel is ``kernels/csrc/probe_shapes.cu`` (replaces ``run_shape``'s
``pallas_call`` of ``unchained_kernel``) on ``wgmma``, its weights a staged
image (``stage_shape_weights``) bulk-copied into a shared ring; it picks
its own 64 rows per warpgroup, so M only sets the row count.

``mma_rounding`` reads how one tensor-core instruction rounds its f32 sum:
one ``wgmma`` through ``unchained``, or one ``mma.sync`` through the
pre-Hopper free bf16 form kept for that reading alone
(``kernels/csrc/probe_mma_sync.cu``, ``mma_sync_sum``).

``unchained`` and ``mma_sync_sum`` run their plain version for a CPU tensor
only; for a CUDA tensor they launch the kernel or raise, and count the
launch in ``.launches``.

    python -m r2l_tpu_torch.exp.probe_shapes [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse
import torch

from ..kernels.r2l_fused import (_check, _mm_f32, _mm_int, _ptr,
                                  _raise_on_error)
from ..kernels.r2l_train import _stream
from ..kernels.staging import (Image, check_image as _check_image, source,
                               stage_matrices, unstage_matrices)
from . import _harness

N_LAYERS = 64
SEED = 0   # the runner's inputs
# (M, K, N) of the JAX probe's main(), each in int8 and bf16
SHAPES = ((1024, 256, 256), (2048, 256, 256), (1024, 512, 256),
          (1024, 256, 512), (1024, 512, 512), (512, 256, 256),
          (1024, 1024, 256))
# the chained square shapes it then runs in int8: ((M, K, N), n_tiles)
CHAINED = (((1024, 256, 256), 32), ((1024, 512, 512), 16))
_NAMES = {torch.int8: "int8", torch.bfloat16: "bfloat16"}
CHUNK = 128        # the kernel's output columns per product (wgmma's N)
STAGE_BYTES = 128  # bytes of K per weight stage (64 bf16, 128 int8)
ENGINES = ("wgmma", "mma.sync")


def _row_sums(a: torch.Tensor) -> torch.Tensor:
    """[rows, N] -> [rows, 1] f32: the sum over N in float64, rounded once
    (exact for integer terms below 2^31, as the int8 rows' are)."""
    return a.double().sum(dim=1, keepdim=True).float()


def unchained_ref(x: torch.Tensor, w: torch.Tensor,
                  chained: bool = False) -> torch.Tensor:
    """Plain version of ``unchained``: x [rows, K], w [L, N, K] (packed
    [out, in]) of one dtype -> [rows, 1] f32. int8 dots in float64 (exact
    integers, each below 2^24 for K <= 1024, so their f32 is exact too)."""
    L, N, K = w.shape
    int8 = x.dtype == torch.int8
    if chained:
        h = x
        if K == N:
            for i in range(L):
                if int8:     # int32 -> int8 wraps modulo 256
                    acc = (h.double() @ w[i].double().T).long()
                    h = ((acc + 128) % 256 - 128).to(torch.int8)
                else:
                    h = _mm_f32(h, w[i]).to(torch.bfloat16)
        return _row_sums(h)
    acc = torch.zeros((x.shape[0], N), dtype=torch.float32, device=x.device)
    for i in range(L):           # f32 adds in layer order, as JAX's
        acc = acc + (_mm_int(x.double(), w[i]) if int8
                     else _mm_f32(x, w[i]))
    return _row_sums(acc)


def _chunked(w: torch.Tensor, chained: bool) -> torch.Tensor:
    """w [L, N, K] -> the [., CHUNK, K] blocks in the kernel's order: free,
    chunk by chunk of CHUNK outputs, each through every layer; chained,
    layer by layer, each through every chunk."""
    L, N, K = w.shape
    w = w.reshape(L, N // CHUNK, CHUNK, K)
    return w if chained else w.transpose(0, 1)


def stage_shape_weights(w: torch.Tensor, chained: bool) -> Image:
    """The image ``unchained``'s kernel bulk-copies: the weights w
    [L, N, K] (packed [out, in]) as [CHUNK, K] blocks in the kernel's
    order (``_chunked``), each cut into stages of STAGE_BYTES of K laid
    out as ``wgmma`` reads B (``staging.stage_matrices``), tagged with the
    form (``chained``) and w."""
    L, N, K = w.shape
    if N % CHUNK or (K * w.element_size()) % STAGE_BYTES:
        raise ValueError(f"the image takes N % {CHUNK} == 0 and K of whole "
                         f"{STAGE_BYTES}-byte stages; got N={N}, K={K}")
    return Image(stage_matrices(_chunked(w, chained).contiguous(),
                                STAGE_BYTES // w.element_size()),
                 chained, source(w))


def unstage_shape_weights(img: Image) -> torch.Tensor:
    """``stage_shape_weights``' inverse: the image -> w [L, N, K] of the
    shape and type it was staged from."""
    (L, N, K), dtype = img.source[0][2:4]
    es = torch.empty(0, dtype=dtype).element_size()
    lead = (L, N // CHUNK) if img.form else (N // CHUNK, L)
    w = unstage_matrices(img.data, (*lead, CHUNK, K), STAGE_BYTES // es,
                         dtype)[0]
    if not img.form:
        w = w.transpose(0, 1)
    return w.reshape(L, N, K)


def check_image(img: Image, w: torch.Tensor, chained: bool) -> None:
    """Raise ValueError unless ``img`` is ``stage_shape_weights(w,
    chained)`` of w as it is now, whole."""
    _check_image(img, chained, w,
                 what=f"stage_shape_weights(w, chained={chained})")


def _fits(K: int, dtype: torch.dtype, chained: bool) -> bool:
    """One warpgroup's tiles (x, or two of h: 64 rows of K) fit beside the
    kernel's 64 KB ring in a block's 227 KB."""
    return (2 if chained else 1) * K * torch.empty(
        0, dtype=dtype).element_size() <= 2048


def unchained(x: torch.Tensor, w: torch.Tensor, chained: bool = False,
              staged: Image | None = None) -> torch.Tensor:
    """x [rows, K] against the L products with ``w`` [L, N, K] (int8 or
    bf16 like x, packed [out, in]) -> [rows, 1] f32: free, the sum over N
    of the f32 sum of the products; chained (K = N), the sum over N of h
    after h <- cast(h W_i^T) L times. K a multiple of 128 (a bf16 chain at
    most 512, else at most 1,024), N of 128. ``staged`` is
    ``stage_shape_weights(w, chained)`` of w as it is, made here when not
    given (a caller timing the kernel stages once); another form's or
    other weights' image raises. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return unchained_ref(x, w, chained)
    from ..kernels import _build
    dev, (L, N, K) = x.device, w.shape
    if x.dtype not in _NAMES:
        raise TypeError(f"x must be int8 or bf16, got {x.dtype}")
    _check(x, "x", x.dtype, (x.shape[0], K), dev)
    _check(w, "w", x.dtype, (L, N, K), dev)
    if (x.shape[0] == 0 or K % 128 or K > 1024 or N % CHUNK
            or not _fits(K, x.dtype, chained) or (chained and K != N)):
        raise ValueError(f"the kernel takes rows > 0, K % 128 == 0 (at most "
                         f"1024, a bf16 chain 512), N % {CHUNK} == 0 and, "
                         f"chained, K == N; got {x.shape[0]} rows, K={K}, "
                         f"N={N}")
    if staged is None:
        staged = stage_shape_weights(w, chained)
    check_image(staged, w, chained)
    out = torch.empty((x.shape[0], 1), dtype=torch.float32, device=dev)
    lib = _build.load("probe_shapes")
    with torch.cuda.device(dev):
        unchained.launches += 1
        rc = lib.probe_shapes_launch(
            _ptr(x), x.shape[0], K, N, _ptr(staged.data), L, _ptr(out),
            int(x.dtype == torch.int8), int(chained), _stream(dev))
    _raise_on_error(rc, "probe_shapes")
    return out


unchained.launches = 0


def mma_sync_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``unchained``'s free bf16 form on the pre-Hopper ``mma.sync`` engine
    (``kernels/csrc/probe_mma_sync.cu``), kept as ``mma_rounding``'s
    instrument: x [rows, K] bf16, w [L, N, K] bf16 -> [rows, 1] f32. K a
    multiple of 128 (at most 1,024), N of 256. CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return unchained_ref(x, w)
    from ..kernels import _build
    dev, (L, N, K) = x.device, w.shape
    _check(x, "x", torch.bfloat16, (x.shape[0], K), dev)
    _check(w, "w", torch.bfloat16, (L, N, K), dev)
    if x.shape[0] == 0 or K % 128 or K > 1024 or N % 256:
        raise ValueError(f"the kernel takes rows > 0, K % 128 == 0 (at most "
                         f"1024) and N % 256 == 0; got {x.shape[0]} rows, "
                         f"K={K}, N={N}")
    out = torch.empty((x.shape[0], 1), dtype=torch.float32, device=dev)
    lib = _build.load("probe_mma_sync")
    with torch.cuda.device(dev):
        mma_sync_sum.launches += 1
        rc = lib.probe_mma_sync_launch(_ptr(x), x.shape[0], K, N, _ptr(w), L,
                                       _ptr(out), _stream(dev))
    _raise_on_error(rc, "probe_mma_sync")
    return out


mma_sync_sum.launches = 0


def shape_inputs(M: int, K: int, N: int, dtype: torch.dtype,
                 generator: torch.Generator, n_tiles: int = 32,
                 n_layers: int = N_LAYERS, device="cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs from a CPU ``generator``: int8 uniform in
    [-127, 127), or bf16 weights normal x 0.05 and x normal; x
    [n_tiles * M, K], w [n_layers, N, K] (packed [out, in])."""
    rows = n_tiles * M
    if dtype == torch.int8:
        w = torch.randint(-127, 127, (n_layers, N, K), generator=generator,
                          dtype=torch.int8)
        x = torch.randint(-127, 127, (rows, K), generator=generator,
                          dtype=torch.int8)
    else:
        w = (torch.randn((n_layers, N, K), generator=generator) * 0.05
             ).to(dtype)
        x = torch.randn((rows, K), generator=generator).to(dtype)
    return x.to(device), w.to(device)


def mma_rounding(k: int, rows: int = 1 << 16, seed: int = SEED,
                 device="cuda", engine: str = "mma.sync") -> dict:
    """How one tensor-core instruction with bf16 products and an f32
    accumulator rounds its sum: ``engine`` "mma.sync" (m16n8k16, through
    ``mma_sync_sum``) or "wgmma" (m64n128k16, through ``unchained``). One
    product, K=128, N=256, every weight 0 but output column 0's first
    ``k`` inputs (16: one instruction; 32: two, the second adding to the
    first's f32 result), so each row's output is that column's accumulator
    (the later instructions and the row sum add exact zeros). The inputs
    span a few binades, as a chain's activations do. Against the f32
    round-to-nearest of the exact sum (for k = 32, of each instruction's
    in turn): the share of rows that differ,
    the largest difference in ulps of the result, the share of those with
    the smaller magnitude, and the largest distance from the exact sum in
    ulps of the largest product."""
    if k not in (16, 32):
        raise ValueError(f"k must be 16 or 32, got {k}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((rows, 128), generator=g)
         * torch.exp2(torch.randint(-4, 5, (rows, 128), generator=g).float())
         ).to(torch.bfloat16)
    w = torch.zeros((1, 256, 128), dtype=torch.bfloat16)
    w[0, 0, :k] = torch.randn(k, generator=g).to(torch.bfloat16)
    run = mma_sync_sum if engine == "mma.sync" else unchained
    got = run(x.to(device), w.to(device)).cpu()[:, 0].double()
    prods = x[:, :k].double() * w[0, 0, :k].double()
    exact = prods.sum(dim=1)
    rn = exact.float()
    if k == 32:
        rn = (prods[:, :16].sum(dim=1).float().double()
              + prods[:, 16:].sum(dim=1)).float()
    ulp = (torch.nextafter(rn.abs(), torch.tensor(float("inf")))
           - rn.abs()).double()
    top = prods.abs().max(dim=1).values.clamp_min(1e-30)
    ulp_top = torch.exp2(torch.floor(torch.log2(top)) - 23)
    differ = got != rn.double()
    return {"engine": engine, "k": k, "rows": rows,
            "differ_share": float(differ.double().mean()),
            "max_ulp": float(((got - rn.double()) / ulp).abs().max()),
            "smaller_magnitude_share": float(
                (got.abs() < rn.double().abs())[differ].double().mean())
            if bool(differ.any()) else 0.0,
            "max_err_in_top_ulp": float(((got - exact).abs()
                                         / ulp_top).max())}


def shape_name(M: int, K: int, N: int, dtype: torch.dtype,
               chained: bool = False) -> str:
    return (f"{'chain' if chained else 'free'}_{_NAMES[dtype]}_M{M}_K{K}"
            f"_N{N}")


def run_shape(M: int, K: int, N: int, dtype: torch.dtype, log: _harness.Log,
              generator: torch.Generator, n_tiles: int = 32,
              chained: bool = False, device="cuda") -> dict:
    """Time one shape by the probes' protocol; frame i rolls x by i rows
    (as JAX does, so no two frames are the same)."""
    x, w = shape_inputs(M, K, N, dtype, generator, n_tiles, device=device)
    staged = stage_shape_weights(w, chained)
    ops = 2.0 * n_tiles * M * K * N * w.shape[0]
    return _harness.time_variant(
        shape_name(M, K, N, dtype, chained),
        lambda i: unchained(torch.roll(x, i, dims=0), w, chained,
                            staged).sum(),
        log, ops, "int8" if dtype == torch.int8 else "bf16",
        {"M": M, "K": K, "N": N, "rows": n_tiles * M})


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m r2l_tpu_torch.exp.probe_shapes")
    p.add_argument("--out", help="also append the JSON records to this file")
    args = p.parse_args(argv)
    dev = _harness.require_cuda(p.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    g = torch.Generator().manual_seed(SEED)
    for dtype in (torch.int8, torch.bfloat16):
        for M, K, N in SHAPES:
            recs.append(run_shape(M, K, N, dtype, log, g, device=dev))
    for (M, K, N), n_tiles in CHAINED:
        recs.append(run_shape(M, K, N, torch.int8, log, g, n_tiles,
                              chained=True, device=dev))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
