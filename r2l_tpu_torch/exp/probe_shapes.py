"""Tensor-core rate by product shape and dtype on the H100.

Port of ``exp/probe_shapes.py``: a fixed input ``[32*M, K]`` against 64
weight matrices ``[K, N]`` (int8 or bf16), either unchained (the products
summed, so nothing waits on a previous product) or chained (each product
feeds the next), to separate dependency stalls from shape limits. The
kernel is ``kernels/csrc/probe_shapes.cu`` (replaces ``run_shape``'s
``pallas_call`` of ``unchained_kernel``), on K1's and K2's engines; it picks
its own 64 rows per block, so M only sets the row count.

``unchained`` runs its plain version for a CPU tensor only; for a CUDA
tensor it launches the kernel or raises, and counts the launch in
``.launches``.

    python -m r2l_tpu_torch.exp.probe_shapes [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import argparse

import torch

from ..kernels.r2l_fused import (_check, _mm_f32, _mm_int, _ptr,
                                  _raise_on_error)
from ..kernels.r2l_train import _stream
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


def unchained(x: torch.Tensor, w: torch.Tensor,
              chained: bool = False) -> torch.Tensor:
    """x [rows, K] against the L products with ``w`` [L, N, K] (int8 or
    bf16 like x, packed [out, in]) -> [rows, 1] f32: free, the sum over N
    of the f32 sum of the products; chained (K = N), the sum over N of h
    after h <- cast(h W_i^T) L times. K a multiple of 128, N of 256. CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return unchained_ref(x, w, chained)
    from ..kernels import _build
    dev, (L, N, K) = x.device, w.shape
    if x.dtype not in _NAMES:
        raise TypeError(f"x must be int8 or bf16, got {x.dtype}")
    _check(x, "x", x.dtype, (x.shape[0], K), dev)
    _check(w, "w", x.dtype, (L, N, K), dev)
    if x.shape[0] == 0 or K % 128 or N % 256 or (chained and K != N):
        raise ValueError(f"the kernel takes rows > 0, K % 128 == 0, "
                         f"N % 256 == 0 and, chained, K == N; got "
                         f"{x.shape[0]} rows, K={K}, N={N}")
    out = torch.empty((x.shape[0], 1), dtype=torch.float32, device=dev)
    lib = _build.load("probe_shapes")
    with torch.cuda.device(dev):
        unchained.launches += 1
        rc = lib.probe_shapes_launch(
            _ptr(x), x.shape[0], K, N, _ptr(w), L, _ptr(out),
            int(x.dtype == torch.int8), int(chained), _stream(dev))
    _raise_on_error(rc, "probe_shapes")
    return out


unchained.launches = 0


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
                 device="cuda") -> dict:
    """How one ``mma.sync`` m16n8k16 (bf16 products, f32 accumulator)
    rounds, read through ``unchained``'s free kernel: one product, K=128,
    N=256, every weight 0 but output column 0's first ``k`` inputs (16: one
    mma; 32: two, the second adding to the first's f32 result), so each
    row's output is that column's accumulator (the later mmas and the row
    sum add exact zeros). The inputs span a few binades, as a chain's
    activations do. Against the f32 round-to-nearest of the exact sum
    (for k = 32, of each mma's in turn): the share of rows that differ,
    the largest difference in ulps of the result, the share of those with
    the smaller magnitude, and the largest distance from the exact sum in
    ulps of the largest product."""
    if k not in (16, 32):
        raise ValueError(f"k must be 16 or 32, got {k}")
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((rows, 128), generator=g)
         * torch.exp2(torch.randint(-4, 5, (rows, 128), generator=g).float())
         ).to(torch.bfloat16)
    w = torch.zeros((1, 256, 128), dtype=torch.bfloat16)
    w[0, 0, :k] = torch.randn(k, generator=g).to(torch.bfloat16)
    got = unchained(x.to(device), w.to(device)).cpu()[:, 0].double()
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
    return {"k": k, "rows": rows,
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
    ops = 2.0 * n_tiles * M * K * N * w.shape[0]
    return _harness.time_variant(
        shape_name(M, K, N, dtype, chained),
        lambda i: unchained(torch.roll(x, i, dims=0), w, chained).sum(),
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
