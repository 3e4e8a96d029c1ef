// One mma.sync's f32 rounding, read through the pre-Hopper free bf16 form
// of the shape probe (r2l_tpu_torch/exp/probe_shapes.py::mma_rounding).
//
// The shape probe (exp/probe_shapes.py::run_shape, its body
// unchained_kernel) runs on wgmma since probe_shapes.cu's redesign; this
// file keeps its free bf16 form on K1's pre-Hopper engine (EngineBF16<256,
// 64>, mma.sync m16n8k16, f32 accumulation) as an instrument only: a fixed
// input x [rows, K] bf16 against n_layers weight matrices W_i [K, N] bf16,
// packed [out, in] as [n_layers, N, K]; out [rows] f32, the sum over N (in
// float64, rounded once) of the f32 sum, in layer order, of f32(x W_i).
// With every weight 0 but a few of one output column, each row's output is
// that column's mma.sync accumulator: how one mma.sync (and two in turn)
// rounds its f32 sum.
//
// Design: 256 threads on a tile of 64 rows; the tile of x stays in shared
// memory; the N columns go 256 at a time, each chunk through every W_i with
// its running f32 sum in registers. What bounds it is of no interest here
// (rows * K * N * n_layers multiply-adds; mma.sync reaches a quarter of the
// card's bf16 rate, PERF.md).
#include "r2l_engines.cuh"

namespace {

using namespace r2l;

constexpr int kTT = 64;     // rows per tile
constexpr int kNC = 256;    // output columns per chunk
using E = EngineBF16<kNC, kTT>;
using M = MmaMap<kNC, kTT>;

__global__ void __launch_bounds__(kThreads, 1)
    probe_mma_sync_kernel(const __nv_bfloat16* __restrict__ x, int n, int K,
                          int N, const __nv_bfloat16* __restrict__ w,
                          int n_layers, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = ld_words(K * 2) * 2;   // bf16 elements per tile row
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + (size_t)kTT * ld * 2);
  const int row0 = blockIdx.x * kTT;
  const int pieces = K * 2 / 16;   // 16-byte pieces per row
  for (int e = threadIdx.x; e < kTT * pieces; e += kThreads) {
    const int r = e / pieces, p = e - r * pieces;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * K) +
                p);
    reinterpret_cast<uint4*>(X + r * ld)[p] = v;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4;
  E::Acc dot;

  // per chunk of 256 columns, the running f32 sum over the layers; then
  // each thread's part of each of its rows in float64.
  double part[M::MT][2] = {};
  for (int c0 = 0; c0 < N; c0 += kNC) {
    float acc[M::MT][M::NT][4] = {};
    for (int i = 0; i < n_layers; ++i) {
      E::mm(dot, X, ld, w + ((size_t)i * N + c0) * K, K, Ws);
#pragma unroll
      for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[mt][nt][u] = __fadd_rn(acc[mt][nt][u], dot.v[mt][nt][u]);
    }
#pragma unroll
    for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < M::NT; ++nt) {
        part[mt][0] += (double)acc[mt][nt][0] + (double)acc[mt][nt][1];
        part[mt][1] += (double)acc[mt][nt][2] + (double)acc[mt][nt][3];
      }
  }
  // The four lanes of a row group, then the eight warps (each owns 32
  // columns of every chunk) through a table in the stage buffers, free
  // after the last product's closing barrier.
  double* red = reinterpret_cast<double*>(Ws);
#pragma unroll
  for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double v = part[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (lane % 4 == 0) red[(mt * 16 + g + 8 * h) * kWarps + warp] = v;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < kTT; r += kThreads) {
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) s += red[r * kWarps + k];
    if (row0 + r < n) out[row0 + r] = (float)s;
  }
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// x [n, K] and w [n_layers, N, K] bf16, K a multiple of 128 (at most 1,024),
// N of 256. Returns a cudaError_t: the launch's own error, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_mma_sync_launch(const void* x, int n, int K, int N,
                                     const void* w, int n_layers, float* out,
                                     void* stream) {
  if (n <= 0 || n_layers < 1 || K <= 0 || K % 128 || N <= 0 || N % kNC)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15)
    return cudaErrorMisalignedAddress;
  const size_t smem = (size_t)kTT * ld_words(K * 2) * 4 + E::kStageBytes;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      probe_mma_sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  probe_mma_sync_kernel<<<(n + kTT - 1) / kTT, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), n, K, N,
      static_cast<const __nv_bfloat16*>(w), n_layers, out);
  return cudaGetLastError();
}
