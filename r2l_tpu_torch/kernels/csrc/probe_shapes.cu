// Probe: tensor-core rate by product shape and dtype, unchained or chained.
//
// Replaces the Pallas TPU kernel exp/probe_shapes.py::run_shape (its body
// unchained_kernel): a fixed input x [rows, K] (bf16 or int8) against
// n_layers weight matrices W_i [K, N] of the same type, packed [out, in]
// as [n_layers, N, K]; out [rows] f32:
//   free     acc = sum over i, in layer order, of f32(x W_i) (f32 adds;
//            an int8 dot is an exact int32, below 2^24 for K <= 1024), then
//            the sum of acc over N;
//   chained  (K = N) h = x, then h = cast(h W_i) n_layers times (int8 wraps
//            modulo 256, bf16 rounds to nearest even), then the sum of
//            f32(h) over N.
// The sum over N is taken in float64 and rounded once to f32: for int8 its
// terms are integers below 2^31, so it is exact in any order and the kernel
// equals the plain version bit for bit.
//
// Design: K1's and K2's engines (EngineBF16<256, 64>, EngineS8<256, 64,
// 128>; mma.sync), 256 threads on a tile of 64 rows. The tile of x stays in
// shared memory; the N columns go 256 at a time, each chunk through every
// W_i with its running f32 sum in registers. The row sums go through warp
// shuffles and a [64][8] float64 table in the stage buffers. Chained: two
// [64][K] tiles, one read while the other is written.
//
// What bounds it: rows * K * N * n_layers multiply-adds; at the probe's
// (M, K, N) = (1024, 256, 256), 32,768 rows and 64 layers, 0.275 T
// multiply-adds: 0.278 ms at the data-sheet 989 bf16 TFLOP/s, 0.139 ms at
// 1,979 int8 TOP/s, compute-bound (the 8 MB of bf16 weights stay in L2).
#include "r2l_engines.cuh"

namespace {

using namespace r2l;

constexpr int kTT = 64;     // rows per tile
constexpr int kNC = 256;    // output columns per chunk

template <bool kInt8> struct Dot;

template <> struct Dot<false> {
  using T = __nv_bfloat16;
  using E = EngineBF16<kNC, kTT>;
  static constexpr size_t kStageBytes = E::kStageBytes;
  E::Acc acc;
  __device__ void mm(const T* A, int lda, const T* Wg, int K, uint32_t* Ws) {
    E::mm(acc, A, lda, Wg, K, Ws);
  }
  __device__ float f32(int mt, int nt, int u) const { return acc.v[mt][nt][u]; }
  __device__ T cast(int mt, int nt, int u) const {
    return __float2bfloat16_rn(acc.v[mt][nt][u]);
  }
  __device__ static float val(T v) { return __bfloat162float(v); }
};

template <> struct Dot<true> {
  using T = int8_t;
  using E = EngineS8<kNC, kTT, 128>;
  static constexpr size_t kStageBytes = E::kStageBytes;
  int acc[E::M::MT][E::M::NT][4];
  __device__ void mm(const T* A, int lda, const T* Wg, int K, uint32_t* Ws) {
    E::mm(acc, A, lda, Wg, K, Ws);
  }
  __device__ float f32(int mt, int nt, int u) const {
    return __int2float_rn(acc[mt][nt][u]);
  }
  __device__ T cast(int mt, int nt, int u) const {  // wraps modulo 256
    return static_cast<int8_t>(static_cast<uint8_t>(acc[mt][nt][u] & 0xff));
  }
  __device__ static float val(T v) { return static_cast<float>(v); }
};

using M = MmaMap<kNC, kTT>;

// Row stride (elements) of a [64][K] tile of T.
template <typename T>
__host__ __device__ constexpr int ld_of(int K) {
  return ld_words(K * (int)sizeof(T)) * (4 / (int)sizeof(T));
}

template <bool kInt8, bool kChained>
__global__ void __launch_bounds__(kThreads, 1)
    probe_shapes_kernel(const void* __restrict__ x_, int n, int K, int N,
                        const void* __restrict__ w_, int n_layers,
                        float* __restrict__ out) {
  using D = Dot<kInt8>;
  using T = typename D::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  const int ld = ld_of<T>(K);
  const size_t tile_bytes = (size_t)kTT * ld * sizeof(T);
  T* X[2] = {reinterpret_cast<T*>(smem),
             reinterpret_cast<T*>(smem + tile_bytes)};
  uint32_t* Ws =
      reinterpret_cast<uint32_t*>(smem + (kChained ? 2 : 1) * tile_bytes);
  const int row0 = blockIdx.x * kTT;
  const int pieces = K * (int)sizeof(T) / 16;   // 16-byte pieces per row
  for (int e = threadIdx.x; e < kTT * pieces; e += kThreads) {
    const int r = e / pieces, p = e - r * pieces;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * K) +
                p);
    reinterpret_cast<uint4*>(X[0] + r * ld)[p] = v;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4;
  D dot;

  if (kChained) {
    int cur = 0;
    for (int i = 0; i < n_layers; ++i) {
      for (int c0 = 0; c0 < N; c0 += kNC) {
        dot.mm(X[cur], ld, w + ((size_t)i * N + c0) * K, K, Ws);
        T* dst = X[cur ^ 1] + c0;
#pragma unroll
        for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < M::NT; ++nt) {
            const int r = mt * 16 + g, c = M::n0() + nt * 8 + 2 * (lane % 4);
            dst[r * ld + c] = dot.cast(mt, nt, 0);
            dst[r * ld + c + 1] = dot.cast(mt, nt, 1);
            dst[(r + 8) * ld + c] = dot.cast(mt, nt, 2);
            dst[(r + 8) * ld + c + 1] = dot.cast(mt, nt, 3);
          }
      }
      cur ^= 1;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < kTT; r += kThreads) {
      double s = 0.0;
      for (int k = 0; k < N; ++k) s += (double)D::val(X[cur][r * ld + k]);
      if (row0 + r < n) out[row0 + r] = (float)s;
    }
    return;
  }

  // free: per chunk of 256 columns, the running f32 sum over the layers;
  // then each thread's part of each of its rows in float64.
  double part[M::MT][2] = {};
  for (int c0 = 0; c0 < N; c0 += kNC) {
    float acc[M::MT][M::NT][4] = {};
    for (int i = 0; i < n_layers; ++i) {
      dot.mm(X[0], ld, w + ((size_t)i * N + c0) * K, K, Ws);
#pragma unroll
      for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[mt][nt][u] = __fadd_rn(acc[mt][nt][u], dot.f32(mt, nt, u));
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

template <bool kInt8, bool kChained>
cudaError_t launch(const void* x, int n, int K, int N, const void* w,
                   int n_layers, float* out, cudaStream_t stream) {
  using T = typename Dot<kInt8>::T;
  const size_t smem = (kChained ? 2 : 1) * (size_t)kTT * ld_of<T>(K) *
                          sizeof(T) + Dot<kInt8>::kStageBytes;
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kern = probe_shapes_kernel<kInt8, kChained>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(n + kTT - 1) / kTT, kThreads, smem, stream>>>(x, n, K, N, w,
                                                        n_layers, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// x [n, K] and w [n_layers, N, K] are int8 when is_int8, else bf16; K a
// multiple of 128, N of 256; chained needs K == N and both tiles in shared
// memory (K <= 512 for bf16). Returns a cudaError_t: the launch's own
// error, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_shapes_launch(const void* x, int n, int K, int N,
                                   const void* w, int n_layers, float* out,
                                   int is_int8, int chained, void* stream) {
  if (n <= 0 || n_layers < 1 || K <= 0 || K % 128 || N <= 0 || N % kNC ||
      (chained && K != N))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return chained ? launch<true, true>(x, n, K, N, w, n_layers, out, s)
                   : launch<true, false>(x, n, K, N, w, n_layers, out, s);
  return chained ? launch<false, true>(x, n, K, N, w, n_layers, out, s)
                 : launch<false, false>(x, n, K, N, w, n_layers, out, s);
}
