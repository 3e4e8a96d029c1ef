// K3: the PE-fused R2L training forward with the activation stash, bf16 or
// f32 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_train_pallas.py::
// train_fwd: K1's chain (positional encoding by the double-angle ladder,
// head Linear+ReLU, nb two-layer ResMLP blocks, global residual,
// Linear+sigmoid tail) that also writes the stash [2nb+1, N, W] in the
// compute dtype: rows 0..nb hold the block inputs h_0 .. h_nb (h_nb is the
// body output before the global residual), row nb+1+b holds block b's
// post-ReLU inner activation t_b. Rounding points are train_fwd's: biases
// added in f32 before the cast, the block output (t2 * res_scale + h) in f32
// from the unrounded t2, then cast.
//
// Design: K1's engines (r2l_engines.cuh) and K1's ray tile (64 rays for
// bf16, 32 for f32) with all activations in shared memory; after each
// epilogue a barrier, then the tile's [TT, W] slab is copied from shared
// memory to its stash row, 16 bytes per thread (the slab of a tile is one
// contiguous piece of the row).
//
// What bounds it: 11.8 MFLOP per ray, 0.97 TFLOP for a canonical step's
// 81,920 rays (0.98 ms at 989 bf16 TFLOP/s), and the 3.65 GB bf16 stash
// write (1.09 ms at 3.35 TB/s): about 1.1 ms, bytes-bound. What this simple
// version leaves on the table: K1's (mma.sync, one tile per SM, two
// barriers per weight stage), plus stash stores that wait at a barrier
// instead of streaming out behind the next layer (TMA stores would).
#include "r2l_engines.cuh"

namespace {

using namespace r2l;

template <typename E, int W, int TT>
__global__ void __launch_bounds__(kThreads, 1) r2l_train_fwd_kernel(
    const float* __restrict__ pts, int n, int dp, int L,
    const typename E::T* __restrict__ head_w,
    const float* __restrict__ head_b,
    const typename E::T* __restrict__ body_w,
    const float* __restrict__ body_b,
    const typename E::T* __restrict__ tail_w,
    const float* __restrict__ tail_b, float* __restrict__ out,
    typename E::T* __restrict__ stash, int nb, int out_dim, float res_scale,
    int use_residual, int linear_tail, int ldx, int ldb, size_t region) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = dp * (2 * L + 1), kpad = round_up(in_dim, kKAlign);
  const int row0 = blockIdx.x * TT;
  const size_t row_stride = (size_t)n * W;  // elements per stash row
  // Region 0: the encoded input X [TT][ldx], then (aliasing it) h0, h and
  // the inner activation, [TT][ldb] each. Then the weight stages.
  T* X = reinterpret_cast<T*>(smem);
  T* H0 = X;
  T* H = X + TT * ldb;
  T* B1 = X + 2 * TT * ldb;
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + region);

  // Positional encoding, freq-major, as K1.
  for (int e = threadIdx.x; e < TT * dp; e += kThreads) {
    const int r = e / dp, s = e - r * dp, g = row0 + r;
    const float p = g < n ? pts[(size_t)g * dp + s] : 0.f;
    T* x = X + r * ldx + s;
    pe_ladder(p, L, [&](int j, float sn, float cs) {
      x[j * dp] = st<T>(sn);
      x[(L + j) * dp] = st<T>(cs);
    });
    x[2 * L * dp] = st<T>(p);
  }
  for (int e = threadIdx.x; e < TT * (kpad - in_dim); e += kThreads) {
    const int r = e / (kpad - in_dim);
    X[r * ldx + in_dim + e - r * (kpad - in_dim)] = st<T>(0.f);
  }

  typename E::Acc acc;
  E::mm(acc, X, ldx, head_w, kpad, Ws);
  E::visit(acc, [&](int r, int c, float v) {
    const T h = st<T>(fmaxf(__fadd_rn(v, head_b[c]), 0.f));
    H0[r * ldb + c] = h;
    H[r * ldb + c] = h;
  });
  __syncthreads();
  store_tile<T, W, TT>(stash, H0, ldb, row0, n);  // row 0: h_0

  for (int blk = 0; blk < nb; ++blk) {
    const float* b1 = body_b + (size_t)(2 * blk) * W;
    const float* b2 = b1 + W;
    E::mm(acc, H, ldb, body_w + (size_t)(2 * blk) * W * W, W, Ws);
    E::visit(acc, [&](int r, int c, float v) {
      B1[r * ldb + c] = st<T>(fmaxf(__fadd_rn(v, b1[c]), 0.f));
    });
    __syncthreads();
    store_tile<T, W, TT>(stash + (size_t)(nb + 1 + blk) * row_stride, B1, ldb,
                         row0, n);  // row nb+1+blk: t_blk
    E::mm(acc, B1, ldb, body_w + (size_t)(2 * blk + 1) * W * W, W, Ws);
    E::visit(acc, [&](int r, int c, float v) {
      T& h = H[r * ldb + c];
      h = st<T>(__fadd_rn(__fmul_rn(__fadd_rn(v, b2[c]), res_scale), ld<T>(h)));
    });
    __syncthreads();
    store_tile<T, W, TT>(stash + (size_t)(blk + 1) * row_stride, H, ldb, row0,
                         n);  // row blk+1: h_{blk+1}
  }
  __syncthreads();  // the last stash copy has read H

  if (use_residual) {
    for (int e = threadIdx.x; e < TT * W; e += kThreads) {
      const int i = (e / W) * ldb + e % W;
      H[i] = st<T>(__fadd_rn(ld<T>(H[i]), ld<T>(H0[i])));
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < TT * out_dim; e += kThreads) {
    const int r = e % TT, o = e / TT, g = row0 + r;
    float s = 0.f;
    for (int k = 0; k < W; ++k)
      s = fmaf(ld<T>(H[r * ldb + k]), ld<T>(tail_w[o * W + k]), s);
    float v = __fadd_rn(s, tail_b[o]);
    if (!linear_tail) v = sigmoid(v);
    if (g < n) out[(size_t)g * out_dim + o] = v;
  }
}

template <typename E, int W, int TT>
cudaError_t launch(const float* pts, int n, int dp, int L, const void* head_w,
                   const float* head_b, const void* body_w,
                   const float* body_b, const void* tail_w,
                   const float* tail_b, float* out, void* stash, int nb,
                   int out_dim, float res_scale, int use_residual,
                   int linear_tail, cudaStream_t stream) {
  using T = typename E::T;
  constexpr int per_word = 4 / sizeof(T);
  const int kpad = round_up(dp * (2 * L + 1), kKAlign);
  const int ldx = ld_words(kpad * sizeof(T)) * per_word;
  const int ldb = ld_words(W * sizeof(T)) * per_word;
  const size_t x_bytes = (size_t)TT * ldx * sizeof(T);
  const size_t buf_bytes = 3 * (size_t)TT * ldb * sizeof(T);
  const size_t region = x_bytes > buf_bytes ? x_bytes : buf_bytes;
  const size_t smem = region + E::kStageBytes;
  auto kern = r2l_train_fwd_kernel<E, W, TT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + TT - 1) / TT;
  kern<<<grid, kThreads, smem, stream>>>(
      pts, n, dp, L, static_cast<const T*>(head_w), head_b,
      static_cast<const T*>(body_w), body_b, static_cast<const T*>(tail_w),
      tail_b, out, static_cast<T*>(stash), nb, out_dim, res_scale,
      use_residual, linear_tail, ldx, ldb, region);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for a width or depth the kernel does not take (two layers per block).
extern "C" int r2l_train_fwd_launch(
    const float* pts, int n, int dp, int L, const void* head_w,
    const float* head_b, const void* body_w, const float* body_b,
    const void* tail_w, const float* tail_b, float* out, void* stash, int W,
    int nb, int out_dim, float res_scale, int use_residual, int linear_tail,
    int weight_is_f32, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || out_dim < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(head_w) | reinterpret_cast<uintptr_t>(body_w) |
       reinterpret_cast<uintptr_t>(stash)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                          \
  pts, n, dp, L, head_w, head_b, body_w, body_b, tail_w, tail_b, out,     \
      stash, nb, out_dim, res_scale, use_residual, linear_tail, s
  if (weight_is_f32) {
    switch (W) {
      case 64: return launch<EngineF32<64, 32>, 64, 32>(R2L_ARGS);
      case 128: return launch<EngineF32<128, 32>, 128, 32>(R2L_ARGS);
      case 256: return launch<EngineF32<256, 32>, 256, 32>(R2L_ARGS);
    }
  } else {
    switch (W) {
      case 64: return launch<EngineBF16<64, 64>, 64, 64>(R2L_ARGS);
      case 128: return launch<EngineBF16<128, 64>, 128, 64>(R2L_ARGS);
      case 256: return launch<EngineBF16<256, 64>, 256, 64>(R2L_ARGS);
    }
  }
#undef R2L_ARGS
  return cudaErrorInvalidValue;
}
