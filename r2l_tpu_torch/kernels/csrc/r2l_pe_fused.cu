// K1: the PE-fused R2L forward, bf16 or f32 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply_pe (its `kern` + `_kernel_body`): raw sample points
// [N, dim_pts] f32 -> positional encoding by the double-angle ladder ->
// head Linear+ReLU -> nb ResMLP blocks (Linear-ReLU-Linear, x res_scale,
// + block input) -> global residual -> Linear+sigmoid tail -> [N, out_dim]
// f32. Activations are rounded to the weight type between layers; dots
// accumulate in f32; biases are added in f32 before the rounding, as in
// `_kernel_body` (not as in `apply_r2l`, which rounds the dot first).
//
// Design: one thread block owns a tile of TT rays (64 for bf16, 32 for
// f32) and keeps all of its activations in shared memory, ray-major, for
// every layer: the encoded input [TT][in_dim], then h0, h and the inner
// activation [TT][W] each (aliasing the encoded input once the head has
// consumed it). Weights, packed [out, in], are read one layer at a time
// from global memory, 64 input channels per step, into shared memory; with
// bf16 weights each step is copied by cp.async while the tensor cores work
// on the previous one. The 11.3 MB bf16 body of the canonical model stays
// resident in the 50 MB L2 across blocks. Only
// [TT, out_dim] f32 is written back. With bf16 weights the dots run on the
// tensor cores (mma.sync m16n8k16, f32 accumulation; each warp owns W/8
// output channels of all 64 rays); with f32 weights, on scalar FMAs (the
// f32 instance checks the algorithm tightly).
//
// What bounds it: 11.8 MFLOP per ray, about 1.89 TFLOP per 400x400 frame,
// against a few hundred KB of input and output, so it is compute-bound.
// What this simple version leaves on the table: wgmma (the only way to the
// card's 989 bf16 TFLOP/s) with TMA-fed weight tiles, fewer barriers than
// two per 64 input channels, and more than one ray tile in flight per SM
// (each tile re-reads the whole weight stack from L2).
#include "r2l_common.cuh"

namespace {

using namespace r2l;

constexpr int kKC = 64;     // input channels per weight stage (bf16)
constexpr int kKC32 = 32;  // input channels per weight step (f32)

template <typename T> __device__ __forceinline__ float ld(T v);
template <> __device__ __forceinline__ float ld<float>(float v) { return v; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
// Round to T and back: the cast to the compute dtype.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return ld<T>(st<T>(v));
}

// f32 weights: scalar FMAs over a TileMap tile; each step's weight rows are
// transposed into shared memory k-major, [kKC32][W], synchronously.
template <int W, int TT>
struct EngineF32 {
  using T = float;
  using M = TileMap<W, TT>;
  struct Acc { float v[M::RM][8]; };
  static constexpr size_t kStageBytes = (size_t)kKC32 * W * 4;

  // acc = A W^T for A = smem [TT][lda] and W = global [W][K] ([out, in],
  // K a multiple of kKC32). Ends with a barrier after the last use of A and
  // the staging buffer.
  __device__ static void mm(Acc& acc, const float* A, int lda,
                            const float* __restrict__ Wg, int K,
                            uint32_t* Ws_) {
    float* Ws = reinterpret_cast<float*>(Ws_);
#pragma unroll
    for (int i = 0; i < M::RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.f;
    const int r0 = M::row(0), c0 = 4 * M::tx();
    for (int k0 = 0; k0 < K; k0 += kKC32) {
      for (int e = threadIdx.x; e < W * kKC32 / 4; e += kThreads) {
        const int n = e % W, kq = e / W;
        const float4 v = __ldg(
            reinterpret_cast<const float4*>(Wg + (size_t)n * K + k0) + kq);
        Ws[(4 * kq) * W + n] = v.x;
        Ws[(4 * kq + 1) * W + n] = v.y;
        Ws[(4 * kq + 2) * W + n] = v.z;
        Ws[(4 * kq + 3) * W + n] = v.w;
      }
      __syncthreads();
      for (int kk = 0; kk < kKC32; ++kk) {
        float a[M::RM];
#pragma unroll
        for (int i = 0; i < M::RM; ++i) a[i] = A[(r0 + i) * lda + k0 + kk];
        const float4 wl = *reinterpret_cast<const float4*>(Ws + kk * W + c0);
        const float4 wh =
            *reinterpret_cast<const float4*>(Ws + kk * W + W / 2 + c0);
        const float w[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
        for (int i = 0; i < M::RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc.v[i][j] = fmaf(a[i], w[j], acc.v[i][j]);
      }
      __syncthreads();
    }
  }

  template <typename F>
  __device__ __forceinline__ static void visit(Acc& acc, F f) {
#pragma unroll
    for (int i = 0; i < M::RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) f(M::row(i), M::col(j), acc.v[i][j]);
  }
};

// bf16 weights: tensor cores (mma.sync m16n8k16, f32 accumulation) over an
// MmaMap tile. The packed [out, in] rows give n-major stages directly
// (pairs of k per word), so each B fragment register is one 32-bit
// shared-memory load, and a stage is a plain cp.async copy.
template <int W, int TT>
struct EngineBF16 {
  using T = __nv_bfloat16;
  using M = MmaMap<W, TT>;
  struct Acc { float v[M::MT][M::NT][4]; };
  static constexpr int kLdw = ld_words(kKC * 2);
  static constexpr size_t kStageBytes = 2 * (size_t)W * kLdw * 4;

  // acc = A W^T for A = smem [TT][lda] and W = global [W][K] ([out, in],
  // K a multiple of kKC). Ends with a barrier after the last use of A and
  // the stages.
  __device__ static void mm(Acc& acc, const T* A, int lda,
                            const T* __restrict__ Wg, int K, uint32_t* Ws) {
#pragma unroll
    for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc.v[mt][nt][u] = 0.f;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int n0 = M::n0(), lda32 = lda / 2;
    const uint32_t* A32 = reinterpret_cast<const uint32_t*>(A);
    pipelined_k_loop<W, kKC * 2, kLdw>(
        Wg, (size_t)K * 2, K / kKC, Ws, [&](int st, const uint32_t* buf) {
#pragma unroll
          for (int s = 0; s < kKC / 16; ++s) {
            uint32_t a[M::MT][4];
#pragma unroll
            for (int mt = 0; mt < M::MT; ++mt) {
              const uint32_t* ap =
                  A32 + (mt * 16 + g) * lda32 + st * (kKC / 2) + 8 * s + t;
              a[mt][0] = ap[0];
              a[mt][1] = ap[8 * lda32];
              a[mt][2] = ap[4];
              a[mt][3] = ap[8 * lda32 + 4];
            }
#pragma unroll
            for (int nt = 0; nt < M::NT; ++nt) {
              const uint32_t* bp = buf + (n0 + nt * 8 + g) * kLdw + 8 * s + t;
              const uint32_t b0 = bp[0], b1 = bp[4];
#pragma unroll
              for (int mt = 0; mt < M::MT; ++mt)
                mma_bf16(acc.v[mt][nt], a[mt], b0, b1);
            }
          }
        });
  }

  template <typename F>
  __device__ __forceinline__ static void visit(Acc& acc, F f) {
    M::visit(acc.v, f);
  }
};

template <typename E, int W, int TT>
__global__ void __launch_bounds__(kThreads, 1) r2l_pe_fused_kernel(
    const float* __restrict__ pts, int n, int dp, int L,
    const typename E::T* __restrict__ head_w,
    const float* __restrict__ head_b,
    const typename E::T* __restrict__ body_w,
    const float* __restrict__ body_b,
    const typename E::T* __restrict__ tail_w,
    const float* __restrict__ tail_b, float* __restrict__ out, int nb,
    int nl, int out_dim, float res_scale, int use_residual, int linear_tail,
    int ldx, int ldb, size_t region) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = dp * (2 * L + 1), kpad = round_up(in_dim, kKAlign);
  const int row0 = blockIdx.x * TT;
  // Region 0: the encoded input X [TT][ldx], then (aliasing it) h0, h and
  // one or two inner activations, [TT][ldb] each. Then the weight rows.
  T* X = reinterpret_cast<T*>(smem);
  T* H0 = X;
  T* H = X + TT * ldb;
  T* B1 = X + 2 * TT * ldb;
  T* B2 = X + 3 * TT * ldb;
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + region);

  // Positional encoding, freq-major: X[r][p*dp + s] is part p (sin octave
  // p, cos octave p-L, or the identity) of scalar s of ray r; the head rows
  // were permuted to match on the host. Columns in_dim..kpad are zero.
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

  for (int blk = 0; blk < nb; ++blk) {
    T* src = H;
    for (int j = 0; j < nl; ++j) {
      const int idx = blk * nl + j;
      E::mm(acc, src, ldb, body_w + (size_t)idx * W * W, W, Ws);
      const float* b = body_b + (size_t)idx * W;
      if (j < nl - 1) {  // inner layer: ReLU, round to T
        T* dst = src == B1 ? B2 : B1;
        E::visit(acc, [&](int r, int c, float v) {
          dst[r * ldb + c] = st<T>(fmaxf(__fadd_rn(v, b[c]), 0.f));
        });
        src = dst;
      } else {  // block tail: round, then (t * res_scale + h) in f32
        T* dst = src == H ? B1 : H;  // in place unless H is the input
        E::visit(acc, [&](int r, int c, float v) {
          const float tv = rnd<T>(__fadd_rn(v, b[c]));
          dst[r * ldb + c] = st<T>(
              __fadd_rn(__fmul_rn(tv, res_scale), ld<T>(H[r * ldb + c])));
        });
        if (dst != H) {
          B1 = H;
          H = dst;
        }
      }
    }
  }
  __syncthreads();

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
                   const float* tail_b, float* out, int nb, int nl,
                   int out_dim, float res_scale, int use_residual,
                   int linear_tail, cudaStream_t stream) {
  using T = typename E::T;
  constexpr int per_word = 4 / sizeof(T);
  const int kpad = round_up(dp * (2 * L + 1), kKAlign);
  const int ldx = ld_words(kpad * sizeof(T)) * per_word;
  const int ldb = ld_words(W * sizeof(T)) * per_word;
  const size_t nbuf = nl >= 3 ? 4 : 3;
  const size_t x_bytes = (size_t)TT * ldx * sizeof(T);
  const size_t buf_bytes = nbuf * TT * ldb * sizeof(T);
  const size_t region = x_bytes > buf_bytes ? x_bytes : buf_bytes;
  const size_t smem = region + E::kStageBytes;
  auto kern = r2l_pe_fused_kernel<E, W, TT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + TT - 1) / TT;
  kern<<<grid, kThreads, smem, stream>>>(
      pts, n, dp, L, static_cast<const T*>(head_w), head_b,
      static_cast<const T*>(body_w), body_b, static_cast<const T*>(tail_w),
      tail_b, out, nb, nl, out_dim, res_scale, use_residual, linear_tail,
      ldx, ldb, region);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for a width or depth the kernel does not take.
extern "C" int r2l_pe_fused_launch(
    const float* pts, int n, int dp, int L, const void* head_w,
    const float* head_b, const void* body_w, const float* body_b,
    const void* tail_w, const float* tail_b, float* out, int W, int nb,
    int nl, int out_dim, float res_scale, int use_residual, int linear_tail,
    int weight_is_f32, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || nl < 1 || out_dim < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(head_w) | reinterpret_cast<uintptr_t>(body_w)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                          \
  pts, n, dp, L, head_w, head_b, body_w, body_b, tail_w, tail_b, out, nb, \
      nl, out_dim, res_scale, use_residual, linear_tail, s
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
