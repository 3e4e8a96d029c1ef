// K4 and K8: the PE-fused static-scale int8 R2L training forward, with an
// int8 stash (K4, stash_q=True) or a bf16 one (K8, stash_q=False).
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_train_pallas.py::
// train_fwd_int8, parameters from calibrate_r2l_int8_pe(...,
// fold_requant=False). This is not K2's chain:
//   * both layers of a block quantize their input with its inverse scale,
//     q = clip(round_half_even(x * inv), -127, 127);
//   * every matmul is int8 x int8 -> int32, exact; the dequantize acc*m + b
//     is one fused multiply-add (res_scale is folded into the block tail's
//     m and b);
//   * K4: the residual stream h and the head output h0 stay f32
//     (h = t2 + h), and the stash [2nb+1, N, W] int8 holds the q-values the
//     matmuls consume: row b the block-b input, row nb+1+b the inner
//     activation, row nb the tail input with the global residual folded in;
//   * K8: train_fwd's stash contract in bf16: row 0 h0 and row b+1 the
//     residual stream after block b, rounded to bf16 each block
//     (h = bf16(t2 + h)), row nb+1+b the inner activation rounded to bf16
//     before it is quantized. The global residual adds the f32 h0.
//
// Design: one thread block owns 64 rays in shared memory: the quantized
// input [64][in_dim] int8, then (aliasing it) h0 f32, h (f32 for K4, bf16
// for K8, plus K8's bf16 staging row of the inner activation) and two int8
// activation buffers [64][W]. Weights, packed [out, in], are streamed from
// global memory (the 5.6 MB int8 body stays in the 50 MB L2) 64 input
// channels per stage (the f32 rows leave no room for K2's 128), copied by
// cp.async one stage ahead of the tensor cores (mma.sync m16n8k32 s8).
// After each stashed activation a barrier, then the tile's slab is copied
// from shared memory to its stash row, 16 bytes per thread.
//
// What bounds it: 11.8 M int8 multiply-adds per ray, 0.97 T operations for
// a canonical step's 81,920 rays (0.49 ms at 1,979 int8 TOP/s), and the
// stash write: 1.83 GB int8 (0.55 ms at 3.35 TB/s) or 3.65 GB bf16 (1.09
// ms), so bytes-bound either way. What this simple version leaves on the
// table: K2's (mma.sync, one tile per SM, two barriers per stage), smaller
// weight stages than K2, and stash stores that wait at a barrier.
#include "r2l_engines.cuh"

namespace {

using namespace r2l;

constexpr int kTT = 64;  // rays per block
constexpr int kKC8 = 64;  // input channels per weight stage

template <int W, bool SQ>
__global__ void __launch_bounds__(kThreads, 1) r2l_train_fwd_int8_kernel(
    const float* __restrict__ pts, int n, int dp, int L,
    const int8_t* __restrict__ head_q, const float* __restrict__ head_m,
    const float* __restrict__ head_b, const float* __restrict__ head_inv,
    const int8_t* __restrict__ body_q, const float* __restrict__ body_m,
    const float* __restrict__ body_b, const float* __restrict__ body_inv,
    const int8_t* __restrict__ tail_q, const float* __restrict__ tail_m,
    const float* __restrict__ tail_b, const float* __restrict__ tail_inv,
    float* __restrict__ out, void* __restrict__ stash_v, int nb, int out_dim,
    int use_residual, int linear_tail, int ldx, size_t region) {
  using E = EngineS8<W, kTT, kKC8>;
  using BF = __nv_bfloat16;
  constexpr int ldh = ld_words(W * 4);    // f32 elements per row
  constexpr int ldq = 4 * ld_words(W);    // int8 elements per row
  constexpr int ldb = 2 * ld_words(W * 2);  // bf16 elements per row
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = dp * (2 * L + 1), kpad = round_up(in_dim, kKAlign);
  const int row0 = blockIdx.x * kTT;
  const size_t row_stride = (size_t)n * W;
  int8_t* stash_q = static_cast<int8_t*>(stash_v);
  BF* stash_b = static_cast<BF*>(stash_v);
  // Region 0: the quantized input X [64][ldx], then (aliasing it) h0 f32;
  // h f32 (K4), or h and the inner activation TB bf16 (K8); the int8
  // activations QA, QB. Then the weight stages.
  int8_t* X = reinterpret_cast<int8_t*>(smem);
  float* H0 = reinterpret_cast<float*>(smem);
  float* H = H0 + kTT * ldh;
  BF* HB = reinterpret_cast<BF*>(H);
  BF* TB = HB + kTT * ldb;
  int8_t* QA = SQ ? reinterpret_cast<int8_t*>(H + kTT * ldh)
                  : reinterpret_cast<int8_t*>(TB + kTT * ldb);
  int8_t* QB = QA + kTT * ldq;
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + region);

  // Quantized positional encoding, freq-major, as K2.
  for (int e = threadIdx.x; e < kTT * dp; e += kThreads) {
    const int r = e / dp, s = e - r * dp, g = row0 + r;
    const float p = g < n ? pts[(size_t)g * dp + s] : 0.f;
    int8_t* x = X + r * ldx;
    pe_ladder(p, L, [&](int j, float sn, float cs) {
      const int ks = j * dp + s, kc = (L + j) * dp + s;
      x[ks] = q8(__fmul_rn(sn, head_inv[ks]));
      x[kc] = q8(__fmul_rn(cs, head_inv[kc]));
    });
    const int ki = 2 * L * dp + s;
    x[ki] = q8(__fmul_rn(p, head_inv[ki]));
  }
  for (int e = threadIdx.x; e < kTT * (kpad - in_dim); e += kThreads) {
    const int r = e / (kpad - in_dim);
    X[r * ldx + in_dim + e - r * (kpad - in_dim)] = 0;
  }

  // QA = the int8 input of what follows h: block `blk`'s first layer
  // quantizes h with its inverse scale; after the last block the tail
  // quantizes h (+ h0) with its own. K4 then copies QA to its stash row.
  auto requant = [&](int blk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTT * W; e += kThreads) {
      const int r = e / W, c = e % W;
      float hv = SQ ? H[r * ldh + c] : ld<BF>(HB[r * ldb + c]);
      float inv;
      if (blk < nb) {
        inv = body_inv[(size_t)(2 * blk) * W + c];
      } else {
        if (use_residual) hv = __fadd_rn(hv, H0[r * ldh + c]);
        inv = tail_inv[c];
      }
      QA[r * ldq + c] = q8(__fmul_rn(hv, inv));
    }
    __syncthreads();
    if constexpr (SQ)
      store_tile<int8_t, W, kTT>(stash_q + (size_t)blk * row_stride, QA, ldq,
                                 row0, n);
  };

  int acc[E::M::MT][E::M::NT][4];
  E::mm(acc, X, ldx, head_q, kpad, Ws);
  E::M::visit(acc, [&](int r, int c, int a) {
    const float v = fmaxf(dequant(a, head_m[c], head_b[c]), 0.f);
    H0[r * ldh + c] = v;
    if constexpr (SQ)
      H[r * ldh + c] = v;
    else
      HB[r * ldb + c] = st<BF>(v);
  });
  if constexpr (!SQ) {
    __syncthreads();
    store_tile<BF, W, kTT>(stash_b, HB, ldb, row0, n);  // row 0: h_0
  }

  for (int blk = 0; blk < nb; ++blk) {
    requant(blk);  // K4: stash row blk
    const size_t l1 = (size_t)(2 * blk) * W, l2 = l1 + W;
    E::mm(acc, QA, ldq, body_q + l1 * W, W, Ws);
    E::M::visit(acc, [&](int r, int c, int a) {
      float t = fmaxf(dequant(a, body_m[l1 + c], body_b[l1 + c]), 0.f);
      if constexpr (!SQ) {
        const BF tb = st<BF>(t);
        TB[r * ldb + c] = tb;
        t = ld<BF>(tb);
      }
      QB[r * ldq + c] = q8(__fmul_rn(t, body_inv[l2 + c]));
    });
    __syncthreads();
    if constexpr (SQ)
      store_tile<int8_t, W, kTT>(stash_q + (size_t)(nb + 1 + blk) * row_stride,
                                 QB, ldq, row0, n);
    else
      store_tile<BF, W, kTT>(stash_b + (size_t)(nb + 1 + blk) * row_stride, TB,
                             ldb, row0, n);
    E::mm(acc, QB, ldq, body_q + l2 * W, W, Ws);
    E::M::visit(acc, [&](int r, int c, int a) {
      const float t2 = dequant(a, body_m[l2 + c], body_b[l2 + c]);
      if constexpr (SQ) {
        float& h = H[r * ldh + c];
        h = __fadd_rn(t2, h);
      } else {
        BF& h = HB[r * ldb + c];
        h = st<BF>(__fadd_rn(t2, ld<BF>(h)));
      }
    });
    if constexpr (!SQ) {
      __syncthreads();
      store_tile<BF, W, kTT>(stash_b + (size_t)(blk + 1) * row_stride, HB, ldb,
                             row0, n);  // row blk+1: h_{blk+1}
    }
  }
  requant(nb);  // the tail input (K4: stash row nb)

  const uint32_t* Q32 = reinterpret_cast<const uint32_t*>(QA);
  for (int e = threadIdx.x; e < kTT * out_dim; e += kThreads) {
    const int r = e % kTT, o = e / kTT, g = row0 + r;
    int s = 0;
    for (int kq = 0; kq < W / 4; ++kq)
      s = __dp4a((int)Q32[r * (ldq / 4) + kq],
                 (int)ldg32(tail_q + (size_t)o * W + 4 * kq), s);
    float v = dequant(s, tail_m[o], tail_b[o]);
    if (!linear_tail) v = sigmoid(v);
    if (g < n) out[(size_t)g * out_dim + o] = v;
  }
}

template <int W, bool SQ>
cudaError_t launch(const float* pts, int n, int dp, int L,
                   const int8_t* head_q, const float* head_m,
                   const float* head_b, const float* head_inv,
                   const int8_t* body_q, const float* body_m,
                   const float* body_b, const float* body_inv,
                   const int8_t* tail_q, const float* tail_m,
                   const float* tail_b, const float* tail_inv, float* out,
                   void* stash, int nb, int out_dim, int use_residual,
                   int linear_tail, cudaStream_t stream) {
  const int kpad = round_up(dp * (2 * L + 1), kKAlign);
  const int ldx = 4 * ld_words(kpad);
  const size_t x_bytes = (size_t)kTT * ldx;
  const size_t h_words = SQ ? ld_words(W * 4) : 2 * ld_words(W * 2);
  const size_t act_bytes =
      (size_t)kTT * (ld_words(W * 4) + h_words + 2 * ld_words(W)) * 4;
  const size_t region = x_bytes > act_bytes ? x_bytes : act_bytes;
  const size_t smem = region + EngineS8<W, kTT, kKC8>::kStageBytes;
  auto kern = r2l_train_fwd_int8_kernel<W, SQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + kTT - 1) / kTT;
  kern<<<grid, kThreads, smem, stream>>>(
      pts, n, dp, L, head_q, head_m, head_b, head_inv, body_q, body_m, body_b,
      body_inv, tail_q, tail_m, tail_b, tail_inv, out, stash, nb, out_dim,
      use_residual, linear_tail, ldx, region);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// stash: int8 with stash_q (K4), bf16 without (K8). Returns a cudaError_t:
// the launch's own error, or cudaErrorInvalidValue for a width or depth the
// kernel does not take (two layers per block).
extern "C" int r2l_train_fwd_int8_launch(
    const float* pts, int n, int dp, int L, const int8_t* head_q,
    const float* head_m, const float* head_b, const float* head_inv,
    const int8_t* body_q, const float* body_m, const float* body_b,
    const float* body_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, void* stash,
    int W, int nb, int out_dim, int use_residual, int linear_tail,
    int stash_q, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || out_dim < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(head_q) | reinterpret_cast<uintptr_t>(body_q) |
       reinterpret_cast<uintptr_t>(stash)) & 15 ||
      reinterpret_cast<uintptr_t>(tail_q) & 3)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                            \
  pts, n, dp, L, head_q, head_m, head_b, head_inv, body_q, body_m, body_b,  \
      body_inv, tail_q, tail_m, tail_b, tail_inv, out, stash, nb, out_dim,  \
      use_residual, linear_tail, s
  if (stash_q) {
    switch (W) {
      case 64: return launch<64, true>(R2L_ARGS);
      case 128: return launch<128, true>(R2L_ARGS);
      case 256: return launch<256, true>(R2L_ARGS);
    }
  } else {
    switch (W) {
      case 64: return launch<64, false>(R2L_ARGS);
      case 128: return launch<128, false>(R2L_ARGS);
      case 256: return launch<256, false>(R2L_ARGS);
    }
  }
#undef R2L_ARGS
  return cudaErrorInvalidValue;
}
