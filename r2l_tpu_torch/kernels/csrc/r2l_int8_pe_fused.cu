// K2: the PE-fused static-scale int8 R2L forward.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply_int8_pe through `_int8_pe_chain`, in its deployed form
// fold_requant=True, nobf16_inner=True, with parameters from
// calibrate_r2l_int8_pe(..., fold_requant=True):
//   * each PE part is quantized with its column's inverse scale,
//     q = clip(round_half_even(x * inv), -127, 127);
//   * every matmul is int8 x int8 -> int32, exact;
//   * dequantize in f32 as acc*m + b (no FMA contraction), ReLU on inner
//     layers, whose output is already in the next layer's int8 units
//     (the inverse scale is folded into m and b), so their requantize is
//     round+clip only; the first layer of each block and the tail
//     quantize with their inverse scales;
//   * the block tail is cast to bf16 and added to the bf16 residual stream
//     in f32; h0 stays f32 for the global residual; the tail is int8, then
//     sigmoid.
//
// Design: one thread block owns a tile of 64 rays and keeps it in shared
// memory, ray-major, for all layers: the quantized input [64][in_dim]
// int8, then (aliasing it) h0 (f32), h (bf16) and two int8 activation
// buffers [64][W]. Weights, packed [out, in], are read from global memory
// 128 input channels at a time (the 5.6 MB int8 body of the canonical model
// stays in the 50 MB L2), each step copied by cp.async while the tensor
// cores work on the previous one; n-major rows put 4 k-values in a word,
// so each B fragment register is one 32-bit load. The dots run on
// the tensor cores (mma.sync m16n8k32 s8, exact s32 accumulation); each
// warp owns W/8 output channels of all 64 rays. Only [64, out_dim] f32 is
// written back.
//
// What bounds it: 11.8 M int8 multiply-adds per ray, about 1.89 T
// operations per 400x400 frame, against a few hundred KB of input and
// output, so it is compute-bound. What this simple version leaves on the
// table: wgmma (the only way to the card's 1,979 int8 TOP/s) with TMA-fed
// weight tiles, fewer barriers than two per 128 input channels, and more
// than one ray tile in flight per SM (each tile re-reads the whole weight
// stack from L2).
#include "r2l_common.cuh"

namespace {

using namespace r2l;

constexpr int kTT = 64;  // rays per block

// round-half-even, clip to [-127, 127] (jnp.clip(jnp.round(y), -127, 127))
__device__ __forceinline__ int8_t q8(float y) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}

// acc * m + b, each step rounded on its own.
__device__ __forceinline__ float dequant(int acc, float m, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
}

template <int W>
struct Engine {
  using M = MmaMap<W, kTT>;
  // input channels per weight stage: 128 where the width allows it
  // (halves the barriers; PERF.md), else 64. Divides the padded head.
  static constexpr int kKC = W >= 128 ? 128 : 64;
  static constexpr int kLdw = ld_words(kKC);
  static constexpr size_t kStageBytes = 2 * (size_t)W * kLdw * 4;

  // acc = A W^T for A = smem int8 [64][lda] and W = global int8 [W][K]
  // ([out, in], K a multiple of kKC): the packed rows give n-major stages
  // directly (4 k-values per word), copied by cp.async one stage ahead.
  // Ends with a barrier after the last use of A and the stages.
  __device__ static void mm(int (&acc)[M::MT][M::NT][4], const int8_t* A,
                            int lda, const int8_t* __restrict__ Wg, int K,
                            uint32_t* Ws) {
#pragma unroll
    for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mt][nt][u] = 0;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int n0 = M::n0(), lda32 = lda / 4;
    const uint32_t* A32 = reinterpret_cast<const uint32_t*>(A);
    pipelined_k_loop<W, kKC, kLdw>(
        Wg, (size_t)K, K / kKC, Ws, [&](int st, const uint32_t* buf) {
#pragma unroll
          for (int s = 0; s < kKC / 32; ++s) {
            uint32_t a[M::MT][4];
#pragma unroll
            for (int mt = 0; mt < M::MT; ++mt) {
              const uint32_t* ap =
                  A32 + (mt * 16 + g) * lda32 + st * (kKC / 4) + 8 * s + t;
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
                mma_s8(acc[mt][nt], a[mt], b0, b1);
            }
          }
        });
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads, 1) r2l_int8_pe_fused_kernel(
    const float* __restrict__ pts, int n, int dp, int L,
    const int8_t* __restrict__ head_q, const float* __restrict__ head_m,
    const float* __restrict__ head_b, const float* __restrict__ head_inv,
    const int8_t* __restrict__ body_q, const float* __restrict__ body_m,
    const float* __restrict__ body_b, const float* __restrict__ body_inv,
    const int8_t* __restrict__ tail_q, const float* __restrict__ tail_m,
    const float* __restrict__ tail_b, const float* __restrict__ tail_inv,
    float* __restrict__ out, int nb, int nl, int out_dim, int use_residual,
    int linear_tail, int ldx, size_t region) {
  using E = Engine<W>;
  constexpr int ldh0 = ld_words(W * 4);      // f32 elements per row
  constexpr int ldh = 2 * ld_words(W * 2);   // bf16 elements per row
  constexpr int ldq = 4 * ld_words(W);       // int8 elements per row
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = dp * (2 * L + 1), kpad = round_up(in_dim, kKAlign);
  const int row0 = blockIdx.x * kTT;
  // Region 0: the quantized input X [64][ldx], then (aliasing it) h0 f32,
  // h bf16 and the int8 activations QA, QB, [64][ld] each. Then the
  // transposed weight rows.
  int8_t* X = reinterpret_cast<int8_t*>(smem);
  float* H0 = reinterpret_cast<float*>(smem);
  __nv_bfloat16* H =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)kTT * ldh0 * 4);
  int8_t* QA = reinterpret_cast<int8_t*>(H + kTT * ldh);
  int8_t* QB = QA + kTT * ldq;
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + region);

  // Quantized positional encoding, freq-major (the head rows and head_inv
  // were permuted to match on the host); columns in_dim..kpad are zero.
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

  // QA = the int8 input of what follows h: the first layer of block `blk`
  // quantizes h with its inverse scale; after the last block the tail
  // quantizes h (+ h0, in f32) with its own. A pass of its own: folding it
  // into the block-tail epilogue measured slower (PERF.md).
  auto requant = [&](int blk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTT * W; e += kThreads) {
      const int r = e / W, c = e % W;
      float hv = __bfloat162float(H[r * ldh + c]);
      float inv;
      if (blk < nb) {
        inv = body_inv[(size_t)blk * nl * W + c];
      } else {
        if (use_residual) hv = __fadd_rn(hv, H0[r * ldh0 + c]);
        inv = tail_inv[c];
      }
      QA[r * ldq + c] = q8(__fmul_rn(hv, inv));
    }
    __syncthreads();
  };

  int acc[E::M::MT][E::M::NT][4];
  E::mm(acc, X, ldx, head_q, kpad, Ws);
  E::M::visit(acc, [&](int r, int c, int a) {
    const float v = fmaxf(dequant(a, head_m[c], head_b[c]), 0.f);
    H0[r * ldh0 + c] = v;
    H[r * ldh + c] = __float2bfloat16_rn(v);
  });

  for (int blk = 0; blk < nb; ++blk) {
    requant(blk);
    int8_t* src = QA;
    for (int j = 0; j < nl; ++j) {
      const int idx = blk * nl + j;
      E::mm(acc, src, ldq, body_q + (size_t)idx * W * W, W, Ws);
      const float* m = body_m + (size_t)idx * W;
      const float* b = body_b + (size_t)idx * W;
      if (j < nl - 1) {  // inner: ReLU, then round+clip (scale folded)
        int8_t* dst = src == QA ? QB : QA;
        E::M::visit(acc, [&](int r, int c, int a) {
          dst[r * ldq + c] = q8(fmaxf(dequant(a, m[c], b[c]), 0.f));
        });
        src = dst;
      } else {  // block tail: bf16, + block input in f32, bf16
        E::M::visit(acc, [&](int r, int c, int a) {
          const float t =
              __bfloat162float(__float2bfloat16_rn(dequant(a, m[c], b[c])));
          __nv_bfloat16& h = H[r * ldh + c];
          h = __float2bfloat16_rn(__fadd_rn(t, __bfloat162float(h)));
        });
      }
    }
  }
  requant(nb);

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

template <int W>
cudaError_t launch(const float* pts, int n, int dp, int L,
                   const int8_t* head_q, const float* head_m,
                   const float* head_b, const float* head_inv,
                   const int8_t* body_q, const float* body_m,
                   const float* body_b, const float* body_inv,
                   const int8_t* tail_q, const float* tail_m,
                   const float* tail_b, const float* tail_inv, float* out,
                   int nb, int nl, int out_dim, int use_residual,
                   int linear_tail, cudaStream_t stream) {
  const int kpad = round_up(dp * (2 * L + 1), kKAlign);
  const int ldx = 4 * ld_words(kpad);
  const size_t x_bytes = (size_t)kTT * ldx;
  const size_t act_bytes = (size_t)kTT * (ld_words(W * 4) + ld_words(W * 2) +
                                          2 * ld_words(W)) * 4;
  const size_t region = x_bytes > act_bytes ? x_bytes : act_bytes;
  const size_t smem = region + Engine<W>::kStageBytes;
  auto kern = r2l_int8_pe_fused_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + kTT - 1) / kTT;
  kern<<<grid, kThreads, smem, stream>>>(
      pts, n, dp, L, head_q, head_m, head_b, head_inv, body_q, body_m, body_b,
      body_inv, tail_q, tail_m, tail_b, tail_inv, out, nb, nl, out_dim,
      use_residual, linear_tail, ldx, region);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for a width or depth the kernel does not take.
extern "C" int r2l_int8_pe_fused_launch(
    const float* pts, int n, int dp, int L, const int8_t* head_q,
    const float* head_m, const float* head_b, const float* head_inv,
    const int8_t* body_q, const float* body_m, const float* body_b,
    const float* body_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, int W, int nb,
    int nl, int out_dim, int use_residual, int linear_tail, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || nl < 1 || out_dim < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(head_q) | reinterpret_cast<uintptr_t>(body_q)) & 15 ||
      reinterpret_cast<uintptr_t>(tail_q) & 3)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                            \
  pts, n, dp, L, head_q, head_m, head_b, head_inv, body_q, body_m, body_b,  \
      body_inv, tail_q, tail_m, tail_b, tail_inv, out, nb, nl, out_dim,     \
      use_residual, linear_tail, s
  switch (W) {
    case 64: return launch<64>(R2L_ARGS);
    case 128: return launch<128>(R2L_ARGS);
    case 256: return launch<256>(R2L_ARGS);
  }
#undef R2L_ARGS
  return cudaErrorInvalidValue;
}
