// K2's PE-fused static-scale int8 R2L forward as it ran before its Hopper
// redesign (r2l_int8_hopper.cuh), kept as the design the probe of its ray
// streams measures (one entry point, r2l_int8_pe_fused.cu), in K2's
// deployed form at width 256.
//
// It computes r2l_tpu/kernels/r2l_pallas.py::_int8_pe_chain:
//   * each PE part is quantized with its column's inverse scale,
//     q = clip(round_half_even(x * inv), -127, 127);
//   * every matmul is int8 x int8 -> int32, exact;
//   * dequantize in f32 as acc*m + b (one fused multiply-add); ReLU on
//     inner layers; the first layer of each block and the tail quantize the
//     residual stream with their inverse scales;
//   * the block tail is cast to bf16 and added to the bf16 residual stream
//     in f32; h0 stays f32 for the global residual; the tail is int8, then
//     sigmoid.
// Its epilogue is K2's deployed one (fold_requant=True, nobf16_inner=True):
// the next inverse scale is folded into m and b, so an inner
// layer's f32 ReLU output is rounded and clipped, no multiply, no bf16.
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
// warp owns W/8 output channels of its rays. Only [64, out_dim] f32 is
// written back.
//
// Streams (exp/probe_pipe_lib.py::apply_int8_pe_streams): with S > 1 the
// block has S teams of 256 threads, team s owning rays [s*64/S,
// (s+1)*64/S) of the tile; the teams share the weight stages and step the
// layers together (StreamTeam), so one team's epilogue can run under
// another's tensor-core work. Rows never mix, so every S gives S = 1's
// output bit for bit. Two 64-ray tiles with their own stages would need
// 418 KB (208,896 bytes each at W=256), far above the 227 KB a block may
// have.
//
// What bounds it: 11.8 M int8 multiply-adds per ray, about 1.89 T
// operations per 400x400 frame, against a few hundred KB of input and
// output, so it is compute-bound. What this simple version leaves on the
// table: wgmma (the only way to the card's 1,979 int8 TOP/s) with TMA-fed
// weight tiles, fewer barriers than two per 128 input channels, and more
// than one ray tile in flight per SM (each tile re-reads the whole weight
// stack from L2).
#pragma once

#include <type_traits>

#include "r2l_engines.cuh"

namespace r2l {
namespace int8chain {

constexpr int kTT = 64;  // rays per block

// input channels per weight stage: 128 where the width allows it (halves
// the barriers; PERF.md), else 64.
template <int W>
using Engine = EngineS8<W, kTT, (W >= 128 ? 128 : 64)>;

template <int S>
using Team = typename std::conditional<S == 1, BlockTeam, StreamTeam<S>>::type;

template <int W, int S>
__global__ void __launch_bounds__(S * kThreads, 1) int8_pe_chain_kernel(
    const float* __restrict__ pts, int n, int dp, int L,
    const int8_t* __restrict__ head_q, const float* __restrict__ head_m,
    const float* __restrict__ head_b, const float* __restrict__ head_inv,
    const int8_t* __restrict__ body_q, const float* __restrict__ body_m,
    const float* __restrict__ body_b, const float* __restrict__ body_inv,
    const int8_t* __restrict__ tail_q, const float* __restrict__ tail_m,
    const float* __restrict__ tail_b, const float* __restrict__ tail_inv,
    float* __restrict__ out, int nb, int nl, int out_dim, int use_residual,
    int linear_tail, int ldx, size_t region) {
  constexpr int kN = S * kThreads;            // threads in the block
  constexpr int kRows = kTT / S;              // rays per team
  using E = EngineS8<W, kRows, Engine<W>::kKC>;
  const Team<S> team;
  const int r0 =   // the team's first ray
      S == 1 ? 0 : (int)(threadIdx.x / kThreads) * kRows;
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
  for (int e = threadIdx.x; e < kTT * dp; e += kN) {
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
  for (int e = threadIdx.x; e < kTT * (kpad - in_dim); e += kN) {
    const int r = e / (kpad - in_dim);
    X[r * ldx + in_dim + e - r * (kpad - in_dim)] = 0;
  }

  // QA = the int8 input of what follows h: the first layer of block `blk`
  // quantizes h with its inverse scale; after the last block the tail
  // quantizes h (+ h0, in f32) with its own. A pass of its own: folding it
  // into the block-tail epilogue measured slower (PERF.md).
  auto requant = [&](int blk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTT * W; e += kN) {
      const int r = e / W, c = e % W;
      float hv = __bfloat162float(H[r * ldh + c]);
      if (blk < nb) {
        const float inv = body_inv[(size_t)blk * nl * W + c];
        QA[r * ldq + c] = q8(__fmul_rn(hv, inv));
      } else {
        if (use_residual) hv = __fadd_rn(hv, H0[r * ldh0 + c]);
        QA[r * ldq + c] = q8(__fmul_rn(hv, tail_inv[c]));
      }
    }
    __syncthreads();
  };

  int acc[E::M::MT][E::M::NT][4];
  E::mm(acc, X + r0 * ldx, ldx, head_q, kpad, Ws, team);
  E::M::visit(acc, [&](int r, int c, int a) {
    const float v = fmaxf(dequant(a, head_m[c], head_b[c]), 0.f);
    H0[(r0 + r) * ldh0 + c] = v;
    H[(r0 + r) * ldh + c] = __float2bfloat16_rn(v);
  }, team);

  for (int blk = 0; blk < nb; ++blk) {
    requant(blk);
    int8_t* src = QA;
    for (int j = 0; j < nl; ++j) {
      const int idx = blk * nl + j;
      E::mm(acc, src + r0 * ldq, ldq, body_q + (size_t)idx * W * W, W, Ws,
            team);
      const float* m = body_m + (size_t)idx * W;
      const float* b = body_b + (size_t)idx * W;
      if (j < nl - 1) {  // inner: ReLU, then the next layer's int8 input
        int8_t* dst = src == QA ? QB : QA;
        E::M::visit(acc, [&](int r, int c, int a) {  // scale folded
          dst[(r0 + r) * ldq + c] = q8(fmaxf(dequant(a, m[c], b[c]), 0.f));
        }, team);
        src = dst;
      } else {  // block tail: bf16, + block input in f32, bf16
        E::M::visit(acc, [&](int r, int c, int a) {
          const float t =
              __bfloat162float(__float2bfloat16_rn(dequant(a, m[c], b[c])));
          __nv_bfloat16& h = H[(r0 + r) * ldh + c];
          h = __float2bfloat16_rn(__fadd_rn(t, __bfloat162float(h)));
        }, team);
      }
    }
  }
  requant(nb);

  const uint32_t* Q32 = reinterpret_cast<const uint32_t*>(QA);
  for (int e = threadIdx.x; e < kTT * out_dim; e += kN) {
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

// Launch one form. Shared memory: the larger of the quantized input and
// the activations, then the two weight stages (208,896 bytes at W=256 and
// the canonical 1,008 inputs, whatever S).
template <int W, int S>
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
  auto kern = int8_pe_chain_kernel<W, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + kTT - 1) / kTT;
  kern<<<grid, S * kThreads, smem, stream>>>(
      pts, n, dp, L, head_q, head_m, head_b, head_inv, body_q, body_m, body_b,
      body_inv, tail_q, tail_m, tail_b, tail_inv, out, nb, nl, out_dim,
      use_residual, linear_tail, ldx, region);
  return cudaGetLastError();
}

// The arguments the C entry points check before any launch: a
// cudaError_t, or cudaSuccess.
inline cudaError_t check_args(int n, int dp, int L, int nb, int nl,
                              int out_dim, const int8_t* head_q,
                              const int8_t* body_q, const int8_t* tail_q) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || nl < 1 || out_dim < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(head_q) |
       reinterpret_cast<uintptr_t>(body_q)) & 15 ||
      reinterpret_cast<uintptr_t>(tail_q) & 3)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace int8chain
}  // namespace r2l

// The arguments of a launch<W, S> call in a C entry point over this
// template, named as its parameters (with `s` the stream).
#define R2L_INT8_CHAIN_ARGS                                                 \
  pts, n, dp, L, head_q, head_m, head_b, head_inv, body_q, body_m, body_b,  \
      body_inv, tail_q, tail_m, tail_b, tail_inv, out, nb, nl, out_dim,     \
      use_residual, linear_tail, s
