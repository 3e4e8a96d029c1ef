// What the wide forms share beside the Hopper pass skeleton
// (wide_hopper.cuh): the types and widths, the scratch's alignment, the
// head's input encoded once (train_encode) and the tail's reduction
// (wide_tail). The student frame's wide form (r2l_wide.cu: K1, K9, K2),
// the training forward's (r2l_wide_train.cu: K3, K4/K8) and the teacher's
// (nerf_wide.cu) run every layer as a pass of the skeleton and include this
// header for these.
#pragma once

#include <stddef.h>

#include <type_traits>

#include "r2l_common.cuh"

namespace r2lw {

enum Type { kBF16 = 0, kF32 = 1, kS8 = 2 };

// The widths the wide forms run at are multiples of this (the skeleton's
// 128-wide output tiles); r2l_fused.py's WIDE_CHANNELS.
constexpr int kWideChannels = 128;
constexpr int kMaxOut = 8;  // the tail's outputs

__host__ __device__ constexpr int elem_bytes(int T) {
  return T == kF32 ? 4 : T == kBF16 ? 2 : 1;
}

template <int T>
using Acc = typename std::conditional<T == kS8, int, float>::type;

// A scratch buffer's bytes rounded up to 256 (its TMA maps' base).
__host__ __device__ constexpr long long aligned(long long b) {
  return (b + 255) / 256 * 256;
}

// ---- the head's input -----------------------------------------------------

// Encoding column c's value x in C: f32 as it is, bf16 rounded, int8 the
// code q8(x * inv[c]); past in_dim (inv null) zero.
template <typename C>
__device__ __forceinline__ C head_code(float x, const float* inv, int c);
template <>
__device__ __forceinline__ float head_code<float>(float x, const float*,
                                                  int) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 head_code<__nv_bfloat16>(
    float x, const float*, int) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ int8_t head_code<int8_t>(float x,
                                                    const float* inv, int c) {
  return inv ? r2l::q8(__fmul_rn(x, __ldg(inv + c))) : int8_t(0);
}

// E [n, kp] of C from pts [n, dp] (kp: in_dim = dp (2L + 1) rounded up to
// 128): one thread a (ray, scalar s) runs the ladder (r2l::pe_ladder, bit
// for bit the plain version's values) and writes column part * dp + s of
// its ray for each of the 2L+1 parts (sin octave part, cos octave part - L,
// the identity at 2L: the head's freq-major order), then its share of the
// zero columns past in_dim. A warp's 32 threads write neighbouring columns.
// Its plain twin is r2l_train.py's train_encoding_ref.
template <typename C>
__global__ void __launch_bounds__(256)
    train_encode(const float* __restrict__ pts, long long n, int dp, int L,
                 int kp, const float* inv, C* __restrict__ E) {
  const int in_dim = dp * (2 * L + 1);
  const long long total = n * dp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / dp;
    const int s = (int)(i - r * dp);
    const float v = __ldg(pts + i);
    C* row = E + r * kp;
    r2l::pe_ladder(v, L, [&](int j, float sn, float cs) {
      row[j * dp + s] = head_code<C>(sn, inv, j * dp + s);
      row[(L + j) * dp + s] = head_code<C>(cs, inv, (L + j) * dp + s);
    });
    row[2 * L * dp + s] = head_code<C>(v, inv, 2 * L * dp + s);
    for (int c = in_dim + s; c < kp; c += dp)
      row[c] = head_code<C>(0.f, nullptr, c);
  }
}

// train_encode of n rays into E on stream st.
template <typename C>
cudaError_t encode(const float* pts, long long n, int dp, int L, int kp,
                   const float* inv, void* E, cudaStream_t st) {
  const long long blocks = (n * dp + 255) / 256;
  train_encode<C><<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), 256,
                    0, st>>>(pts, n, dp, L, kp, inv, static_cast<C*>(E));
  return cudaGetLastError();
}

// ---- the tail ---------------------------------------------------------------

// The tail: out[r, o] = sigmoid(h[r] . tail_w[o] + tail_b[o]) (int8: the
// codes' exact int32 dot, dequantized by one FMA); a warp a ray, 16 bytes a
// lane a step, the sums reduced by shuffles. bf16/f32 with h0 (the global
// residual): the input is h + h0 rounded to T.
template <int T>
__global__ void __launch_bounds__(256)
    wide_tail(const void* h, int n, int W, const void* tw, const float* tm,
              const float* tb, int out_dim, int linear_tail, float* out,
              const void* h0 = nullptr) {
  constexpr int es = elem_bytes(T), per = 16 / es;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;
  Acc<T> acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0;
  const unsigned char* hr = static_cast<const unsigned char*>(h) +
                            (size_t)row * W * es;
  const unsigned char* wb = static_cast<const unsigned char*>(tw);
  for (int c = lane * per; c < W; c += 32 * per) {
    const uint4 hv = *reinterpret_cast<const uint4*>(hr + (size_t)c * es);
    uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
    if constexpr (T != kS8) {
      if (h0) {
        const uint4 gv = *reinterpret_cast<const uint4*>(
            static_cast<const unsigned char*>(h0) + ((size_t)row * W + c) * es);
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (T == kBF16) {
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&gw[k]));
            const __nv_bfloat162 r = __floats2bfloat162_rn(
                __fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
            hw[k] = *reinterpret_cast<const uint32_t*>(&r);
          } else {
            hw[k] = __float_as_uint(__fadd_rn(__uint_as_float(hw[k]),
                                              __uint_as_float(gw[k])));
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o >= out_dim) break;
      const uint4 wv = *reinterpret_cast<const uint4*>(
          wb + ((size_t)o * W + c) * es);
      const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (T == kS8) {
          acc[o] = __dp4a(static_cast<int>(hw[k]), static_cast<int>(ww[k]),
                          acc[o]);
        } else if constexpr (T == kBF16) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ww[k]));
          acc[o] = fmaf(a.x, b.x, acc[o]);
          acc[o] = fmaf(a.y, b.y, acc[o]);
        } else {
          acc[o] = fmaf(__uint_as_float(hw[k]), __uint_as_float(ww[k]),
                        acc[o]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o)
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], m);
  if (lane == 0)
    for (int o = 0; o < out_dim; ++o) {
      float y;
      if constexpr (T == kS8)
        y = r2l::dequant(acc[o], tm[o], tb[o]);
      else
        y = __fadd_rn(acc[o], tb[o]);
      out[(size_t)row * out_dim + o] = linear_tail ? y : r2l::sigmoid(y);
    }
}

}  // namespace r2lw
