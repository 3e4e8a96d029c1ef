// Pieces shared by the tensor-core probe kernels still on the pre-Hopper
// engines (probe_bign.cu, probe_int8_chain.cu; the chain and ResMLP body
// probes moved to wgmma, probe_hopper.cuh): a ray tile's input read from a
// global ray-major [n][256] f32 matrix into shared memory as bf16, and the
// tile's bf16 activations written back as f32. Both are spread over the
// `nthr` threads of a group whose own index is `tid` (the whole block).
#pragma once

#include "r2l_engines.cuh"

namespace r2l {
namespace probe {

constexpr int kW = 256;                       // the probes' width
constexpr int kTT = 64;                       // rays per tile
constexpr int kLdb = 2 * ld_words(kW * 2);    // bf16 elements per row

// dst[r][c] = bf16(x[row0 + r][c]), 0 for rays at or past n.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const float* __restrict__ x,
                                          int row0, int n, int tid,
                                          int nthr) {
  constexpr int kPerRow = kW / 4;
  for (int e = tid; e < kTT * kPerRow; e += nthr) {
    const int r = e / kPerRow, v = e - r * kPerRow;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      f = __ldg(reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * kW) +
                v);
    __nv_bfloat16* d = dst + r * kLdb + 4 * v;
    d[0] = __float2bfloat16_rn(f.x);
    d[1] = __float2bfloat16_rn(f.y);
    d[2] = __float2bfloat16_rn(f.z);
    d[3] = __float2bfloat16_rn(f.w);
  }
}

// out[row0 + r][c] = f32(src[r][c]) for rays below n, 16 bytes per store.
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const __nv_bfloat16* src, int row0,
                                           int n, int tid, int nthr) {
  constexpr int kPerRow = kW / 4;
  for (int e = tid; e < kTT * kPerRow; e += nthr) {
    const int r = e / kPerRow, v = e - r * kPerRow;
    if (row0 + r >= n) continue;
    const __nv_bfloat16* s = src + r * kLdb + 4 * v;
    reinterpret_cast<float4*>(out + (size_t)(row0 + r) * kW)[v] =
        make_float4(__bfloat162float(s[0]), __bfloat162float(s[1]),
                    __bfloat162float(s[2]), __bfloat162float(s[3]));
  }
}

}  // namespace probe
}  // namespace r2l
