// Pieces shared by the R2L and NeRF kernels: the positional-encoding
// ladder, the int8 quantize and dequantize, the sigmoid, cp.async. The
// pre-Hopper bf16 engine that the mma.sync rounding instrument
// (probe_mma_sync.cu) keeps (its thread layout, mma.sync, its k-loop) is in
// r2l_engines.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace r2l {

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The packed weights' input axis is padded to a multiple of this (the
// Python side's K_ALIGN), so every staged slice of a row is whole 16-byte
// pieces.
constexpr int kKAlign = 128;

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// sin/cos of p * 2^j for j in [0, L) by the double-angle recurrence
// (r2l_pallas.py::_pe_sin_cos_ladder): sin 2x = (2 sin x) cos x,
// cos 2x = 1 - (2 sin x) sin x, every product rounded on its own (no FMA
// contraction), so the result matches the plain PyTorch version bit for
// bit. emit(j, sin, cos) receives each octave.
template <typename Emit>
__device__ __forceinline__ void pe_ladder(float p, int L, Emit emit) {
  float s = sinf(p), c = cosf(p);
  emit(0, s, c);
  for (int j = 1; j < L; ++j) {
    const float s2 = __fmul_rn(2.0f, s);
    const float ns = __fmul_rn(s2, c);
    c = __fsub_rn(1.0f, __fmul_rn(s2, s));
    s = ns;
    emit(j, s, c);
  }
}

// The plain versions' sigmoid: 1 / (1 + exp(-x)) in f32.
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// round-half-even, clip to [-127, 127] (jnp.clip(jnp.round(y), -127, 127))
__device__ __forceinline__ int8_t q8(float y) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}

// int8 dequantize acc * m + b as one fused multiply-add, rounded once (as
// XLA contracts it, and as the plain versions compute it in float64).
__device__ __forceinline__ float dequant(int acc, float m, float b) {
  return __fmaf_rn(__int2float_rn(acc), m, b);
}

// x rounded to bf16, as f32.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The teacher's dequantize in bf16 (Pallas fused_nerf_render_t's
// bf16_requant): acc to f32, then bf16; m and b rounded to bf16; the
// product rounded to bf16, then the sum: two roundings, never one FMA.
__device__ __forceinline__ float dequant_bf16(int acc, float m, float b) {
  const float p = bf16r(__fmul_rn(bf16r(__int2float_rn(acc)), bf16r(m)));
  return bf16r(__fadd_rn(p, bf16r(b)));
}

}  // namespace r2l
