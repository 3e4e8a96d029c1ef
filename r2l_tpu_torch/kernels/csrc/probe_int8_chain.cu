// Probe: the static-scale int8 chain of K2's engine, with no head, tail or
// encoding, in three modes.
//
// Replaces two Pallas TPU kernels, x [N, 256] f32 -> [N, 256] f32 through
// n_layers int8 layers with int8 weights packed [out, in]:
//   static    exp/probe_mxu.py::make_int8 (its body int8_kernel) and
//             exp/probe_wall.py::make's `realistic` mode: x rounded to
//             bf16, then per layer
//               q = clip(round_half_even(f32(h) * inv_s), -127, 127)
//               h = bf16(relu(f32(q Wq_i^T) * s_i))        int32 dot
//             and f32(h);
//   mxu_only  exp/probe_wall.py::make's `mxu_only`: one
//             q = clip(round_half_even(x * inv_s), -127, 127) of the f32
//             input, every layer's int32 dot of that q summed in int32,
//             f32 of the sum (at most 86 * 256 * 127 * 4 < 2^24: exact);
//   mincast   `mincast`: q as in mxu_only, then per layer
//             q = int8(dot >> 8), an arithmetic shift and a wrapping cast
//             (as XLA's convert), and f32(q).
// Every step rounds as the plain version does (exact int32 dots, one f32
// product, round-half-even), so the two agree bit for bit.
//
// Design: K2's engine (EngineS8<256, 64, 128>, mma.sync m16n8k32 s8, 128
// input channels per cp.async stage). 256 threads own a 64-ray tile; the
// epilogue writes the next layer's int8 input in place over this layer's
// (the engine ends with a barrier after its last read of it), and the last
// layer's bf16 output to a bf16 tile: 122 KB of shared memory. mxu_only
// keeps its int32 sum beside the accumulators in registers; mxu_only and
// mincast write their last layer straight to global memory.
//
// What bounds it: 256 * 256 int8 multiply-adds per ray and layer, 1.85 T
// operations for the probes' 163,840 rays x 86 layers, against 336 MB of
// f32 input and output: 0.933 ms at the data-sheet 1,979 int8 TOP/s,
// compute-bound.
#include "probe_common.cuh"

namespace {

using namespace r2l;
using namespace r2l::probe;

enum Mode { kStatic = 0, kMxuOnly = 1, kMincast = 2 };

using E = EngineS8<kW, kTT, 128>;
constexpr int kLdq = 4 * ld_words(kW);   // int8 elements per row
constexpr size_t kQBytes = (size_t)kTT * kLdq;
constexpr size_t kHBytes = (size_t)kTT * kLdb * 2;

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    probe_int8_chain_kernel(const float* __restrict__ x, int n,
                            const int8_t* __restrict__ wq,
                            const float* __restrict__ s, float inv_s,
                            float* __restrict__ out, int n_layers) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Q = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + kQBytes + kHBytes);
  const int row0 = blockIdx.x * kTT;
  if (kMode == kStatic) {
    load_tile(H, x, row0, n, threadIdx.x, kThreads);
    __syncthreads();
    for (int e = threadIdx.x; e < kTT * kW; e += kThreads) {
      const int r = e / kW, c = e % kW;
      Q[r * kLdq + c] =
          q8(__fmul_rn(__bfloat162float(H[r * kLdb + c]), inv_s));
    }
  } else {  // the f32 input quantized as it is
    for (int e = threadIdx.x; e < kTT * kW; e += kThreads) {
      const int r = e / kW, c = e % kW;
      const float v = row0 + r < n ? x[(size_t)(row0 + r) * kW + c] : 0.f;
      Q[r * kLdq + c] = q8(__fmul_rn(v, inv_s));
    }
  }
  int acc[E::M::MT][E::M::NT][4];
  int sum[E::M::MT][E::M::NT][4] = {};
  // rows of the tile past n are skipped where a mode writes global memory
  auto put = [&](int r, int c, float v) {
    if (row0 + r < n) out[(size_t)(row0 + r) * kW + c] = v;
  };
  for (int i = 0; i < n_layers; ++i) {
    E::mm(acc, Q, kLdq, wq + (size_t)i * kW * kW, kW, Ws);
    const bool last = i == n_layers - 1;
    if (kMode == kStatic) {
      const float* si = s + (size_t)i * kW;
      E::M::visit(acc, [&](int r, int c, int a) {
        const __nv_bfloat16 h = __float2bfloat16_rn(
            fmaxf(__fmul_rn(__int2float_rn(a), si[c]), 0.f));
        if (last)
          H[r * kLdb + c] = h;
        else
          Q[r * kLdq + c] = q8(__fmul_rn(__bfloat162float(h), inv_s));
      });
    } else if (kMode == kMxuOnly) {
#pragma unroll
      for (int mt = 0; mt < E::M::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < E::M::NT; ++nt)
#pragma unroll
          for (int u = 0; u < 4; ++u) sum[mt][nt][u] += acc[mt][nt][u];
    } else {
      E::M::visit(acc, [&](int r, int c, int a) {
        const int8_t q = static_cast<int8_t>(a >> 8);   // wraps mod 256
        if (last)
          put(r, c, static_cast<float>(q));
        else
          Q[r * kLdq + c] = q;
      });
    }
  }
  if (kMode == kStatic) {
    __syncthreads();
    store_tile(out, H, row0, n, threadIdx.x, kThreads);
  } else if (kMode == kMxuOnly) {
    E::M::visit(sum, [&](int r, int c, int a) {
      put(r, c, __int2float_rn(a));
    });
  }
}

template <int kMode>
cudaError_t launch(const float* x, int n, const int8_t* wq, const float* s,
                   float inv_s, float* out, int n_layers,
                   cudaStream_t stream) {
  const size_t smem = kQBytes + kHBytes + E::kStageBytes;
  auto kern = probe_int8_chain_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(n + kTT - 1) / kTT, kThreads, smem, stream>>>(x, n, wq, s, inv_s,
                                                        out, n_layers);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// mode: 0 static, 1 mxu_only, 2 mincast (s unused, may be null, in the
// last two). Returns a cudaError_t: the launch's own error, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_int8_chain_launch(const float* x, int n,
                                       const int8_t* wq, const float* s,
                                       float inv_s, float* out, int n_layers,
                                       int mode, void* stream) {
  if (n <= 0 || n_layers < 1 || (mode == kStatic && s == nullptr))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kStatic:
      return launch<kStatic>(x, n, wq, s, inv_s, out, n_layers, st);
    case kMxuOnly:
      return launch<kMxuOnly>(x, n, wq, s, inv_s, out, n_layers, st);
    case kMincast:
      return launch<kMincast>(x, n, wq, s, inv_s, out, n_layers, st);
  }
  return cudaErrorInvalidValue;
}
