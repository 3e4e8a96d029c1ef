// Probe: the static-scale int8 chain of K2's engine, with no head, tail or
// encoding.
//
// Replaces the Pallas TPU kernel exp/probe_mxu.py::make_int8 (its body
// int8_kernel): x [N, 256] f32, rounded to bf16, through n_layers layers
//   q = clip(round_half_even(f32(h) * inv_s), -127, 127)     int8
//   h = bf16(relu(f32(q Wq_i^T) * s_i))                       int32 dot
// with int8 weights packed [out, in] and one f32 scale per output column,
// then f32 [N, 256]. Every step rounds as the plain version does (an exact
// int32 dot, one f32 product, round-half-even), so the two agree bit for
// bit.
//
// Design: K2's engine (EngineS8<256, 64, 128>, mma.sync m16n8k32 s8, 128
// input channels per cp.async stage). 256 threads own a 64-ray tile; the
// epilogue writes the next layer's int8 input in place over this layer's
// (the engine ends with a barrier after its last read of it), and the last
// layer's bf16 output to a bf16 tile: 122 KB of shared memory.
//
// What bounds it: 256 * 256 int8 multiply-adds per ray and layer, 1.85 T
// operations for the probe's 163,840 rays x 86 layers, against 336 MB of
// f32 input and output: 0.933 ms at the data-sheet 1,979 int8 TOP/s,
// compute-bound.
#include "probe_common.cuh"

namespace {

using namespace r2l;
using namespace r2l::probe;

using E = EngineS8<kW, kTT, 128>;
constexpr int kLdq = 4 * ld_words(kW);   // int8 elements per row
constexpr size_t kQBytes = (size_t)kTT * kLdq;
constexpr size_t kHBytes = (size_t)kTT * kLdb * 2;

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
  load_tile(H, x, row0, n, threadIdx.x, kThreads);
  __syncthreads();
  for (int e = threadIdx.x; e < kTT * kW; e += kThreads) {
    const int r = e / kW, c = e % kW;
    Q[r * kLdq + c] = q8(__fmul_rn(__bfloat162float(H[r * kLdb + c]), inv_s));
  }
  int acc[E::M::MT][E::M::NT][4];
  for (int i = 0; i < n_layers; ++i) {
    E::mm(acc, Q, kLdq, wq + (size_t)i * kW * kW, kW, Ws);
    const float* si = s + (size_t)i * kW;
    const bool last = i == n_layers - 1;
    E::M::visit(acc, [&](int r, int c, int a) {
      const __nv_bfloat16 h = __float2bfloat16_rn(
          fmaxf(__fmul_rn(__int2float_rn(a), si[c]), 0.f));
      if (last)
        H[r * kLdb + c] = h;
      else
        Q[r * kLdq + c] = q8(__fmul_rn(__bfloat162float(h), inv_s));
    });
  }
  __syncthreads();
  store_tile(out, H, row0, n, threadIdx.x, kThreads);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int probe_int8_chain_launch(const float* x, int n,
                                       const int8_t* wq, const float* s,
                                       float inv_s, float* out, int n_layers,
                                       void* stream) {
  if (n <= 0 || n_layers < 1) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  const size_t smem = kQBytes + kHBytes + E::kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      probe_int8_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  probe_int8_chain_kernel<<<(n + kTT - 1) / kTT, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, n, wq, s, inv_s, out, n_layers);
  return cudaGetLastError();
}
