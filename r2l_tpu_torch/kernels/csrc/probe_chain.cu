// Probe: the bf16 tensor-core chain of K1's engine, with no head, tail or
// encoding.
//
// Replaces the Pallas TPU kernel exp/probe_mxu.py::make_chain (its body
// chain_kernel): x [N, 256] f32, rounded to bf16, through n_layers products
// h <- epi(h W_i^T) with bf16 weights packed [out, in], then f32 [N, 256].
// The epilogue is a compile-time mode:
//   full  f32 accumulation, + bias in f32, ReLU, round to bf16 (K1's inner
//         layer);
//   lean  the dot rounded to bf16, + the bias rounded to bf16 (their sum in
//         f32, rounded to bf16), ReLU;
//   none  the dot rounded to bf16.
// JAX asks `lean` and `none` for a bf16 accumulation
// (preferred_element_type=bf16). Neither mma.sync nor wgmma accumulates in
// bf16, so the port defines both as the f32 sum rounded once to bf16; the
// plain versions (r2l_tpu_torch/exp/probe_mxu.py) compute the same.
//
// Design. Single stream: K1's engine and layout (EngineBF16<256, 64>,
// mma.sync m16n8k16, 64 input channels per cp.async stage, two barriers per
// stage): 256 threads own a 64-ray tile, its activations ping-pong between
// two bf16 buffers in shared memory, 141 KB in all, so one tile runs per SM,
// as in K1. Dual (`dual`, the probe's "G" variant and ROADMAP D's "two ray
// tiles in flight per SM"): 512 threads in two warp groups, each owning one
// half (64 rays) of a 128-ray tile with its own weight stages and its own
// named barrier, walk the layers independently, so one group's epilogue and
// barriers overlap the other's tensor-core work. Each group writes its
// layer outputs in place (the engine ends with a barrier after its last
// read of A), so both fit in 215 KB. Each group runs EngineBF16's mm and
// visit as their team (its thread index and its named barrier): the same
// engine as the single stream, so the same stages, fragments and order of
// sums, and dual equals single bit for bit.
//
// What bounds it: 2 * 256 * 256 multiply-adds per ray and layer, 1.85 TFLOP
// for the probe's 163,840 rays x 86 layers, against 336 MB of f32 input and
// output: 1.867 ms at the data-sheet 989 bf16 TFLOP/s, compute-bound.
#include "probe_common.cuh"

namespace {

using namespace r2l;
using namespace r2l::probe;

enum Mode { kFull = 0, kLean = 1, kNone = 2 };

using E = EngineBF16<kW, kTT>;
constexpr size_t kTileBytes = (size_t)kTT * kLdb * 2;

template <int kMode>
__device__ __forceinline__ __nv_bfloat16 epilogue(float v, const float* b,
                                                  int c) {
  if (kMode == kFull) return st<__nv_bfloat16>(fmaxf(__fadd_rn(v, b[c]), 0.f));
  if (kMode == kLean)
    return st<__nv_bfloat16>(fmaxf(
        __fadd_rn(rnd<__nv_bfloat16>(v), rnd<__nv_bfloat16>(b[c])), 0.f));
  return st<__nv_bfloat16>(v);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    probe_chain_kernel(const float* __restrict__ x, int n,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ out,
                       int n_layers) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* H[2] = {reinterpret_cast<__nv_bfloat16*>(smem),
                         reinterpret_cast<__nv_bfloat16*>(smem + kTileBytes)};
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + 2 * kTileBytes);
  const int row0 = blockIdx.x * kTT;
  load_tile(H[0], x, row0, n, threadIdx.x, kThreads);
  E::Acc acc;
  for (int i = 0; i < n_layers; ++i) {
    __nv_bfloat16* dst = H[(i + 1) & 1];
    E::mm(acc, H[i & 1], kLdb, w + (size_t)i * kW * kW, kW, Ws);
    const float* bi = b + (size_t)i * kW;
    E::visit(acc, [&](int r, int c, float v) {
      dst[r * kLdb + c] = epilogue<kMode>(v, bi, c);
    });
  }
  __syncthreads();
  store_tile(out, H[n_layers & 1], row0, n, threadIdx.x, kThreads);
}

// One of the dual kernel's two warp groups, as the engine's team: its
// thread index and its named barrier (ids 1 and 2; 0 is __syncthreads()).
struct Group {
  static constexpr int kCopyThreads = kThreads;
  int g, t;
  __device__ __forceinline__ int tid() const { return t; }
  __device__ __forceinline__ int ctid() const { return t; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(kThreads) : "memory");
  }
};

template <int kMode>
__global__ void __launch_bounds__(2 * kThreads, 1)
    probe_chain_dual_kernel(const float* __restrict__ x, int n,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ b,
                            float* __restrict__ out, int n_layers) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Group G{(int)threadIdx.x / kThreads, (int)threadIdx.x % kThreads};
  unsigned char* mine = smem + G.g * (kTileBytes + E::kStageBytes);
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(mine);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(mine + kTileBytes);
  const int row0 = (2 * blockIdx.x + G.g) * kTT;
  load_tile(H, x, row0, n, G.tid(), kThreads);
  E::Acc acc;
  for (int i = 0; i < n_layers; ++i) {
    E::mm(acc, H, kLdb, w + (size_t)i * kW * kW, kW, Ws, G);
    const float* bi = b + (size_t)i * kW;
    E::visit(acc, [&](int r, int c, float v) {
      H[r * kLdb + c] = epilogue<kMode>(v, bi, c);
    }, G);
  }
  G.sync();
  store_tile(out, H, row0, n, G.tid(), kThreads);
}

template <int kMode>
cudaError_t launch(const float* x, int n, const __nv_bfloat16* w,
                   const float* b, float* out, int n_layers, int dual,
                   cudaStream_t stream) {
  auto kern = dual ? probe_chain_dual_kernel<kMode> : probe_chain_kernel<kMode>;
  const int threads = dual ? 2 * kThreads : kThreads;
  const size_t smem = dual ? 2 * (kTileBytes + E::kStageBytes)
                           : 2 * kTileBytes + E::kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rays = dual ? 2 * kTT : kTT;
  kern<<<(n + rays - 1) / rays, threads, smem, stream>>>(x, n, w, b, out,
                                                         n_layers);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// mode: 0 full, 1 lean, 2 none; dual: 0 one stream, 1 two warp groups.
// Returns a cudaError_t: the launch's own error, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_chain_launch(const float* x, int n, const void* w,
                                  const float* b, float* out, int n_layers,
                                  int mode, int dual, void* stream) {
  if (n <= 0 || n_layers < 1 || (mode != kNone && b == nullptr))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull: return launch<kFull>(x, n, wb, b, out, n_layers, dual, s);
    case kLean: return launch<kLean>(x, n, wb, b, out, n_layers, dual, s);
    case kNone: return launch<kNone>(x, n, wb, b, out, n_layers, dual, s);
  }
  return cudaErrorInvalidValue;
}
