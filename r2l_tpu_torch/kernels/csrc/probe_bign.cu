// Probe: the bf16 chain at N=512 (does a wider product lift K1's engine?).
//
// Replaces the Pallas TPU kernel exp/probe_mxu.py::make_bign (its body
// bign_kernel): x [N, 256] f32, rounded to bf16, through n_pairs pairs
//   a = bf16(relu(h W1_p^T))   [T, 512]
//   h = bf16(relu(a W2_p^T))   [T, 256]
// with bf16 weights packed [out, in] (W1 [n_pairs, 512, 256], W2
// [n_pairs, 256, 512]), then f32 [N, 256]. JAX asks a bf16 accumulation;
// as in probe_chain.cu the port sums in f32 and rounds once.
//
// Design: K1's engine (EngineBF16<256, 64>, mma.sync m16n8k16, 64 input
// channels per cp.async stage). The 512-wide product is two 256-wide
// halves, one per call of the engine (rows 0-255 and 256-511 of W1_p), so
// the accumulator stays K1's 64 registers a thread; the second product runs
// K = 512 deep. 256 threads own a 64-ray tile: h [64][256] and a [64][512]
// bf16 and the weight stages, 170 KB of shared memory, one tile per SM;
// ptxas (-Xptxas=-v, CUDA 12.8) reports 152 registers a thread, no spill.
//
// What bounds it: 2 * 2 * 256 * 512 multiply-adds per ray and pair, 3.69
// TFLOP for the probe's 163,840 rays x 43 pairs, against 336 MB of f32
// input and output: 3.735 ms at the data-sheet 989 bf16 TFLOP/s,
// compute-bound.
#include "probe_common.cuh"

namespace {

using namespace r2l;
using namespace r2l::probe;

using E = EngineBF16<kW, kTT>;
constexpr int kLda = 2 * ld_words(2 * kW * 2);  // bf16 elements per row of a
constexpr size_t kHBytes = (size_t)kTT * kLdb * 2;
constexpr size_t kABytes = (size_t)kTT * kLda * 2;

__global__ void __launch_bounds__(kThreads, 1)
    probe_bign_kernel(const float* __restrict__ x, int n,
                      const __nv_bfloat16* __restrict__ w1,
                      const __nv_bfloat16* __restrict__ w2,
                      float* __restrict__ out, int n_pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + kHBytes);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + kHBytes + kABytes);
  const int row0 = blockIdx.x * kTT;
  load_tile(H, x, row0, n, threadIdx.x, kThreads);
  E::Acc acc;
  for (int p = 0; p < n_pairs; ++p) {
    for (int half = 0; half < 2; ++half) {
      E::mm(acc, H, kLdb, w1 + ((size_t)(2 * p + half) * kW) * kW, kW, Ws);
      __nv_bfloat16* a = A + half * kW;
      E::visit(acc, [&](int r, int c, float v) {
        a[r * kLda + c] = st<__nv_bfloat16>(fmaxf(v, 0.f));
      });
    }
    // in place on h: this product reads only a
    E::mm(acc, A, kLda, w2 + (size_t)p * kW * 2 * kW, 2 * kW, Ws);
    E::visit(acc, [&](int r, int c, float v) {
      H[r * kLdb + c] = st<__nv_bfloat16>(fmaxf(v, 0.f));
    });
  }
  __syncthreads();
  store_tile(out, H, row0, n, threadIdx.x, kThreads);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int probe_bign_launch(const float* x, int n, const void* w1,
                                 const void* w2, float* out, int n_pairs,
                                 void* stream) {
  if (n <= 0 || n_pairs < 1) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out)) &
      15)
    return cudaErrorMisalignedAddress;
  const size_t smem = kHBytes + kABytes + E::kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      probe_bign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  probe_bign_kernel<<<(n + kTT - 1) / kTT, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, n, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), out, n_pairs);
  return cudaGetLastError();
}
