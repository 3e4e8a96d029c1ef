// K1: the PE-fused R2L forward, bf16 or f32 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply_pe (its `kern` + `_kernel_body`): raw sample points
// [N, dim_pts] f32 -> positional encoding by the double-angle ladder ->
// head Linear+ReLU -> nb ResMLP blocks (Linear-ReLU-Linear, x res_scale,
// + block input) -> global residual -> Linear+sigmoid tail -> [N, out_dim]
// f32. Activations are rounded to the weight type between layers; dots
// accumulate in f32; biases are added in f32 before the rounding, as in
// `_kernel_body` (not as in `apply_r2l`, which rounds the dot first).
//
// Design: one thread block owns a tile of TT rays (64 for bf16, 32 for
// f32), encodes them into shared memory and runs the chain of
// r2l_chain.cuh on them, all activations in shared memory, ray-major, for
// every layer: the encoded input [TT][in_dim], then h0, h and the inner
// activation [TT][W] each (aliasing the encoded input once the head has
// consumed it). Weights, packed [out, in], are read one layer at a time
// from global memory, 64 input channels per step, into shared memory; with
// bf16 weights each step is copied by cp.async while the tensor cores work
// on the previous one. The 11.3 MB bf16 body of the canonical model stays
// resident in the 50 MB L2 across blocks. Only
// [TT, out_dim] f32 is written back. With bf16 weights the dots run on the
// tensor cores (mma.sync m16n8k16, f32 accumulation; each warp owns W/8
// output channels of all 64 rays); with f32 weights, on scalar FMAs (the
// f32 instance checks the algorithm tightly).
//
// What bounds it: 11.8 MFLOP per ray, about 1.89 TFLOP per 400x400 frame,
// against a few hundred KB of input and output, so it is compute-bound.
// What this simple version leaves on the table: wgmma (the only way to the
// card's 989 bf16 TFLOP/s) with TMA-fed weight tiles, fewer barriers than
// two per 64 input channels, and more than one ray tile in flight per SM
// (each tile re-reads the whole weight stack from L2).
#include "r2l_chain.cuh"

namespace {

using namespace r2l;

template <typename E, int W, int TT>
__global__ void __launch_bounds__(kThreads, 1) r2l_pe_fused_kernel(
    const float* __restrict__ pts, int dp, int L,
    const ChainParams<typename E::T> p, int ldx, int ldb, size_t region) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = dp * (2 * L + 1), kpad = round_up(in_dim, kKAlign);
  const int row0 = blockIdx.x * TT;
  T* X = reinterpret_cast<T*>(smem);

  // Positional encoding, freq-major: X[r][p*dp + s] is part p (sin octave
  // p, cos octave p-L, or the identity) of scalar s of ray r; the head rows
  // were permuted to match on the host. Columns in_dim..kpad are zero.
  for (int e = threadIdx.x; e < TT * dp; e += kThreads) {
    const int r = e / dp, s = e - r * dp, g = row0 + r;
    const float v = g < p.n ? pts[(size_t)g * dp + s] : 0.f;
    T* x = X + r * ldx + s;
    pe_ladder(v, L, [&](int j, float sn, float cs) {
      x[j * dp] = st<T>(sn);
      x[(L + j) * dp] = st<T>(cs);
    });
    x[2 * L * dp] = st<T>(v);
  }
  for (int e = threadIdx.x; e < TT * (kpad - in_dim); e += kThreads) {
    const int r = e / (kpad - in_dim);
    X[r * ldx + in_dim + e - r * (kpad - in_dim)] = st<T>(0.f);
  }
  r2l_chain<E, W, TT>(smem, p, kpad, ldx, ldb, region, row0);
}

template <typename E, int W, int TT>
cudaError_t launch(const float* pts, int n, int dp, int L, const void* head_w,
                   const float* head_b, const void* body_w,
                   const float* body_b, const void* tail_w,
                   const float* tail_b, float* out, int nb, int nl,
                   int out_dim, float res_scale, int use_residual,
                   int linear_tail, cudaStream_t stream) {
  using T = typename E::T;
  const ChainLayout c =
      chain_layout<E, W, TT>(round_up(dp * (2 * L + 1), kKAlign), nl);
  auto kern = r2l_pe_fused_kernel<E, W, TT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return err;
  const ChainParams<T> p{static_cast<const T*>(head_w), head_b,
                         static_cast<const T*>(body_w), body_b,
                         static_cast<const T*>(tail_w), tail_b, out, n, nb,
                         nl, out_dim, res_scale, use_residual, linear_tail};
  const int grid = (n + TT - 1) / TT;
  kern<<<grid, kThreads, c.smem, stream>>>(pts, dp, L, p, c.ldx, c.ldb,
                                          c.region);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for a width or depth the kernel does not take.
extern "C" int r2l_pe_fused_launch(
    const float* pts, int n, int dp, int L, const void* head_w,
    const float* head_b, const void* body_w, const float* body_b,
    const void* tail_w, const float* tail_b, float* out, int W, int nb,
    int nl, int out_dim, float res_scale, int use_residual, int linear_tail,
    int weight_is_f32, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || nl < 1 || out_dim < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(head_w) | reinterpret_cast<uintptr_t>(body_w)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                          \
  pts, n, dp, L, head_w, head_b, body_w, body_b, tail_w, tail_b, out, nb, \
      nl, out_dim, res_scale, use_residual, linear_tail, s
  if (weight_is_f32) {
    switch (W) {
      case 64: return launch<EngineF32<64, 32>, 64, 32>(R2L_ARGS);
      case 128: return launch<EngineF32<128, 32>, 128, 32>(R2L_ARGS);
      case 256: return launch<EngineF32<256, 32>, 256, 32>(R2L_ARGS);
    }
  } else {
    switch (W) {
      case 64: return launch<EngineBF16<64, 64>, 64, 64>(R2L_ARGS);
      case 128: return launch<EngineBF16<128, 64>, 128, 64>(R2L_ARGS);
      case 256: return launch<EngineBF16<256, 64>, 256, 64>(R2L_ARGS);
    }
  }
#undef R2L_ARGS
  return cudaErrorInvalidValue;
}
