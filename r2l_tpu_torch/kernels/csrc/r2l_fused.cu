// K9: the R2L forward on an encoded input, bf16 or f32 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply (its `_kernel` + `_kernel_body`): x [N, in_dim] f32 (the
// positional encoding done outside, in `r2l_embed`'s per-scalar order, no
// row permutation) -> rounded once to the weight type -> head Linear+ReLU
// -> nb ResMLP blocks -> global residual -> Linear+sigmoid tail ->
// [N, out_dim] f32, with K1's rounding points (r2l_chain.cuh).
//
// Design: K1's, with the encoding phase replaced by a load of x. One thread
// block owns a tile of TT rays (64 for bf16, 32 for f32): its [TT, in_dim]
// slab of x is one contiguous piece of device memory, read coalesced (16
// bytes per thread where in_dim is a multiple of 4) straight from the
// unpadded input: no padded copy is made, the columns up to the head's
// multiple of 128 are zeroed in shared memory. Then r2l_chain.cuh runs the
// chain with every activation in shared memory.
//
// What bounds it: 11.8 MFLOP per ray as K1, about 1.89 TFLOP per 400x400
// frame, against 0.65 GB of f32 input (0.19 ms at 3.35 TB/s), so it is
// compute-bound. What it leaves on the table: K1's (mma.sync, one ray tile
// per SM, two barriers per weight stage).
#include "r2l_chain.cuh"

namespace {

using namespace r2l;

template <typename E, int W, int TT>
__global__ void __launch_bounds__(kThreads, 1) r2l_fused_kernel(
    const float* __restrict__ x, int in_dim,
    const ChainParams<typename E::T> p, int ldx, int ldb, size_t region) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = round_up(in_dim, kKAlign);
  const int row0 = blockIdx.x * TT;
  const int rows = min(TT, p.n - row0);
  T* X = reinterpret_cast<T*>(smem);

  const float* src = x + (size_t)row0 * in_dim;
  if ((in_dim & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int q = in_dim / 4;  // 16-byte pieces per row
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int e = threadIdx.x; e < TT * q; e += kThreads) {
      const int r = e / q;
      const float4 v =
          r < rows ? __ldg(src4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      T* d = X + r * ldx + 4 * (e - r * q);
      d[0] = st<T>(v.x);
      d[1] = st<T>(v.y);
      d[2] = st<T>(v.z);
      d[3] = st<T>(v.w);
    }
  } else {
    for (int e = threadIdx.x; e < TT * in_dim; e += kThreads) {
      const int r = e / in_dim;
      X[r * ldx + e - r * in_dim] = st<T>(r < rows ? src[e] : 0.f);
    }
  }
  for (int e = threadIdx.x; e < TT * (kpad - in_dim); e += kThreads) {
    const int r = e / (kpad - in_dim);
    X[r * ldx + in_dim + e - r * (kpad - in_dim)] = st<T>(0.f);
  }
  r2l_chain<E, W, TT>(smem, p, kpad, ldx, ldb, region, row0);
}

template <typename E, int W, int TT>
cudaError_t launch(const float* x, int n, int in_dim, const void* head_w,
                   const float* head_b, const void* body_w,
                   const float* body_b, const void* tail_w,
                   const float* tail_b, float* out, int nb, int nl,
                   int out_dim, float res_scale, int use_residual,
                   int linear_tail, cudaStream_t stream) {
  using T = typename E::T;
  const ChainLayout c = chain_layout<E, W, TT>(round_up(in_dim, kKAlign), nl);
  auto kern = r2l_fused_kernel<E, W, TT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return err;
  const ChainParams<T> p{static_cast<const T*>(head_w), head_b,
                         static_cast<const T*>(body_w), body_b,
                         static_cast<const T*>(tail_w), tail_b, out, n, nb,
                         nl, out_dim, res_scale, use_residual, linear_tail};
  const int grid = (n + TT - 1) / TT;
  kern<<<grid, kThreads, c.smem, stream>>>(x, in_dim, p, c.ldx, c.ldb,
                                          c.region);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for a width or depth the kernel does not take.
extern "C" int r2l_fused_launch(
    const float* x, int n, int in_dim, const void* head_w,
    const float* head_b, const void* body_w, const float* body_b,
    const void* tail_w, const float* tail_b, float* out, int W, int nb,
    int nl, int out_dim, float res_scale, int use_residual, int linear_tail,
    int weight_is_f32, void* stream) {
  if (n <= 0 || in_dim <= 0 || nb < 0 || nl < 1 || out_dim < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(head_w) | reinterpret_cast<uintptr_t>(body_w)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                          \
  x, n, in_dim, head_w, head_b, body_w, body_b, tail_w, tail_b, out, nb,  \
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
