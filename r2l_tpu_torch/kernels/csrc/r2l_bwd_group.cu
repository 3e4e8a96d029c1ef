// K5: the R2L training backward through a group of ResMLP blocks, bf16 or
// f32 weights, with a stash in the weights' type, a bf16 stash under f32
// weights (the int8 forward's bf16 stash, K8), or (body_scale) the int8
// q-value stash.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_train_pallas.py::
// bwd_group. For blocks b_start+cnt-1 .. b_start, top-down, per ray:
//   dt2 = (dh * res_scale).cast(cd)
//   dW[2k+1] += dt2^T t1r,  db[2k+1] += sum dt2          (over all rays)
//   dt1 = (t1 > 0 ? dt2 W2^T : 0).cast(cd)
//   dW[2k]   += dt1^T h_in, db[2k]   += sum dt1
//   dh      += dt1 W1^T                                  (f32)
// With the int8 stash, h_in = (q * scale).cast(cd), t1 = q * scale.
//
// The TPU kernel accumulates dW/db in one output block that its sequential
// grid revisits, so its sums have one fixed order. Here the ray tiles run
// in parallel, and the sums are kept deterministic without atomics:
//   pass 1 (one block per tile of 64 rays, 32 for f32 weights): the dh walk
//     above with K1's engines (the weights transposed, [in][out], so that
//     dt2 W2^T is the engine's A W^T), writing dt2 and dt1 of every layer
//     to a scratch [2cnt, N, W] in the compute dtype and each tile's column
//     sums of them to a per-tile partial of db;
//   passes 2 and 3 (r2l_bwd_dw.cuh, shared with the int8-dL/dx probe
//     r2l_bwd_qdx.cu): dW[l] = G_l^T A_l over all rays (G_l from pass 1,
//     A_l the layer's input from the stash) in ranges of rays, then the
//     ranges' partials of dW and the tiles' partials of db, each summed in
//     a fixed order.
// Two runs of the same inputs give bit-identical dh, dW and db.
//
// What bounds it: 4*N*W^2 FLOP per layer (the dh product and the dW
// product), 1.85 TFLOP for the 86 layers of a canonical step's 81,920 rays
// (1.87 ms at 989 bf16 TFLOP/s); per 4-block call 0.172 TFLOP (0.174 ms).
// What this simple version leaves on the table: the round trip of dt2/dt1
// through device memory (pass 2 could run inside pass 1 with the tile's
// partial dW kept on chip for a persistent block), each pass-2 operand read
// twice (once per 128-wide tile of the other side), mma.sync instead of
// wgmma, and a one-level reduction of the db partials.
#include "r2l_bwd_dw.cuh"

namespace {

using namespace r2l;
using namespace r2l::bwd;

// The mask of the inner ReLU from the stashed activation (its dequantized
// value for the int8 stash).
__device__ __forceinline__ bool live(float v, const float*, int) {
  return v > 0.f;
}
__device__ __forceinline__ bool live(__nv_bfloat16 v, const float*, int) {
  return __bfloat162float(v) > 0.f;
}
__device__ __forceinline__ bool live(int8_t q, const float* sc, int c) {
  return __fmul_rn((float)q, sc[c]) > 0.f;
}

// Pass 1: the dh walk over one ray tile.
template <typename E, int W, int TT, typename S>
__global__ void __launch_bounds__(kThreads, 1) bwd_dh_kernel(
    const typename E::T* __restrict__ w_t, const S* __restrict__ stash_t,
    const float* __restrict__ scale, const float* __restrict__ dh_in,
    float* __restrict__ dh_out, typename E::T* __restrict__ dts,
    float* __restrict__ dbp, int n, int cnt, float res_scale, int ldf,
    int ldb) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * TT;
  const size_t row_stride = (size_t)n * W;
  float* DH = reinterpret_cast<float*>(smem);      // [TT][ldf] f32 dh
  T* DT = reinterpret_cast<T*>(DH + TT * ldf);      // [TT][ldb] dt2 or dt1
  uint32_t* Ws = reinterpret_cast<uint32_t*>(DT + TT * ldb);

  for (int e = threadIdx.x; e < TT * W; e += kThreads) {
    const int r = e / W, c = e % W, g = row0 + r;
    DH[r * ldf + c] = g < n ? dh_in[(size_t)g * W + c] : 0.f;
  }
  // DT is layer l's output grad: to the scratch, and its column sums (rays
  // in order) to this tile's partial of db.
  auto emit = [&](int l) {
    __syncthreads();
    store_tile<T, W, TT>(dts + (size_t)l * row_stride, DT, ldb, row0, n);
    for (int c = threadIdx.x; c < W; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < TT; ++r) s = __fadd_rn(s, ld<T>(DT[r * ldb + c]));
      dbp[((size_t)blockIdx.x * 2 * cnt + l) * W + c] = s;
    }
  };

  typename E::Acc acc;
  for (int k = cnt - 1; k >= 0; --k) {
    __syncthreads();  // DH is whole
    for (int e = threadIdx.x; e < TT * W; e += kThreads) {
      const int r = e / W, c = e % W;
      DT[r * ldb + c] = st<T>(__fmul_rn(DH[r * ldf + c], res_scale));
    }
    emit(2 * k + 1);
    E::mm(acc, DT, ldb, w_t + (size_t)(2 * k + 1) * W * W, W, Ws);
    const S* tk = stash_t + (size_t)k * row_stride;
    const float* sc = scale ? scale + (size_t)(2 * k + 1) * W : nullptr;
    E::visit(acc, [&](int r, int c, float v) {
      const int g = row0 + r;
      const bool on = g < n && live(tk[(size_t)g * W + c], sc, c);
      DT[r * ldb + c] = st<T>(on ? v : 0.f);
    });
    emit(2 * k);
    E::mm(acc, DT, ldb, w_t + (size_t)(2 * k) * W * W, W, Ws);
    E::visit(acc, [&](int r, int c, float v) {
      float& d = DH[r * ldf + c];
      d = __fadd_rn(d, v);
    });
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TT * W; e += kThreads) {
    const int r = e / W, c = e % W, g = row0 + r;
    if (g < n) dh_out[(size_t)g * W + c] = DH[r * ldf + c];
  }
}

template <typename E, int W, int TT, typename S>
cudaError_t launch(const void* w_t, const void* stash_h, const void* stash_t,
                   const float* scale, const float* dh_in, float* dh_out,
                   void* dts, float* dbp, float* part, float* dw, float* db,
                   int n, int cnt, float res_scale, int splits,
                   cudaStream_t stream) {
  using T = typename E::T;
  constexpr int per_word = 4 / sizeof(T);
  const int ldf = ld_words(W * 4);
  const int ldb = ld_words(W * sizeof(T)) * per_word;
  const size_t smem = (size_t)TT * ldf * 4 + (size_t)TT * ldb * sizeof(T) +
                      E::kStageBytes;
  auto kern = bwd_dh_kernel<E, W, TT, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (n + TT - 1) / TT;
  kern<<<ntiles, kThreads, smem, stream>>>(
      static_cast<const T*>(w_t), static_cast<const S*>(stash_t), scale,
      dh_in, dh_out, static_cast<T*>(dts), dbp, n, cnt, res_scale, ldf, ldb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return dw_passes<T, S, W>(dts, stash_h, stash_t, scale, dbp, part, dw, db,
                            n, cnt, splits, ntiles, stream);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// w_t: the group's 2cnt weights, each transposed ([in][out]); stash_h and
// stash_t: the group's stash rows of block inputs and inner activations,
// [cnt][n][W] each, in the weight type or, with stash_bf16, bf16 under f32
// weights; scale: their [2cnt][W] dequant scales (int8 stash) or null. Scratch: dts [2cnt][n][W] in the weight type, dbp [ceil(n/32)]
// [2cnt][W] f32, part [splits][2cnt][W][W] f32. Returns a cudaError_t: a
// launch's own error, or cudaErrorInvalidValue for a width or a combination
// the kernels do not take.
extern "C" int r2l_bwd_group_launch(
    const void* w_t, const void* stash_h, const void* stash_t,
    const float* scale, const float* dh_in, float* dh_out, void* dts,
    float* dbp, float* part, float* dw, float* db, int n, int W, int cnt,
    float res_scale, int weight_is_f32, int stash_bf16, int splits,
    void* stream) {
  if (n <= 0 || cnt < 1 || splits < 1 || (weight_is_f32 && scale) ||
      (stash_bf16 && !weight_is_f32))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w_t) | reinterpret_cast<uintptr_t>(stash_h) |
       reinterpret_cast<uintptr_t>(stash_t) | reinterpret_cast<uintptr_t>(dts) |
       reinterpret_cast<uintptr_t>(part)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                             \
  w_t, stash_h, stash_t, scale, dh_in, dh_out, dts, dbp, part, dw, db, n,    \
      cnt, res_scale, splits, s
  using BF = __nv_bfloat16;
  if (weight_is_f32 && stash_bf16) {
    switch (W) {
      case 64: return launch<EngineF32<64, 32>, 64, 32, BF>(R2L_ARGS);
      case 128: return launch<EngineF32<128, 32>, 128, 32, BF>(R2L_ARGS);
      case 256: return launch<EngineF32<256, 32>, 256, 32, BF>(R2L_ARGS);
    }
  } else if (weight_is_f32) {
    switch (W) {
      case 64: return launch<EngineF32<64, 32>, 64, 32, float>(R2L_ARGS);
      case 128: return launch<EngineF32<128, 32>, 128, 32, float>(R2L_ARGS);
      case 256: return launch<EngineF32<256, 32>, 256, 32, float>(R2L_ARGS);
    }
  } else if (scale) {
    switch (W) {
      case 64: return launch<EngineBF16<64, 64>, 64, 64, int8_t>(R2L_ARGS);
      case 128: return launch<EngineBF16<128, 64>, 128, 64, int8_t>(R2L_ARGS);
      case 256: return launch<EngineBF16<256, 64>, 256, 64, int8_t>(R2L_ARGS);
    }
  } else {
    switch (W) {
      case 64: return launch<EngineBF16<64, 64>, 64, 64, BF>(R2L_ARGS);
      case 128: return launch<EngineBF16<128, 64>, 128, 64, BF>(R2L_ARGS);
      case 256: return launch<EngineBF16<256, 64>, 256, 64, BF>(R2L_ARGS);
    }
  }
#undef R2L_ARGS
  return cudaErrorInvalidValue;
}
