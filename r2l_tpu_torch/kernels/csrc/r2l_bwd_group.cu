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
// in parallel, and the sums are kept deterministic without atomics: pass 1
// (the dh walk) writes every layer's output grad to a scratch (f32 weights:
// and each ray tile's column sums to a partial of db); pass 2 sums
// dW = G^T A (bf16 weights: and db = G^T 1) over ranges of rays; pass 3
// adds the ranges' and the tiles' partials in a fixed order. Two runs of the same inputs give bit-identical dh, dW and db. The
// passes and their design are in r2l_bwd_hopper.cuh.
//
// What bounds it: 4*N*W^2 FLOP per layer (the dh product and the dW
// product), 1.85 TFLOP for the 86 layers of a canonical step's 81,920 rays
// (1.87 ms at 989 bf16 TFLOP/s); per 4-block call 0.172 TFLOP (0.174 ms).
// The scratch design moves 1.34 GB per such call (dh in and out, the stash
// rows of the mask, dt written and read back, the layer inputs), 0.40 ms at
// 3.35 TB/s: that, not the products, is its floor.
#include "r2l_bwd_hopper.cuh"

namespace {

using r2lbh::Args1;

template <typename T, int W, typename S>
cudaError_t launch_w(const Args1& a, const void* stash_h, float* part,
                     float* dw, float* db, int splits, cudaStream_t s) {
  return r2lbh::launch<T, W, S>(a, stash_h, part, dw, db, splits, s);
}

template <typename T, typename S>
cudaError_t launch_t(const Args1& a, int W, const void* stash_h, float* part,
                     float* dw, float* db, int splits, cudaStream_t s) {
  switch (W) {
    case 64: return launch_w<T, 64, S>(a, stash_h, part, dw, db, splits, s);
    case 128: return launch_w<T, 128, S>(a, stash_h, part, dw, db, splits, s);
    case 256: return launch_w<T, 256, S>(a, stash_h, part, dw, db, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: the step's image of every body layer's W^T (stage_bwd_weights),
// from the group's first layer on; stash_h and stash_t: the group's stash
// rows of block inputs and inner activations, [cnt][n][W] each, in the
// weight type or, with stash_bf16, bf16 under f32 weights; scale: their
// [2cnt][W] dequant scales (int8 stash) or null. Scratch: dts [2cnt][n][W]
// in the weight type, dbp [max(ceil(n/64), splits)][2cnt][W] f32, part
// [splits][2cnt][W][W] f32. Returns a cudaError_t: a launch's own error, or
// cudaErrorInvalidValue for a width or a combination the kernels do not
// take.
extern "C" int r2l_bwd_group_launch(
    const void* staged, const void* stash_h, const void* stash_t,
    const float* scale, const float* dh_in, float* dh_out, void* dts,
    float* dbp, float* part, float* dw, float* db, int n, int W, int cnt,
    float res_scale, int weight_is_f32, int stash_bf16, int splits,
    void* stream) {
  if (n <= 0 || cnt < 1 || splits < 1 || (weight_is_f32 && scale) ||
      (stash_bf16 && !weight_is_f32))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(staged) |
       reinterpret_cast<uintptr_t>(stash_h) |
       reinterpret_cast<uintptr_t>(stash_t) | reinterpret_cast<uintptr_t>(dts) |
       reinterpret_cast<uintptr_t>(dh_in) | reinterpret_cast<uintptr_t>(dh_out) |
       reinterpret_cast<uintptr_t>(part)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args1 a{};
  a.staged = static_cast<const unsigned char*>(staged);
  a.stash_t = stash_t;
  a.scale = scale;
  a.dh_in = dh_in;
  a.dh_out = dh_out;
  a.dts = dts;
  a.dbp = dbp;
  a.n = n;
  a.cnt = cnt;
  a.res_scale = res_scale;
  using BF = __nv_bfloat16;
#define R2L_ARGS a, W, stash_h, part, dw, db, splits, s
  if (weight_is_f32 && stash_bf16) return launch_t<float, BF>(R2L_ARGS);
  if (weight_is_f32) return launch_t<float, float>(R2L_ARGS);
  if (scale) return launch_t<BF, int8_t>(R2L_ARGS);
  return launch_t<BF, BF>(R2L_ARGS);
#undef R2L_ARGS
}
