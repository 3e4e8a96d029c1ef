// K3: the PE-fused R2L training forward with the activation stash, bf16 or
// f32 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_train_pallas.py::
// train_fwd: K1's chain (positional encoding by the double-angle ladder,
// head Linear+ReLU, nb two-layer ResMLP blocks, global residual,
// Linear+sigmoid tail) that also writes the stash [2nb+1, N, W] in the
// compute dtype: rows 0..nb hold the block inputs h_0 .. h_nb (h_nb is the
// body output before the global residual), row nb+1+b holds block b's
// post-ReLU inner activation t_b. Rounding points are train_fwd's: biases
// added in f32 before the cast, the block output (t2 * res_scale + h) in f32
// from the unrounded t2, then cast.
//
// Design: K1's Hopper chain (r2l_hopper.cuh, its kTrain instance): 128 rays
// a block in bf16 (two consumer warpgroups on wgmma m64nWk16), 64 in f32
// (one, 3xTF32), the weights bulk-copied from an image staged once per
// training step (r2l_train.py: stage_chain_weights of the live weights)
// through a ring the two blocks of a cluster share. The epilogues store the
// stash rows from the registers with no barrier (bf16: 16 bytes a thread
// after a transpose within the quad), streaming out behind the next
// layer's products. f32 is 3xTF32 with each weight stage's products summed
// apart and added in f32: the tensor cores truncate every sum they add to,
// and summed by them alone the deep stash rows read 7.8e-5 from true f32,
// over the 1e-5 limit; summed apart, 6.2e-6 to 6.9e-6 over four seeds of
// the weights.
//
// What bounds it: 11.8 MFLOP per ray, 0.97 TFLOP for a canonical step's
// 81,920 rays (0.98 ms at 989 bf16 TFLOP/s; f32 as 3xTF32 5.85 ms at 495
// TF32 TFLOP/s, 14.4 ms on the CUDA cores), and the stash write: 3.65 GB
// bf16 (1.09 ms at 3.35 TB/s), 7.3 GB f32 (2.18 ms). bf16 is bytes-bound,
// f32 bound by its products. The parent design (K1's pre-Hopper
// engines: 64- or 32-ray tiles, one per SM, the stash slabs copied after a
// block barrier, f32 on the CUDA cores) took 5.998 ms (bf16) and 63.2 ms
// (f32) on an H100 80GB HBM3 at 700 W; PERF.md has this one's runs.
#include "r2l_hopper.cuh"

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// `staged` is the image of stage_chain_weights (r2l_fused.py) of the
// freq-major packing; h0 K1's scratch (h0_elems values of the weight type,
// chain_scratch); stash [2nb+1, n, W] of the weight type. Returns a
// cudaError_t: the launch's own error, cudaErrorLaunchOutOfResources for a
// cluster that cannot be resident, cudaErrorInvalidValue for a shape the
// kernel does not take (W 64, 128 or 256; two layers per block) or a
// scratch too small.
extern "C" int r2l_train_fwd_launch(
    const float* pts, int n, int dp, int L, const void* staged,
    const float* head_b, const float* body_b, const void* tail_w,
    const float* tail_b, float* out, void* h0, long long h0_elems,
    void* stash, int W, int nb, int out_dim, float res_scale,
    int use_residual, int linear_tail, int weight_is_f32, void* stream) {
  if (dp <= 0 || L <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(stash) & 15)
    return cudaErrorMisalignedAddress;
  r2lh::Args a = {};
  a.in = pts; a.n = n; a.dp = dp; a.L = L; a.in_dim = dp * (2 * L + 1);
  a.staged = static_cast<const unsigned char*>(staged);
  a.head_b = head_b; a.body_b = body_b; a.tail_w = tail_w;
  a.tail_b = tail_b; a.out = out; a.h0 = h0; a.stash = stash;
  a.nb = nb; a.nl = 2; a.out_dim = out_dim; a.res_scale = res_scale;
  a.use_residual = use_residual; a.linear_tail = linear_tail;
  return r2lh::launch<true, true>(a, W, weight_is_f32, h0_elems,
                                  static_cast<cudaStream_t>(stream));
}
