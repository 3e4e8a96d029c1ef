// K1: the PE-fused R2L forward, bf16 or f32 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply_pe (its `kern` + `_kernel_body`): raw sample points
// [N, dim_pts] f32 -> positional encoding by the double-angle ladder ->
// head Linear+ReLU -> nb ResMLP blocks (Linear-ReLU-Linear, x res_scale,
// + block input) -> global residual -> Linear+sigmoid tail -> [N, out_dim]
// f32, with the rounding points of r2l_hopper.cuh.
//
// Design (r2l_hopper.cuh): 128 rays a block in bf16 (two consumer
// warpgroups on wgmma m64nWk16), 64 in f32 (one, on wgmma m64nWk8 tf32 as
// 3xTF32), a producer thread that bulk-copies the weights, staged once per
// model into wgmma's shared-memory layout, through a ring of three 32 KB
// stages that the two blocks of a cluster share (multicast). The encoding
// is produced in slices of 2W columns in the kernel, each by the ladder, in
// the freq-major order of the head's rows (prepare_fused_params_pe).
//
// What bounds it: 11.8 MFLOP per ray, about 1.89 TFLOP per 400x400 frame:
// 1.9 ms at the card's 989 bf16 TFLOP/s; in f32, three TF32 products, 11.4
// ms at 495 TFLOP/s (28.2 ms on the CUDA cores' 67). Its input and output
// are a few MB, so it is compute-bound. The weights stream from L2 once per
// cluster: 11.8 MB bf16 per 256 rays, about 7.4 GB a frame; 47.2 MB of f32
// hi/lo per 128 rays, about 59 GB. The parent design (64-channel cp.async
// stages behind block barriers, mma.sync, one 64- or 32-ray tile per SM,
// f32 on the CUDA cores) took 10.3 ms (bf16) and 105.5 ms (f32) a frame on
// an H100 80GB HBM3 at 700 W; PERF.md has this one's runs.
#include "r2l_hopper.cuh"

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// `staged` is the image of stage_chain_weights (r2l_fused.py), h0 a scratch
// of h0_elems values of the weight type (blocks x rows x W, chain_scratch).
// Returns a cudaError_t: the launch's own error,
// cudaErrorLaunchOutOfResources for a cluster that cannot be resident, or
// cudaErrorInvalidValue for a shape the kernel does not take (W 64, 128 or
// 256) or a scratch too small.
extern "C" int r2l_pe_fused_launch(
    const float* pts, int n, int dp, int L, const void* staged,
    const float* head_b, const float* body_b, const void* tail_w,
    const float* tail_b, float* out, void* h0, long long h0_elems, int W,
    int nb, int nl, int out_dim, float res_scale, int use_residual,
    int linear_tail, int weight_is_f32, void* stream) {
  if (dp <= 0 || L <= 0) return cudaErrorInvalidValue;
  r2lh::Args a = {};
  a.in = pts; a.n = n; a.dp = dp; a.L = L; a.in_dim = dp * (2 * L + 1);
  a.staged = static_cast<const unsigned char*>(staged);
  a.head_b = head_b; a.body_b = body_b; a.tail_w = tail_w;
  a.tail_b = tail_b; a.out = out; a.h0 = h0;
  a.nb = nb; a.nl = nl; a.out_dim = out_dim; a.res_scale = res_scale;
  a.use_residual = use_residual; a.linear_tail = linear_tail;
  return r2lh::launch<true>(a, W, weight_is_f32, h0_elems,
                            static_cast<cudaStream_t>(stream));
}
