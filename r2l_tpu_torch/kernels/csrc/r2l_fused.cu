// K9: the R2L forward on an encoded input, bf16 or f32 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply (its `_kernel` + `_kernel_body`): x [N, in_dim] f32 (the
// positional encoding done outside, in `r2l_embed`'s per-scalar order, no
// row permutation) -> rounded once to the weight type -> head Linear+ReLU
// -> nb ResMLP blocks -> global residual -> Linear+sigmoid tail ->
// [N, out_dim] f32, with K1's rounding points (r2l_hopper.cuh).
//
// Design: K1's (r2l_hopper.cuh), with the encoding replaced by a read of
// x: each slice of 2W columns of the tile's rows is read straight from the
// unpadded input (16 bytes a thread where in_dim is a multiple of 4,
// neighbouring threads on neighbouring addresses), the columns past in_dim
// zero; no padded copy is made.
//
// What bounds it: 11.8 MFLOP per ray as K1, about 1.89 TFLOP per 400x400
// frame, against 0.65 GB of f32 input (0.19 ms at 3.35 TB/s), so it is
// compute-bound; the weights stream from L2 as K1's.
#include "r2l_hopper.cuh"

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py);
// the arguments and errors are K1's (r2l_pe_fused.cu), with x and in_dim
// for the points.
extern "C" int r2l_fused_launch(
    const float* x, int n, int in_dim, const void* staged,
    const float* head_b, const float* body_b, const void* tail_w,
    const float* tail_b, float* out, void* h0, long long h0_elems, int W,
    int nb, int nl, int out_dim, float res_scale, int use_residual,
    int linear_tail, int weight_is_f32, void* stream) {
  r2lh::Args a = {};
  a.in = x; a.n = n; a.in_dim = in_dim;
  a.vec = (in_dim & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  a.staged = static_cast<const unsigned char*>(staged);
  a.head_b = head_b; a.body_b = body_b; a.tail_w = tail_w;
  a.tail_b = tail_b; a.out = out; a.h0 = h0;
  a.nb = nb; a.nl = nl; a.out_dim = out_dim; a.res_scale = res_scale;
  a.use_residual = use_residual; a.linear_tail = linear_tail;
  return r2lh::launch<false>(a, W, weight_is_f32, h0_elems,
                             static_cast<cudaStream_t>(stream));
}
