// The wide form of K1, K9 and K2: the student's frame at any netwidth that
// is a multiple of 128 (r2l_fused.py sends every student wider than 256
// here, padded with zero channels to that multiple, and K2's students
// whose 2L+1 encoding parts overflow its head slice).
//
// Replaces, at those widths, the Pallas TPU kernels r2l_tpu/kernels/
// r2l_pallas.py::fused_r2l_apply_pe (:164; bf16 and f32 weights),
// fused_r2l_apply (:270; an encoded input, bf16 and f32) and
// fused_r2l_apply_int8_pe (:571; in _int8_pe_chain's three forms). The
// design, the rounding points and the bound are in r2l_wide.cuh.
#include "r2l_wide.cuh"

using namespace r2lw;

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// in: pe ? pts [n, dp] (in_dim = dp * (2L + 1)) : x [n, in_dim], f32.
// dtype: 0 bf16, 1 f32 (weights and compute), 2 int8 (pe only; epilogue
// one of K2's forms, Epi). image: stage_wide_chain's tiles of the head
// ([W, in_dim padded to 128] in the fields' column order) and of every
// body layer, then for int8 the (m, b) table of the head and the body.
// scratch: wide_scratch_bytes(rows, ...) bytes, 256-byte aligned; rows:
// rays a pass (0: all n). Returns a cudaError_t: a launch's own error, or
// cudaErrorInvalidValue for a shape the wide form does not take (W not a
// multiple of 128, no layer a block, more than 8 outputs) or a scratch too
// small.
extern "C" int r2l_wide_launch(
    const float* in, int n, int dp, int L, int in_dim, int pe, int dtype,
    const unsigned char* image, const float* head_b, const float* body_b,
    const float* head_inv, const float* body_inv, const void* tail_w,
    const float* tail_m, const float* tail_b, const float* tail_inv,
    float* out, unsigned char* scratch, long long scratch_bytes, int rows,
    int W, int nb, int nl, int out_dim, float res_scale, int use_residual,
    int linear_tail, int epilogue, void* stream) {
  if (n <= 0 || W <= 0 || W % kWideChannels != 0 || nb < 0 || nl < 1 ||
      out_dim < 1 || out_dim > kMaxOut || in_dim <= 0 || dtype < 0 ||
      dtype > 2 || epilogue < 0 || epilogue > 2)
    return cudaErrorInvalidValue;
  if (pe && (dp <= 0 || L <= 0 || in_dim != dp * (2 * L + 1)))
    return cudaErrorInvalidValue;
  if (dtype == kS8 && !pe) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(image) & 15 ||
      reinterpret_cast<uintptr_t>(scratch) & 255 ||
      reinterpret_cast<uintptr_t>(tail_w) & 15)
    return cudaErrorMisalignedAddress;
  Chain c{};
  c.in = in;
  c.n = n;
  c.dp = dp;
  c.L = L;
  c.in_dim = in_dim;
  c.pe = pe;
  c.image = image;
  c.head_b = head_b;
  c.body_b = body_b;
  c.head_inv = head_inv;
  c.body_inv = body_inv;
  c.tail_w = tail_w;
  c.tail_m = tail_m;
  c.tail_b = tail_b;
  c.tail_inv = tail_inv;
  c.out = out;
  c.scratch = scratch;
  c.scratch_bytes = scratch_bytes;
  c.rows = rows;
  c.W = W;
  c.nb = nb;
  c.nl = nl;
  c.out_dim = out_dim;
  c.res_scale = res_scale;
  c.use_residual = use_residual;
  c.linear_tail = linear_tail;
  c.epilogue = epilogue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return run<kBF16>(c, s);
    case kF32: return run<kF32>(c, s);
    default: return run<kS8>(c, s);
  }
}
