// Probe: K2 with three requantize epilogues.
//
// Replaces the Pallas TPU kernel exp/probe_epi.py::apply_variant (its body
// chain_variant): K2 whole (PE, head, the 43 blocks, tail) with the inner
// requantize
//   v0  the bf16 ReLU output times the next inverse scale in f32
//       (r2l_pallas.py's fold_requant=False);
//   v1  the same product in bf16: t_bf16 * bf16(inv), rounded to bf16
//       before round and clip (as XLA computes it), the first layer of
//       each block too;
//   v2  v1 with the inner ReLU folded into the clip's lower bound 0.
// Mosaic refused v1 and v2 on the TPU (exp/probe_epi.jsonl), so the card
// measures them first.
//
// Design: r2l_int8_chain.cuh's kernel (one 64-ray tile per block, K2's
// engine and stages) with the epilogue as a compile-time form.
//
// What bounds it: K2's work, about 1.89 T int8 operations per 400x400
// frame (0.953 ms at the data-sheet 1,979 TOP/s), compute-bound.
#include "r2l_int8_chain.cuh"

using namespace r2l;
using namespace r2l::int8chain;

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// W must be 256 and variant one of 0, 1, 2. Returns a cudaError_t: the
// launch's own error, or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int probe_epi_launch(
    const float* pts, int n, int dp, int L, const int8_t* head_q,
    const float* head_m, const float* head_b, const float* head_inv,
    const int8_t* body_q, const float* body_m, const float* body_b,
    const float* body_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, int W, int nb,
    int nl, int out_dim, int use_residual, int linear_tail, int variant,
    void* stream) {
  cudaError_t err = check_args(n, dp, L, nb, nl, out_dim, head_q, body_q,
                               tail_q);
  if (err != cudaSuccess) return err;
  if (W != 256) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<256, kUnfolded, 1>(R2L_INT8_CHAIN_ARGS);
    case 1: return launch<256, kEpiV1, 1>(R2L_INT8_CHAIN_ARGS);
    case 2: return launch<256, kEpiV2, 1>(R2L_INT8_CHAIN_ARGS);
  }
  return cudaErrorInvalidValue;
}
