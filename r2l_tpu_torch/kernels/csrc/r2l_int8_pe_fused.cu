// K2's pre-Hopper int8 chain, kept for the probe of its ray streams.
//
// Replaces the Pallas TPU kernel exp/probe_pipe_lib.py::
// apply_int8_pe_streams (r2l_tpu/kernels/r2l_pallas.py::_int8_pe_chain in
// its deployed form, in S = 2 or 4 ray streams; S = 1 is the chain as K2
// ran before its Hopper redesign). The kernel, its design and its bound
// are in r2l_int8_chain.cuh: this file instantiates its forms, each
// compiled once.
#include "r2l_int8_chain.cuh"

using namespace r2l;
using namespace r2l::int8chain;

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// K2's deployed form at width 256; streams 1, 2 or 4. Returns a
// cudaError_t: the launch's own error, or cudaErrorInvalidValue for a
// stream count or depth the kernel does not take.
extern "C" int r2l_int8_pe_fused_launch(
    const float* pts, int n, int dp, int L, const int8_t* head_q,
    const float* head_m, const float* head_b, const float* head_inv,
    const int8_t* body_q, const float* body_m, const float* body_b,
    const float* body_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, int nb, int nl,
    int out_dim, int use_residual, int linear_tail, int streams,
    void* stream) {
  cudaError_t err = check_args(n, dp, L, nb, nl, out_dim, head_q, body_q,
                               tail_q);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (streams) {
    case 1: return launch<256, 1>(R2L_INT8_CHAIN_ARGS);
    case 2: return launch<256, 2>(R2L_INT8_CHAIN_ARGS);
    case 4: return launch<256, 4>(R2L_INT8_CHAIN_ARGS);
  }
  return cudaErrorInvalidValue;
}
