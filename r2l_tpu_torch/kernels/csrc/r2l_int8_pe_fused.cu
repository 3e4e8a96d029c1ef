// K2: the PE-fused static-scale int8 R2L forward, and the probes of its
// epilogue and its ray streams.
//
// Replaces the Pallas TPU kernels r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply_int8_pe (through `_int8_pe_chain`, in its three distinct
// forms: fold_requant=True with nobf16_inner=True, the deployed form with
// parameters from calibrate_r2l_int8_pe(..., fold_requant=True);
// fold_requant=True alone; fold_requant=False, where nobf16_inner has no
// effect), exp/probe_epi.py::apply_variant (v1 and v2; its v0 is K2's
// fold_requant=False) and exp/probe_pipe_lib.py::apply_int8_pe_streams (the
// deployed form in S = 2 or 4 ray streams; S = 1 is K2). The kernel, its
// design and its bound are in r2l_int8_chain.cuh: this file instantiates
// its forms, each compiled once.
#include "r2l_int8_chain.cuh"

using namespace r2l;
using namespace r2l::int8chain;

namespace {

template <int kEpi>
cudaError_t launch_width(
    int W, const float* pts, int n, int dp, int L, const int8_t* head_q,
    const float* head_m, const float* head_b, const float* head_inv,
    const int8_t* body_q, const float* body_m, const float* body_b,
    const float* body_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, int nb, int nl,
    int out_dim, int use_residual, int linear_tail, cudaStream_t s) {
  switch (W) {
    case 64: return launch<64, kEpi, 1>(R2L_INT8_CHAIN_ARGS);
    case 128: return launch<128, kEpi, 1>(R2L_INT8_CHAIN_ARGS);
    case 256: return launch<256, kEpi, 1>(R2L_INT8_CHAIN_ARGS);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// epilogue: r2l_int8_chain.cuh's Epi (K2's kDeployed, kFold, kUnfolded at
// widths 64, 128, 256; the probe's kEpiV1, kEpiV2 at 256); streams: 1, or 2
// and 4 for kDeployed at width 256. Returns a cudaError_t: the launch's own
// error, or cudaErrorInvalidValue for a form, width or depth the kernel
// does not take.
extern "C" int r2l_int8_pe_fused_launch(
    const float* pts, int n, int dp, int L, const int8_t* head_q,
    const float* head_m, const float* head_b, const float* head_inv,
    const int8_t* body_q, const float* body_m, const float* body_b,
    const float* body_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, int W, int nb,
    int nl, int out_dim, int use_residual, int linear_tail, int epilogue,
    int streams, void* stream) {
  cudaError_t err = check_args(n, dp, L, nb, nl, out_dim, head_q, body_q,
                               tail_q);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streams == 1) {
    switch (epilogue) {
      case kDeployed: return launch_width<kDeployed>(W, R2L_INT8_CHAIN_ARGS);
      case kFold: return launch_width<kFold>(W, R2L_INT8_CHAIN_ARGS);
      case kUnfolded: return launch_width<kUnfolded>(W, R2L_INT8_CHAIN_ARGS);
    }
  }
  if (W != 256) return cudaErrorInvalidValue;
  if (streams == 1 && epilogue == kEpiV1)
    return launch<256, kEpiV1, 1>(R2L_INT8_CHAIN_ARGS);
  if (streams == 1 && epilogue == kEpiV2)
    return launch<256, kEpiV2, 1>(R2L_INT8_CHAIN_ARGS);
  if (epilogue == kDeployed && streams == 2)
    return launch<256, kDeployed, 2>(R2L_INT8_CHAIN_ARGS);
  if (epilogue == kDeployed && streams == 4)
    return launch<256, kDeployed, 4>(R2L_INT8_CHAIN_ARGS);
  return cudaErrorInvalidValue;
}
