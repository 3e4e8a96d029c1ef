// K2: the PE-fused static-scale int8 R2L forward on Hopper.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_pallas.py::
// fused_r2l_apply_int8_pe (through `_int8_pe_chain`, in its three distinct
// forms: fold_requant=True with nobf16_inner=True, the deployed form with
// parameters from calibrate_r2l_int8_pe(..., fold_requant=True);
// fold_requant=True alone; fold_requant=False, where nobf16_inner has no
// effect), exp/probe_epi.py::apply_variant (v1 and v2 at width 256; its
// v0 is K2's fold_requant=False), and exp/probe_pipe_lib.py::
// apply_int8_pe_streams (S = 1 and 4 at width 256; its S = 2 is K2's
// deployed form). Each of K2's three forms also with bf16_resid (the
// global residual in bf16, kBf16Resid). The kernels, their design and
// their bound are in r2l_int8_hopper.cuh: this file instantiates their
// forms, each compiled once.
#include "r2l_int8_hopper.cuh"

using namespace r2l8h;

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: stage_int8_chain's image of head_q and body_q and of the head's
// and the body's (m, b) epilogue table; h0: a scratch of
// h0_elems floats ([blocks * 128 * W], blocks padded to whole 2-block
// clusters; none without the global residual); epilogue: r2l_int8_hopper.
// cuh's Epi, K2's three forms at widths 64, 128 and 256 (each also plus
// kBf16Resid, the form with bf16_resid), the epilogue
// probe's kEpiV1 and kEpiV2 and the stream probe's kStreams1 and kStreams4
// at 256 (kStreams4 needs the h0 scratch, [blocks * 256 * W], with or
// without the global residual). Returns a cudaError_t: the launch's own
// error, or cudaErrorInvalidValue for a form, width or depth the kernel
// does not take.
extern "C" int r2l_int8_hopper_launch(
    const float* pts, int n, int dp, int L, const unsigned char* staged,
    const float* head_inv, const float* body_inv, const int8_t* tail_q,
    const float* tail_m, const float* tail_b, const float* tail_inv,
    float* out, float* h0, long long h0_elems, int W, int nb, int nl,
    int out_dim, int use_residual, int linear_tail, int epilogue,
    void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || nl < 1 || out_dim < 1 ||
      2 * L + 1 > 2 * W)  // a head slice holds a scalar's parts at least
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(staged) & 15 ||
      reinterpret_cast<uintptr_t>(tail_q) & 1)
    return cudaErrorMisalignedAddress;
  Args a{};
  a.pts = pts;
  a.n = n;
  a.dp = dp;
  a.L = L;
  a.staged = staged;
  a.head_inv = head_inv;
  a.body_inv = body_inv;
  a.tail_q = tail_q;
  a.tail_m = tail_m;
  a.tail_b = tail_b;
  a.tail_inv = tail_inv;
  a.out = out;
  a.h0 = h0;
  a.nb = nb;
  a.nl = nl;
  a.out_dim = out_dim;
  a.use_residual = use_residual;
  a.linear_tail = linear_tail;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kDeployed: return launch_width<kDeployed>(a, W, h0_elems, s);
    case kFold: return launch_width<kFold>(a, W, h0_elems, s);
    case kUnfolded: return launch_width<kUnfolded>(a, W, h0_elems, s);
    case kDeployed | kBf16Resid:
      return launch_width<kDeployed | kBf16Resid>(a, W, h0_elems, s);
    case kFold | kBf16Resid:
      return launch_width<kFold | kBf16Resid>(a, W, h0_elems, s);
    case kUnfolded | kBf16Resid:
      return launch_width<kUnfolded | kBf16Resid>(a, W, h0_elems, s);
  }
  if (W == 256 && epilogue == kEpiV1)
    return launch_as<256, kEpiV1>(a, h0_elems, s);
  if (W == 256 && epilogue == kEpiV2)
    return launch_as<256, kEpiV2>(a, h0_elems, s);
  if (W == 256 && epilogue == kStreams1)
    return launch_as<256, kStreams1>(a, h0_elems, s);
  if (W == 256 && epilogue == kStreams4)
    return launch_as<256, kStreams4>(a, h0_elems, s);
  return cudaErrorInvalidValue;
}
