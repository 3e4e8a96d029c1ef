// Probe: the bf16 tensor-core chain of K1's body, with no residual, head,
// tail or encoding, on Hopper's wgmma.
//
// Replaces the Pallas TPU kernel exp/probe_mxu.py::make_chain (its body
// chain_kernel): x [N, 256] f32, rounded to bf16, through n_layers products
// h <- epi(h W_i^T) with bf16 weights, then f32 [N, 256]. The epilogue is a
// compile-time mode:
//   full  f32 accumulation, + bias in f32, ReLU, round to bf16 (K1's inner
//         layer);
//   lean  the dot rounded to bf16, + the bias rounded to bf16 (their sum in
//         f32, rounded to bf16), ReLU;
//   none  the dot rounded to bf16.
// JAX asks `lean` and `none` for a bf16 accumulation
// (preferred_element_type=bf16). wgmma does not accumulate in bf16, so the
// port defines both as the f32 sum rounded once to bf16; the plain versions
// (r2l_tpu_torch/exp/probe_mxu.py) compute the same.
//
// Design: probe_hopper.cuh's bf16 skeleton, K1's products, ring and
// cluster (the weights as probe_mxu.stage_chain stages them, four
// 32 KB stages a layer, multicast to a 2-block cluster of 256 rays), each
// layer written in place; `dual` the two warpgroups half a layer apart
// (single: in lockstep), bit for bit the same function.
//
// What bounds it: 2 * 256 * 256 multiply-adds per ray and layer, 1.85 TFLOP
// for the probe's 163,840 rays x 86 layers, against 336 MB of f32 input and
// output: 1.867 ms at the data-sheet 989 bf16 TFLOP/s, compute-bound. The
// image (11.3 MB) is read from L2 once per cluster: 7.2 GB a frame.
#include "probe_hopper.cuh"

using namespace probe_h;

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: stage_chain's image of the n_layers [256, 256] bf16
// weights; b: [n_layers, 256] f32 (mode none: unused, may be null); mode:
// 0 full, 1 lean, 2 none; dual: 0 the warpgroups in lockstep, 1 half a
// layer apart. Returns a cudaError_t: the launch's own error, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_chain_launch(const float* x, int n, const void* staged,
                                  const float* b, float* out, int n_layers,
                                  int mode, int dual, void* stream) {
  if (n <= 0 || n_layers < 1 || (mode != kNone && b == nullptr))
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(staged) || !aligned16(out) ||
      (b != nullptr && !aligned16(b)))
    return cudaErrorMisalignedAddress;
  Bf16Args a{};
  a.x = x;
  a.n = n;
  a.staged = static_cast<const unsigned char*>(staged);
  a.b = b;
  a.out = out;
  a.n_layers = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull: return launch_bf16<kFull>(a, dual, s);
    case kLean: return launch_bf16<kLean>(a, dual, s);
    case kNone: return launch_bf16<kNone>(a, dual, s);
  }
  return cudaErrorInvalidValue;
}
