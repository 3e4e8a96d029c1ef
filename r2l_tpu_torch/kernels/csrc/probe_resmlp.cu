// Probe: K2's int8 ResMLP body with static activation scales, and its bf16
// control, with no head, tail or encoding, on Hopper's wgmma.
//
// Replaces the Pallas TPU kernel exp/probe_int8.py::make_runner with its
// bodies (x [N, 256] f32 -> [N, 256] f32 through n_blocks two-layer
// blocks, the residual stream h in bf16):
//   int8      resmlp_kernel(fold=False): per block
//               q0 = clip(round_half_even(f32(h) * inv_a), -127, 127)
//               t  = relu(a1 * m1 + b1)           (one fused multiply-add)
//               q1 = clip(round_half_even(t * inv_a), -127, 127)
//               h  = bf16(fma(a2, m2 * rs, b2 * rs) + f32(h))
//             with a1, a2 the exact int32 dots;
//   int8fold  resmlp_kernel(fold=True): ReLU and the requantize folded into
//             the int32 -> int8 step,
//               q1 = clip(round_half_even(fma(a1, m1 * inv_a, b1 * inv_a)),
//                         0, 127);
//   bf16      bf16_kernel: bf16 weights, f32 accumulation,
//               t = bf16(relu(h W1^T + b1)),
//               h = bf16((t W2^T + b2) * rs + f32(h)), t unrounded here.
// The groupings are XLA's on the CPU (one FMA for acc * m + b, the scale
// products rounded on their own, the residual added after the FMA; tests/
// test_torch_probe_int8.py), so the int8 bodies equal their plain versions
// bit for bit. The scale products m1 * inv_a, b1 * inv_a, m2 * rs, b2 * rs
// are the epilogue table's, staged on the host (probe_int8.
// stage_resmlp), where no FMA contraction can move them.
//
// Design (probe_hopper.cuh): the int8 bodies on K2's wgmma s8 chain, ring
// and epilogue helpers, Q, H and four slots as K2 holds them; the inner
// layer quantizes as K4's kTrainQ (folded: as K2's deployed form), the
// block output rounds once as K8's kTrainB, and the next block's input is
// quantized in the same pass. The control on K1's bf16 chain, its residual
// stream in registers. `dual`: the two warpgroups half a layer apart
// (single: in lockstep), bit for bit the same function.
//
// What bounds it: 2 * 256 * 256 multiply-adds per ray and block layer, 1.85
// T operations for the probe's 163,840 rays x 86 layers, against 336 MB of
// f32 input and output: 0.933 ms at the data-sheet 1,979 int8 TOP/s (1.867
// ms at 989 bf16 TFLOP/s for the control), compute-bound. The image is
// read from L2 once per 2-block cluster of 256 rays: 3.6 GB a frame in int8
// (7.2 GB bf16).
#include "probe_hopper.cuh"

using namespace probe_h;

namespace {
enum Body { kInt8 = 0, kInt8Fold = 1, kBf16 = 2 };
}

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: stage_resmlp's image of the 2 n_blocks [256, 256] weights
// (int8, or bf16 for the control); mb: the int8 bodies' epilogue table,
// [2 n_blocks][256][2] f32 (m, b) per column, the scale products folded in
// (body 2: unused, may be null); b: the control's biases [2 n_blocks, 256]
// f32 (bodies 0 and 1: unused); body: 0 int8, 1 int8 folded, 2 bf16;
// dual: 0 the warpgroups in lockstep, 1 half a layer apart. Returns a
// cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int probe_resmlp_launch(const float* x, int n, const void* staged,
                                   const float* mb, const float* b,
                                   float inv_a, float rs, float* out,
                                   int n_blocks, int body, int dual,
                                   void* stream) {
  if (n <= 0 || n_blocks < 1 || body < kInt8 || body > kBf16 ||
      (body == kBf16 ? b == nullptr : mb == nullptr))
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(staged) || !aligned16(out) ||
      !aligned16(body == kBf16 ? static_cast<const void*>(b) : mb))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == kBf16) {
    Bf16Args a{};
    a.x = x;
    a.n = n;
    a.staged = static_cast<const unsigned char*>(staged);
    a.b = b;
    a.rs = rs;
    a.out = out;
    a.n_layers = 2 * n_blocks;
    return launch_bf16<kResMLP>(a, dual, s);
  }
  S8Args a{};
  a.x = x;
  a.n = n;
  a.staged = static_cast<const unsigned char*>(staged);
  a.mb = reinterpret_cast<const float4*>(mb);
  a.inv_a = inv_a;
  a.out = out;
  a.nb = n_blocks;
  return body == kInt8Fold ? launch_s8<true>(a, dual, s)
                           : launch_s8<false>(a, dual, s);
}
