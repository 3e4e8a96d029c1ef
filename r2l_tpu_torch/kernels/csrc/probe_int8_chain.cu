// Probe: the static-scale int8 chain of K2's engine, with no head, tail or
// encoding, in three modes, on Hopper's wgmma.
//
// Replaces two Pallas TPU kernels, x [N, 256] f32 -> [N, 256] f32 through
// n_layers int8 layers with int8 weights packed [out, in]:
//   static    exp/probe_mxu.py::make_int8 (its body int8_kernel) and
//             exp/probe_wall.py::make's `realistic` mode: x rounded to
//             bf16, then per layer
//               q = clip(round_half_even(f32(h) * inv_s), -127, 127)
//               h = bf16(relu(f32(q Wq_i^T) * s_i))        int32 dot
//             and f32(h);
//   mxu_only  exp/probe_wall.py::make's `mxu_only`: one
//             q = clip(round_half_even(x * inv_s), -127, 127) of the f32
//             input, every layer's int32 dot of that q summed in int32,
//             f32 of the sum (the plain version sums in f32: equal while
//             every partial sum stays below 2^24, as the probe's weights
//             keep it, 86 * 256 * 127 * 4 < 2^24);
//   mincast   `mincast`: q as in mxu_only, then per layer
//             q = int8(dot >> 8), an arithmetic shift and a wrapping cast
//             (as XLA's convert; q may be -128), and f32(q).
// Every step rounds as the plain version does (exact int32 dots, one f32
// product, round-half-even), so the two agree bit for bit.
//
// Design: probe_hopper.cuh's s8 skeleton (K2's ring and helpers). Two 64-ray
// consumer warpgroups a block and a producer that bulk-copies the image
// (probe_mxu.stage_int8_chain: two 32 KB stages of 128 input channels a
// layer) into a ring multicast over a 2-block cluster. Each layer is one
// wgmma m64n256k32 s8 product into an s32 accumulator of 128 registers,
// A the warpgroup's int8 tile Q [64 x 256] (16 KB) in the core-matrix
// layout. static and mincast write the next layer's q in place over Q
// (the product's wgmma.wait_group has completed the warpgroup's reads of
// its rows), and the last layer's output straight from the registers; the
// static dequantize reads the scale table s with ldg2. mxu_only's q never
// changes, so every layer's product adds into the same accumulator
// (scale-d 1 after layer 0), exact in int32. Shared memory: Q 32 KB and
// six 32 KB slots (the chain's tile needs no H): 224 KB. Each mode runs
// the schedule the design run measured faster (kPingPong; exp/
// int8_bwd_variants.py's chain8_sched): the warpgroups half a layer apart
// (a layer's two stages fit the ring twice over) or in lockstep.
//
// What bounds it: 256 * 256 int8 multiply-adds per ray and layer, 1.85 T
// operations for the probes' 163,840 rays x 86 layers, against 336 MB of
// f32 input and output: 0.933 ms at the data-sheet 1,979 int8 TOP/s,
// compute-bound. The image (5.6 MB) is read from L2 once per cluster:
// 3.6 GB a frame.
#include "probe_hopper.cuh"

using namespace probe_h;

namespace {

enum Mode { kStatic = 0, kMxuOnly = 1, kMincast = 2 };
// Each mode's schedule: true half a layer apart, false in lockstep.
constexpr bool kPingPong[3] = {true, false, true};

// K2's s8 ring (hopper::Kind<int8_t>) with six slots in place of four.
struct RingS8 {
  using Acc = int;
  static constexpr int kKS = 128, kKSB = 128, kWGs = 2, kStages = 6;
  static constexpr int kParts = 1;
  static constexpr bool kRegA = false;
};
constexpr int kQ = 64 * kW;  // a warpgroup's Q [64 x 256] int8

struct Args {
  const float* x;  // [n, 256] f32
  int n;
  const unsigned char* staged;  // n_layers x 2 stages of s8 weights
  const float* s;  // static: [n_layers, 256] f32, the dequantize scales
  float inv_s;     // the input scale
  float* out;      // [n, 256] f32
  int n_layers;
};

template <int kMode, bool kDual>
__global__ void __launch_bounds__(kWG * 3, 1)
    probe_int8_chain_kernel(const Args a) {
  using K = RingS8;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  if (!start<int8_t, K>(smem, 2 * kQ, a.staged, a.n_layers * 2, ring))
    return;
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const int row0 = (blockIdx.x * 2 + wg) * 64, bar_id = 1 + wg;
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
  const int t = lane % 4;
  unsigned char* Qm = smem + wg * kQ;
  const float inv = a.inv_s;
  const Turns<kDual> turns{wg};

  // the first q: of bf16(x) (static), of x itself (the others)
  each_own(row0, a.n, wtid, [&](int, int h, int c, int g) {
    float2 v = load2(a.x, g, c);
    if (kMode == kStatic)
      v = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
    putq(Qm, r0 + 8 * h, c, q8b(__fmul_rn(v.x, inv)),
         q8b(__fmul_rn(v.y, inv)));
  });

  int acc[kW / 2];
  int it = 0;
  for (int i = 0; i < a.n_layers; ++i) {
    if (kMode != kMxuOnly || i == 0) {
      fence_async_smem();  // the epilogue's writes, before wgmma reads them
      wg_bar(bar_id);
    }
    turns.before(i);
    product<int8_t, kW, kC, K>(acc, Qm, kW, kW, Qm, kW, kW, ring, it, wtid,
                               kMode == kMxuOnly && i > 0);
    turns.after();
    if (kMode == kMxuOnly) continue;
    const bool last = i + 1 == a.n_layers;
    const float* si = a.s + (size_t)i * kW;
#pragma unroll
    for (int j0 = 0; j0 < kW / 8; j0 += 4) {
      float2 sp[4];  // four column pairs' scales, loaded ahead of their use
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sp[q] = kMode == kStatic ? ldg2(si + 8 * (j0 + q) + 2 * t)
                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q, c = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, g = row0 + r < a.n ? row0 + r : -1;
          const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
          if (kMode == kStatic) {  // |a| <= 256 * 128 * 127 < 2^22: i2f
            const float2 y = __bfloat1622float2(__floats2bfloat162_rn(
                fmaxf(__fmul_rn(i2f(a0), sp[q].x), 0.f),
                fmaxf(__fmul_rn(i2f(a1), sp[q].y), 0.f)));
            if (last)
              store2(a.out, g, c, y);
            else
              putq(Qm, r, c, q8b(__fmul_rn(y.x, inv)),
                   q8b(__fmul_rn(y.y, inv)));
          } else if (last) {  // mincast: the low byte, wrapped
            store2(a.out, g, c,
                   make_float2((float)(int8_t)(a0 >> 8),
                               (float)(int8_t)(a1 >> 8)));
          } else {
            putq(Qm, r, c, a0 >> 8, a1 >> 8);
          }
        }
      }
    }
  }
  turns.finish();
  if (kMode == kMxuOnly)  // above i2f's 2^22: the exact conversion
    each_own(row0, a.n, wtid, [&](int j, int h, int c, int g) {
      store2(a.out, g, c,
             make_float2(__int2float_rn(acc[4 * j + 2 * h]),
                         __int2float_rn(acc[4 * j + 2 * h + 1])));
    });
  cluster_sync();
}

template <int kMode>
cudaError_t launch(const Args& a, cudaStream_t s) {
  return launch_cluster<int8_t, kC, RingS8>(
      probe_int8_chain_kernel<kMode, kPingPong[kMode]>, a, blocks_of(a.n),
      smem_bytes<RingS8>(2 * kQ), s);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: probe_mxu.stage_int8_chain's image of the n_layers [256, 256]
// int8 weights; s: its scale table, [n_layers, 256] f32 (mode static; the
// others do not read it, and it may be null); mode: 0 static, 1 mxu_only,
// 2 mincast. Returns a cudaError_t: the launch's own error, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_int8_chain_launch(const float* x, int n,
                                       const void* staged, const float* s,
                                       float inv_s, float* out, int n_layers,
                                       int mode, void* stream) {
  if (n <= 0 || n_layers < 1 || (mode == kStatic && s == nullptr))
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(staged) || !aligned16(out) ||
      (mode == kStatic && !aligned16(s)))
    return cudaErrorMisalignedAddress;
  Args a{};
  a.x = x;
  a.n = n;
  a.staged = static_cast<const unsigned char*>(staged);
  a.s = s;
  a.inv_s = inv_s;
  a.out = out;
  a.n_layers = n_layers;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kStatic: return launch<kStatic>(a, st);
    case kMxuOnly: return launch<kMxuOnly>(a, st);
    case kMincast: return launch<kMincast>(a, st);
  }
  return cudaErrorInvalidValue;
}
