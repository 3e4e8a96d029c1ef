// Probe: K2's int8 ResMLP body with static activation scales, and its bf16
// control, with no head, tail or encoding.
//
// Replaces the Pallas TPU kernel exp/probe_int8.py::make_runner with its
// bodies (x [N, 256] f32 -> [N, 256] f32 through n_blocks two-layer
// blocks, the residual stream h in bf16, weights packed [out, in]):
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
//               h = bf16((t W2^T + b2) * rs + f32(h)).
// The groupings are XLA's on the CPU (one FMA for acc * m + b, the scale
// products rounded on their own, the residual added after the FMA; tests/
// test_torch_probe_int8.py), so the int8 bodies equal their plain versions
// bit for bit.
//
// Design: K2's engines (EngineS8<256, 64, 128>, mma.sync m16n8k32 s8;
// EngineBF16<256, 64>, m16n8k16) on a 64-ray tile per team of 256 threads.
// Single: one team per block. Dual (the probe's dual and interleaved
// forms, which compute the same function as single): two teams per block,
// each on its own 64-ray tile, sharing one set of weight stages stepped in
// lockstep (StreamTeam), so one tile's epilogue runs beside the other's
// tensor-core work. Shared memory per block, single / dual: int8 h bf16 +
// q int8 per tile, 124,928 / 176,128 bytes; bf16 h and t per tile, 141,312
// / 208,896 bytes. A dual form with a set of stages per tile (as
// probe_chain.cu's) would need 249,856 (int8) or 282,624 (bf16) bytes,
// above the 232,448 a block may have.
//
// What bounds it: 2 * 256 * 256 multiply-adds per ray and block layer, 1.85
// T operations for the probe's 163,840 rays x 86 layers, against 336 MB of
// f32 input and output: 0.933 ms at the data-sheet 1,979 int8 TOP/s (1.867
// ms at 989 bf16 TFLOP/s for the control), compute-bound.
#include <type_traits>

#include "probe_common.cuh"

namespace {

using namespace r2l;
using namespace r2l::probe;

enum Body { kInt8 = 0, kInt8Fold = 1, kBf16 = 2 };

using E8 = EngineS8<kW, kTT, 128>;
using EB = EngineBF16<kW, kTT>;
constexpr int kLdq = 4 * ld_words(kW);   // int8 elements per row
constexpr size_t kQBytes = (size_t)kTT * kLdq;
constexpr size_t kHBytes = (size_t)kTT * kLdb * 2;

template <int kBody, int S>
constexpr size_t smem_bytes() {
  return kBody == kBf16 ? 2 * S * kHBytes + EB::kStageBytes
                        : S * (kHBytes + kQBytes) + E8::kStageBytes;
}

template <int kBody, int S>
__global__ void __launch_bounds__(S * kThreads, 1)
    probe_resmlp_kernel(const float* __restrict__ x, int n,
                        const void* __restrict__ w,
                        const float* __restrict__ m,
                        const float* __restrict__ b, float inv_a, float rs,
                        float* __restrict__ out, int n_blocks) {
  using Team =
      typename std::conditional<S == 1, BlockTeam, StreamTeam<S>>::type;
  const Team team;
  const int tile = S == 1 ? 0 : (int)(threadIdx.x / kThreads);
  const int t = team.tid(), row0 = (blockIdx.x * S + tile) * kTT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem + tile * kHBytes);
  load_tile(H, x, row0, n, t, kThreads);

  if constexpr (kBody == kBf16) {
    __nv_bfloat16* T =
        reinterpret_cast<__nv_bfloat16*>(smem + (S + tile) * kHBytes);
    uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + 2 * S * kHBytes);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    EB::Acc acc;
    for (int blk = 0; blk < n_blocks; ++blk) {
      const float* b1 = b + (size_t)(2 * blk) * kW;
      const float* b2 = b1 + kW;
      EB::mm(acc, H, kLdb, wb + (size_t)(2 * blk) * kW * kW, kW, Ws, team);
      EB::visit(acc, [&](int r, int c, float v) {
        T[r * kLdb + c] = __float2bfloat16_rn(fmaxf(__fadd_rn(v, b1[c]), 0.f));
      }, team);
      EB::mm(acc, T, kLdb, wb + (size_t)(2 * blk + 1) * kW * kW, kW, Ws,
             team);
      EB::visit(acc, [&](int r, int c, float v) {
        __nv_bfloat16& h = H[r * kLdb + c];
        h = __float2bfloat16_rn(__fadd_rn(
            __fmul_rn(__fadd_rn(v, b2[c]), rs), __bfloat162float(h)));
      }, team);
    }
  } else {
    int8_t* Q = reinterpret_cast<int8_t*>(smem + S * kHBytes) +
                tile * kTT * kLdq;
    uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + S * (kHBytes + kQBytes));
    const auto* wq = static_cast<const int8_t*>(w);
    team.sync();
    for (int e = t; e < kTT * kW; e += kThreads) {
      const int r = e / kW, c = e % kW;
      Q[r * kLdq + c] = q8(__fmul_rn(__bfloat162float(H[r * kLdb + c]), inv_a));
    }
    int acc[E8::M::MT][E8::M::NT][4];
    for (int blk = 0; blk < n_blocks; ++blk) {
      const float* m1 = m + (size_t)(2 * blk) * kW;
      const float* b1 = b + (size_t)(2 * blk) * kW;
      const float* m2 = m1 + kW;
      const float* b2 = b1 + kW;
      const bool last = blk == n_blocks - 1;
      E8::mm(acc, Q, kLdq, wq + (size_t)(2 * blk) * kW * kW, kW, Ws, team);
      E8::M::visit(acc, [&](int r, int c, int a) {
        int8_t q;
        if (kBody == kInt8Fold)   // ReLU as the clip's floor, scale folded
          q = static_cast<int8_t>(fminf(fmaxf(rintf(__fmaf_rn(
                  __int2float_rn(a), __fmul_rn(m1[c], inv_a),
                  __fmul_rn(b1[c], inv_a))), 0.f), 127.f));
        else
          q = q8(__fmul_rn(fmaxf(dequant(a, m1[c], b1[c]), 0.f), inv_a));
        Q[r * kLdq + c] = q;
      }, team);
      E8::mm(acc, Q, kLdq, wq + (size_t)(2 * blk + 1) * kW * kW, kW, Ws,
             team);
      E8::M::visit(acc, [&](int r, int c, int a) {
        __nv_bfloat16& h = H[r * kLdb + c];
        h = __float2bfloat16_rn(__fadd_rn(
            dequant(a, __fmul_rn(m2[c], rs), __fmul_rn(b2[c], rs)),
            __bfloat162float(h)));
        // the next block's first quantize, by the thread that owns the
        // value (the engine's last read of Q is behind its barrier)
        if (!last) Q[r * kLdq + c] = q8(__fmul_rn(__bfloat162float(h), inv_a));
      }, team);
    }
  }
  team.sync();
  store_tile(out, H, row0, n, t, kThreads);
}

template <int kBody, int S>
cudaError_t launch(const float* x, int n, const void* w, const float* m,
                   const float* b, float inv_a, float rs, float* out,
                   int n_blocks, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kBody, S>();
  auto kern = probe_resmlp_kernel<kBody, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rays = S * kTT;
  kern<<<(n + rays - 1) / rays, S * kThreads, smem, stream>>>(
      x, n, w, m, b, inv_a, rs, out, n_blocks);
  return cudaGetLastError();
}

template <int kBody>
cudaError_t launch_body(int dual, const float* x, int n, const void* w,
                        const float* m, const float* b, float inv_a, float rs,
                        float* out, int n_blocks, cudaStream_t s) {
  return dual ? launch<kBody, 2>(x, n, w, m, b, inv_a, rs, out, n_blocks, s)
              : launch<kBody, 1>(x, n, w, m, b, inv_a, rs, out, n_blocks, s);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// body: 0 int8, 1 int8 folded, 2 bf16 (m unused, may be null); dual: 0 one
// 64-ray tile per block, 1 two. Returns a cudaError_t: the launch's own
// error, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_resmlp_launch(const float* x, int n, const void* w,
                                   const float* m, const float* b,
                                   float inv_a, float rs, float* out,
                                   int n_blocks, int body, int dual,
                                   void* stream) {
  if (n <= 0 || n_blocks < 1 || b == nullptr ||
      (body != kBf16 && m == nullptr))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kInt8:
      return launch_body<kInt8>(dual, x, n, w, m, b, inv_a, rs, out,
                                n_blocks, s);
    case kInt8Fold:
      return launch_body<kInt8Fold>(dual, x, n, w, m, b, inv_a, rs, out,
                                    n_blocks, s);
    case kBf16:
      return launch_body<kBf16>(dual, x, n, w, m, b, inv_a, rs, out,
                                n_blocks, s);
  }
  return cudaErrorInvalidValue;
}
