// The Hopper skeleton of the exp/ body probes: the bf16 chain
// (probe_chain.cu, exp/probe_mxu.py::make_chain) and the ResMLP body with
// its bf16 control (probe_resmlp.cu, exp/probe_int8.py::make_runner),
// whose kernels are here, and the chain at N=512 (probe_bign.cu,
// make_bign) and the int8 chain in three modes (probe_int8_chain.cu,
// make_int8 and exp/probe_wall.py::make), whose kernels are in their own
// files on these pieces. Each is the body of a user kernel without its
// head, tail or encoding: the bf16 chains K1's (r2l_hopper.cuh), the int8
// ones K2's (r2l_int8_hopper.cuh, whose epilogue helpers they use), on the
// same machinery (hopper_ring.cuh, hopper_wgmma.cuh).
//
// A block owns 128 rays: two consumer warpgroups of 64 (wgmma's M) and one
// producer warpgroup, of which one thread bulk-copies the staged weight
// image (r2l_tpu_torch/exp/probe_int8.py::stage_resmlp,
// probe_mxu.py::stage_chain: every layer [256 out, 256 in] cut into
// stages of 128 bytes of each output row, laid out as wgmma reads B) into a
// ring of 32 KB slots. Two blocks form a cluster and share each stage
// (multicast), so the image is read from L2 once per 256 rays. The grid is
// padded to whole clusters; a block with no rays takes part in every stage
// to the end. Products are wgmma m64n256 (bf16 k16 -> f32, s8 k32 -> s32),
// both operands in shared memory, the activations in the core-matrix
// layout; epilogues run on the accumulator registers and write the next
// layer's input in place (each thread its own rows: the product's
// wgmma.wait_group has completed the warpgroup's reads of them, as in K2).
//
// Each warpgroup loads its tile of x [n, 256] f32 itself, each thread the
// values of its accumulator positions (rows r0 and r0 + 8, column pairs
// 8j + 2t), rounds them to bf16 and writes them where its layer-0 product
// reads them; it writes its tile's result back as f32 the same way.
//
// `dual` keeps its meaning: the same function, bit for bit. Single runs the
// two consumer warpgroups in lockstep (both start each layer's products
// together, as K2's kStreams1); dual half a layer apart (warpgroup 1 starts
// a layer's products when warpgroup 0's are done, warpgroup 0 the next
// layer's when warpgroup 1's are, as K2's deployed ping-pong). Rows never
// mix and every ray meets the same stages in the same order, so the two
// schedules give the same bits. The ping-pong needs a whole layer's stages
// in the ring (the leader finishes a layer's products before the follower
// starts them): four at W256 in bf16, two in int8.
//
// Shared memory at W256:
//   bf16 (chain and control): the tile A [128 rays x 256] bf16, 64 KB, then
//     five 32 KB slots (160 KB): 224 KB. K1's layout (H, T and three slots)
//     cannot hold a layer's four stages, so the control keeps each thread's
//     residual pairs in 64 registers and writes t and the block output into
//     A in place;
//   int8 (K2's budget): Q [128 x 256] int8 32 KB, H [128 x 256] bf16 in the
//     accumulator's order 64 KB, four 32 KB slots: 224 KB.
#pragma once

#include "r2l_int8_hopper.cuh"

namespace probe_h {

using namespace hopper;
using r2l8h::each_pair;
using r2l8h::i2f;
using r2l8h::ldg2;
using r2l8h::pair_arrive;
using r2l8h::pair_sync;
using r2l8h::q8b;
using r2l8h::q8b_relu;

constexpr int kW = 256;      // the probes' width
constexpr int kC = 2;        // blocks of a cluster
constexpr int kRows = 128;   // rays of a block

// The rings' shapes (hopper::Kind's members): 128 bytes of each output row
// a stage, two consumer warpgroups; int8 K2's four slots (Kind<int8_t>),
// bf16 five, two more than K1's three.
struct RingBF16 {
  using Acc = float;
  static constexpr int kKS = 64, kKSB = 128, kWGs = 2, kStages = 5;
  static constexpr int kParts = 1;
  static constexpr bool kRegA = false;
};
constexpr int kSlotBytes = kW * 128;  // a stage: 256 outputs x 128 bytes

// Shared memory: `tiles` bytes of activations, the ring, its barriers.
template <typename K>
constexpr int smem_bytes(int tiles) {
  return tiles + K::kStages * kSlotBytes + 2 * K::kStages * 8;
}

// The consumer warpgroups' turns around each layer's product: in lockstep
// (named barrier 3 for both), or half a layer apart (barriers 3 and 4, as
// K2's ping-pong; 1 and 2 are each warpgroup's own).
template <bool kDual>
struct Turns {
  int wg;
  __device__ __forceinline__ void before(int layer) const {
    if (!kDual || wg == 1)
      pair_sync(3);
    else if (layer > 0)
      pair_sync(4);
  }
  __device__ __forceinline__ void after() const {
    if (kDual) pair_arrive(wg == 0 ? 3 : 4);
  }
  __device__ __forceinline__ void finish() const {  // 1's last arrival
    if (kDual && wg == 0) pair_sync(4);
  }
};

// The block's ring over its shared memory from `off`, its barriers set up
// and the cluster joined (every thread). The producer warpgroup then copies
// the image's `stages` stages in order and returns false; a consumer
// returns true.
template <typename T, typename K>
__device__ __forceinline__ bool start(unsigned char* smem, int off,
                                      const unsigned char* staged,
                                      int stages, Ring& ring) {
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  ring.slots = smem_u32(smem + off);
  ring.full = smem_u32(smem + off + K::kStages * kSlotBytes);
  ring.empty = ring.full + 8 * K::kStages;
  ring.slot_bytes = kSlotBytes;
  if (threadIdx.x == 0) ring_init<T, kC, K>(ring);
  __syncthreads();
  cluster_sync();
  if (wg == K::kWGs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const uint32_t rank = cluster_rank();
    if (wtid == 0)
      for (int it = 0; it < stages; ++it)
        fill<T, kC, K>(ring, it, staged + (size_t)it * kSlotBytes,
                       kSlotBytes, rank);
    cluster_sync();
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  return true;
}

// Each of the thread's pairs of its tile: f(j, h, c, row) for column pair c
// = 8j + 2t of its row h (0: r0, 1: r0 + 8), row the ray's in x (-1 at or
// past n).
template <typename F>
__device__ __forceinline__ void each_own(int row0, int n, int wtid, F f) {
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < kW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = row0 + r0 + 8 * h;
      f(j, h, 8 * j + 2 * (lane % 4), g < n ? g : -1);
    }
}
__device__ __forceinline__ float2 load2(const float* x, int g, int c) {
  return g < 0 ? make_float2(0.f, 0.f)
               : __ldg(reinterpret_cast<const float2*>(x + (size_t)g * kW +
                                                       c));
}
__device__ __forceinline__ void store2(float* out, int g, int c, float2 v) {
  if (g >= 0) *reinterpret_cast<float2*>(out + (size_t)g * kW + c) = v;
}

// A bf16 pair at (r, c), c even, of a core-matrix tile of kW bf16 a row.
__device__ __forceinline__ __nv_bfloat162& at2(unsigned char* t, int r,
                                               int c) {
  return *reinterpret_cast<__nv_bfloat162*>(t + cm_off(r, 2 * c, 2 * kW));
}
// The low bytes of two words (q8b's, or a wrapped int8 cast) into the
// pair (r, c), c even, of a core-matrix tile of kW int8 a row.
__device__ __forceinline__ void putq(unsigned char* q, int r, int c, int x0,
                                     int x1) {
  *reinterpret_cast<uint16_t*>(q + cm_off(r, c, kW)) =
      (uint16_t)__byte_perm(x0, x1, 0x0040);
}

// ---- the bf16 chains: the probe chain's three modes, the control --------

// The epilogue of each layer (kFull, kLean, kNone: the chain's modes, every
// layer; kResMLP: the ResMLP body's bf16 control, layer 2b the block's
// inner layer, kFull's, and 2b + 1 its output).
enum Bf16Form { kFull = 0, kLean = 1, kNone = 2, kResMLP = 3 };

struct Bf16Args {
  const float* x;   // [n, 256] f32
  int n;
  const unsigned char* staged;  // n_layers x 4 stages of bf16 weights
  const float* b;   // [n_layers, 256] f32 (kNone: unused)
  float rs;         // kResMLP: the residual scale
  float* out;       // [n, 256] f32
  int n_layers;
};

// A chain layer's output before its rounding to bf16, from the f32 sum v
// and the bias b of its column.
template <int kForm>
__device__ __forceinline__ float chain_out(float v, float b) {
  if (kForm == kLean)  // the dot and the bias rounded to bf16, summed in f32
    return fmaxf(__fadd_rn(rnd<__nv_bfloat16>(v), rnd<__nv_bfloat16>(b)),
                 0.f);
  if (kForm == kNone) return v;
  return fmaxf(__fadd_rn(v, b), 0.f);  // kFull, K1's inner layer
}

template <int kForm, bool kDual>
__global__ void __launch_bounds__(kWG * 3, 1)
    probe_bf16_kernel(const Bf16Args a) {
  using K = RingBF16;
  constexpr int kTile = 64 * kW * 2;  // a warpgroup's A
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  if (!start<__nv_bfloat16, K>(smem, 2 * kTile, a.staged, a.n_layers * 4,
                               ring))
    return;
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const int row0 = (blockIdx.x * 2 + wg) * 64, bar_id = 1 + wg;
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
  unsigned char* A = smem + wg * kTile;
  const Turns<kDual> turns{wg};
  // the control's residual stream: the thread's pairs, [j][h]
  [[maybe_unused]] __nv_bfloat162 hr[kW / 8][2];

  each_own(row0, a.n, wtid, [&](int j, int h, int c, int g) {
    const float2 v = load2(a.x, g, c);
    const __nv_bfloat162 hb = __floats2bfloat162_rn(v.x, v.y);
    at2(A, r0 + 8 * h, c) = hb;
    if constexpr (kForm == kResMLP) hr[j][h] = hb;
  });

  float acc[kW / 2];
  int it = 0;  // this warpgroup's place in the ring
  for (int i = 0; i < a.n_layers; ++i) {
    fence_async_smem();  // the epilogue's writes, before wgmma reads them
    wg_bar(bar_id);
    turns.before(i);
    product<__nv_bfloat16, kW, kC, K>(acc, A, 2 * kW, kW, A, 2 * kW, kW,
                                      ring, it, wtid);
    turns.after();
    const float* b = a.b + (size_t)i * kW;
#pragma unroll
    for (int j0 = 0; j0 < kW / 8; j0 += 4) {
      float2 bb[4];  // four column pairs' biases, loaded ahead of their use
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bb[q] = kForm == kNone ? make_float2(0.f, 0.f)
                               : ldg2(b + 8 * (j0 + q) + 2 * (lane % 4));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q, c = 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          __nv_bfloat162 y;
          if constexpr (kForm == kResMLP) {
            if (i & 1) {  // block output: bf16((t + b) * rs + f32(h)) from
                          // the unrounded t, the plain version's order
              const float2 hv = __bfloat1622float2(hr[j][h]);
              y = __floats2bfloat162_rn(
                  __fadd_rn(__fmul_rn(__fadd_rn(v0, bb[q].x), a.rs), hv.x),
                  __fadd_rn(__fmul_rn(__fadd_rn(v1, bb[q].y), a.rs), hv.y));
              hr[j][h] = y;
            } else {
              y = __floats2bfloat162_rn(chain_out<kFull>(v0, bb[q].x),
                                        chain_out<kFull>(v1, bb[q].y));
            }
          } else {
            y = __floats2bfloat162_rn(chain_out<kForm>(v0, bb[q].x),
                                      chain_out<kForm>(v1, bb[q].y));
          }
          at2(A, r0 + 8 * h, c) = y;
        }
      }
    }
  }
  turns.finish();
  each_own(row0, a.n, wtid, [&](int j, int h, int c, int g) {
    __nv_bfloat162 y;
    if constexpr (kForm == kResMLP)
      y = hr[j][h];
    else
      y = at2(A, r0 + 8 * h, c);
    store2(a.out, g, c, __bfloat1622float2(y));
  });
  cluster_sync();
}

// ---- the int8 ResMLP body ------------------------------------------------

struct S8Args {
  const float* x;   // [n, 256] f32
  int n;
  const unsigned char* staged;  // 2 nb layers x 2 stages of s8 weights
  const float4* mb;  // [2 nb][128]: each column pair's (m, b, m', b')
  float inv_a;       // the static activation scale's inverse
  float* out;        // [n, 256] f32
  int nb;            // blocks
};

// int8 (kFold false) and its folded requantize (kFold true), both with the
// table's constants staged on the host, each product rounded on its own:
// layer 2b's (m, b), folded (m * inv_a, b * inv_a); layer 2b + 1's
// (m * rs, b * rs).
template <bool kFold, bool kDual>
__global__ void __launch_bounds__(kWG * 3, 1)
    probe_s8_kernel(const S8Args a) {
  using K = Kind<int8_t>;
  constexpr int kQ = 64 * kW, kH = 64 * kW * 2;  // a warpgroup's Q and H
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  if (!start<int8_t, K>(smem, 2 * (kQ + kH), a.staged, a.nb * 4, ring))
    return;
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const int row0 = (blockIdx.x * 2 + wg) * 64, bar_id = 1 + wg;
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
  const int t = lane % 4;
  unsigned char* Qm = smem + wg * kQ;
  __nv_bfloat162* hs =
      reinterpret_cast<__nv_bfloat162*>(smem + 2 * kQ + wg * kH);
  const float inv = a.inv_a;
  const Turns<kDual> turns{wg};
  // the thread's pair (c, c + 1) of its row h in H, the accumulator's order
  auto at = [&](int h, int c) { return ((c / 8) * 2 + h) * kWG + wtid; };
  // a block's input: q8(f32(h) * inv_a), the product rounded on its own
  auto quantize = [&](int h, int c, __nv_bfloat162 hb) {
    const float2 v = __bfloat1622float2(hb);
    putq(Qm, r0 + 8 * h, c, q8b(__fmul_rn(v.x, inv)),
         q8b(__fmul_rn(v.y, inv)));
  };

  each_own(row0, a.n, wtid, [&](int, int h, int c, int g) {
    const float2 v = load2(a.x, g, c);
    const __nv_bfloat162 hb = __floats2bfloat162_rn(v.x, v.y);
    hs[at(h, c)] = hb;
    quantize(h, c, hb);
  });

  int acc[kW / 2];
  int it = 0;
  for (int blk = 0; blk < a.nb; ++blk) {
    for (int l = 0; l < 2; ++l) {
      const int idx = 2 * blk + l;
      fence_async_smem();
      wg_bar(bar_id);
      turns.before(idx);
      product<int8_t, kW, kC, K>(acc, Qm, kW, kW, Qm, kW, kW, ring, it, wtid);
      turns.after();
      const float4* mb = a.mb + (size_t)idx * (kW / 2);
      if (l == 0) {  // inner: ReLU, then the second layer's int8 input
        each_pair<kW>(mb, t, [&](int j, int c, float4 p) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float t0 = __fmaf_rn(i2f(acc[4 * j + 2 * h]), p.x, p.y);
            const float t1 = __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), p.z, p.w);
            if (kFold)  // clip(rint(t), 0, 127): the ReLU is the floor
              putq(Qm, r0 + 8 * h, c, q8b_relu(t0), q8b_relu(t1));
            else        // q8(relu(t) * inv_a), no bf16 (K4's kTrainQ)
              putq(Qm, r0 + 8 * h, c,
                   q8b(__fmul_rn(fmaxf(t0, 0.f), inv)),
                   q8b(__fmul_rn(fmaxf(t1, 0.f), inv)));
          }
        });
        continue;
      }
      // block output: bf16(t2 + f32(h)) rounded once from f32 (K8's
      // kTrainB), then the next block's input in the same pass
      const bool last = blk + 1 == a.nb;
      each_pair<kW>(mb, t, [&](int j, int c, float4 p) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float t0 = __fmaf_rn(i2f(acc[4 * j + 2 * h]), p.x, p.y);
          const float t1 = __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), p.z, p.w);
          const float2 ho = __bfloat1622float2(hs[at(h, c)]);
          const __nv_bfloat162 hn = __floats2bfloat162_rn(
              __fadd_rn(t0, ho.x), __fadd_rn(t1, ho.y));
          hs[at(h, c)] = hn;
          if (!last) quantize(h, c, hn);
        }
      });
    }
  }
  turns.finish();
  each_own(row0, a.n, wtid, [&](int, int h, int c, int g) {
    store2(a.out, g, c, __bfloat1622float2(hs[at(h, c)]));
  });
  cluster_sync();
}

// blocks of 128 rays over n, padded to whole clusters
inline int blocks_of(int n) {
  return ((n + kRows - 1) / kRows + kC - 1) / kC * kC;
}

template <int kForm, bool kDual>
cudaError_t launch_bf16_as(const Bf16Args& a, cudaStream_t s) {
  return launch_cluster<__nv_bfloat16, kC, RingBF16>(
      probe_bf16_kernel<kForm, kDual>, a, blocks_of(a.n),
      smem_bytes<RingBF16>(2 * 64 * kW * 2), s);
}
template <int kForm>
cudaError_t launch_bf16(const Bf16Args& a, int dual, cudaStream_t s) {
  return dual ? launch_bf16_as<kForm, true>(a, s)
              : launch_bf16_as<kForm, false>(a, s);
}

template <bool kFold, bool kDual>
cudaError_t launch_s8_as(const S8Args& a, cudaStream_t s) {
  return launch_cluster<int8_t, kC>(
      probe_s8_kernel<kFold, kDual>, a, blocks_of(a.n),
      smem_bytes<Kind<int8_t>>(2 * 64 * kW * 3), s);
}
template <bool kFold>
cudaError_t launch_s8(const S8Args& a, int dual, cudaStream_t s) {
  return dual ? launch_s8_as<kFold, true>(a, s)
              : launch_s8_as<kFold, false>(a, s);
}

// The pointers the kernels read 16 bytes at a time (x and out 8)
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace probe_h
