// K2 on Hopper: the student's PE-fused static-scale int8 chain on wgmma s8
// (r2l_int8_hopper.cu); on the same kernel K4 and K8, the int8 training
// forward with its stash (r2l_train_fwd_int8.cu; its forms are described
// below K2's), the probe of K2's requantize epilogue (two forms), and the
// probe of its ray streams (two schedules beside K2's own), described last.
//
// The function is r2l_tpu/kernels/r2l_pallas.py::_int8_pe_chain, as the
// plain version int8_pe_chain_ref computes it, bit for bit:
//   * each PE part (the double-angle ladder, r2l::pe_ladder) is quantized
//     with its column's inverse scale, q8(x * inv): round half even, clip
//     to +-127, the product rounded on its own (__fmul_rn);
//   * every product is int8 x int8 -> int32, exact;
//   * dequantize acc * m + b as one FMA (r2l::dequant); ReLU on inner
//     layers; the first layer of each block quantizes the bf16 residual
//     stream with its inverse scale, the tail quantizes h (+ the f32 h0);
//   * an inner layer's output becomes the next layer's int8 input in one of
//     three forms (the reference's fold_requant / nobf16_inner flags):
//     kDeployed q8(relu(t)) (the scale folded into m, b), kFold
//     q8(bf16(relu(t))), kUnfolded q8(bf16(relu(t)) * inv);
//   * the block tail is cast to bf16 and added to the bf16 residual stream
//     in f32, rounded; h0 stays f32 for the global residual; the tail is an
//     int8 dot, dequantized, then sigmoid;
//   * with bf16_resid (each form plus kBf16Resid) h0 is rounded to bf16 and
//     the tail's input h + h0 is rounded to bf16 before it is quantized.
//
// Design (the student's Hopper skeleton, r2l_hopper.cuh, on hopper_ring.cuh
// and hopper_wgmma.cuh): a block owns 128 rays, two consumer warpgroups of
// 64 (wgmma's M), and one producer warpgroup of which one thread copies the
// weights. Two blocks form a cluster and share a ring of four slots into
// which the staged s8 image (stage_int8_chain: the head's stages, then each
// body layer's, KS = 128 input channels for all W outputs, 64 at W64, laid
// out as wgmma reads B) is bulk-copied, each half multicast into both, so
// the image is read from L2 once per 256 rays and no block barrier sits in
// the k-loop. Products are wgmma m64nWk32 s8, both operands K-major in
// shared memory: the activations Q [64 rays x W] int8 per warpgroup in the
// core-matrix layout, written by the previous epilogue.
//
// The two consumer warpgroups run half a layer apart in the body (a
// ping-pong): warpgroup 1 starts a layer's products when warpgroup 0's are
// done, warpgroup 0 the next layer's when warpgroup 1's are, so one's
// products run under the other's epilogue (measured on an H100: 4% faster
// than both at once; PERF.md).
//
// Epilogues run on the accumulator registers, each column pair's (m, b)
// one float4 of the image's table: dequantize, ReLU, requantize straight
// into Q, int32 to f32 and the requantize's rounding by adds of 1.5 * 2^23
// (the conversion instructions measured 11% slower). The block tail adds
// the residual stream H, kept in shared memory as bf16 in the
// accumulator's own order (each thread reads and writes only its own
// values), by one bf16 add (f32 adds and a rounding, the same value,
// measured 7% slower), and quantizes the next block's input in the same
// pass: the old chain's separate requantize over H is gone. h0, in f32,
// does not fit beside the ring: it is parked in a device-memory scratch in
// the accumulator's order (the wrapper's, [blocks x 128 x W] f32) and read
// back by the tail, which quantizes h (+ h0) and takes its dot products
// (each thread's partial sums over its columns, then two quad shuffles).
//
// The head's input (1,008 int8 columns, padded to 1,024) does not fit
// beside the ring either: it is produced in slices of 2W columns into Q and
// H, which are free then, quantized as it is encoded, and the head
// accumulates over the slices. The image orders the head's columns so that
// a slice holds whole scalars (24 of the 48 at W256), so each scalar's
// ladder runs once (in the fields' freq-major order every slice ran every
// scalar's: the encoding measured 1.0 ms of a 5.4 ms frame, now 0.5).
//
// Shared memory at W256: Q 32 KB, H 64 KB, the ring 4 x 32 KB: 224 KB.
//
// What bounds it: 11.8 M int8 multiply-adds per ray at W256/D88, 1.89 T
// operations per 400x400 frame, 0.953 ms at the card's 1,979 TOP/s.
//
// K4 and K8 (kTrainQ, kTrainB): r2l_tpu/kernels/r2l_train_pallas.py::
// train_fwd_int8 as train_fwd_int8_ref computes it, bit for bit, on K2's
// head, ring, ping-pong and epilogue arithmetic, with four differences:
//   * both layers of a block quantize their input with its inverse scale
//     (calibrate_r2l_int8_pe(..., fold_requant=False)); K8's inner layer is
//     kUnfolded's q8(bf16(relu(t)) * inv), K4's q8(relu(t) * inv), no bf16;
//   * the block tail: K8 rounds h = bf16(t2 + float(h)) once from the f32
//     t2 (K2 rounds t2 to bf16 first); K4 keeps h in f32, h = t2 + h
//     (res_scale is folded into the tail's m and b);
//   * the inverse scales come from the image (stage_int8_train: the s8
//     weights, the (m, b) table, then every body layer's inverse input
//     scale), staged after each per-step calibration;
//   * the stash [2nb+1, n, W]: K4's rows are the q-values the products
//     consume (row b block b's input, nb+1+b its inner activation, nb the
//     tail's input with the global residual), which Q holds in the
//     core-matrix layout once an epilogue wrote them: after the barrier
//     that hands Q to the next product, one thread issues eight 8-ray boxes
//     of it through a tensor map (bulk stores, streaming out behind the
//     product), and waits until they have read Q before the next epilogue
//     writes it; row nb, never in Q, goes from the registers. K8's rows
//     (K3's in bf16: h_0, h_{b+1}, t1r) are never in a tile as they are
//     stashed, so each epilogue stores them from the registers, each
//     thread's column pairs (16 bytes a thread after a transpose within
//     the quad, K3 bf16's, measured no faster here; PERF.md).
// K4's f32 residual stream takes 128 KB (two warpgroups at W256), so its
// ring has four 16 KB slots of 64 channels (Q 32 KB + H 128 KB + ring 64
// KB = 224 KB); K8 keeps K2's layout (H bf16 64 KB, four 32 KB slots). Both
// keep h0 in f32 in the device scratch, as K2.
//
// The epilogue probe (kEpiV1, kEpiV2): exp/probe_epi.py::apply_variant's v1
// and v2 as r2l_tpu_torch/exp/probe_epi.py::apply_variant_ref computes
// them, bit for bit, on K2's kUnfolded packing and layout. Every body
// layer's input is quantized as clip(round(bf16(t * bf16(inv))), lo, 127),
// t a bf16 value: the product of two bf16 values is exact in f32 and is
// rounded once to bf16 (q8b_bf16). That is three places here: the head's
// epilogue (block 0's first layer) and the block tail (the next block's
// first layer), t the bf16 residual stream and lo = -127; and the inner
// epilogue, where v1 quantizes bf16(relu(t)) with lo = -127 and v2 bf16(t)
// with lo = 0, the ReLU folded into the clip (equal to v1 wherever the
// inverse scales are positive). The global tail's quantize stays K2's f32
// one. v0 of the probe is kUnfolded itself.
//
// The stream probe (kStreams1, kStreams4): exp/probe_pipe_lib.py::
// apply_int8_pe_streams, K2's deployed form with each ray tile split into S
// streams whose products are issued before any of their epilogues runs, as
// schedules of K2's consumer warpgroups, 64 rays each: rows never mix, so
// every S gives K2's output bit for bit, on K2's image (stage_int8_chain).
//   * S = 2 is K2's ping-pong itself (kDeployed): one warpgroup's products
//     under the other's epilogue.
//   * S = 1 (kStreams1), the control: K2 in lockstep, both warpgroups
//     starting each layer's products together (a named barrier) and so
//     running their epilogues together; K2 before its ping-pong. Built so
//     rather than as one warpgroup a block, which would also halve the rays
//     each weight stage serves: the interleave is then the only difference.
//   * S = 4 (kStreams4): four consumer warpgroups a block (256 rays), each a
//     turn behind the one before it (warpgroup k starts its products when
//     k - 1's are done, 0 when 3's are). Shared memory at W256: Q 64 KB
//     and H 128 KB leave room for a ring of two 16 KB slots only. Registers:
//     five warpgroups leave a consumer 112 after setmaxnreg (the producer
//     keeps 24), under the 128 of an m64n256 s32 accumulator, so each layer
//     is two products of W/2 outputs (m64n128k32, 64 registers), each with
//     its own turn and epilogue. A product reads the half of K2's image
//     stages that holds its outputs (a stage's rows are its outputs, eight
//     to a core-matrix row outermost, so each half is 16 KB of whole rows
//     and a slot): the same image, in another order. The first half's int8
//     outputs wait in 16 registers until the second half's product has
//     read Q. The head is halved the same way: half 0 over every slice, its
//     h0 parked in the device scratch (always allocated for this form), then
//     half 1 from the last slice back (the last one still in Q | H), after
//     which both halves' H and block 0's input are formed.
#pragma once

#include "hopper_ring.cuh"
#include "r2l_common.cuh"

namespace r2l8h {

using namespace hopper;
using r2l::dequant;
using r2l::q8;

// K2's three forms, the training forward's: K4 (int8 stash) and K8 (bf16
// stash), the epilogue probe's v1 and v2, and the stream probe's S = 1 and
// S = 4 (its S = 2 is kDeployed).
enum Epi {
  kDeployed = 0, kFold = 1, kUnfolded = 2, kTrainQ = 3, kTrainB = 4,
  kEpiV1 = 5, kEpiV2 = 6, kStreams1 = 7, kStreams4 = 8
};

// K2's three forms with the global residual in bf16 (Pallas bf16_resid):
// this flag added to kDeployed, kFold or kUnfolded (r2l_fused.py's
// BF16_RESID). h0 is the head's output rounded to bf16, and the tail's input
// h + h0 is rounded to bf16 before it is quantized.
constexpr int kBf16Resid = 16;
__host__ __device__ constexpr bool bf16_resid(int epi) {
  return (epi & kBf16Resid) != 0;
}

// the epilogue arithmetic of a form: the stream probe's is K2's deployed
// one, a bf16_resid form's its own form's
__host__ __device__ constexpr int arith(int epi) {
  return epi == kStreams1 || epi == kStreams4 ? kDeployed : epi & ~kBf16Resid;
}

// the forms that read each body layer's inverse scale from the image
__host__ __device__ constexpr bool image_inv(int epi) {
  return epi == kTrainQ || epi == kTrainB;
}
// the epilogue probe's forms: a bf16 product before every body layer
__host__ __device__ constexpr bool bf16_quantize(int epi) {
  return epi == kEpiV1 || epi == kEpiV2;
}

// The ring's shape (hopper::Kind's members) at width W in form kEpi, and
// kC, the blocks of a cluster: K4's f32 residual stream at W256 leaves room
// for stages of 64 channels only.
template <int W, int kEpi = kDeployed>
struct Chain8 {
  using Acc = int;
  static constexpr int kKS =
      W >= 128 && !(W == 256 && kEpi == kTrainQ) ? 128 : 64;
  static constexpr int kKSB = kKS, kWGs = 2;
  static constexpr int kStages = 4, kParts = 1;
  static constexpr bool kRegA = false;
  static constexpr int kC = 2;
  static constexpr int kN = W;  // outputs per product
};
// S = 4: four consumer warpgroups, two 16 KB slots, each product W/2
// outputs (a slot: half of K2's stage), 24 / 112 registers after setmaxnreg
template <int W>
struct Chain8<W, kStreams4> : Chain8<W, kDeployed> {
  static constexpr int kWGs = 4, kStages = 2, kN = W / 2;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 112;
};
// the head's columns as staged are rounded to this (int8_head_columns)
template <int W>
constexpr int head_align() {
  return W >= 128 ? 128 : 64;
}


// Everything a launch needs, passed by value (the kernel parameter space).
struct Args {
  const float* pts;  // [n, dp]
  int n, dp, L;
  const unsigned char* staged;  // stage_int8_chain's image
  const float* head_inv;  // [in_dim]
  const float* body_inv;  // [nb * nl, W]
  const int8_t* tail_q;                      // [out_dim, W]
  const float *tail_m, *tail_b, *tail_inv;   // [out_dim], [out_dim], [W]
  float* out;                                // [n, out_dim]
  float* h0;  // scratch: [blocks * 128 * W] f32
  void* stash;  // K4/K8: [2nb+1, n, W] int8 / bf16
  int nb, nl, out_dim, use_residual, linear_tail;
  // layout, set by plan()
  const float4* mb;  // the image's epilogue table: the head's, each body
                     // layer's (m[c], b[c], m[c+1], b[c+1]) per pair
  int kpad, off_h, off_ring, off_bar, slot_bytes, stages, smem;
};

template <int W, int kEpi>
inline void plan(Args& a) {
  using K = Chain8<W, kEpi>;
  // the head as staged: slices of 2W columns, each of whole scalars' parts
  // (sps scalars of P parts), the last one's columns rounded up to 128 (64
  // at W64)
  const int P = 2 * a.L + 1, sps = 2 * W / P;
  const int nsl = (a.dp + sps - 1) / sps;
  a.kpad = (nsl - 1) * 2 * W +
           r2l::round_up((a.dp - (nsl - 1) * sps) * P, head_align<W>());
  const int rows = 64 * K::kWGs;  // rays per block
  a.off_h = rows * W;  // Q: [rows][W] int8
  // H: [rows][W] bf16 (K4: f32)
  a.off_ring = a.off_h + rows * W * (kEpi == kTrainQ ? 4 : 2);
  a.slot_bytes = K::kN * K::kKSB;
  a.off_bar = a.off_ring + K::kStages * a.slot_bytes;
  a.smem = a.off_bar + 2 * K::kStages * 8;
  a.stages = (a.kpad + a.nb * a.nl * W) / K::kKS;  // the image's stages
  a.mb = reinterpret_cast<const float4*>(
      a.staged + (size_t)a.stages * W * K::kKS);
  if (image_inv(kEpi))  // the image's inverse scales, after the table
    a.body_inv = reinterpret_cast<const float*>(
        a.mb + (size_t)(1 + a.nb * a.nl) * (W / 2));
}

// blocks of `rows` rays over n, padded to whole 2-block clusters
inline long long blocks_of(int n, int rows) {
  const long long blocks = (n + rows - 1) / rows;
  return (blocks + 1) / 2 * 2;
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The int32 sum of a body layer as f32: |acc| <= 256 * 127 * 127 < 2^22,
// so the bits of 1.5 * 2^23 + acc, less 1.5 * 2^23, are exact (two
// full-rate adds where the conversion runs at a quarter of the rate).
__device__ __forceinline__ float i2f(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.f);
}

// q8 (round half even, clip to +-127) as the low byte of the result:
// clipping first gives the same integer, and adding 1.5 * 2^23 rounds it
// half to even into the float's low bits (as K7's q8i).
__device__ __forceinline__ int q8b(float y) {
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f),
                                  12582912.f));
}
// q8b(relu(y)): the ReLU is the clip's floor
__device__ __forceinline__ int q8b_relu(float y) {
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, 0.f), 127.f), 12582912.f));
}
// The epilogue probe's quantize of a column pair of bf16 values t with
// their bf16 inverse scales (inv_as): the exact f32 products, rounded to
// bf16 together (one packed conversion), then clipped to [lo, 127] (which
// also bounds a product far beyond the int8 range, or infinite) and
// rounded half to even as q8b, into the low bytes.
__device__ __forceinline__ int2 q8b_bf16(float2 t, float2 inv, float lo) {
  const float2 y = __bfloat1622float2(
      __floats2bfloat162_rn(__fmul_rn(t.x, inv.x), __fmul_rn(t.y, inv.y)));
  return make_int2(
      __float_as_int(__fadd_rn(fminf(fmaxf(y.x, lo), 127.f), 12582912.f)),
      __float_as_int(__fadd_rn(fminf(fmaxf(y.y, lo), 127.f), 12582912.f)));
}
// A column pair's inverse scales as form kEpi multiplies by them: the
// epilogue probe's rounded to bf16, once a pair for both of its rows.
template <int kEpi>
__device__ __forceinline__ float2 inv_as(float2 inv) {
  if constexpr (bf16_quantize(kEpi))
    return __bfloat1622float2(__floats2bfloat162_rn(inv.x, inv.y));
  else
    return inv;
}
// A block's first-layer input, a column pair of one row: the bf16 residual
// stream v (K4: f32) times the layer's inverse scales (inv_as), in f32, or
// as the probe's bf16 product.
template <int kEpi>
__device__ __forceinline__ int2 q8_in(float2 v, float2 inv) {
  if constexpr (bf16_quantize(kEpi))
    return q8b_bf16(v, inv, -127.f);
  else
    return make_int2(q8b(__fmul_rn(v.x, inv.x)), q8b(__fmul_rn(v.y, inv.y)));
}

// Named barriers 3 and 4 between the two consumer warpgroups (0 is the
// block's, 1 and 2 each warpgroup's own): sync waits for the other
// warpgroup's arrival, arrive does not wait.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Each column pair (c, c + 1) of the thread's accumulator with its
// epilogue constants p = (m[c], b[c], m[c+1], b[c+1]): f(j, c, p), four
// pairs' constants loaded ahead of their use.
template <int W, typename F>
__device__ __forceinline__ void each_pair(const float4* mb, int t, F f) {
#pragma unroll
  for (int j0 = 0; j0 < W / 8; j0 += 4) {
    float4 p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = __ldg(mb + 4 * (j0 + q) + t);
#pragma unroll
    for (int q = 0; q < 4; ++q) f(j0 + q, 8 * (j0 + q) + 2 * t, p[q]);
  }
}

// The head's input slice i (sw columns from column 2W i of the image's
// order) of a warpgroup's 64 rays from row0, into Q (the first W columns)
// and H (the rest, an int8 tile of W columns). A slice holds whole
// scalars, freq-major: column p * ns + sl of slice i is part p (sin octave
// p, cos octave p - L, or the identity) of scalar i * sps + sl, quantized
// with its inverse scale (head_inv is freq-major over all scalars: p * dp
// + s); neighbouring lanes store neighbouring bytes.
template <int W>
__device__ __forceinline__ void encode_slice(const Args& a, int i, int sw,
                                             unsigned char* Qm,
                                             unsigned char* Hm, int row0,
                                             int wtid) {
  const int P = 2 * a.L + 1, sps = 2 * W / P;
  const int ns = min(sps, a.dp - i * sps);  // scalars here
  auto put = [&](int r, int c, int8_t q) {
    unsigned char* t = Qm;
    if (c >= W) {
      t = Hm;
      c -= W;
    }
    reinterpret_cast<int8_t*>(t)[cm_off(r, c, W)] = q;
  };
  for (int e = wtid; e < 64 * ns; e += kWG) {
    const int r = e / ns, sl = e - r * ns, s = i * sps + sl;
    const int g = row0 + r;
    const float v = g < a.n ? a.pts[(size_t)g * a.dp + s] : 0.f;
    auto emit = [&](int p, float x) {
      const int8_t q = (int8_t)q8b(__fmul_rn(x, a.head_inv[p * a.dp + s]));
      put(r, p * ns + sl, q);
    };
    r2l::pe_ladder(v, a.L, [&](int j, float sn, float cs) {
      emit(j, sn);
      emit(a.L + j, cs);
    });
    emit(2 * a.L, v);
  }
  const int z0 = ns * P, nz = sw - z0;  // the zero padding
  if (nz > 0)
    for (int e = wtid; e < 64 * nz; e += kWG) {
      const int r = e / nz;
      put(r, z0 + e - r * nz, 0);
    }
}

// The tail of a warpgroup's 64 rays from row0 on its quantized input:
// qval(h, c) gives the thread's q pair of its row h at columns (c, c + 1),
// which seen(h, c, q) receives once (K4 stores it to stash row nb); the
// outputs four at a time, each thread's partial sums over its columns, then
// two quad shuffles.
template <int W, typename QV, typename Seen>
__device__ __forceinline__ void tail_dots(const Args& a, int row0, int wtid,
                                          QV qval, Seen seen) {
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
  for (int o0 = 0; o0 < a.out_dim; o0 += 4) {
    int p[2][4] = {};
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 q = qval(h, c);
        if (o0 == 0) seen(h, c, q);
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          if (o0 + o >= a.out_dim) break;
          dot2(p[h][o], q.x, q.y, head2(a.tail_q + (size_t)(o0 + o) * W + c));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (o0 + o >= a.out_dim) break;
        const int sum = quad_sum(p[h][o]);
        const int g = row0 + r0 + 8 * h;
        if (lane % 4 == 0 && g < a.n) {
          const float v = dequant(sum, a.tail_m[o0 + o], a.tail_b[o0 + o]);
          a.out[(size_t)g * a.out_dim + o0 + o] =
              a.linear_tail ? v : r2l::sigmoid(v);
        }
      }
  }
}

template <int W, int kEpi>
__global__ void __launch_bounds__(kWG * 3, 1)
    r2l_int8_hopper_kernel(const Args a,
                           const __grid_constant__ CUtensorMap stash_map) {
  using K = Chain8<W, kEpi>;
  constexpr bool kQ = kEpi == kTrainQ;  // K4: f32 h, int8 stash
  constexpr int kA = arith(kEpi);       // the epilogue's arithmetic
  constexpr bool kBR = bf16_resid(kEpi);  // h0 and the tail's input bf16
  constexpr bool kLockstep = kEpi == kStreams1;
  constexpr int kC = K::kC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const uint32_t rank = cluster_rank();
  Ring ring;
  ring.slots = smem_u32(smem + a.off_ring);
  ring.full = smem_u32(smem + a.off_bar);
  ring.empty = ring.full + 8 * K::kStages;
  ring.slot_bytes = a.slot_bytes;

  if (threadIdx.x == 0) ring_init<int8_t, kC, K>(ring);
  __syncthreads();
  cluster_sync();

  if (wg == K::kWGs) {  // the producer: every stage, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0)
      for (int it = 0; it < a.stages; ++it)
        fill<int8_t, kC, K>(ring, it, a.staged + (size_t)it * a.slot_bytes,
                            a.slot_bytes, rank);
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int tile = blockIdx.x * K::kWGs + wg, row0 = tile * 64;
  const int bar_id = 1 + wg;
  unsigned char* Qm = smem + wg * 64 * W;
  unsigned char* Hm = smem + a.off_h + wg * 64 * W * (kQ ? 4 : 2);
  __nv_bfloat162* hs = reinterpret_cast<__nv_bfloat162*>(Hm);
  float2* hf = reinterpret_cast<float2*>(Hm);  // K4's f32 h
  float2* h0s = reinterpret_cast<float2*>(a.h0) + (size_t)tile * 64 * (W / 2);
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
  const bool res = a.use_residual;

  // K4: the stash row Q holds for the bulk stores after the next barrier
  // (-1: none)
  int pend_row = -1;
  auto tiles_ready = [&]() {
    fence_async_smem();
    wg_bar(bar_id);
    if constexpr (kQ) {
      if (pend_row >= 0 && wtid == 0) {
        for (int rg = 0; rg < 8; ++rg)
          if (row0 + 8 * rg < a.n)
            bulk_store_box(&stash_map, smem_u32(Qm + rg * 8 * W), 0,
                           row0 + 8 * rg, 0, pend_row);
        bulk_commit();
      }
      pend_row = -1;
    }
  };
  // K4: Q's bulk stores have read it, for the epilogue that overwrites it
  auto q_free = [&]() {
    if constexpr (kQ) {
      if (wtid == 0) bulk_wait_read<0>();
      wg_bar(bar_id);
    }
  };
  // the thread's pair (c, c + 1) of its row h (0: r0, 1: r0 + 8) in an
  // accumulator-ordered tile
  auto at = [&](int h, int c) { return ((c / 8) * 2 + h) * kWG + wtid; };
  // a pair of q8b words into Q at (r, c), c even: their low bytes
  auto putq = [&](int r, int c, int x0, int x1) {
    *reinterpret_cast<uint16_t*>(Qm + cm_off(r, c, W)) =
        (uint16_t)__byte_perm(x0, x1, 0x0040);
  };
  // K4/K8: the stash's pair (c, c + 1) of row r in stash row `row`
  auto stash_at = [&](int row, int r, int c) -> void* {
    const int g = row0 + r;
    if (g >= a.n) return nullptr;
    const size_t i = ((size_t)row * a.n + g) * W + c;
    return kQ ? static_cast<void*>(static_cast<int8_t*>(a.stash) + i)
              : static_cast<void*>(static_cast<__nv_bfloat16*>(a.stash) + i);
  };
  // K4: the low bytes of two q8 values into stash row `row` (the tail's
  // input, never in Q)
  auto stashq = [&](int row, int r, int c, int x0, int x1) {
    if constexpr (kQ) {
      if (void* p = stash_at(row, r, c))
        *static_cast<uint16_t*>(p) = (uint16_t)__byte_perm(x0, x1, 0x0040);
    }
  };
  // K8: the bf16 pair of column group j (columns 8j + 2t, + 1) of the
  // thread's row h into stash row `row`
  auto stashb = [&](int row, int j, int h, __nv_bfloat162 v) {
    if constexpr (kEpi == kTrainB) {
      if (void* p = stash_at(row, r0 + 8 * h, 8 * j + 2 * (lane % 4)))
        *static_cast<__nv_bfloat162*>(p) = v;
    }
  };

  int acc[W / 2];
  int it = 0;  // this warpgroup's place in the ring

  // ---- the head, over the image's slices of 2W input columns: [0, W) in
  // Q, [W, 2W) in H (encode_slice) ----
  for (int i = 0, c0 = 0; c0 < a.kpad; ++i, c0 += 2 * W) {
    const int sw = min(2 * W, a.kpad - c0);             // columns here
    if (c0 > 0) wg_bar(bar_id);  // every warp's product read the last slice
    encode_slice<W>(a, i, sw, Qm, Hm, row0, wtid);
    tiles_ready();
    product<int8_t, W, kC, K>(acc, Qm, W, W, Hm, W, sw, ring, it, wtid,
                              c0 > 0);
  }

  // The tail on its quantized input, qval(h, c) (tail_dots; K4 stores it
  // to stash row nb).
  auto tail = [&](auto qval) {
    tail_dots<W>(a, row0, wtid, qval, [&](int h, int c, int2 q) {
      stashq(a.nb, r0 + 8 * h, c, q.x, q.y);
    });
  };
  // the tail's input of h (+ h0): q8((h [+ h0]) * tail_inv); bf16_resid:
  // h + h0 of two bf16 values rounded to bf16 (the bf16 add)
  auto tail_in = [&](float2 hv, int h, int c) -> int2 {
    if (res) {
      const float2 z = h0s[at(h, c)];
      hv.x = __fadd_rn(hv.x, z.x);
      hv.y = __fadd_rn(hv.y, z.y);
      if constexpr (kBR)
        hv = __bfloat1622float2(__floats2bfloat162_rn(hv.x, hv.y));
    }
    const float2 inv = ldg2(a.tail_inv + c);
    return make_int2(q8(__fmul_rn(hv.x, inv.x)), q8(__fmul_rn(hv.y, inv.y)));
  };

  // ---- the head's epilogue: h0 (f32; bf16_resid: bf16(h0), parked as
  // f32), H = bf16(h0), and the input of
  // block 0's first layer. H's accumulator order crosses the rows of the
  // slice it held, which other warps' products may still read: a barrier
  // first. ----
  wg_bar(bar_id);
  const int t = lane % 4;
  each_pair<W>(a.mb, t, [&](int j, int c, float4 p) {
    const float2 inv = inv_as<kEpi>(
        a.nb > 0 ? ldg2(a.body_inv + c) : make_float2(0.f, 0.f));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = fmaxf(dequant(acc[4 * j + 2 * h], p.x, p.y), 0.f);
      const float x1 = fmaxf(dequant(acc[4 * j + 2 * h + 1], p.z, p.w), 0.f);
      const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
      if (res)
        h0s[at(h, c)] = kBR ? __bfloat1622float2(hb) : make_float2(x0, x1);
      // K4 runs on the f32 h0, K2 and K8 on its bf16 rounding
      const float2 hv = kQ ? make_float2(x0, x1) : __bfloat1622float2(hb);
      if constexpr (kQ)
        hf[at(h, c)] = hv;
      else
        hs[at(h, c)] = hb;
      stashb(0, j, h, hb);
      if (a.nb > 0) {
        const int2 q = q8_in<kEpi>(hv, inv);
        putq(r0 + 8 * h, c, q.x, q.y);
      }
    }
  });
  pend_row = 0;  // K4: block 0's input
  // the thread's final h at (c, c + 1) of its row h, as f32
  auto h_of = [&](int h, int c) -> float2 {
    if constexpr (kQ)
      return hf[at(h, c)];
    else
      return __bfloat1622float2(hs[at(h, c)]);
  };
  if (a.nb == 0) {  // no body: h = h0
    tail([&](int h, int c) { return tail_in(h_of(h, c), h, c); });
    cluster_sync();
    return;
  }

  // ---- the body ----
  for (int blk = 0; blk < a.nb; ++blk) {
    for (int jl = 0; jl < a.nl; ++jl) {
      const int idx = blk * a.nl + jl;
      const float4* mb = a.mb + (size_t)(1 + idx) * (W / 2);
      tiles_ready();
      // warpgroup 0 leads, 1 follows half a layer behind; in lockstep (the
      // stream probe's S = 1) both start each layer together
      if (kLockstep) pair_sync(3);
      else if (wg == 1) pair_sync(3);
      else if (idx > 0) pair_sync(4);
      product<int8_t, W, kC, K>(acc, Qm, W, W, Qm, W, W, ring, it, wtid);
      if (!kLockstep) pair_arrive(wg == 0 ? 3 : 4);
      q_free();
      if (jl + 1 < a.nl) {  // inner: ReLU, then the next layer's int8 input
        const float* inv = a.body_inv + (size_t)(idx + 1) * W;
        each_pair<W>(mb, t, [&](int j, int c, float4 p) {
          float2 iv = make_float2(0.f, 0.f);
          if (kA >= kUnfolded) iv = inv_as<kEpi>(ldg2(inv + c));
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // t0, t1 before the ReLU
            const float t0 = __fmaf_rn(i2f(acc[4 * j + 2 * h]), p.x, p.y);
            const float t1 = __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), p.z, p.w);
            const int r = r0 + 8 * h;
            int x0, x1;
            if (kA == kDeployed) {           // scale folded, no bf16
              x0 = q8b_relu(t0);
              x1 = q8b_relu(t1);
            } else if (kA == kFold) {        // scale folded, through bf16
              const float2 v = __bfloat1622float2(__floats2bfloat162_rn(t0, t1));
              x0 = q8b_relu(v.x);
              x1 = q8b_relu(v.y);
            } else if (kEpi == kTrainQ) {    // f32 multiply, no bf16
              x0 = q8b(__fmul_rn(fmaxf(t0, 0.f), iv.x));
              x1 = q8b(__fmul_rn(fmaxf(t1, 0.f), iv.y));
            } else if (bf16_quantize(kEpi)) {  // bf16 multiply; v2: the
              const bool v2 = kEpi == kEpiV2;  // ReLU as the clip's floor
              const int2 q = q8b_bf16(
                  __bfloat1622float2(__floats2bfloat162_rn(
                      v2 ? t0 : fmaxf(t0, 0.f), v2 ? t1 : fmaxf(t1, 0.f))),
                  iv, v2 ? 0.f : -127.f);
              x0 = q.x;
              x1 = q.y;
            } else {                         // f32 multiply by the scale
              const __nv_bfloat162 vb =
                  __floats2bfloat162_rn(fmaxf(t0, 0.f), fmaxf(t1, 0.f));
              const float2 v = __bfloat1622float2(vb);
              x0 = q8b(__fmul_rn(v.x, iv.x));
              x1 = q8b(__fmul_rn(v.y, iv.y));
              stashb(a.nb + 1 + blk, j, h, vb);
            }
            putq(r, c, x0, x1);
          }
        });
        pend_row = a.nb + 1 + blk;  // K4: the inner activation's q
        continue;
      }
      // block tail: bf16, + the block input in f32, bf16; then the next
      // block's first-layer input, or (last block) the tail
      // (the sum of two bf16 values rounded once to bf16 is the f32 sum
      // rounded to bf16: an f32 rounding of it never lands on a bf16 tie).
      // K8: the f32 t2 + the bf16 h in f32, rounded once; K4: h in f32.
      // K8 stashes h_{blk+1} in stash row blk + 1.
      auto block_out = [&](int j, int h, int c, float4 p) -> float2 {
        const float t0 = __fmaf_rn(i2f(acc[4 * j + 2 * h]), p.x, p.y);
        const float t1 = __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), p.z, p.w);
        if constexpr (kQ) {
          const float2 ho = hf[at(h, c)];
          const float2 hn = make_float2(__fadd_rn(t0, ho.x),
                                        __fadd_rn(t1, ho.y));
          hf[at(h, c)] = hn;
          return hn;
        } else {
          __nv_bfloat162 hn;
          if constexpr (kEpi == kTrainB) {
            const float2 ho = __bfloat1622float2(hs[at(h, c)]);
            hn = __floats2bfloat162_rn(__fadd_rn(t0, ho.x),
                                       __fadd_rn(t1, ho.y));
            stashb(blk + 1, j, h, hn);
          } else {
            hn = __hadd2(__floats2bfloat162_rn(t0, t1), hs[at(h, c)]);
          }
          hs[at(h, c)] = hn;
          return __bfloat1622float2(hn);
        }
      };
      if (blk + 1 < a.nb) {
        const float* inv = a.body_inv + (size_t)(blk + 1) * a.nl * W;
        each_pair<W>(mb, t, [&](int j, int c, float4 p) {
          const float2 iv = inv_as<kEpi>(ldg2(inv + c));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int2 q = q8_in<kEpi>(block_out(j, h, c, p), iv);
            putq(r0 + 8 * h, c, q.x, q.y);
          }
        });
        pend_row = blk + 1;  // K4: the next block's input
        continue;
      }
      // the last block: finish h, then the tail on h (+ h0)
      each_pair<W>(mb, t, [&](int j, int c, float4 p) {
#pragma unroll
        for (int h = 0; h < 2; ++h) block_out(j, h, c, p);
      });
      tail([&](int h, int c) { return tail_in(h_of(h, c), h, c); });
    }
  }
  if (wg == 0 && !kLockstep) pair_sync(4);  // warpgroup 1's last arrival
  if constexpr (kQ) {  // every bulk store has written its row
    if (wtid == 0) bulk_wait<0>();
  }
  cluster_sync();
}

// Named barriers of the stream probe's S = 4 turns, 5 + k for warpgroup k
// (1..4 are the warpgroups' own): k waits on its own, which k - 1 (3 for 0)
// passes when its products are done.
__device__ __forceinline__ void turn_sync(int k) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(5 + k) : "memory");
}
__device__ __forceinline__ void turn_arrive(int k) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(5 + k) : "memory");
}

// The stream probe at S = 4 (kStreams4, described at the top): K2's
// deployed form, four consumer warpgroups a block, each product W/2
// outputs of half of K2's image stages, each warpgroup a turn behind the
// one before it.
template <int W>
__global__ void __launch_bounds__(kWG * 5, 1)
    r2l_int8_streams4_kernel(const Args a) {
  using K = Chain8<W, kStreams4>;
  constexpr int kC = K::kC, kN = K::kN;   // outputs per product
  constexpr int kSt = W / K::kKS;         // the image's stages a body layer
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const uint32_t rank = cluster_rank();
  Ring ring;
  ring.slots = smem_u32(smem + a.off_ring);
  ring.full = smem_u32(smem + a.off_bar);
  ring.empty = ring.full + 8 * K::kStages;
  ring.slot_bytes = a.slot_bytes;

  if (threadIdx.x == 0) ring_init<int8_t, kC, K>(ring);
  __syncthreads();
  cluster_sync();

  const int P = 2 * a.L + 1, sps = 2 * W / P;
  const int nsl = (a.dp + sps - 1) / sps;
  // the head's slices: half 0 from the first, half 1 from the last
  auto slice = [&](int hf, int s) { return hf == 0 ? s : nsl - 1 - s; };
  auto slice_cols = [&](int i) { return min(2 * W, a.kpad - i * 2 * W); };

  if (wg == K::kWGs) {  // the producer: half-stages, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        K::kProducerRegs));
    if (wtid == 0) {
      int it = 0;
      auto copy = [&](int g, int hf) {  // half hf of the image's stage g
        fill<int8_t, kC, K>(ring, it++,
                            a.staged + (size_t)g * W * K::kKS +
                                hf * a.slot_bytes,
                            a.slot_bytes, rank);
      };
      for (int hf = 0; hf < 2; ++hf)
        for (int s = 0; s < nsl; ++s) {
          const int i = slice(hf, s), g0 = i * 2 * W / K::kKS;
          for (int g = g0; g < g0 + slice_cols(i) / K::kKS; ++g) copy(g, hf);
        }
      const int head = a.kpad / K::kKS;
      for (int idx = 0; idx < a.nb * a.nl; ++idx)
        for (int hf = 0; hf < 2; ++hf)
          for (int st = 0; st < kSt; ++st) copy(head + idx * kSt + st, hf);
    }
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      K::kConsumerRegs));

  const int tile = blockIdx.x * K::kWGs + wg, row0 = tile * 64;
  const int bar_id = 1 + wg;
  unsigned char* Qm = smem + wg * 64 * W;
  unsigned char* Hm = smem + a.off_h + wg * 64 * W * 2;
  __nv_bfloat162* hs = reinterpret_cast<__nv_bfloat162*>(Hm);
  float2* h0s = reinterpret_cast<float2*>(a.h0) + (size_t)tile * 64 * (W / 2);
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
  const int t = lane % 4;
  auto tiles_ready = [&]() {
    fence_async_smem();
    wg_bar(bar_id);
  };
  auto at = [&](int h, int c) { return ((c / 8) * 2 + h) * kWG + wtid; };
  auto putq = [&](int r, int c, uint32_t pair) {
    *reinterpret_cast<uint16_t*>(Qm + cm_off(r, c, W)) = (uint16_t)pair;
  };
  // two q8b words as the pair of bytes putq stores
  auto qpair = [](int x0, int x1) {
    return (uint32_t)__byte_perm(x0, x1, 0x0040) & 0xFFFFu;
  };

  int acc[kN / 2];
  int it = 0;  // this warpgroup's place in the ring

  // ---- the head, half by half (half 1's first slice is half 0's last,
  // still in Q | H) ----
  for (int hf = 0; hf < 2; ++hf) {
    for (int s = 0; s < nsl; ++s) {
      const int i = slice(hf, s), sw = slice_cols(i);
      if (hf == 0 || s > 0) {
        if (hf > 0 || s > 0) wg_bar(bar_id);  // the last slice was read
        encode_slice<W>(a, i, sw, Qm, Hm, row0, wtid);
        tiles_ready();
      }
      product<int8_t, kN, kC, K>(acc, Qm, W, W, Hm, W, sw, ring, it, wtid,
                                 s > 0);
    }
    if (hf == 0)  // half 0's h0, parked until Q and H are free
      each_pair<kN>(a.mb, t, [&](int j, int c, float4 p) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          h0s[at(h, c)] = make_float2(
              fmaxf(dequant(acc[4 * j + 2 * h], p.x, p.y), 0.f),
              fmaxf(dequant(acc[4 * j + 2 * h + 1], p.z, p.w), 0.f));
      });
  }
  // H = bf16(h0) and block 0's input, half 1 from the accumulator, half 0
  // from the scratch (H's accumulator order crosses the rows of the slice
  // it held, which other warps' products may still read: a barrier first)
  wg_bar(bar_id);
  auto head_out = [&](int h, int c, float x0, float x1, float2 inv) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
    hs[at(h, c)] = hb;
    if (a.nb > 0) {
      const float2 hv = __bfloat1622float2(hb);
      putq(r0 + 8 * h, c, qpair(q8b(__fmul_rn(hv.x, inv.x)),
                                q8b(__fmul_rn(hv.y, inv.y))));
    }
  };
  auto body_inv0 = [&](int c) {
    return a.nb > 0 ? ldg2(a.body_inv + c) : make_float2(0.f, 0.f);
  };
  each_pair<kN>(a.mb + kN / 2, t, [&](int j, int c, float4 p) {
    c += kN;
    const float2 inv = body_inv0(c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = fmaxf(dequant(acc[4 * j + 2 * h], p.x, p.y), 0.f);
      const float x1 = fmaxf(dequant(acc[4 * j + 2 * h + 1], p.z, p.w), 0.f);
      h0s[at(h, c)] = make_float2(x0, x1);
      head_out(h, c, x0, x1, inv);
    }
  });
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 inv = body_inv0(c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = h0s[at(h, c)];
      head_out(h, c, x.x, x.y, inv);
    }
  }

  // the tail's input of h (+ h0): q8((h [+ h0]) * tail_inv)
  auto tail = [&]() {
    tail_dots<W>(a, row0, wtid, [&](int h, int c) -> int2 {
      float2 hv = __bfloat1622float2(hs[at(h, c)]);
      if (a.use_residual) {
        const float2 z = h0s[at(h, c)];
        hv.x = __fadd_rn(hv.x, z.x);
        hv.y = __fadd_rn(hv.y, z.y);
      }
      const float2 inv = ldg2(a.tail_inv + c);
      return make_int2(q8(__fmul_rn(hv.x, inv.x)),
                       q8(__fmul_rn(hv.y, inv.y)));
    }, [](int, int, int2) {});
  };
  if (a.nb == 0) {  // no body: h = h0
    tail();
    cluster_sync();
    return;
  }

  // ---- the body: per layer two products of kN outputs, each a turn ----
  uint32_t pk[kN / 8];  // half 0's int8 outputs, until Q is free
  for (int blk = 0; blk < a.nb; ++blk) {
    for (int jl = 0; jl < a.nl; ++jl) {
      const int idx = blk * a.nl + jl;
      const bool inner = jl + 1 < a.nl, last = !inner && blk + 1 == a.nb;
      const float4* mb = a.mb + (size_t)(1 + idx) * (W / 2);
      const float* inv = a.body_inv + (size_t)(blk + 1) * a.nl * W;
      tiles_ready();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (wg > 0 || idx > 0 || hf > 0) turn_sync(wg);
        product<int8_t, kN, kC, K>(acc, Qm, W, W, Qm, W, W, ring, it, wtid);
        turn_arrive((wg + 1) % K::kWGs);
        // a pair of q8b words of half hf's column c: half 0's wait in pk
        auto out = [&](int j, int h, int c, int x0, int x1) {
          const uint32_t v = qpair(x0, x1);
          if (hf == 0)
            pk[j] = h ? pk[j] | v << 16 : v;
          else
            putq(r0 + 8 * h, c, v);
        };
        if (inner) {  // ReLU, then the next layer's int8 input (folded)
          each_pair<kN>(mb + hf * kN / 2, t, [&](int j, int c, float4 p) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float t0 = __fmaf_rn(i2f(acc[4 * j + 2 * h]), p.x, p.y);
              const float t1 =
                  __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), p.z, p.w);
              out(j, h, c + hf * kN, q8b_relu(t0), q8b_relu(t1));
            }
          });
        } else {  // block tail: bf16, + the bf16 residual stream, bf16
          each_pair<kN>(mb + hf * kN / 2, t, [&](int j, int c, float4 p) {
            c += hf * kN;
            const float2 iv = last ? make_float2(0.f, 0.f) : ldg2(inv + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float t0 = __fmaf_rn(i2f(acc[4 * j + 2 * h]), p.x, p.y);
              const float t1 =
                  __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), p.z, p.w);
              const __nv_bfloat162 hn =
                  __hadd2(__floats2bfloat162_rn(t0, t1), hs[at(h, c)]);
              hs[at(h, c)] = hn;
              if (!last) {
                const float2 v = __bfloat1622float2(hn);
                out(j, h, c, q8b(__fmul_rn(v.x, iv.x)),
                    q8b(__fmul_rn(v.y, iv.y)));
              }
            }
          });
        }
      }
      if (last) {
        tail();
        continue;
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)  // half 0's outputs, now Q is free
#pragma unroll
        for (int h = 0; h < 2; ++h)
          putq(r0 + 8 * h, 8 * j + 2 * t, pk[j] >> (16 * h));
    }
  }
  if (wg == 0) turn_sync(0);  // warpgroup 3's last arrival
  cluster_sync();
}

// Launch over the n rays' blocks, padded to whole clusters, after checking
// the h0 scratch (h0_elems floats; none without the global residual, but
// for S = 4, whose head parks half of h0 there).
template <int W, int kEpi>
cudaError_t launch_as(Args a, long long h0_elems, cudaStream_t stream) {
  plan<W, kEpi>(a);
  using K = Chain8<W, kEpi>;
  const long long blocks = blocks_of(a.n, 64 * K::kWGs);
  if ((a.use_residual || kEpi == kStreams4) &&
      h0_elems < blocks * 64 * K::kWGs * W)
    return cudaErrorInvalidValue;
  if constexpr (kEpi == kStreams4) {
    return launch_cluster<int8_t, K::kC, K>(
        r2l_int8_streams4_kernel<W>, a, (int)blocks, a.smem, stream);
  } else {
    CUtensorMap map = {};  // K4's stash, through its Q tiles
    if (kEpi == kTrainQ) {
      const cudaError_t err = tile_map(&map, a.stash, a.n, W, 2 * a.nb + 1);
      if (err != cudaSuccess) return err;
    }
    return launch_cluster<int8_t, K::kC, K>(
        r2l_int8_hopper_kernel<W, kEpi>, a, (int)blocks, a.smem, stream,
        map);
  }
}

template <int kEpi>
cudaError_t launch_width(const Args& a, int W, long long h0_elems,
                         cudaStream_t stream) {
  switch (W) {
    case 64: return launch_as<64, kEpi>(a, h0_elems, stream);
    case 128: return launch_as<128, kEpi>(a, h0_elems, stream);
    case 256: return launch_as<256, kEpi>(a, h0_elems, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace r2l8h
