// K5 on Hopper: the dh walk (pass 1) on the student's Hopper skeleton, and
// the dW pass (pass 2) on wgmma for bf16 weights (r2l_bwd_group.cu); passes
// 2 and 3 also serve K5's int8-dL/dx probe (r2l_bwd_qdx.cu).
//
// Pass 1, per ray, for blocks b_start+cnt-1 .. b_start, top-down:
//   dt2 = (dh * res_scale).cast(cd)
//   dt1 = (t1 > 0 ? dt2 W2^T : 0).cast(cd)
//   dh  = dh + dt1 W1^T                                  (f32)
// writing dt2 and dt1 of every layer to a scratch [2cnt][n][W] in the
// compute dtype; for f32 weights also each 64-ray tile's column sums of
// them (a fixed order: two rows per thread, the warp's eight row pairs by
// shuffles, the four warps in order) to that tile's partial of db.
//
// Its shape is K1's (r2l_hopper.cuh): a block owns 128 rays (bf16: two
// consumer warpgroups of 64) or 64 (f32: one), two blocks a cluster share a
// ring of weight stages bulk-copied from an image made once per training
// step (r2l_train.py, stage_bwd_weights: every body layer's W^T, [in][out],
// staged as wgmma reads B, f32 as TF32 high and low parts), so dt W^T is
// the chain's A B^T; the producer walks the group's layers top-down. The
// products are wgmma m64nWk16 bf16 with the tile DT [64 rays x W] in shared
// memory, or 3xTF32 for f32 weights (A split in registers). dh is the
// accumulator's own f32 values: dt2 is formed from the registers; the
// registers then serve the next two products, so dh is parked in dh_out
// (row-major, in the accumulator's order each warp writes whole 32-byte
// sectors) and added back after the second: dh + (dt1 W1^T), the plain
// version's order. 128 accumulator registers a thread at W256, no second
// accumulator. Each dt goes to the scratch (Pass1 below says how); for
// bf16 weights the block's stash rows of the ReLU mask are prefetched into
// shared memory by cp.async under the block's first product.
//
// Pass 2, bf16 weights: dW[l] = G_l^T A_l over a range of rays ("split"),
// G_l the layer's output grad from the scratch, A_l its input from the
// stash, both ray-major in device memory. A block owns 128 rows of dW[l]
// (two consumer warpgroups of 64) and all W columns, and walks its rays 64
// at a time through four shared-memory stages filled by TMA: 64-column
// boxes of 64 rays in the 128-byte swizzle, which wgmma m64nWk16 reads
// MN-major (both transpose bits set), so neither operand is transposed on
// the way in and G is read once (the stash once per 128 rows of dW). db is
// one more product on the same G tiles, m64n8k16 against a tile of ones,
// so pass 1 keeps no column sums. The int8 q-stash goes through registers,
// dequantized (q * scale, cast to bf16) one stage ahead. f32 weights run
// 3xTF32 on wgmma (bwd_dw_tf32_kernel below: TF32 reads both operands
// K-major, so the stash is transposed on its way into shared memory) and
// keep pass 1's db. The splits' (or tiles') partials of dW and db are then
// summed in a fixed order (pass 3, sum_parts), so two runs give
// bit-identical outputs. Measured on an H100 (PERF.md): the bf16 pass is
// bound by its loads (no faster without its products); TMA took it from
// 0.56 ms to 0.24 a 4-block call against cp.async of 16-byte pieces; the
// f32 pass on 3xTF32 takes about 1.4 ms against the scalar FMAs' 3.2.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "r2l_hopper.cuh"

namespace r2lbh {

using namespace hopper;
using r2lh::Chain;

// ---- pass 1: the dh walk --------------------------------------------------

struct Args1 {
  const unsigned char* staged;  // the group's layers' W^T image, layer lo first
  const void* stash_t;          // [cnt][n][W]: block inputs' inner activations
  const float* scale;           // [2cnt][W] (int8 stash) or null
  const float* dh_in;           // [n, W]
  float* dh_out;                // [n, W]
  void* dts;                    // [2cnt][n][W] of T
  float* dbp;  // db's partials: [ceil(n / 64)][2cnt][W] (f32 weights)
               // or [splits][2cnt][W]
  int n, cnt;
  float res_scale;
  // layout, set by plan1()
  int layer_bytes, off_st, off_red, off_ring, off_bar, slot_bytes, smem;
};

// Pass 1's shape by weight type T and stash type S: bf16 weights prefetch
// each block's stash rows of the mask into shared memory (rows of W S
// values and 16 bytes, so that a warp's pair loads hit 32 banks) and store
// dt from the registers; f32 weights, whose tiles leave no room, read the
// mask from device memory, keep db's column sums, and store dt from the
// whole tile (measured on an H100, PERF.md: bf16 from the registers, 1.27
// ms a 4-block call, beat pairs swapped between lanes, 1.34, and the tile,
// 1.82, which spilled registers; f32 through the tile beat the registers).
template <typename T, typename S>
struct Pass1 {
  static constexpr bool kPrefetch = sizeof(T) == 2;
  static constexpr bool kDb = sizeof(T) == 4;
  static constexpr bool kStoreTile = sizeof(T) == 4;
};

template <typename T, int W, typename S>
__host__ __device__ constexpr int stash_ld() {
  return W * (int)sizeof(S) + 16;
}

template <typename T, int W, typename S>
inline void plan1(Args1& a) {
  using K = Chain<T>;
  using P = Pass1<T, S>;
  const int tile = 64 * K::kWGs * r2lh::tile_ld<T, W>() * (K::kRegA ? 4 : 1);
  a.layer_bytes = W * W * (int)sizeof(T) * K::kParts;
  a.off_st = r2l::round_up(tile, 128);
  a.off_red = a.off_st + (P::kPrefetch ? 64 * K::kWGs * stash_ld<T, W, S>()
                                        : 0);
  a.off_ring = a.off_red + (P::kDb ? K::kWGs * 4 * W * 4 : 0);
  a.slot_bytes = W * K::kKSB * K::kParts;
  a.off_bar = a.off_ring + K::kStages * a.slot_bytes;
  a.smem = a.off_bar + 2 * K::kStages * 8;
}

// A stash pair (c, c + 1) as f32 (the int8 stash dequantized, q * scale).
__device__ __forceinline__ float2 stash2(const __nv_bfloat16* p, const float*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 stash2(const float* p, const float*) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 stash2(const int8_t* p, const float* sc) {
  const char2 q = *reinterpret_cast<const char2*>(p);
  return make_float2(__fmul_rn((float)q.x, sc[0]), __fmul_rn((float)q.y, sc[1]));
}

template <typename T, int W, typename S>
__global__ void __launch_bounds__(kWG * (Chain<T>::kWGs + 1), 1)
    bwd_dh_hopper_kernel(const Args1 a) {
  using K = Chain<T>;
  using P = Pass1<T, S>;
  constexpr int kC = K::kC;
  constexpr int kU = K::kRegA ? 4 : 1;  // bytes per tile ld unit
  constexpr int kLd = r2lh::tile_ld<T, W>();
  constexpr int kLdS = stash_ld<T, W, S>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const uint32_t rank = cluster_rank();
  Ring ring;
  ring.slots = smem_u32(smem + a.off_ring);
  ring.full = smem_u32(smem + a.off_bar);
  ring.empty = ring.full + 8 * K::kStages;
  ring.slot_bytes = a.slot_bytes;

  if (threadIdx.x == 0) ring_init<T, kC, K>(ring);
  __syncthreads();
  cluster_sync();

  if (wg == K::kWGs) {  // the producer: the layers top-down, in stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0) {
      int it = 0;
      for (int k = a.cnt - 1; k >= 0; --k)
        for (int l = 2 * k + 1; l >= 2 * k; --l)
          for (int st = 0; st < W / K::kKS; ++st)
            fill<T, kC, K>(ring, it++,
                           a.staged + (size_t)l * a.layer_bytes +
                               (size_t)st * a.slot_bytes,
                           a.slot_bytes, rank);
    }
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int tile = blockIdx.x * K::kWGs + wg, row0 = tile * 64;
  const int bar_id = 1 + wg;
  unsigned char* DT = smem + wg * 64 * kLd * kU;
  unsigned char* ST = smem + a.off_st + wg * 64 * kLdS;
  float* red = reinterpret_cast<float*>(smem + a.off_red) + wg * 4 * W;
  const int lane = wtid % 32, warp = wtid / 32, t = lane % 4;
  const int r0 = 16 * warp + lane / 4;
  const size_t rs = (size_t)a.n * W;
  T* dts = static_cast<T*>(a.dts);
  const S* stash_t = static_cast<const S*>(a.stash_t);

  auto tiles_ready = [&]() {
    if constexpr (!K::kRegA) fence_async_smem();
    wg_bar(bar_id);
  };
  auto put2 = [&](int r, int c, float x0, float x1) {
    if constexpr (K::kRegA)
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(DT) + r * kLd + c) =
          make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(DT + cm_off(r, 2 * c, kLd)) =
          __floats2bfloat162_rn(x0, x1);
  };
  // Layer l's output grad, x = f(j, h, c) rounded to T for the thread's
  // pair (c, c + 1) of row h: into DT (the next product's A), the scratch
  // (bf16 weights: from the registers; f32: store_dt) and (f32 weights)
  // this tile's partial of db.
  auto emit = [&](int l, auto f) {
    T* dl = dts + l * rs;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + 2 * t;
      float2 x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[h] = f(j, h, c);
        put2(r0 + 8 * h, c, x[h].x, x[h].y);
        const int g = row0 + r0 + 8 * h;
        if (!P::kStoreTile && g < a.n)
          *reinterpret_cast<typename r2lh::Pair<T>::P*>(
              dl + (size_t)g * W + c) = r2lh::Pair<T>::make(x[h].x, x[h].y);
      }
      if (!P::kDb) continue;
      float s0 = __fadd_rn(x[0].x, x[1].x), s1 = __fadd_rn(x[0].y, x[1].y);
#pragma unroll
      for (int m = 4; m < 32; m *= 2) {
        s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, m));
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
      }
      if (lane < 4) {
        red[warp * W + c] = s0;
        red[warp * W + c + 1] = s1;
      }
    }
    if (!P::kDb) return;
    wg_bar(bar_id);
    if (row0 < a.n)
      for (int c = wtid; c < W; c += kWG) {
        float s = red[c];
        for (int w = 1; w < 4; ++w) s = __fadd_rn(s, red[w * W + c]);
        a.dbp[((size_t)tile * 2 * a.cnt + l) * W + c] = s;
      }
  };
  // f32 weights: DT (whole, after a barrier) to layer l's rows of the
  // scratch, 16 bytes a thread along each row
  auto store_dt = [&](int l) {
    if constexpr (P::kStoreTile) {
      constexpr int kP = W * (int)sizeof(T) / 16;  // 16-byte pieces a row
      unsigned char* dst = reinterpret_cast<unsigned char*>(dts + l * rs);
      for (int e = wtid; e < 64 * kP; e += kWG) {
        const int r = e / kP, p = e - r * kP, g = row0 + r;
        if (g < a.n)
          *reinterpret_cast<uint4*>(dst + (size_t)g * W * sizeof(T) +
                                    16 * p) =
              *reinterpret_cast<const uint4*>(DT + r * kLd * 4 + 16 * p);
      }
    }
  };
  // block k's stash rows of the mask into ST (bf16 weights), in flight
  // under the block's first product
  auto prefetch = [&](int k) {
    if constexpr (P::kPrefetch) {
      constexpr int kP = W * (int)sizeof(S) / 16;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(stash_t + k * rs);
#pragma unroll 1
      for (int e = wtid; e < 64 * kP; e += kWG) {
        const int r = e / kP, p = e - r * kP, g = row0 + r;
        if (g < a.n)
          r2l::cp_async16(ST + r * kLdS + 16 * p,
                          src + (size_t)g * W * sizeof(S) + 16 * p);
      }
      r2l::cp_async_commit();
    }
  };

  float acc[W / 2];
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = row0 + r0 + 8 * h, c = 8 * j + 2 * t;
      const float2 v = g < a.n ? *reinterpret_cast<const float2*>(
                                     a.dh_in + (size_t)g * W + c)
                               : make_float2(0.f, 0.f);
      acc[4 * j + 2 * h] = v.x;
      acc[4 * j + 2 * h + 1] = v.y;
    }

  int it = 0;  // this warpgroup's place in the ring
  for (int k = a.cnt - 1; k >= 0; --k) {
    prefetch(k);
    if (P::kStoreTile && k + 1 < a.cnt) wg_bar(bar_id);  // stored the last DT
    // park dh, then dt2 = (dh * res_scale).cast(cd)
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = row0 + r0 + 8 * h;
        if (g < a.n)
          *reinterpret_cast<float2*>(a.dh_out + (size_t)g * W + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    emit(2 * k + 1, [&](int j, int h, int) {
      return make_float2(rnd<T>(__fmul_rn(acc[4 * j + 2 * h], a.res_scale)),
                         rnd<T>(__fmul_rn(acc[4 * j + 2 * h + 1],
                                          a.res_scale)));
    });
    tiles_ready();
    store_dt(2 * k + 1);
    product<T, W, kC, K>(acc, DT, kLd, W, DT, kLd, W, ring, it, wtid);
    // dt1 = (t1 > 0 ? dt2 W2^T : 0).cast(cd)
    if constexpr (P::kPrefetch) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    // every thread's rows of ST landed; (f32) every thread stored DT
    if (P::kPrefetch || P::kStoreTile) wg_bar(bar_id);
    const S* tk = stash_t + k * rs;
    const float* sc = a.scale ? a.scale + (size_t)(2 * k + 1) * W : nullptr;
    emit(2 * k, [&](int j, int h, int c) {
      const int r = r0 + 8 * h, g = row0 + r;
      float2 live = make_float2(0.f, 0.f);
      if (g < a.n) {
        const S* p = P::kPrefetch
                         ? reinterpret_cast<const S*>(ST + r * kLdS) + c
                         : tk + (size_t)g * W + c;
        live = stash2(p, sc ? sc + c : nullptr);
      }
      return make_float2(live.x > 0.f ? rnd<T>(acc[4 * j + 2 * h]) : 0.f,
                         live.y > 0.f ? rnd<T>(acc[4 * j + 2 * h + 1]) : 0.f);
    });
    tiles_ready();
    store_dt(2 * k);
    product<T, W, kC, K>(acc, DT, kLd, W, DT, kLd, W, ring, it, wtid);
    // dh = dh + dt1 W1^T
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = row0 + r0 + 8 * h;
        float2 d = make_float2(0.f, 0.f);
        if (g < a.n) {
          d = *reinterpret_cast<const float2*>(a.dh_out + (size_t)g * W +
                                               8 * j + 2 * t);
          d.x = __fadd_rn(d.x, acc[4 * j + 2 * h]);
          d.y = __fadd_rn(d.y, acc[4 * j + 2 * h + 1]);
        }
        acc[4 * j + 2 * h] = d.x;
        acc[4 * j + 2 * h + 1] = d.y;
      }
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = row0 + r0 + 8 * h;
      if (g < a.n)
        *reinterpret_cast<float2*>(a.dh_out + (size_t)g * W + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  cluster_sync();
}

// ---- pass 2: dW on wgmma (bf16 weights) ----------------------------------

constexpr int kKR = 64;     // rays per stage
constexpr int kDwStages = 4;
constexpr int kBox = 64;    // a TMA box: 64 columns (128 bytes) x 64 rays

template <int W>
struct DwShape {
  static constexpr int kWGs = W >= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int BM = 64 * kWGs;           // rows of dW per block
  static constexpr int kThreads = kWG * kWGs;
  // a stage: G's BM and A's W columns as 64-column boxes of 64 rays x 128
  // bytes (8 KB each, 128-byte swizzle); then the stages' full barriers and
  // db's B operand, one chunk of ones
  static constexpr int kBoxBytes = kBox * kKR * 2;
  static constexpr int kGBytes = BM / kBox * kBoxBytes;
  static constexpr int kStageBytes = kGBytes + W / kBox * kBoxBytes;
  static constexpr int kOffBar = kDwStages * kStageBytes;
  static constexpr int kOffOnes = kOffBar + 128;
  static constexpr int kSmem = kOffOnes + kKR * 16 + 1024;  // + alignment
};

// bf16 x 8 of int8 q * scale, rounded.
__device__ __forceinline__ uint4 dequant8(uint2 q, const float* sc) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&q);
  __nv_bfloat162 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __floats2bfloat162_rn(__fmul_rn((float)b[2 * i], sc[2 * i]),
                                 __fmul_rn((float)b[2 * i + 1], sc[2 * i + 1]));
  return *reinterpret_cast<const uint4*>(v);
}

// A wgmma descriptor of a 128-byte-swizzled MN-major operand: 64-column
// boxes of 128-byte rows, the next 8 rows (K) 1 KB on, the next box (M or
// N) `lbo` bytes on.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, int lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// One 3-D TMA box (64 columns, 64 rays, one layer) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c, int r, int l, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(l), "r"(bar)
      : "memory");
}

// Pass 2, bf16: one block per 128 (64 at W64) rows of dW[l] and per range
// of rays, 64 rays a stage. G's and the bf16 stash's rows arrive by TMA, as
// 64-column boxes of 64 rays in the 128-byte swizzle, which wgmma reads
// MN-major; the int8 stash goes through registers, dequantized, into the
// same layout one stage ahead. Rays past the range are zero: TMA fills past
// n, and a range is a whole number of stages.
template <typename S, int W>
__global__ void __launch_bounds__(DwShape<W>::kThreads, 1)
    bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tt,
                        const S* __restrict__ stash_h,
                        const S* __restrict__ stash_t,
                        const float* __restrict__ scale,
                        float* __restrict__ part,
                        float* __restrict__ dbpart, int n, int cnt,
                        int rays_per_split) {
  using D = DwShape<W>;
  constexpr bool kQ = sizeof(S) == 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int b = blockIdx.x;
  const int ot = b % (W / D::BM);
  b /= W / D::BM;
  const int l = b % (2 * cnt), sp = b / (2 * cnt);
  const int o0 = ot * D::BM, r_begin = sp * rays_per_split;
  const int r_end = min(n, r_begin + rays_per_split);
  const int nst = r_end > r_begin ? (r_end - r_begin + kKR - 1) / kKR : 0;
  const size_t rs = (size_t)n * W;
  const S* A = ((l & 1) ? stash_t : stash_h) + (size_t)(l >> 1) * rs;
  const CUtensorMap* ta = (l & 1) ? &tt : &th;
  const float* sc = kQ ? scale + (size_t)l * W : nullptr;
  const int tid = threadIdx.x, wg = tid / kWG, wtid = tid % kWG;
  const uint32_t full = smem_u32(smem + D::kOffBar);

  auto gbuf = [&](int s) { return smem + (s % kDwStages) * D::kStageBytes; };
  auto abuf = [&](int s) { return gbuf(s) + D::kGBytes; };
  // thread 0: stage s's boxes (G's; and the bf16 stash's)
  auto load_stage = [&](int s) {
    const uint32_t bar = full + 8 * (s % kDwStages);
    const int rb = r_begin + s * kKR;
    bar_expect_tx(bar, kQ ? D::kGBytes : D::kStageBytes);
    for (int i = 0; i < D::BM / kBox; ++i)
      tma_box(smem_u32(gbuf(s)) + i * D::kBoxBytes, &tg, o0 + kBox * i, rb,
              l, bar);
    if (!kQ)
      for (int i = 0; i < W / kBox; ++i)
        tma_box(smem_u32(abuf(s)) + i * D::kBoxBytes, ta, kBox * i, rb,
                l >> 1, bar);
  };
  // int8 A: 16 q-values (two 8-column chunks) per piece, through registers
  constexpr int kQPieces = kQ ? kKR * (W / 16) / D::kThreads : 1;
  uint4 qreg[kQPieces];
  auto piece = [&](int i, int& r, int& p) {  // ray r, columns 16p..16p+15
    const int e = tid + i * D::kThreads;
    r = e / (W / 16);
    p = e - r * (W / 16);
  };
  auto load_q = [&](int s) {
    if constexpr (kQ) {
      const int rb = r_begin + s * kKR;
#pragma unroll
      for (int i = 0; i < kQPieces; ++i) {
        int r, p;
        piece(i, r, p);
        qreg[i] = s < nst && rb + r < r_end
                      ? __ldg(reinterpret_cast<const uint4*>(
                            A + (size_t)(rb + r) * W + 16 * p))
                      : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_q = [&](int s) {  // into the 128-byte swizzle of the boxes
    if constexpr (kQ) {
#pragma unroll
      for (int i = 0; i < kQPieces; ++i) {
        int r, p;
        piece(i, r, p);
        unsigned char* box = abuf(s) + (16 * p / kBox) * D::kBoxBytes;
        const int q = (16 * p % kBox) / 8;  // the first 16-byte chunk
        *reinterpret_cast<uint4*>(box + r * 128 + ((q ^ (r % 8)) * 16)) =
            dequant8(make_uint2(qreg[i].x, qreg[i].y), sc + 16 * p);
        *reinterpret_cast<uint4*>(box + r * 128 + (((q + 1) ^ (r % 8)) * 16)) =
            dequant8(make_uint2(qreg[i].z, qreg[i].w), sc + 16 * p + 8);
      }
      fence_async_smem();
    }
  };

  float acc[W / 2], dbacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  unsigned char* ones = smem + D::kOffOnes;
  for (int e = tid; e < kKR * 4; e += D::kThreads)  // bf16 1.0, twice
    reinterpret_cast<uint32_t*>(ones)[e] = 0x3F803F80u;
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) bar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kDwStages && s < nst; ++s) load_stage(s);
  load_q(0);
  store_q(0);
  __syncthreads();
  for (int s = 0; s < nst; ++s) {
    bar_wait(full + 8 * (s % kDwStages), (s / kDwStages) & 1);
    load_q(s + 1);
    wgmma_fence();
    const uint32_t ga = smem_u32(gbuf(s)) + wg * D::kBoxBytes;
    const uint32_t aa = smem_u32(abuf(s));
#pragma unroll
    for (int ks = 0; ks < kKR / 16; ++ks) {
      Wgmma<W>::bf16_mn(acc, desc_sw128(ga + ks * 2048, D::kBoxBytes),
                        desc_sw128(aa + ks * 2048, D::kBoxBytes), 1);
      Wgmma<8>::bf16_mn(dbacc, desc_sw128(ga + ks * 2048, D::kBoxBytes),
                        desc(smem_u32(ones) + ks * 256, kKR * 16), 1);
    }
    wgmma_commit();
    if (s + 1 < nst) store_q(s + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dbacc);
    __syncthreads();  // every warpgroup's products read stage s
    if (tid == 0 && s + kDwStages < nst) load_stage(s + kDwStages);
  }

  float* out = part + ((size_t)sp * 2 * cnt + l) * W * W;
  const int lane = wtid % 32;
  const int o = o0 + 64 * wg + 16 * (wtid / 32) + lane / 4;
  if (lane % 4 == 0) {  // every column of the ones product is db
    float* dbo = dbpart + ((size_t)sp * 2 * cnt + l) * W;
    dbo[o] = dbacc[0];
    dbo[o + 8] = dbacc[2];
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int i = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + (size_t)o * W + i) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(o + 8) * W + i) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Pass 2, f32 weights, as 3xTF32 on wgmma: one block per 64 x kWGs rows
// (o) and BN = min(W, 128) columns (i) of dW[l] and per range of rays, 32
// rays a stage. TF32 wgmma reads B K-major only and A from registers: G's
// stage is copied ray-major by cp.async (rows padded by 8 floats, so the
// A fragments' reads fall in 32 banks) and each thread reads its fragment
// transposed and splits it (a_hi, a_lo); the stash's stage goes through
// registers one stage ahead, split and stored transposed as K-major core
// matrices (w_hi, then w_lo; a warp's stores cover 4 rays x 8 columns, 32
// banks). Per k8 step a_hi w_lo, a_lo w_hi, a_hi w_hi (a bf16 stash is
// exact in TF32: no w_lo). The tensor cores' sums truncate, so a stage's
// products start from zero and are added to a running f32 sum each stage
// (round to nearest), not accumulated across the range.
template <int W>
struct DwTf32Shape {
  static constexpr int kWGs = W >= 128 ? 2 : 1;
  static constexpr int BM = 64 * kWGs, BN = W < 128 ? W : 128;
  static constexpr int kThreads = kWG * kWGs;
  static constexpr int kKR = 32;            // rays per stage
  static constexpr int kLdG = BM + 8;       // floats per row of G's stage
  static constexpr int kGBytes = kKR * kLdG * 4;
  static constexpr int kBBytes = BN * kKR * 4;  // one TF32 part
  static constexpr int kOffB = 2 * kGBytes;     // G double-buffered
  static constexpr int kSmem = kOffB + 2 * kBBytes;
  static constexpr int kAPer = kKR * BN / kThreads;  // stash values a thread
};

__device__ __forceinline__ float stash_f(float x) { return x; }
__device__ __forceinline__ float stash_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename S, int W>
__global__ void __launch_bounds__(DwTf32Shape<W>::kThreads, 1)
    bwd_dw_tf32_kernel(const float* __restrict__ dts,
                       const S* __restrict__ stash_h,
                       const S* __restrict__ stash_t,
                       float* __restrict__ part, int n, int cnt,
                       int rays_per_split) {
  using D = DwTf32Shape<W>;
  constexpr int kKR = D::kKR, BN = D::BN, BM = D::BM;
  constexpr bool kLoB = sizeof(S) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  int b = blockIdx.x;
  const int it = b % (W / BN);
  b /= W / BN;
  const int ot = b % (W / BM);
  b /= W / BM;
  const int l = b % (2 * cnt), sp = b / (2 * cnt);
  const int o0 = ot * BM, i0 = it * BN, r_begin = sp * rays_per_split;
  const int r_end = min(n, r_begin + rays_per_split);
  const int nst = r_end > r_begin ? (r_end - r_begin + kKR - 1) / kKR : 0;
  const size_t rs = (size_t)n * W;
  const float* G = dts + (size_t)l * rs;
  const S* A = ((l & 1) ? stash_t : stash_h) + (size_t)(l >> 1) * rs;
  const int tid = threadIdx.x, wg = tid / kWG, wtid = tid % kWG;
  const int lane = wtid % 32, g = lane / 4, t = lane % 4;
  const int m0 = 64 * wg + 16 * (wtid / 32) + g;  // the fragment's row
  float* gs[2] = {reinterpret_cast<float*>(smem),
                  reinterpret_cast<float*>(smem + D::kGBytes)};
  unsigned char* bs = smem + D::kOffB;
  const uint32_t bh = smem_u32(bs), bl = bh + D::kBBytes;

  // G's stage s: rows of BM floats, 16 bytes a copy, zero past r_end
  auto copy_g = [&](int s) {
    const int rb = r_begin + s * kKR;
    for (int f = tid; f < kKR * BM / 4; f += D::kThreads) {
      const int r = f / (BM / 4), c = 4 * (f % (BM / 4));
      float* dst = gs[s & 1] + r * D::kLdG + c;
      if (rb + r < r_end)
        r2l::cp_async16(dst, G + (size_t)(rb + r) * W + o0 + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    r2l::cp_async_commit();
  };
  // the stash's stage s into registers, as loaded (converted where stored,
  // so that no load is waited for before the products): element e = tid +
  // k * threads is column 8 (e / 32 % (BN / 8)) + e % 8 of ray
  // 4 (e / 32 / (BN / 8)) + e / 8 % 4
  S areg[D::kAPer];
  auto elem = [&](int k, int& r, int& c) {
    const int e = tid + k * D::kThreads, h = e / 32;
    c = 8 * (h % (BN / 8)) + e % 8;
    r = 4 * (h / (BN / 8)) + e / 8 % 4;
  };
  auto load_a = [&](int s) {
    const int rb = r_begin + s * kKR;
#pragma unroll
    for (int k = 0; k < D::kAPer; ++k) {
      int r, c;
      elem(k, r, c);
      areg[k] = s < nst && rb + r < r_end
                    ? __ldg(A + (size_t)(rb + r) * W + i0 + c)
                    : static_cast<S>(0.f);
    }
  };
  // ... split and stored as K-major core matrices: (column c, ray r) at
  // byte 4r of row c, rows of kKR * 4 bytes
  auto store_a = [&]() {
#pragma unroll
    for (int k = 0; k < D::kAPer; ++k) {
      int r, c;
      elem(k, r, c);
      const int off = hopper::cm_off(c, 4 * r, kKR * 4);
      const float x = stash_f(areg[k]);
      const uint32_t hi = tf32_rna(x);
      *reinterpret_cast<uint32_t*>(bs + off) = hi;
      if (kLoB)
        *reinterpret_cast<uint32_t*>(bs + D::kBBytes + off) =
            tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
    }
  };

  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
  if (nst > 0) copy_g(0);
  load_a(0);
  for (int s = 0; s < nst; ++s) {
    store_a();
    if (s + 1 < nst) copy_g(s + 1);
    else r2l::cp_async_commit();  // an empty group: wait_group 1 below
    load_a(s + 1);
    r2l::cp_async_wait_prior();
    fence_async_smem();
    __syncthreads();  // G's stage s and the stash's, for every warpgroup
    const float* gt = gs[s & 1];
    uint32_t hi[kKR / 8][4], lo[kKR / 8][4];
#pragma unroll
    for (int j = 0; j < kKR / 8; ++j) {
      const int k = 8 * j + t;
      const float x[4] = {gt[k * D::kLdG + m0], gt[k * D::kLdG + m0 + 8],
                          gt[(k + 4) * D::kLdG + m0],
                          gt[(k + 4) * D::kLdG + m0 + 8]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hi[j][q] = tf32_rna(x[q]);
        lo[j][q] = tf32_rna(__fsub_rn(x[q], __uint_as_float(hi[j][q])));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKR / 8; ++j) {
      const uint64_t dh = desc(bh + j * 256, kKR * 4 * 8);
      if (kLoB) {
        const uint64_t dl = desc(bl + j * 256, kKR * 4 * 8);
        Wgmma<BN>::tf32(acc, hi[j], dl, j > 0);
        Wgmma<BN>::tf32(acc, lo[j], dh, 1);
      } else {
        Wgmma<BN>::tf32(acc, lo[j], dh, j > 0);
      }
      Wgmma<BN>::tf32(acc, hi[j], dh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < kKR / 8; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    __syncthreads();  // stage s read: its buffers may be written again
  }

  float* out = part + ((size_t)sp * 2 * cnt + l) * W * W;
  const int o = o0 + m0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int i = i0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(out + (size_t)o * W + i) =
        make_float2(sum[4 * j], sum[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(o + 8) * W + i) =
        make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// A 3-D tensor map over [layers][n][W] bf16 for 64 x 64 boxes in the
// 128-byte swizzle (cuTensorMapEncodeTiled, looked up through the runtime's
// entry-point query: no link to libcuda).
inline cudaError_t box_map(CUtensorMap* map, const void* base, int n, int W,
                           int layers) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)n,
                              (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 2, (cuuint64_t)n * W * 2};
  const cuuint32_t box[3] = {kBox, kKR, 1}, step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Pass 3: out[j] = sum over p of in[p][j], p in order.
__global__ void sum_parts_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int parts,
                                 size_t m) {
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s = __fadd_rn(s, in[(size_t)p * m + j]);
    out[j] = s;
  }
}

inline cudaError_t sum_parts(const float* in, float* out, int parts,
                             size_t m, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int grid = (int)((m + kThreads - 1) / kThreads);
  sum_parts_kernel<<<grid, kThreads, 0, stream>>>(in, out, parts, m);
  return cudaGetLastError();
}

// Passes 2 and 3 after pass 1: dW [2cnt][W][W] and db [2cnt][W] through the
// partials `part` ([splits][2cnt][W][W]) and `dbp` (pass 1's ntiles for
// f32 weights, else pass 2's splits).
template <typename T, typename S, int W>
cudaError_t dw_passes(const void* dts, const void* stash_h,
                      const void* stash_t, const float* scale,
                      const float* dbp, float* part, float* dw, float* db,
                      int n, int cnt, int splits, int ntiles,
                      cudaStream_t stream) {
  const int rays_per_split = (n + splits - 1) / splits;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {  // f32 weights: 3xTF32
    using D = DwTf32Shape<W>;
    auto kern = bwd_dw_tf32_kernel<S, W>;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, D::kSmem)) !=
        cudaSuccess)
      return err;
    const int grid = (W / D::BN) * (W / D::BM) * 2 * cnt * splits;
    kern<<<grid, D::kThreads, D::kSmem, stream>>>(
        static_cast<const float*>(dts), static_cast<const S*>(stash_h),
        static_cast<const S*>(stash_t), part, n, cnt, rays_per_split);
  } else {
    using D = DwShape<W>;
    auto kern = bwd_dw_wgmma_kernel<S, W>;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, D::kSmem)) !=
        cudaSuccess)
      return err;
    // the stash's maps serve the bf16 stash only (int8 goes through the
    // registers): G's stands in for them
    CUtensorMap tg, th, tt;
    if ((err = box_map(&tg, dts, n, W, 2 * cnt)) != cudaSuccess) return err;
    th = tt = tg;
    if (sizeof(S) == 2 &&
        ((err = box_map(&th, stash_h, n, W, cnt)) != cudaSuccess ||
         (err = box_map(&tt, stash_t, n, W, cnt)) != cudaSuccess))
      return err;
    // a range is a whole number of stages (TMA zero-fills past n only)
    const int rps = (rays_per_split + kKR - 1) / kKR * kKR;
    const int grid = (W / D::BM) * 2 * cnt * splits;
    kern<<<grid, D::kThreads, D::kSmem, stream>>>(
        tg, th, tt, static_cast<const S*>(stash_h),
        static_cast<const S*>(stash_t), scale, part, const_cast<float*>(dbp),
        n, cnt, rps);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_parts(part, dw, splits, (size_t)2 * cnt * W * W,
                                 stream)) != cudaSuccess)
    return err;
  return sum_parts(dbp, db, sizeof(T) == 4 ? ntiles : splits,
                             (size_t)2 * cnt * W, stream);
}

// Pass 1 over the n rays' blocks, padded to whole clusters, then passes 2
// and 3.
template <typename T, int W, typename S>
cudaError_t launch(Args1 a, const void* stash_h, float* part, float* dw,
                   float* db, int splits, cudaStream_t stream) {
  using K = Chain<T>;
  plan1<T, W, S>(a);
  const long long blocks = r2lh::blocks_of<T>(a.n);
  cudaError_t err = launch_cluster<T, K::kC, K>(
      bwd_dh_hopper_kernel<T, W, S>, a, (int)blocks, a.smem, stream);
  if (err != cudaSuccess) return err;
  const int ntiles = (a.n + 63) / 64;
  return dw_passes<T, S, W>(a.dts, stash_h, a.stash_t, a.scale, a.dbp, part,
                            dw, db, a.n, a.cnt, splits, ntiles, stream);
}

}  // namespace r2lbh
