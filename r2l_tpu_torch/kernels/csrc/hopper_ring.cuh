// The Hopper machinery the warp-specialised kernels share: the teacher's
// (nerf_hopper.cuh: K6, K7) and the student's chain (r2l_hopper.cuh: K1,
// K9).
//
// A producer thread walks the weight stages of a staged image (each stage
// laid out exactly as wgmma reads B from shared memory: K-major 8-row x
// 16-byte core matrices, no swizzle) and moves each with one 1-D bulk copy
// (cp.async.bulk, completing on an mbarrier) into a ring of kStages slots
// with a full and an empty barrier each. The kC blocks of a cluster share the
// ring's stages: each producer copies 1/kC of every stage into all of them
// (.multicast::cluster), so a stage is read from L2 once per cluster; a slot
// is refilled when the consumers of every block released it (remote mbarrier
// arrives); a ring may also be shared by a pair of the cluster's blocks
// only (Ring::base, the int8-dL/dx probe's 4-block clusters). Consumer
// warpgroups run wgmma on the slots: bf16 m64nNk16 and
// int8 m64nNk32 with both operands in shared memory; f32 as 3xTF32
// (a_hi w_lo + a_lo w_hi + a_hi w_hi, summed in f32 by wgmma m64nNk8 tf32
// with A split in registers, the stage holding w_hi then w_lo). A stalled
// barrier traps after ~10 s: a fault the launch reports, not a hung card.
//
// K4's stash rows leave shared memory the other way, by bulk stores
// (cp.async.bulk to global, a bulk group per issuing thread): an s8
// core-matrix tile through a 4-D tensor map, eight 8-row boxes a 64-row
// tile (tile_map).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_wgmma.cuh"

namespace hopper {

constexpr int kWG = 128;   // threads of a warpgroup

// The weight types' shapes. KSB: bytes of one output row in one stage;
// kWGs: consumer warpgroups (64 rows each); kRegA: A from registers.
template <typename T> struct Kind;
template <> struct Kind<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kKS = 64, kKSB = 128, kWGs = 2, kStages = 3;
  static constexpr int kParts = 1;  // weight parts per stage
  static constexpr bool kRegA = false;
};
template <> struct Kind<int8_t> {
  using Acc = int;
  static constexpr int kKS = 128, kKSB = 128, kWGs = 2, kStages = 4;
  static constexpr int kParts = 1;
  static constexpr bool kRegA = false;
};
template <> struct Kind<float> {
  using Acc = float;
  static constexpr int kKS = 16, kKSB = 64, kWGs = 1, kStages = 3;
  static constexpr int kParts = 2;  // TF32 high, then low
  static constexpr bool kRegA = true;
};

// ---- PTX: barriers, bulk copies, the cluster, wgmma bookkeeping --------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
// Wait for the phase of `parity` to complete. A wait past ~20 G cycles
// (over 10 s) traps: a fault the launch reports, not a hung card.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
// Arrive on the barrier at the same offset in the cluster's block `cta`.
__device__ __forceinline__ void bar_arrive_cta(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta) : "memory");
}
// Copy `bytes` from global src to dst in the kC blocks of the cluster from
// block `base` on; each block's barrier at `bar` counts the bytes that land
// in it.
template <int kC>
__device__ __forceinline__ void bulk_copy_all(uint32_t dst, const void* src,
                                              int bytes, uint32_t bar,
                                              uint32_t base = 0) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar),
      "h"((uint16_t)(((1 << kC) - 1) << base))
      : "memory");
}
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// generic-proxy writes to shared memory, before wgmma reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <typename A, int M>
__device__ __forceinline__ void fence_regs(A (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if constexpr (std::is_same<A, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}
// A shared-memory matrix descriptor, no swizzle: K-major 8-row x 16-byte
// core matrices, the next core matrix along K 128 bytes on, the next eight
// rows `sbo` bytes on.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// Byte offset of (row r, byte b of the row) in a core-matrix tile whose
// rows hold `ld` bytes.
__device__ __forceinline__ int cm_off(int r, int b, int ld) {
  return ((r >> 3) * (ld >> 4) + (b >> 4)) * 128 + (r & 7) * 16 + (b & 15);
}
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ---- the weight ring -----------------------------------------------------

// The ring's slots and barriers in this block's shared memory, and the
// first of the kC blocks that share it (0: the whole cluster's ring).
struct Ring {
  uint32_t slots, full, empty;  // shared addresses
  int slot_bytes;
  uint32_t base = 0;
};

// Initialise the ring's barriers (thread 0 of the block): a full barrier
// completes on the producer's expect_tx and the stage's bytes, an empty one
// on the release of each consumer warpgroup of each block of the cluster.
// K (Kind<T> by default) gives the ring's shape.
template <typename T, int kC, typename K = Kind<T>>
__device__ __forceinline__ void ring_init(const Ring& ring) {
  for (int s = 0; s < K::kStages; ++s) {
    bar_init(ring.full + 8 * s, 1);
    bar_init(ring.empty + 8 * s, kC * K::kWGs);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's step `it`: wait until slot it % kStages is free, then copy
// this block's 1/kC of the stage of `bytes` at src into every block that
// shares the ring (`rank`: this block's in the cluster).
template <typename T, int kC, typename K = Kind<T>>
__device__ __forceinline__ void fill(const Ring& ring, int it,
                                     const unsigned char* src, int bytes,
                                     uint32_t rank) {
  const int slot = it % K::kStages, ph = (it / K::kStages) & 1;
  const int part = bytes / kC, off = (int)(rank - ring.base) * part;
  bar_wait(ring.empty + 8 * slot, ph ^ 1);
  bar_expect_tx(ring.full + 8 * slot, bytes);
  bulk_copy_all<kC>(ring.slots + slot * ring.slot_bytes + off, src + off,
                    part, ring.full + 8 * slot, ring.base);
}

// Release a slot to the producer of every block that shares the ring (one
// thread of the warpgroup).
template <int kC>
__device__ __forceinline__ void release(const Ring& ring, int slot,
                                        int wtid) {
  if (wtid == 0) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      bar_arrive_cta(ring.empty + 8 * slot, ring.base + c);
  }
}

// A product's A operand: k bytes [0, k0) from tile 0, the rest from tile 1,
// each the warpgroup's 64 rows (bf16/int8: shared address and row bytes;
// f32: pointer and row stride in floats).
struct SrcSS {
  uint32_t t0, t1;
  int ld0, ld1, k0;
};
struct SrcRS {
  const float* t0;
  const float* t1;
  int ld0, ld1, k0;
};

// d = A B^T over the layer's stages, B from the ring (bf16 or int8, both
// operands in shared memory); with `accumulate`, d += A B^T. Each stage's
// products are committed as one group; the previous stage is released once
// its group completed, so one stage's products are in flight while the next
// stage is awaited.
template <typename T, int N, int kC, typename K>
__device__ __forceinline__ void mm_ss(typename K::Acc (&d)[N / 2],
                                      const SrcSS& s, int kbytes,
                                      const Ring& ring, int& it, int wtid,
                                      int accumulate) {
  const int nst = kbytes / K::kKSB;
  int pend = -1;
  fence_regs(d);
  for (int st = 0; st < nst; ++st, ++it) {
    const int slot = it % K::kStages, ph = (it / K::kStages) & 1;
    bar_wait(ring.full + 8 * slot, ph);
    wgmma_fence();
    const uint32_t b = ring.slots + slot * ring.slot_bytes;
#pragma unroll
    for (int j = 0; j < K::kKSB / 32; ++j) {
      const int kb = st * K::kKSB + 32 * j;
      const uint64_t da =
          kb < s.k0 ? desc(s.t0 + (kb >> 4) * 128, s.ld0 * 8)
                    : desc(s.t1 + ((kb - s.k0) >> 4) * 128, s.ld1 * 8);
      const uint64_t db = desc(b + j * 256, K::kKSB * 8);
      if constexpr (sizeof(T) == 1)
        Wgmma<N>::s8(d, da, db, st > 0 || j > 0 || accumulate);
      else
        Wgmma<N>::bf16(d, da, db, st > 0 || j > 0 || accumulate);
    }
    wgmma_commit();
    if (pend >= 0) {
      wgmma_wait<1>();
      release<kC>(ring, pend, wtid);
    }
    pend = slot;
  }
  wgmma_wait<0>();
  fence_regs(d);
  release<kC>(ring, pend, wtid);
}

// A ring shape K with `static constexpr bool kSplit = true` has mm_rs sum
// each stage's products apart (below); any other does not.
template <typename K, typename = void>
struct SplitSums : std::false_type {};
template <typename K>
struct SplitSums<K, std::void_t<decltype(K::kSplit)>>
    : std::integral_constant<bool, K::kSplit> {};

// The same for f32 weights as 3xTF32: per k8 step the warp's A fragment is
// read from shared memory, split into high and low TF32 parts, and
// a_hi w_lo, a_lo w_hi, a_hi w_hi are accumulated (the stage holds w_hi,
// then w_lo). A sits in registers, so each stage's products complete
// before the next stage's fragments are loaded. With K::kSplit each
// stage's products are summed apart, from zero, in parts of 64 of the N
// outputs (two buffers of 32 accumulator registers, not 128 more), and
// each part's sum is added to the running sum in f32 while the next part's
// products run: the tensor cores truncate every sum they add a product
// to, which at a running sum of 96 products a layer costs f32's last bits
// (PERF.md; two halves one after the other measured 2% slower).
template <int N, int kC, typename K>
__device__ __forceinline__ void mm_rs(float (&d)[N / 2], const SrcRS& s,
                                      int kelems, const Ring& ring, int& it,
                                      int wtid, int accumulate) {
  const int nst = kelems / K::kKS;
  const int lane = wtid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * (wtid / 32) + g;
  fence_regs(d);
  for (int st = 0; st < nst; ++st, ++it) {
    const int slot = it % K::kStages, ph = (it / K::kStages) & 1;
    uint32_t hi[K::kKS / 8][4], lo[K::kKS / 8][4];
#pragma unroll
    for (int j = 0; j < K::kKS / 8; ++j) {
      int k = st * K::kKS + 8 * j;
      const float* tile = s.t0;
      int ld = s.ld0;
      if (k >= s.k0) {
        tile = s.t1;
        ld = s.ld1;
        k -= s.k0;
      }
      const float x[4] = {tile[r0 * ld + k + t], tile[(r0 + 8) * ld + k + t],
                          tile[r0 * ld + k + t + 4],
                          tile[(r0 + 8) * ld + k + t + 4]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hi[j][q] = tf32_rna(x[q]);
        lo[j][q] = tf32_rna(__fsub_rn(x[q], __uint_as_float(hi[j][q])));
      }
    }
    bar_wait(ring.full + 8 * slot, ph);
    wgmma_fence();
    const uint32_t b = ring.slots + slot * ring.slot_bytes;
    const int part = N * K::kKSB;  // bytes of w_hi in the stage
    if constexpr (SplitSums<K>::value) {
      constexpr int NP = N / 64;
      float s[2][32];
      auto issue = [&](int p) {
        const uint32_t bo = b + p * 64 * K::kKSB;  // the part's rows of w
#pragma unroll
        for (int j = 0; j < K::kKS / 8; ++j) {
          const uint64_t bh = desc(bo + j * 256, K::kKSB * 8);
          const uint64_t bl = desc(bo + part + j * 256, K::kKSB * 8);
          Wgmma<64>::tf32(s[p % 2], hi[j], bl, j > 0);
          Wgmma<64>::tf32(s[p % 2], lo[j], bh, 1);
          Wgmma<64>::tf32(s[p % 2], hi[j], bh, 1);
        }
        wgmma_commit();
      };
      const bool add = st > 0 || accumulate;
      issue(0);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p + 1 < NP) {
          wgmma_fence();  // the adds below read the other buffer last
          issue(p + 1);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s[p % 2]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          d[p * 32 + i] =
              add ? __fadd_rn(d[p * 32 + i], s[p % 2][i]) : s[p % 2][i];
      }
      fence_regs(d);
    } else {
#pragma unroll
      for (int j = 0; j < K::kKS / 8; ++j) {
        const uint64_t bh = desc(b + j * 256, K::kKSB * 8);
        const uint64_t bl = desc(b + part + j * 256, K::kKSB * 8);
        Wgmma<N>::tf32(d, hi[j], bl, st > 0 || j > 0 || accumulate);
        Wgmma<N>::tf32(d, lo[j], bh, 1);
        Wgmma<N>::tf32(d, hi[j], bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
    }
#pragma unroll
    for (int j = 0; j < K::kKS / 8; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
    release<kC>(ring, slot, wtid);
  }
}

// One product's A operand and the ring: d = A B^T (d += with
// `accumulate`), A's first k0 channels from tile t0, the rest from t1 (tile
// rows ld0/ld1 bytes, f32: floats); K (Kind<T> by default) gives the ring's
// shape.
template <typename T, int N, int kC = 2, typename K = Kind<T>>
__device__ __forceinline__ void product(typename K::Acc (&d)[N / 2],
                                        const unsigned char* t0, int ld0,
                                        int k0, const unsigned char* t1,
                                        int ld1, int kin, const Ring& ring,
                                        int& it, int wtid,
                                        int accumulate = 0) {
  if constexpr (K::kRegA) {
    const SrcRS s{reinterpret_cast<const float*>(t0),
                  reinterpret_cast<const float*>(t1), ld0, ld1, k0};
    mm_rs<N, kC, K>(d, s, kin, ring, it, wtid, accumulate);
  } else {
    const SrcSS s{smem_u32(t0), smem_u32(t1), ld0, ld1,
                  k0 * (int)sizeof(T)};
    mm_ss<T, N, kC, K>(d, s, kin * (int)sizeof(T), ring, it, wtid,
                       accumulate);
  }
}

// ---- the accumulator -----------------------------------------------------

// Visit the warpgroup's accumulator two columns at a time:
// f(h, row, col, v[col], v[col + 1]) with h = 0 for the thread's upper row
// (16 * warp + lane / 4) and 1 for the row 8 below.
template <int N, typename A, typename F>
__device__ __forceinline__ void visit(A (&d)[N / 2], int wtid, F f) {
  const int lane = wtid % 32;
  const int r0 = 16 * (wtid / 32) + lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t;
    f(0, r0, c, d[4 * j], d[4 * j + 1]);
    f(1, r0 + 8, c, d[4 * j + 2], d[4 * j + 3]);
  }
}

// v[q] of lane t of a quad becomes lane q's v[t] (two rounds of
// exchanges with the lanes 1, then 2 apart): of four column groups of a
// row, whose 8 columns the quad holds two each, each lane then holds one
// group whole.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
#pragma unroll
  for (int m = 1; m <= 2; m *= 2)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q & m) continue;
      const bool up = t & m;
      const uint32_t got =
          __shfl_xor_sync(0xffffffffu, up ? v[q] : v[q + m], m);
      if (up)
        v[q] = got;
      else
        v[q + m] = got;
    }
}

// Sum v over the quad that holds a row's columns.
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Round to T and back: the cast to the compute dtype.
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two neighbouring head weights (c even) as the epilogue's type.
template <typename T>
__device__ __forceinline__ float2 head2(const T* w) {
  if constexpr (sizeof(T) == 2)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
  else
    return *reinterpret_cast<const float2*>(w);
}
__device__ __forceinline__ int2 head2(const int8_t* w) {
  const char2 q = *reinterpret_cast<const char2*>(w);
  return make_int2(q.x, q.y);
}
// p += x0 w0 + x1 w1 (int8: exact; dense: two FMAs)
__device__ __forceinline__ void dot2(float& p, float x0, float x1,
                                     float2 w) {
  p = fmaf(x1, w.y, fmaf(x0, w.x, p));
}
__device__ __forceinline__ void dot2(int& p, int x0, int x1, int2 w) {
  p += x0 * w.x + x1 * w.y;
}

// ---- bulk stores ---------------------------------------------------------

// One box of a tensor map from shared memory at src (128-byte aligned) to
// global memory at the box's coordinates; rows past the tensor's extent
// are not written.
__device__ __forceinline__ void bulk_store_box(const CUtensorMap* map,
                                               uint32_t src, int c0, int c1,
                                               int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(
          map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk groups but the newest N have read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ... and completed their writes
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link to libcuda), or null.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// A 4-D tensor map that writes s8 core-matrix tiles (8 rows x 16-byte core
// matrices, the next core matrix along the row 128 bytes on: wgmma's
// K-major layout without swizzle) into `rows` row-major [n][W] int8
// matrices at base, one after another: dimensions (the 16 bytes of a
// core-matrix row, the n rays, the W / 16 core matrices along a row, the
// rows), so a box of (16, 8, W / 16, 1) is one 8-ray group of a tile, laid
// out in shared memory as the tile holds it.
inline cudaError_t tile_map(CUtensorMap* map, void* base, int n, int W,
                            int rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {16, (cuuint64_t)n, (cuuint64_t)W / 16,
                              (cuuint64_t)rows};
  const cuuint64_t strides[3] = {(cuuint64_t)W, 16, (cuuint64_t)n * W};
  const cuuint32_t box[4] = {16, 8, (cuuint32_t)(W / 16), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the launch ----------------------------------------------------------

// The registers a thread of the producer and of a consumer warpgroup hold
// after setmaxnreg: K::kProducerRegs and K::kConsumerRegs where the ring
// shape K names them, else 40 and 232 (two consumer warpgroups).
template <typename K, typename = void>
struct Regs {
  static constexpr int kProducer = 40, kConsumer = 232;
};
template <typename K>
struct Regs<K, std::void_t<decltype(K::kConsumerRegs)>> {
  static constexpr int kProducer = K::kProducerRegs;
  static constexpr int kConsumer = K::kConsumerRegs;
};

// Launch `kern` over `blocks` blocks (padded to whole kC-block clusters) of
// kWG * (kWGs + 1) threads and `smem` bytes, after checking what would keep
// it from ever running: setmaxnreg moves registers within the block's
// allocation (the producer gives up 128 * (regs - Regs<K>::kProducer), the
// consumers take 128 * (Regs<K>::kConsumer - regs) each), and a cluster
// that cannot be resident at this footprint would never be scheduled.
// `more` are the kernel's parameters after `a`.
template <typename T, int kC, typename K = Kind<T>, typename Kern,
          typename Args, typename... More>
cudaError_t launch_cluster(Kern kern, const Args& a, int blocks, int smem,
                           cudaStream_t stream, const More&... more) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kC;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + kC - 1) / kC * kC);
  cfg.blockDim = dim3(kWG * (K::kWGs + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess) return err;
  if (fa.numRegs * (int)cfg.blockDim.x <
      kWG * (Regs<K>::kProducer + Regs<K>::kConsumer * K::kWGs))
    return cudaErrorLaunchOutOfResources;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg)) !=
      cudaSuccess)
    return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaLaunchKernelEx(&cfg, kern, a, more...)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace hopper
