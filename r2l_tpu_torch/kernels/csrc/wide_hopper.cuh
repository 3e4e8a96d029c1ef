// The Hopper pass skeleton of the wide forms: one layer of a network too
// wide to keep on the chip, as a GEMM over activations in device memory,
// out[rows, N] = epilogue(A[rows, K] W[N, K]^T), on wgmma fed by TMA in a
// warp-specialised block. The teacher's wide form (nerf_wide.cu: f32, bf16
// and int8) runs every GEMM layer on it, and K5's wide form (r2l_wide_bwd.cu)
// its dh walk, each with an epilogue of its own (the Epi parameter); the
// student's and the training forward's wide passes (r2l_wide.cuh, mma.sync)
// can move onto it the same way.
//
// Operands. A's K is the concatenation of two sources, st0 stages of
// kKC channels from tensor map a0, then st1 from a1 (the teacher's
// [encoding | h] after a skip, [feature | view encoding] in the view
// layer); B is the layer's weights, [N, K] row-major in the compute type
// (f32: [2N, K], TF32 high parts then low parts, split once at packing).
// Every map reads boxes of 128 bytes of a row x rows in the 128-byte
// swizzle, which is the layout wgmma reads K-major from shared memory.
//
// Block: 128 points x kBN outputs a tile (bf16 and int8 256, the last tile
// of a layer whose N is 128 more than a multiple of 256 is 128 wide; f32
// 128), two consumer warpgroups of 64 rows each and a producer warpgroup,
// whose one thread issues every TMA load (its registers go to the
// consumers, setmaxnreg) into a ring of kStages slots (A 16 KB, B 32 KB a
// slot; bf16 three, f32 and int8 four) with a full and an empty mbarrier
// each. The grid is one block an SM; a block walks its tiles in
// row-tile-major order, so the N-tiles of one row tile run side by side (A
// read from device memory once, then from L2), and the producer fills the
// next tile's stages while the consumers finish the last one's epilogue.
// Two-block clusters run pairs of row tiles with the same outputs: each
// block loads half of every B stage into both (.multicast::cluster), and a
// slot is refilled once the consumers of both released it.
//
// Products: bf16 wgmma m64nNk16 and int8 m64nNk32 s8 x s8 -> s32 (exact),
// both operands in shared memory; f32 as 3xTF32 on wgmma m64nNk8 tf32 with
// A from registers, split into high and low parts by cvt.rna (a_hi w_lo,
// a_lo w_hi, a_hi w_hi, each k8 step in that order), each stage's
// fragments loaded while the previous stage's products run. The tensor
// cores truncate every sum they add a product to, so the f32 sum has two
// routes: one running sum over K (the teacher's, as K6 f32), or, with
// kSplit, each stage's products summed apart from zero, in halves of the
// tile's outputs (two buffers of 32 registers), each half's sum added to
// the running sum in f32 while the next half's products run (K5's walk:
// over K = 512 one sum reads past its limit; PERF.md).
//
// Epilogue: Epi::pair(args, row, col, acc0, acc1, v0, v1) on each
// accumulator pair of the tile (args: the epilogue's own parameter struct,
// Epi::Args; it may read side tensors at (row, col) and write side
// outputs, and guards the rows past the pass itself), v0 and v1 rounded to
// the output type (int8: round-half-even, clipped to +-127) into a 64-row
// staging tile of the warpgroup's own in the same swizzle (no bank
// conflicts), then out by TMA stores of 128-byte boxes, in kRounds rounds
// of the tile's columns; rows past the pass are neither read by TMA (it
// fills zeros) nor stored. Where Epi::stores(args) is false, nothing is
// staged or stored (K5's last dh pass).
//
// What bounds a pass: the products (2 N K operations a row) at the card's
// tensor rate, and its activations' bytes (rows (K + N) elements). PERF.md
// has the measured times.
#pragma once

#include <type_traits>

#include "hopper_ring.cuh"
#include "r2l_common.cuh"

namespace wideh {

using namespace hopper;

// The compute types' tiles: kBN outputs a block tile, kKC input channels a
// stage (128 bytes of a row), kParts weight parts a stage (f32: TF32 high,
// low), kStages ring slots, kRounds epilogue rounds (the staging tile
// holds 1/kRounds of a tile: f32 halves it to make room for a fourth slot,
// which bf16 runs slower with; PERF.md).
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int kBN = 256, kKC = 64, kParts = 1;
  static constexpr int kStages = 3, kRounds = 1;
};
template <> struct Tile<float> {
  static constexpr int kBN = 128, kKC = 32, kParts = 2;
  static constexpr int kStages = 4, kRounds = 2;
};
template <> struct Tile<int8_t> {
  static constexpr int kBN = 256, kKC = 128, kParts = 1;
  static constexpr int kStages = 4, kRounds = 1;
};

// The accumulator's type: s32 for int8, f32 otherwise.
template <typename T>
using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int,
                                      float>::type;

constexpr int kBM = 128;                // points a tile: two warpgroups
constexpr int kC = 2;         // blocks a cluster, which share B's stages
constexpr int kBRows = 128;   // rows of a B box: two a slot
constexpr int kThreads = 3 * kWG;  // two consumer warpgroups, a producer
constexpr int kBoxRows = 64;            // rows of an A box and a store box
constexpr int kBoxBytes = kBoxRows * 128;
constexpr int kABytes = kBM * 128;      // A's part of a slot

// Shared memory from a 1024-byte aligned base: the ring's slots (A, then
// B), each warpgroup's staging tile, the barriers.
template <typename T>
struct Smem {
  static constexpr int kBBytes = Tile<T>::kBN * 128 * Tile<T>::kParts;
  static constexpr int kSlot = kABytes + kBBytes;
  static constexpr int kOut =
      kBoxRows * Tile<T>::kBN * (int)sizeof(T) / Tile<T>::kRounds;
  static constexpr int kStages = Tile<T>::kStages;
  static constexpr int kStage = kStages * kSlot;
  static constexpr int kBar = kStage + 2 * kOut;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
};

// One pass: `rows` points (A's rows and the output's), N output channels
// (a multiple of 128), K = (st0 + st1) * kKC.
struct Pass {
  int rows, N, st0, st1;
};

// The epilogue of the teacher's f32 and bf16 layers: the bias added in f32,
// then ReLU where the layer has one (the rounding to the compute type
// follows).
struct BiasRelu {
  struct Args {
    const float4* epi;  // [N] (m, b, inv, 0) a channel: .y is the bias
    int relu;
  };
  __device__ __forceinline__ static bool stores(const Args&) { return true; }
  __device__ __forceinline__ static void pair(const Args& e, int, int col,
                                              float a0, float a1, float& v0,
                                              float& v1) {
    const float* b = reinterpret_cast<const float*>(e.epi) + 4 * col + 1;
    v0 = __fadd_rn(a0, __ldg(b));
    v1 = __fadd_rn(a1, __ldg(b + 4));
    if (e.relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
  }
};

// The epilogue of the teacher's int8 layers: acc * m + b in one FMA, ReLU
// where the layer has one, times the consumer's inverse scale (1 where
// folded); the store rounds half to even and clips.
struct Requant {
  using Args = BiasRelu::Args;
  __device__ __forceinline__ static bool stores(const Args&) { return true; }
  __device__ __forceinline__ static void pair(const Args& e, int, int col,
                                              int a0, int a1, float& v0,
                                              float& v1) {
    const float* t = reinterpret_cast<const float*>(e.epi) + 4 * col;
    const float2 mb0 = __ldg(reinterpret_cast<const float2*>(t));
    const float2 mb1 = __ldg(reinterpret_cast<const float2*>(t + 4));
    v0 = r2l::dequant(a0, mb0.x, mb0.y);
    v1 = r2l::dequant(a1, mb1.x, mb1.y);
    if (e.relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
    v0 = __fmul_rn(v0, __ldg(t + 2));
    v1 = __fmul_rn(v1, __ldg(t + 6));
  }
};

// ---- PTX ----------------------------------------------------------------

// A K-major operand in the 128-byte swizzle: rows of 128 bytes, the next 8
// rows 1 KB on (the leading offset is not read).
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// Byte b of row r of a 128-byte-swizzled box (1024-byte aligned).
__device__ __forceinline__ int sw128(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}
// One box at coordinates (c0 along the row, c1 rows) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// ---- the block ------------------------------------------------------------

// Where a tile is: its first row and output channel. The kC blocks of a
// cluster take the kC row tiles of a group with the same outputs (block
// `rank` the rank-th), so the weights' stages are theirs in common.
struct Where {
  int row0, n0;
};
template <typename T>
__device__ __forceinline__ Where where(int group, int ntn, int rank) {
  const int mg = group / ntn;
  return {(mg * kC + rank) * kBM, (group - mg * ntn) * Tile<T>::kBN};
}

// One B box into the same slot of every block of the cluster, completing
// on each one's barrier at `bar`.
__device__ __forceinline__ void tma_load_all(uint32_t dst,
                                             const CUtensorMap* map, int c0,
                                             int c1, uint32_t bar) {
  if constexpr (kC == 1) {
    tma_load(dst, map, c0, c1, bar);
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], "
        "%5;\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
        "h"((uint16_t)((1 << kC) - 1))
        : "memory");
  }
}
// Release a slot to the producers of every block of the cluster (one
// thread of a consumer warpgroup).
__device__ __forceinline__ void release_slot(uint32_t bar) {
  if constexpr (kC == 1) {
    arrive(bar);
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c) bar_arrive_cta(bar, c);
  }
}

// The producer: every stage of every tile of the block, in the consumers'
// order; A is the block's own, B's two boxes (bf16, int8: outputs n0 and n0
// + 128; f32: the high and the low parts of n0) are each loaded by one
// block of the cluster into all of them.
template <typename T>
__device__ void produce(const CUtensorMap* a0, const CUtensorMap* a1,
                        const CUtensorMap* b, const Pass& p, uint32_t base,
                        int groups, int ntn, int rank) {
  using S = Smem<T>;
  constexpr int kKC = Tile<T>::kKC;
  const uint32_t full = base + S::kBar, empty = full + 8 * S::kStages;
  const int KT = p.st0 + p.st1;
  int it = 0;
  for (int gi = blockIdx.x / kC; gi < groups; gi += gridDim.x / kC) {
    const Where w = where<T>(gi, ntn, rank);
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int slot = it % S::kStages, ph = (it / S::kStages) & 1;
      const uint32_t fb = full + 8 * slot, sa = base + slot * S::kSlot;
      const uint32_t sb = sa + kABytes;
      bar_wait(empty + 8 * slot, ph ^ 1);
      bar_expect_tx(fb, S::kSlot);
      const bool first = kt < p.st0;
      const CUtensorMap* am = first ? a0 : a1;
      const int k = (first ? kt : kt - p.st0) * kKC;
      tma_load(sa, am, k, w.row0, fb);
      tma_load(sa + kBoxBytes, am, k, w.row0 + kBoxRows, fb);
      for (int i = rank; i < 2; i += kC)
        tma_load_all(sb + i * kBRows * 128, b, kt * kKC,
                     Tile<T>::kParts == 2 ? i * p.N + w.n0
                                          : w.n0 + i * kBRows,
                     fb);
    }
  }
}

// bf16 and int8: d = A B^T over the tile's stages, both operands in shared
// memory, four k-steps of 32 bytes a stage; each stage's products one
// group, the previous stage's slot released once its group completed.
template <typename T, int NN>
__device__ __forceinline__ void mainloop_ss(Acc<T> (&d)[NN / 2],
                                            uint32_t base, int KT, int wg,
                                            int wtid, int& it) {
  using S = Smem<T>;
  const uint32_t full = base + S::kBar, empty = full + 8 * S::kStages;
  int prev = -1;
  fence_regs(d);
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int slot = it % S::kStages, ph = (it / S::kStages) & 1;
    const uint32_t sa = base + slot * S::kSlot + wg * kBoxBytes;
    const uint32_t sb = base + slot * S::kSlot + kABytes;
    bar_wait(full + 8 * slot, ph);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same<T, int8_t>::value)
        Wgmma<NN>::s8(d, desc_k128(sa + 32 * j), desc_k128(sb + 32 * j),
                      kt > 0 || j > 0);
      else
        Wgmma<NN>::bf16(d, desc_k128(sa + 32 * j), desc_k128(sb + 32 * j),
                        kt > 0 || j > 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (wtid == 0) release_slot(empty + 8 * prev);
    }
    prev = slot;
  }
  wgmma_wait<0>();
  fence_regs(d);
  if (wtid == 0) release_slot(empty + 8 * prev);
}

// f32: the stage's A fragments (the warp's rows g and g + 8, g = lane / 4,
// hold the k8 step j's columns 8j + t and 8j + t + 4 at chunks 2j and 2j +
// 1 of the swizzled row), split into TF32 parts (h, l), once the stage has
// landed in slot `slot`.
__device__ __forceinline__ void load_tf32(uint32_t (&h)[4][4],
                                          uint32_t (&l)[4][4],
                                          const unsigned char* A, int wtid) {
  const int lane = wtid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * (wtid / 32) + g;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c0 = sw128(0, 32 * j + 4 * t) ^ (g << 4);  // r0 & 7 == g
    const int c1 = c0 ^ 16;
    const float x[4] = {
        *reinterpret_cast<const float*>(A + r0 * 128 + c0),
        *reinterpret_cast<const float*>(A + (r0 + 8) * 128 + c0),
        *reinterpret_cast<const float*>(A + r0 * 128 + c1),
        *reinterpret_cast<const float*>(A + (r0 + 8) * 128 + c1)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      h[j][q] = tf32_rna(x[q]);
      l[j][q] = tf32_rna(__fsub_rn(x[q], __uint_as_float(h[j][q])));
    }
  }
}

// The stage's twelve 3xTF32 products of outputs [n0, n0 + N) of the slot's
// B (bh, bl: its high and low parts) into d; `acc` 0 starts d from zero.
template <int N>
__device__ __forceinline__ void products_tf32(float (&d)[N / 2],
                                              const uint32_t (&h)[4][4],
                                              const uint32_t (&l)[4][4],
                                              uint32_t bh, uint32_t bl,
                                              int acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    Wgmma<N>::tf32(d, h[j], desc_k128(bl + 32 * j), acc || j > 0);
    Wgmma<N>::tf32(d, l[j], desc_k128(bh + 32 * j), 1);
    Wgmma<N>::tf32(d, h[j], desc_k128(bh + 32 * j), 1);
  }
}

// f32 (3xTF32), one running sum: one stage with the fragment registers (h,
// l) of its parity.
template <int NN>
__device__ __forceinline__ void stage_tf32(float (&d)[NN / 2],
                                           uint32_t (&h)[4][4],
                                           uint32_t (&l)[4][4],
                                           const unsigned char* smem,
                                           uint32_t base, int kt, int wg,
                                           int wtid, int& it, int& prev) {
  using S = Smem<float>;
  constexpr int kBN = Tile<float>::kBN;
  const uint32_t full = base + S::kBar, empty = full + 8 * S::kStages;
  const int slot = it % S::kStages, ph = (it / S::kStages) & 1;
  const uint32_t sb = base + slot * S::kSlot + kABytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fence_regs(h[j]);  // the products that read them have completed
    fence_regs(l[j]);
  }
  bar_wait(full + 8 * slot, ph);
  load_tf32(h, l, smem + slot * S::kSlot + wg * kBoxBytes, wtid);
  wgmma_fence();
  products_tf32<NN>(d, h, l, sb, sb + kBN * 128, kt > 0);
  wgmma_commit();
  if (prev >= 0) {
    wgmma_wait<1>();
    if (wtid == 0) release_slot(empty + 8 * prev);
  }
  prev = slot;
  ++it;
}

template <int NN>
__device__ __forceinline__ void mainloop_tf32(float (&d)[NN / 2],
                                              const unsigned char* smem,
                                              uint32_t base, int KT, int wg,
                                              int wtid, int& it) {
  using S = Smem<float>;
  const uint32_t empty = base + S::kBar + 8 * S::kStages;
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
  int prev = -1;
  fence_regs(d);
  for (int kt = 0; kt < KT; kt += 2) {
    stage_tf32<NN>(d, h0, l0, smem, base, kt, wg, wtid, it, prev);
    if (kt + 1 < KT)
      stage_tf32<NN>(d, h1, l1, smem, base, kt + 1, wg, wtid, it, prev);
  }
  wgmma_wait<0>();
  fence_regs(d);
  if (wtid == 0) release_slot(empty + 8 * prev);
}

// f32 with kSplit: one stage with the fragment registers (h, l) of its
// parity, its products in two halves of the tile's NN outputs, each summed
// apart from zero into p0 and p1; the half issued before each one is added
// to d once it completed (pending: 0 none, 1 p0, 2 p1), and the previous
// stage's slot released once its second half completed.
template <int NN>
__device__ __forceinline__ void stage_tf32_split(
    float (&d)[NN / 2], float (&p0)[NN / 4], float (&p1)[NN / 4],
    uint32_t (&h)[4][4], uint32_t (&l)[4][4], const unsigned char* smem,
    uint32_t base, int wg, int wtid, int& it, int& prev, int& pending) {
  using S = Smem<float>;
  constexpr int kBN = Tile<float>::kBN, kH = NN / 2;
  const uint32_t full = base + S::kBar, empty = full + 8 * S::kStages;
  const int slot = it % S::kStages, ph = (it / S::kStages) & 1;
  const uint32_t sb = base + slot * S::kSlot + kABytes;
  // add the completed half's sums to d (its columns: the half's n-tiles)
  auto add = [&](float(&p)[NN / 4], int half) {
    fence_regs(p);
#pragma unroll
    for (int j = 0; j < kH / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[4 * (j + half * kH / 8) + q] =
            __fadd_rn(d[4 * (j + half * kH / 8) + q], p[4 * j + q]);
  };
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fence_regs(h[j]);  // the products that read them have completed
    fence_regs(l[j]);
  }
  bar_wait(full + 8 * slot, ph);
  load_tf32(h, l, smem + slot * S::kSlot + wg * kBoxBytes, wtid);
  wgmma_fence();
  products_tf32<kH>(p0, h, l, sb, sb + kBN * 128, 0);
  wgmma_commit();
  if (pending == 2) {  // the previous stage's second half
    wgmma_wait<1>();
    add(p1, 1);
    if (wtid == 0) release_slot(empty + 8 * prev);
  }
  wgmma_fence();
  products_tf32<kH>(p1, h, l, sb + kH * 128, sb + kBN * 128 + kH * 128, 0);
  wgmma_commit();
  wgmma_wait<1>();
  add(p0, 0);
  pending = 2;
  prev = slot;
  ++it;
}

template <int NN>
__device__ __forceinline__ void mainloop_tf32_split(float (&d)[NN / 2],
                                                    const unsigned char* smem,
                                                    uint32_t base, int KT,
                                                    int wg, int wtid,
                                                    int& it) {
  using S = Smem<float>;
  const uint32_t empty = base + S::kBar + 8 * S::kStages;
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
  float p0[NN / 4], p1[NN / 4];
  int prev = -1, pending = 0;
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < KT; kt += 2) {
    stage_tf32_split<NN>(d, p0, p1, h0, l0, smem, base, wg, wtid, it, prev,
                         pending);
    if (kt + 1 < KT)
      stage_tf32_split<NN>(d, p0, p1, h1, l1, smem, base, wg, wtid, it, prev,
                           pending);
  }
  wgmma_wait<0>();
  fence_regs(p1);
#pragma unroll
  for (int j = 0; j < NN / 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      d[4 * (j + NN / 16) + q] = __fadd_rn(d[4 * (j + NN / 16) + q],
                                           p1[4 * j + q]);
  if (wtid == 0) release_slot(empty + 8 * prev);
}

// Two values rounded to T at dst (int8: round-half-even, clipped).
template <typename T>
__device__ __forceinline__ void put2(unsigned char* dst, float v0, float v1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  else if constexpr (std::is_same<T, int8_t>::value)
    *reinterpret_cast<char2*>(dst) = make_char2(r2l::q8(v0), r2l::q8(v1));
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

// The epilogue of an NN-wide tile: each accumulator pair through Epi,
// rounded to T into the warpgroup's staging tile, then TMA stores of its
// 128-byte boxes once the previous tile's stores have read it (neither
// where Epi stores nothing).
template <typename T, typename Epi, int NN>
__device__ __forceinline__ void epilogue(Acc<T> (&d)[NN / 2],
                                         const CUtensorMap* out,
                                         const typename Epi::Args& e,
                                         unsigned char* stg, Where w, int wg,
                                         int wtid) {
  constexpr int kCols = 128 / (int)sizeof(T);  // channels a box
  constexpr int kRounds = Tile<T>::kRounds;
  constexpr int kPer = Tile<T>::kBN / kCols / kRounds;  // boxes a round
  const bool st = Epi::stores(e);
  const int row0 = w.row0 + wg * kBoxRows;
#pragma unroll
  for (int rd = 0; rd < kRounds && rd * kPer < NN / kCols; ++rd) {
    if (st) {
      if (wtid == 0) bulk_wait_read<0>();
      wg_bar(1 + wg);
    }
    visit<NN>(d, wtid, [&](int, int r, int c, Acc<T> a0, Acc<T> a1) {
      const int byte = c * (int)sizeof(T), bx = byte >> 7;
      if (bx / kPer != rd) return;
      float v0, v1;
      Epi::pair(e, row0 + r, w.n0 + c, a0, a1, v0, v1);
      if (st)
        put2<T>(stg + (bx - rd * kPer) * kBoxBytes + sw128(r, byte & 127), v0,
                v1);
    });
    if (!st) continue;
    fence_async_smem();
    wg_bar(1 + wg);
    if (wtid == 0) {
#pragma unroll
      for (int bx = rd * kPer; bx < (rd + 1) * kPer && bx < NN / kCols; ++bx)
        tma_store(out, smem_u32(stg) + (bx - rd * kPer) * kBoxBytes,
                  w.n0 + bx * kCols, row0);
      bulk_commit();
    }
  }
}

// One NN-wide tile of a consumer warpgroup.
template <typename T, typename Epi, bool kSplit, int NN>
__device__ __forceinline__ void tile_of(const CUtensorMap* out, const Pass& p,
                                        const typename Epi::Args& e,
                                        const unsigned char* smem,
                                        uint32_t base, unsigned char* stg,
                                        Where w, int wg, int wtid, int& it) {
  Acc<T> d[NN / 2];
  const int KT = p.st0 + p.st1;
  if constexpr (!std::is_same<T, float>::value)
    mainloop_ss<T, NN>(d, base, KT, wg, wtid, it);
  else if constexpr (kSplit)
    mainloop_tf32_split<NN>(d, smem, base, KT, wg, wtid, it);
  else
    mainloop_tf32<NN>(d, smem, base, KT, wg, wtid, it);
  epilogue<T, Epi, NN>(d, out, e, stg, w, wg, wtid);
}

template <typename T, typename Epi, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    wide_pass(const __grid_constant__ CUtensorMap a0,
              const __grid_constant__ CUtensorMap a1,
              const __grid_constant__ CUtensorMap b,
              const __grid_constant__ CUtensorMap out, const Pass p,
              const typename Epi::Args e) {
  using S = Smem<T>;
  constexpr int kBN = Tile<T>::kBN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int ntn = (p.N + kBN - 1) / kBN;
  const int groups = ((p.rows + kBM - 1) / kBM + kC - 1) / kC * ntn;
  const int rank = kC > 1 ? (int)cluster_rank() : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      bar_init(base + S::kBar + 8 * s, 1);
      bar_init(base + S::kBar + 8 * (S::kStages + s), 2 * kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block's barriers before any copy or release
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  if (wg == 2) {  // the producer: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0) produce<T>(&a0, &a1, &b, p, base, groups, ntn, rank);
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  unsigned char* stg = smem + S::kStage + wg * S::kOut;
  int it = 0;
  for (int gi = blockIdx.x / kC; gi < groups; gi += gridDim.x / kC) {
    const Where w = where<T>(gi, ntn, rank);
    if (kBN == 256 && p.N - w.n0 < kBN)
      tile_of<T, Epi, kSplit, 128>(&out, p, e, smem, base, stg, w, wg, wtid,
                                   it);
    else
      tile_of<T, Epi, kSplit, kBN>(&out, p, e, smem, base, stg, w, wg, wtid,
                                   it);
  }
  if (wtid == 0) bulk_wait<0>();  // the stores have landed
  cluster_sync();  // no block leaves while another may copy or release
}

// ---- the host -------------------------------------------------------------

// A 2-D tensor map over the row-major [rows, cols] matrix of T at base, for
// boxes of 128 bytes of a row x box_rows rows in the 128-byte swizzle.
template <typename T>
inline cudaError_t sw128_map(CUtensorMap* map, const void* base,
                             long long rows, int cols, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {128 / (cuuint32_t)sizeof(T),
                             (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map,
      sizeof(T) == 2   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
// An activation buffer's map (A loads and output stores).
template <typename T>
inline cudaError_t act_map(CUtensorMap* map, const void* base, long long rows,
                           int cols) {
  return sw128_map<T>(map, base, rows, cols, kBoxRows);
}
// A layer's weights [N, K] (f32: [2N, K], its TF32 parts) as B.
template <typename T>
inline cudaError_t weight_map(CUtensorMap* map, const void* base, int N,
                              int K) {
  return sw128_map<T>(map, base, (long long)N * Tile<T>::kParts, K, kBRows);
}

// The block's shape for hopper::launch_cluster: two consumer warpgroups.
struct Shape {
  static constexpr int kWGs = 2;
};

// One pass on one block an SM, kC-block clusters (at most one a group of
// tiles): a1 is read only where p.st1 > 0; `out` only where
// Epi::stores(e).
template <typename T, typename Epi, bool kSplit = false>
cudaError_t launch_pass(const CUtensorMap& a0, const CUtensorMap& a1,
                        const CUtensorMap& b, const CUtensorMap& out,
                        const Pass& p, const typename Epi::Args& e,
                        cudaStream_t stream) {
  constexpr int kBN = Tile<T>::kBN;
  if (p.rows <= 0) return cudaSuccess;
  if (p.N % 128 != 0 || p.st0 < 1 || p.st1 < 0)
    return cudaErrorInvalidValue;
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long groups = (long long)((p.rows + kBM * kC - 1) / (kBM * kC)) *
                           ((p.N + kBN - 1) / kBN);
  const int clusters = (int)(groups < sms / kC ? groups : sms / kC);
  return launch_cluster<T, kC, Shape>(wide_pass<T, Epi, kSplit>, a0,
                                      kC * clusters, Smem<T>::kBytes, stream,
                                      a1, b, out, p, e);
}

}  // namespace wideh
