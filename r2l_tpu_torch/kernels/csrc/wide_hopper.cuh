// The Hopper pass skeleton of the wide forms: one layer of a network too
// wide to keep on the chip, as a GEMM over activations in device memory,
// out[rows, N] = epilogue(A[rows, K] W[N, K]^T), on wgmma fed by TMA in a
// warp-specialised block. The teacher's wide form (nerf_wide.cu: f32, bf16
// and int8) runs every GEMM layer on it, K5's wide form (r2l_wide_bwd.cu)
// its dh walk and the training forward's (r2l_wide_train.cu: K3, K4/K8)
// every layer and the student frame's (r2l_wide.cu: K1, K9, K2) every
// layer, each with an epilogue of its own (the Epi parameter).
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
// 128; an epilogue may ask for 128, Epi::kBN, as the int8 training ones do:
// their side tensors need the registers of half a tile's accumulators), two
// consumer warpgroups of 64 rows each and a producer warpgroup,
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
// cores truncate every sum they add a product to, so the f32 sum has routes
// set by kSplit, the input channels a partial sum: 0, one running sum over
// K (the teacher's, as K6 f32); 32, each stage's products summed apart from
// zero (K5's walk: over K = 512 one sum reads past its limit); 8, each k8
// step's three products summed apart (K3: its stash reads past the limit
// with 32; PERF.md). A partial sum is taken in halves of the tile's outputs
// (two buffers of 32 registers, wgmma m64n64k8): the products of one half
// run while the other half's completed sum is added to the running sum in
// f32 (32 adds a thread), so one group of three products is always in
// flight behind the adds, and the two consumer warpgroups, which share the
// tensor cores, fill each other's waits. At 8 that is eight groups, eight
// waits and 256 adds a thread a stage (three products of 64 x 64 x 8 a
// group); the registers stay those of the 32-channel route (64 for the
// sum, 64 for the halves, 64 for two stages' fragments).
//
// Epilogue: Epi::pair(args, row, col, acc0, acc1, v0, v1) on each
// accumulator pair of the tile (args: the epilogue's own parameter struct,
// Epi::Args; it may read side tensors at (row, col) and write side
// outputs, and guards the rows past the pass itself; K5's and K3's do).
// An epilogue may instead have a side tile (Epi::SideT, the int8 training
// forward's): the producer loads its [128 x 128] by TMA into the ring's
// room that a 128-wide tile leaves, the pairs read and overwrite it in
// shared memory, and it is stored by TMA with the tile (HasSideTile; read
// and written a pair at a time in device memory, these accesses' latency
// set the int8 passes' pace: PERF.md). v0 and v1 rounded to
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

// The outputs of a pass's tiles: the type's kBN, or the epilogue's where
// it sets one (128).
template <typename T, typename Epi, typename = void>
struct TileN {
  static constexpr int value = Tile<T>::kBN;
};
template <typename T, typename Epi>
struct TileN<T, Epi, std::void_t<decltype(Epi::kBN)>> {
  static constexpr int value = Epi::kBN;
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
  // the ring's full and empty barriers, then the side tile's (below)
  static constexpr int kSideBar = kBar + 2 * kStages * 8;
  static constexpr int kBytes = kSideBar + 2 * 8 + 1024;
};

// One pass: `rows` points (A's rows and the output's), N output channels
// (a multiple of 128), K = (st0 + st1) * kKC; `side` (an epilogue with a
// side tile, Epi::SideT): 0 none this pass, 1 written (stored to the side
// output's map), 2 also read (loaded from the side input's map).
struct Pass {
  int rows, N, st0, st1;
  int side;
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

// The epilogue of the teacher's int8 layers: acc * m + b in one FMA (kBrq,
// Pallas bf16_requant: in bf16, r2l::dequant_bf16), ReLU where the layer
// has one, times the consumer's inverse scale (1 where folded); the store
// rounds half to even and clips.
template <bool kBrq>
struct RequantT {
  using Args = BiasRelu::Args;
  __device__ __forceinline__ static bool stores(const Args&) { return true; }
  __device__ __forceinline__ static void pair(const Args& e, int, int col,
                                              int a0, int a1, float& v0,
                                              float& v1) {
    const float* t = reinterpret_cast<const float*>(e.epi) + 4 * col;
    const float2 mb0 = __ldg(reinterpret_cast<const float2*>(t));
    const float2 mb1 = __ldg(reinterpret_cast<const float2*>(t + 4));
    if constexpr (kBrq) {
      v0 = r2l::dequant_bf16(a0, mb0.x, mb0.y);
      v1 = r2l::dequant_bf16(a1, mb1.x, mb1.y);
    } else {
      v0 = r2l::dequant(a0, mb0.x, mb0.y);
      v1 = r2l::dequant(a1, mb1.x, mb1.y);
    }
    if (e.relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
    v0 = __fmul_rn(v0, __ldg(t + 2));
    v1 = __fmul_rn(v1, __ldg(t + 6));
  }
};
using Requant = RequantT<false>;

// Side tensors read and written a pair at a time, at (row, col) and (row,
// col + 1) of a [rows, N] tensor: K3's h, and the int8 forms' h0 (two
// passes of a call). Loads clamp the row to the pass's (rows past it are
// computed, never stored: a guard in the skeleton costs more) and go
// through the non-coherent path; stores leave the rows past the pass out.
__device__ __forceinline__ float2 side2(const float* p, int row, int col,
                                        int rows, int N) {
  return __ldg(reinterpret_cast<const float2*>(
      p + (size_t)min(row, rows - 1) * N + col));
}
__device__ __forceinline__ float2 side2(const __nv_bfloat16* p, int row,
                                        int col, int rows, int N) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
      p + (size_t)min(row, rows - 1) * N + col)));
}
__device__ __forceinline__ void put_side(float* p, int row, int col,
                                         int rows, int N, float2 v) {
  if (row < rows)
    *reinterpret_cast<float2*>(p + (size_t)row * N + col) = v;
}

// K3's layers (the training forward in bf16 or f32, r2l_train.py's
// train_fwd_ref): the bias added in f32, then ReLU (the head and a block's
// inner layer), or at a block's end t2 * res_scale + h with t2 = acc + b
// unrounded and h the block's input, its stash row read at (row, col). The
// skeleton rounds to T and stores the tile to the layer's own stash row.
// kFrame: K1's and K9's layers (the student frame, r2l_fused.py's
// _chain_ref), where t2 is rounded to T before the residual; each layer's
// output goes to a scratch buffer.
template <typename T, bool kFrame = false>
struct TrainK3 {
  struct Args {
    const float* bias;  // [N]
    const T* h;         // a block's end: its input [rows, N]; else null
    int rows, N;
    float res_scale;
  };
  __device__ __forceinline__ static bool stores(const Args&) { return true; }
  __device__ __forceinline__ static void pair(const Args& e, int row, int col,
                                              float a0, float a1, float& v0,
                                              float& v1) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(e.bias + col));
    v0 = __fadd_rn(a0, b.x);
    v1 = __fadd_rn(a1, b.y);
    if (!e.h) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      return;
    }
    const float2 h = side2(e.h, row, col, e.rows, e.N);
    if constexpr (kFrame) {
      v0 = rnd<T>(v0);
      v1 = rnd<T>(v1);
    }
    v0 = __fadd_rn(__fmul_rn(v0, e.res_scale), h.x);
    v1 = __fadd_rn(__fmul_rn(v1, e.res_scale), h.y);
  }
};

// K4's (kQ) and K8's layers (the int8 training forward, train_fwd_int8_ref
// with fold_requant=False): v = acc * m + b in one FMA; the head h0 =
// ReLU(v), h = h0 (K4) or h0 rounded to bf16 (K8), h0 kept in f32 for the
// global residual; an inner layer t = ReLU(v) (K8: rounded to bf16 and
// written to its stash row); a block's end h = v + h_in (K8: rounded to
// bf16). h_in, h and K8's t travel in the pass's side tile (SideT: K4's f32
// stream, read and written in place; K8's bf16 stash rows), which the
// producer loads and the skeleton stores by TMA; h0 a pair at a time. The
// value handed to the skeleton is what the next product quantizes (after
// the last block, h + h0: the tail's) times its inverse scale; the s8
// store rounds half to even and clips: the codes (K4: to the stash rows;
// K8: to one of two scratch buffers in turn).
template <bool kQ>
struct TrainK48 {
  enum Kind { kHead = 0, kInner = 1, kEnd = 2 };
  using SideT = typename std::conditional<kQ, float, __nv_bfloat16>::type;
  static constexpr int kBN = 128;  // the side tile's room: see side_box
  struct Args {
    const float* mb;   // the layer's (m, b) a channel
    const float* inv;  // the next product's inverse scales [N]
    float* h0;         // with the global residual: kHead writes, a final
                       // kEnd reads; else null
    int kind, final_, rows, N;
  };
  __device__ __forceinline__ static bool stores(const Args&) { return true; }
  // s: the pair's two values in the side tile (h_in in, h or t out); the
  // pass has none where K4's inner layers run
  __device__ __forceinline__ static void pair(const Args& e, int row, int col,
                                              int a0, int a1,
                                              unsigned char* s, float& v0,
                                              float& v1) {
    const float4 mb = __ldg(reinterpret_cast<const float4*>(e.mb + 2 * col));
    float x0 = r2l::dequant(a0, mb.x, mb.y), x1 = r2l::dequant(a1, mb.z, mb.w);
    if (e.kind == kInner) {
      x0 = fmaxf(x0, 0.f);
      x1 = fmaxf(x1, 0.f);
      if constexpr (!kQ) {
        x0 = rnd<__nv_bfloat16>(x0);
        x1 = rnd<__nv_bfloat16>(x1);
        put_pair(s, x0, x1);
      }
    } else {
      float2 g = make_float2(0.f, 0.f);  // h0
      if (e.kind == kHead) {
        g = make_float2(fmaxf(x0, 0.f), fmaxf(x1, 0.f));
        x0 = kQ ? g.x : rnd<__nv_bfloat16>(g.x);
        x1 = kQ ? g.y : rnd<__nv_bfloat16>(g.y);
        if (e.h0) put_side(e.h0, row, col, e.rows, e.N, g);
      } else {
        const float2 h = get_pair(s);
        x0 = __fadd_rn(x0, h.x);
        x1 = __fadd_rn(x1, h.y);
        if constexpr (!kQ) {
          x0 = rnd<__nv_bfloat16>(x0);
          x1 = rnd<__nv_bfloat16>(x1);
        }
        if (e.final_ && e.h0) g = side2(e.h0, row, col, e.rows, e.N);
      }
      put_pair(s, x0, x1);
      if (e.final_ && e.h0) {
        x0 = __fadd_rn(x0, g.x);
        x1 = __fadd_rn(x1, g.y);
      }
    }
    const float2 inv = __ldg(reinterpret_cast<const float2*>(e.inv + col));
    v0 = __fmul_rn(x0, inv.x);
    v1 = __fmul_rn(x1, inv.y);
  }

 private:
  __device__ __forceinline__ static float2 get_pair(const unsigned char* s) {
    if constexpr (kQ)
      return *reinterpret_cast<const float2*>(s);
    else
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
  }
  __device__ __forceinline__ static void put_pair(unsigned char* s, float v0,
                                                  float v1) {
    if constexpr (kQ)
      *reinterpret_cast<float2*>(s) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(v0, v1);
  }
};

// K2's layers (the student frame in static-scale int8, r2l_fused.py's
// int8_pe_chain_ref in one of its forms, Form: r2l_fused.py's EPILOGUES):
// v = acc * m + b in one FMA; the head h0 = ReLU(v) in f32, h = h0 rounded
// to bf16; an inner layer t = ReLU(v), deployed in f32, fold and unfolded
// rounded to bf16, unfolded also times the next product's inverse scale (the
// folded forms have it in m and b); a block's end h = v rounded to bf16
// plus h_in, rounded to bf16. h travels in the pass's bf16 side tile (one
// residual stream, read and written in place: the producer loads h_in by
// TMA a tile ahead, the skeleton stores h); h0 a pair at a time. The value
// handed to the skeleton is what the next product quantizes (after the
// last block, h + h0: the tail's) times its inverse scale, except the
// folded inner layers'; the s8 store rounds half to even and clips. A form
// plus kBf16Resid (Pallas bf16_resid): h0 is h, the head's output rounded
// to bf16, and the tail's h + h0 is rounded to bf16.
struct FrameK2 {
  enum Kind { kHead = 0, kInner = 1, kEnd = 2 };
  enum Form { kDeployed = 0, kFold = 1, kUnfolded = 2, kBf16Resid = 16 };
  using SideT = __nv_bfloat16;
  static constexpr int kBN = 128;  // the side tile's room: see side_box
  struct Args {
    const float* mb;   // the layer's (m, b) a channel
    const float* inv;  // the next product's inverse scales [N]
    float* h0;         // with the global residual: kHead writes, a final
                       // kEnd reads; else null
    int kind, final_, rows, N, form;
  };
  __device__ __forceinline__ static bool stores(const Args&) { return true; }
  // s: the pair's two values of h in the side tile; none in an inner pass
  __device__ __forceinline__ static void pair(const Args& e, int row, int col,
                                              int a0, int a1,
                                              unsigned char* s, float& v0,
                                              float& v1) {
    const float4 mb = __ldg(reinterpret_cast<const float4*>(e.mb + 2 * col));
    float x0 = r2l::dequant(a0, mb.x, mb.y), x1 = r2l::dequant(a1, mb.z, mb.w);
    const float2 inv = __ldg(reinterpret_cast<const float2*>(e.inv + col));
    const int form = e.form & ~kBf16Resid;
    const bool br = (e.form & kBf16Resid) != 0;
    if (e.kind == kInner) {
      x0 = fmaxf(x0, 0.f);
      x1 = fmaxf(x1, 0.f);
      if (form != kDeployed) {
        x0 = rnd<__nv_bfloat16>(x0);
        x1 = rnd<__nv_bfloat16>(x1);
      }
      v0 = form == kUnfolded ? __fmul_rn(x0, inv.x) : x0;
      v1 = form == kUnfolded ? __fmul_rn(x1, inv.y) : x1;
      return;
    }
    float2 g = make_float2(0.f, 0.f);  // h0
    if (e.kind == kHead) {
      g = make_float2(fmaxf(x0, 0.f), fmaxf(x1, 0.f));
      x0 = rnd<__nv_bfloat16>(g.x);
      x1 = rnd<__nv_bfloat16>(g.y);
      if (br) g = make_float2(x0, x1);
      if (e.h0) put_side(e.h0, row, col, e.rows, e.N, g);
    } else {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(s));
      x0 = rnd<__nv_bfloat16>(__fadd_rn(rnd<__nv_bfloat16>(x0), h.x));
      x1 = rnd<__nv_bfloat16>(__fadd_rn(rnd<__nv_bfloat16>(x1), h.y));
      if (e.final_ && e.h0) g = side2(e.h0, row, col, e.rows, e.N);
    }
    *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(x0, x1);
    if (e.final_ && e.h0) {
      x0 = __fadd_rn(x0, g.x);
      x1 = __fadd_rn(x1, g.y);
      if (br) {
        x0 = rnd<__nv_bfloat16>(x0);
        x1 = rnd<__nv_bfloat16>(x1);
      }
    }
    v0 = __fmul_rn(x0, inv.x);
    v1 = __fmul_rn(x1, inv.y);
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

// An epilogue with a side tile (Epi::SideT): [kBM rows x kBN] of SideT a
// tile, which the producer loads from the side input's map (Pass::side 2)
// once the previous tile's epilogue released it, the epilogue reads and
// overwrites in place through a pointer to each pair, and the epilogue's
// first thread stores to the side output's map with the tile's output.
// It lies in the ring's unused room: a 128-wide tile reads half of a slot's
// B, so the other half of each slot holds two of the tile's 64-row x
// 128-byte boxes (the 128-byte swizzle), the warpgroup's own SideBoxes
// boxes from box wg * SideBoxes on (f32: eight boxes in four slots).
template <typename Epi, typename = void>
struct HasSideTile : std::false_type {};
template <typename Epi>
struct HasSideTile<Epi, std::void_t<typename Epi::SideT>> : std::true_type {};
template <typename Epi, bool = HasSideTile<Epi>::value>
struct SideBoxes {  // a warpgroup's boxes
  static constexpr int value = 0;
};
template <typename Epi>
struct SideBoxes<Epi, true> {
  static constexpr int value =
      kBRows * (int)sizeof(typename Epi::SideT) / 128;
};
template <typename T>
__device__ __forceinline__ uint32_t side_box(uint32_t base, int i) {
  return base + (i / 2) * Smem<T>::kSlot + kABytes + kBRows * 128 +
         (i % 2) * kBoxBytes;
}

// Where a tile is: its first row and output channel. The kC blocks of a
// cluster take the kC row tiles of a group with the same outputs (block
// `rank` the rank-th), so the weights' stages are theirs in common.
struct Where {
  int row0, n0;
};
template <int kBN>
__device__ __forceinline__ Where where(int group, int ntn, int rank) {
  const int mg = group / ntn;
  return {(mg * kC + rank) * kBM, (group - mg * ntn) * kBN};
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
// order; A is the block's own, B's boxes (bf16, int8: outputs n0 and, in a
// 256-wide tile, n0 + 128; f32: the high and the low parts of n0) are each
// loaded by one block of the cluster into all of them.
template <typename T, typename Epi, int kBN>
__device__ void produce(const CUtensorMap* a0, const CUtensorMap* a1,
                        const CUtensorMap* b, const CUtensorMap* side_in,
                        const Pass& p, uint32_t base, int groups, int ntn,
                        int rank) {
  using S = Smem<T>;
  constexpr int kKC = Tile<T>::kKC;
  constexpr int kBoxes = Tile<T>::kParts == 2 ? 2 : kBN / kBRows;
  const uint32_t full = base + S::kBar, empty = full + 8 * S::kStages;
  const int KT = p.st0 + p.st1;
  int it = 0, sit = 0;
  for (int gi = blockIdx.x / kC; gi < groups; gi += gridDim.x / kC) {
    const Where w = where<kBN>(gi, ntn, rank);
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int slot = it % S::kStages, ph = (it / S::kStages) & 1;
      const uint32_t fb = full + 8 * slot, sa = base + slot * S::kSlot;
      const uint32_t sb = sa + kABytes;
      bar_wait(empty + 8 * slot, ph ^ 1);
      bar_expect_tx(fb, kABytes + kBoxes * kBRows * 128);
      const bool first = kt < p.st0;
      const CUtensorMap* am = first ? a0 : a1;
      const int k = (first ? kt : kt - p.st0) * kKC;
      tma_load(sa, am, k, w.row0, fb);
      tma_load(sa + kBoxBytes, am, k, w.row0 + kBoxRows, fb);
      for (int i = rank; i < kBoxes; i += kC)
        tma_load_all(sb + i * kBRows * 128, b, kt * kKC,
                     Tile<T>::kParts == 2 ? i * p.N + w.n0
                                          : w.n0 + i * kBRows,
                     fb);
    }
    if constexpr (HasSideTile<Epi>::value) {
      // the tile's side tile, once the previous tile's epilogue is done
      // with it (after this tile's stages: those run ahead of it)
      if (p.side) {
        using SideT = typename Epi::SideT;
        constexpr int kSB = SideBoxes<Epi>::value;
        const uint32_t sfull = base + S::kSideBar, sempty = sfull + 8;
        bar_wait(sempty, (sit & 1) ^ 1);
        bar_expect_tx(sfull, p.side == 2 ? 2 * kSB * kBoxBytes : 0);
        if (p.side == 2)
          for (int i = 0; i < 2 * kSB; ++i)
            tma_load(side_box<T>(base, i), side_in,
                     w.n0 + (i % kSB) * (128 / (int)sizeof(SideT)),
                     w.row0 + (i / kSB) * kBoxRows, sfull);
        ++sit;
      }
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

// The stage's 3xTF32 products of k8 steps [j0, j1) and outputs [n0, n0 +
// N) of the slot's B (bh, bl: its high and low parts) into d, each step
// a_hi w_lo, a_lo w_hi, a_hi w_hi; `acc` 0 starts d from zero.
template <int N>
__device__ __forceinline__ void products_tf32(float (&d)[N / 2],
                                              const uint32_t (&h)[4][4],
                                              const uint32_t (&l)[4][4],
                                              uint32_t bh, uint32_t bl,
                                              int acc, int j0 = 0,
                                              int j1 = 4) {
#pragma unroll
  for (int j = j0; j < j1; ++j) {
    Wgmma<N>::tf32(d, h[j], desc_k128(bl + 32 * j), acc || j > j0);
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

// Half `half` of the tile's NN outputs (its n-tiles), summed apart in p,
// added to d in f32 once its products completed.
template <int NN>
__device__ __forceinline__ void add_half(float (&d)[NN / 2],
                                         float (&p)[NN / 4], int half) {
  constexpr int kH = NN / 2;
  fence_regs(p);
#pragma unroll
  for (int j = 0; j < kH / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      d[4 * (j + half * kH / 8) + q] =
          __fadd_rn(d[4 * (j + half * kH / 8) + q], p[4 * j + q]);
}

// f32 with kSplit input channels a partial sum: one stage with the
// fragment registers (h, l) of its parity, its k8 steps in groups of
// kSplit / 8, each group's products in two halves of the tile's NN outputs
// summed apart from zero into p0 and p1. After each half is issued, the
// half issued before it is added to d once it completed (`pending`: p1
// holds a sum not yet added), and the previous stage's slot is released
// once the last group that read it (its second half) completed.
template <int NN, int kSplit>
__device__ __forceinline__ void stage_tf32_split(
    float (&d)[NN / 2], float (&p0)[NN / 4], float (&p1)[NN / 4],
    uint32_t (&h)[4][4], uint32_t (&l)[4][4], const unsigned char* smem,
    uint32_t base, int wg, int wtid, int& it, int& prev, bool& pending) {
  using S = Smem<float>;
  constexpr int kBN = Tile<float>::kBN, kH = NN / 2, kG = kSplit / 8;
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
#pragma unroll
  for (int j0 = 0; j0 < 4; j0 += kG) {
    wgmma_fence();
    products_tf32<kH>(p0, h, l, sb, sb + kBN * 128, 0, j0, j0 + kG);
    wgmma_commit();
    if (pending) {  // the previous group's second half
      wgmma_wait<1>();
      add_half<NN>(d, p1, 1);
      if (j0 == 0 && wtid == 0) release_slot(empty + 8 * prev);
    }
    wgmma_fence();
    products_tf32<kH>(p1, h, l, sb + kH * 128, sb + kBN * 128 + kH * 128, 0,
                      j0, j0 + kG);
    wgmma_commit();
    wgmma_wait<1>();
    add_half<NN>(d, p0, 0);
    pending = true;
  }
  prev = slot;
  ++it;
}

template <int NN, int kSplit>
__device__ __forceinline__ void mainloop_tf32_split(float (&d)[NN / 2],
                                                    const unsigned char* smem,
                                                    uint32_t base, int KT,
                                                    int wg, int wtid,
                                                    int& it) {
  static_assert(kSplit == 8 || kSplit == 16 || kSplit == 32,
                "a partial sum is a whole number of k8 steps of a stage");
  using S = Smem<float>;
  const uint32_t empty = base + S::kBar + 8 * S::kStages;
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
  float p0[NN / 4], p1[NN / 4];
  int prev = -1;
  bool pending = false;
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < KT; kt += 2) {
    stage_tf32_split<NN, kSplit>(d, p0, p1, h0, l0, smem, base, wg, wtid, it,
                                 prev, pending);
    if (kt + 1 < KT)
      stage_tf32_split<NN, kSplit>(d, p0, p1, h1, l1, smem, base, wg, wtid,
                                   it, prev, pending);
  }
  wgmma_wait<0>();
  add_half<NN>(d, p1, 1);
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
// where Epi stores nothing). With a side tile (HasSideTile, its loads
// landed): each pair reads and writes its side values there, and the
// warpgroup's side boxes go out with its first round.
template <typename T, typename Epi, int NN>
__device__ __forceinline__ void epilogue(Acc<T> (&d)[NN / 2],
                                         const CUtensorMap* out,
                                         const CUtensorMap* side_out,
                                         const typename Epi::Args& e,
                                         const Pass& p, unsigned char* smem,
                                         uint32_t base, unsigned char* stg,
                                         Where w, int wg, int wtid) {
  constexpr int kCols = 128 / (int)sizeof(T);  // channels a box
  constexpr int kRounds = Tile<T>::kRounds;
  constexpr int kPer = Tile<T>::kBN / kCols / kRounds;  // boxes a round
  constexpr bool kSide = HasSideTile<Epi>::value;
  const bool st = Epi::stores(e);
  const int row0 = w.row0 + wg * kBoxRows;
  static_assert(!kSide || (NN == kBRows && Tile<T>::kParts == 1 &&
                          Smem<T>::kStages >= SideBoxes<Epi>::value),
                "a side tile lies in the unused halves of 128-wide tiles' B "
                "stages");
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
      if constexpr (kSide) {
        const int sb = c * (int)sizeof(typename Epi::SideT);
        unsigned char* sp =
            p.side ? smem +
                         (side_box<T>(base, wg * SideBoxes<Epi>::value +
                                                (sb >> 7)) -
                          base) +
                         sw128(r, sb & 127)
                   : nullptr;
        Epi::pair(e, row0 + r, w.n0 + c, a0, a1, sp, v0, v1);
      } else {
        Epi::pair(e, row0 + r, w.n0 + c, a0, a1, v0, v1);
      }
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
      if constexpr (kSide)
        if (p.side && rd == 0)  // the side tile: one round (int8)
          for (int i = 0; i < SideBoxes<Epi>::value; ++i)
            tma_store(side_out,
                      side_box<T>(base, wg * SideBoxes<Epi>::value + i),
                      w.n0 + i * (128 / (int)sizeof(typename Epi::SideT)),
                      row0);
      bulk_commit();
    }
  }
}

// One NN-wide tile of a consumer warpgroup; with a side tile, the
// epilogue waits for its loads (the producer's), and once the epilogue's
// stores have read it the tile is the producer's again (`sit`: the side
// tiles the warpgroup has had).
template <typename T, typename Epi, int kSplit, int NN>
__device__ __forceinline__ void tile_of(const CUtensorMap* out,
                                        const CUtensorMap* side_out,
                                        const Pass& p,
                                        const typename Epi::Args& e,
                                        unsigned char* smem, uint32_t base,
                                        unsigned char* stg, Where w, int wg,
                                        int wtid, int& it, int& sit) {
  Acc<T> d[NN / 2];
  const int KT = p.st0 + p.st1;
  if constexpr (!std::is_same<T, float>::value)
    mainloop_ss<T, NN>(d, base, KT, wg, wtid, it);
  else if constexpr (kSplit > 0)
    mainloop_tf32_split<NN, kSplit>(d, smem, base, KT, wg, wtid, it);
  else
    mainloop_tf32<NN>(d, smem, base, KT, wg, wtid, it);
  const uint32_t sfull = base + Smem<T>::kSideBar;
  if (HasSideTile<Epi>::value && p.side) bar_wait(sfull, sit & 1);
  epilogue<T, Epi, NN>(d, out, side_out, e, p, smem, base, stg, w, wg, wtid);
  if (HasSideTile<Epi>::value && p.side) {
    if (wtid == 0) {
      bulk_wait_read<0>();
      arrive(sfull + 8);
    }
    ++sit;
  }
}

template <typename T, typename Epi, int kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    wide_pass(const __grid_constant__ CUtensorMap a0,
              const __grid_constant__ CUtensorMap a1,
              const __grid_constant__ CUtensorMap b,
              const __grid_constant__ CUtensorMap out,
              const __grid_constant__ CUtensorMap side_in,
              const __grid_constant__ CUtensorMap side_out, const Pass p,
              const typename Epi::Args e) {
  using S = Smem<T>;
  constexpr int kBN = TileN<T, Epi>::value;
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
    bar_init(base + S::kSideBar, 1);      // the side tile's loads landed
    bar_init(base + S::kSideBar + 8, 2);  // both warpgroups are done with it
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block's barriers before any copy or release
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  if (wg == 2) {  // the producer: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0)
      produce<T, Epi, kBN>(&a0, &a1, &b, &side_in, p, base, groups, ntn,
                           rank);
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  unsigned char* stg = smem + S::kStage + wg * S::kOut;
  int it = 0, sit = 0;
  for (int gi = blockIdx.x / kC; gi < groups; gi += gridDim.x / kC) {
    const Where w = where<kBN>(gi, ntn, rank);
    if (kBN == 256 && p.N - w.n0 < kBN)
      tile_of<T, Epi, kSplit, 128>(&out, &side_out, p, e, smem, base, stg, w,
                                   wg, wtid, it, sit);
    else
      tile_of<T, Epi, kSplit, kBN>(&out, &side_out, p, e, smem, base, stg, w,
                                   wg, wtid, it, sit);
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
// Epi::stores(e); with a side tile (p.side) side_in where p.side is 2 and
// side_out. kSplit (f32): the input channels a partial sum, 0 one running
// sum.
template <typename T, typename Epi, int kSplit = 0>
cudaError_t launch_pass(const CUtensorMap& a0, const CUtensorMap& a1,
                        const CUtensorMap& b, const CUtensorMap& out,
                        const CUtensorMap& side_in,
                        const CUtensorMap& side_out, const Pass& p,
                        const typename Epi::Args& e, cudaStream_t stream) {
  constexpr int kBN = TileN<T, Epi>::value;
  if (p.rows <= 0) return cudaSuccess;
  if (p.N % 128 != 0 || p.st0 < 1 || p.st1 < 0 || p.side < 0 ||
      p.side > 2 || (p.side && !HasSideTile<Epi>::value))
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
                                      a1, b, out, side_in, side_out, p, e);
}
// A pass without a side tile.
template <typename T, typename Epi, int kSplit = 0>
cudaError_t launch_pass(const CUtensorMap& a0, const CUtensorMap& a1,
                        const CUtensorMap& b, const CUtensorMap& out,
                        const Pass& p, const typename Epi::Args& e,
                        cudaStream_t stream) {
  return launch_pass<T, Epi, kSplit>(a0, a1, b, out, out, out, p, e, stream);
}

// One layer's pass of `rows` x N outputs from the K input channels of the
// map `a` against the weights at w ([N, K] of T, f32 two parts) into out
// [rows, N]; with side_out (an epilogue with a side tile, [rows, N] of its
// SideT), the side tile stored there and, with side_in, loaded from there
// first. The training forward's and the frame's layers (r2l_wide_train.cu,
// r2l_wide.cu).
template <typename T, typename Epi, int kSplit = 0>
cudaError_t layer_pass(const CUtensorMap& a, const void* w, int rows, int N,
                       int K, const void* out, const typename Epi::Args& e,
                       cudaStream_t stream, const void* side_in = nullptr,
                       const void* side_out = nullptr) {
  CUtensorMap wm, om, si, so;
  cudaError_t err = weight_map<T>(&wm, w, N, K);
  if (err == cudaSuccess) err = act_map<T>(&om, out, rows, N);
  int side = 0;
  if constexpr (HasSideTile<Epi>::value) {
    using S = typename Epi::SideT;
    if (side_out) {
      side = side_in ? 2 : 1;
      if (err == cudaSuccess) err = act_map<S>(&so, side_out, rows, N);
      if (err == cudaSuccess)
        err = act_map<S>(&si, side_in ? side_in : side_out, rows, N);
    }
  }
  if (err != cudaSuccess) return err;
  const Pass p{rows, N, K * (int)sizeof(T) / 128, 0, side};
  if (!side) return launch_pass<T, Epi, kSplit>(a, a, wm, om, p, e, stream);
  return launch_pass<T, Epi, kSplit>(a, a, wm, om, si, so, p, e, stream);
}

}  // namespace wideh
