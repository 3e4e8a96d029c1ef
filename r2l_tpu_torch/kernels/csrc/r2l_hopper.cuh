// The student's R2L chain on Hopper, one kernel template shared by K1
// (r2l_pe_fused.cu: the positional encoding in the kernel), K9
// (r2l_fused.cu: the encoded input read from device memory) and K3
// (r2l_train_fwd.cu: K1 with the training stash), bf16 or f32 weights: head
// Linear+ReLU -> nb ResMLP blocks (nl Linear layers with ReLU between, x
// res_scale, + block input) -> global residual -> Linear+sigmoid tail ->
// [n, out_dim] f32.
//
// Rounding follows the Pallas `_kernel_body`: activations are rounded to
// the weight type between layers, dots accumulate in f32, biases are added
// in f32 before the rounding (not as in `apply_r2l`, which rounds the dot
// first), and the block output is (t * res_scale + h) in f32 from the
// rounded t, rounded; the global residual adds the rounded h0 to it in f32
// and rounds; the tail is an f32 dot of that with the tail weights.
//
// Work: a block owns 128 rays (bf16: two consumer warpgroups of 64, wgmma's
// M) or 64 (f32: one), their activations in shared memory: H, the block
// input, and T, the inner activation, each [64 rays x W] per warpgroup.
// One producer warpgroup, of which one thread copies the weights, gives
// its registers to the consumers (setmaxnreg).
//
// Weights: staged once per model (r2l_fused.py, stage_chain_weights): the
// head, then every body layer, each cut into stages of KS input channels
// for all W outputs, laid out as wgmma reads B; bulk-copied through the
// ring of hopper_ring.cuh, three slots of 32 KB at W256, which runs without
// a break from the head through the body. Two blocks form a cluster and
// share each stage (multicast), so the image is read from L2 once per 256
// rays in bf16 (11.8 MB at W256/D88, 7.4 GB a 400x400 frame) and once per
// 128 in f32 (47.2 MB of hi/lo, 59 GB a frame). Measured on an H100
// (PERF.md): four-block clusters, which halve those bytes, ran 7% (bf16) and
// 13% (f32) slower, and six 16 KB slots 11-12% slower than three of 32 KB:
// the time goes with the stages and the coupling of the blocks that share
// them, not with the L2 bytes. The grid is padded to whole clusters; a
// block with no rays takes part in every stage to the end.
//
// Products: bf16 wgmma m64nWk16 with both operands in shared memory; f32 as
// 3xTF32 (a_hi w_lo + a_lo w_hi + a_hi w_hi by wgmma m64nWk8 tf32, A split
// in registers): about 21 mantissa bits, far inside K1's f32 limit (K3's
// sums each stage apart: ChainTrainF32). The
// head's input (K1: 1,008 columns padded to 1,024) does not fit beside the
// ring: it is produced in slices of 2W columns into T | H, which are free
// then, and the head accumulates over the slices. K1 encodes each slice by
// the double-angle ladder (r2l::pe_ladder, the plain version's values bit
// for bit), in the freq-major column order the host gave the head's rows;
// K9 reads each slice of x [n, in_dim] f32, the ragged last one padded with
// zeros.
//
// Epilogues run on the accumulator registers: bias, ReLU, the rounding,
// stored in the layout the next product reads (bf16: core matrices; f32:
// rows of W + 4 floats), the block tail reading h from H in the same pass.
// h0, the global residual, does not fit either: each warpgroup parks its
// tile in a device-memory scratch (the wrapper's, [blocks x rows x W] of
// the weight type) in the accumulator's own order, so every store and load
// is a whole warp's contiguous 128 or 256 bytes. The tail (W -> out_dim) is
// a dot product of the final h, formed in the last block's epilogue: each
// thread's partial sum over its columns, then two quad shuffles.
//
// K3 (kTrain) differs in three places. Its block output is (t * res_scale
// + h) from the unrounded t (train_fwd's rounding, r2l_train.py); f32
// sums each weight stage's products apart (ChainTrainF32); and what its
// epilogues round also goes to the stash [2nb+1, n, W] of the weight type
// (rows 0..nb the block inputs h_0..h_nb, row nb+1+b block b's inner
// activation), 3.65 GB (bf16) or 7.3 GB (f32) a step's call, straight from
// the registers with no barrier (kK3Stash). bf16 trades the pairs of four
// column groups within the quad (quad_transpose) so that each thread
// stores 16 bytes whole; f32 stores each thread's 8-byte pairs, as the
// buffers of the transpose would spill its registers. Measured on an H100
// (PERF.md): bf16 3.68 ms against 4.98 for pairs, 2.41 with no stores at
// all; bulk stores from the tiles after the barrier that hands them to the
// next product (tensor-map boxes of the core-matrix tiles; f32 row by row)
// measured 1.6 (bf16) and 0.6 ms (f32) slower than these.
#pragma once

#include "hopper_ring.cuh"
#include "r2l_common.cuh"

namespace r2lh {

using namespace hopper;

// The chain's shape by weight type: the ring's (as hopper::Kind: input
// channels and bytes of a row per stage, slots, consumer warpgroups, weight
// parts, A from registers) and kC, the blocks of a cluster.
template <typename T> struct Chain;
template <> struct Chain<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kKS = 64, kKSB = 128, kWGs = 2, kStages = 3;
  static constexpr int kParts = 1;
  static constexpr bool kRegA = false;
  static constexpr int kC = 2;
};
template <> struct Chain<float> {
  using Acc = float;
  static constexpr int kKS = 16, kKSB = 64, kWGs = 1, kStages = 3;
  static constexpr int kParts = 2;  // TF32 high, then low
  static constexpr bool kRegA = true;
  static constexpr int kC = 2;
};
// K3's f32 chain: K1's, each weight stage's 3xTF32 products summed apart
// and added to the running sum in f32 (hopper_ring.cuh, mm_rs): K3 f32 is
// held to true f32 at 1e-5 on every stash row, which the products summed
// by the tensor cores alone cross (PERF.md)
struct ChainTrainF32 : Chain<float> {
  static constexpr bool kSplit = true;
};
template <typename T, bool kTrain>
struct ChainFor {
  using type = Chain<T>;
};
template <>
struct ChainFor<float, true> {
  using type = ChainTrainF32;
};

// Everything a launch needs, passed by value (the kernel parameter space).
struct Args {
  const float* in;   // K1: pts [n, dp]; K9: x [n, in_dim]
  int n, dp, L, in_dim;
  int vec;           // K9: rows of whole, 16-byte aligned float4s
  const unsigned char* staged;  // the staged image (stage_chain_weights)
  const float* head_b;  // [W]
  const float* body_b;  // [nb * nl, W]
  const void* tail_w;   // [out_dim, W], the weight type
  const float* tail_b;  // [out_dim]
  float* out;           // [n, out_dim]
  void* h0;             // scratch, [blocks * rows * W] of the weight type
  void* stash;          // K3: [2nb+1, n, W] of the weight type
  int nb, nl, out_dim;
  float res_scale;
  int use_residual, linear_tail;
  // layout, set by plan()
  int kpad;    // the head's input width as staged (a multiple of 128)
  int off_t, off_ring, off_bar, slot_bytes, stages, smem;
};

// A tile row of W values: bytes (bf16, core matrices) or floats (f32, +4
// so that the A fragments' rows fall in different banks). A constant, so
// that every tile offset of an epilogue is one too.
template <typename T, int W>
__host__ __device__ constexpr int tile_ld() {
  return Chain<T>::kRegA ? W + 4 : W * (int)sizeof(T);
}

// Shared memory, in order: H, T (each [rows][ld]), the ring, its barriers.
template <typename T, int W>
inline void plan(Args& a) {
  using K = Chain<T>;
  const int rows = 64 * K::kWGs;
  const int tile = rows * tile_ld<T, W>() * (K::kRegA ? 4 : 1);
  a.kpad = r2l::round_up(a.in_dim, r2l::kKAlign);
  a.off_t = r2l::round_up(tile, 128);
  a.off_ring = a.off_t + r2l::round_up(tile, 128);
  a.slot_bytes = W * K::kKSB * K::kParts;
  a.off_bar = a.off_ring + K::kStages * a.slot_bytes;
  a.smem = a.off_bar + 2 * K::kStages * 8;
  a.stages = (a.kpad + a.nb * a.nl * W) / K::kKS;
}

// Blocks of a launch of n rays, padded to whole clusters.
template <typename T>
inline long long blocks_of(int n) {
  constexpr int rows = 64 * Chain<T>::kWGs, kC = Chain<T>::kC;
  const long long blocks = (n + rows - 1) / rows;
  return (blocks + kC - 1) / kC * kC;
}

// The scratch's pair type: two neighbouring values of the weight type.
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using P = __nv_bfloat162;
  __device__ static P make(float x0, float x1) {
    return __floats2bfloat162_rn(x0, x1);
  }
  __device__ static float2 get(P p) { return __bfloat1622float2(p); }
};
template <> struct Pair<float> {
  using P = float2;
  __device__ static P make(float x0, float x1) { return make_float2(x0, x1); }
  __device__ static float2 get(P p) { return p; }
};

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// A layer's epilogue over the warpgroup's accumulator: f(r, c, v[c],
// v[c + 1], (b[c], b[c + 1]), j, h) for the thread's two rows (h = 0, 1)
// and each of its column pairs (c = 8j + 2t), the bias of four column
// pairs loaded ahead of their use (each once, for both rows).
template <int W, typename F>
__device__ __forceinline__ void epilogue(float (&d)[W / 2], int wtid,
                                         const float* b, F f) {
  const int lane = wtid % 32;
  const int r0 = 16 * (wtid / 32) + lane / 4, t = lane % 4;
#pragma unroll
  for (int j0 = 0; j0 < W / 8; j0 += 4) {
    float2 bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bb[q] = ldg2(b + 8 * (j0 + q) + 2 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q, c = 8 * j + 2 * t;
      f(r0, c, d[4 * j], d[4 * j + 1], bb[q], j, 0);
      f(r0 + 8, c, d[4 * j + 2], d[4 * j + 3], bb[q], j, 1);
    }
  }
}

// K3's stash stores by weight type (PERF.md, design runs): after a
// transpose within the quad, 16 bytes a thread (kStashQuad: bf16), or each
// thread's column pairs (kStashPairs: f32, whose registers the quad's
// buffers would spill).
enum StashStore { kStashQuad, kStashPairs };
template <typename T>
constexpr StashStore kK3Stash = sizeof(T) == 2 ? kStashQuad : kStashPairs;

template <typename T, int W, bool kPE, bool kTrain>
__global__ void __launch_bounds__(kWG * (Chain<T>::kWGs + 1), 1)
    r2l_hopper_kernel(const Args a) {
  using K = typename ChainFor<T, kTrain>::type;
  using PT = Pair<T>;
  constexpr int kC = K::kC;
  constexpr int kU = K::kRegA ? 4 : 1;  // bytes per tile ld unit
  constexpr int kLd = tile_ld<T, W>();
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

  if (wg == K::kWGs) {  // the producer: every stage, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0)
      for (int it = 0; it < a.stages; ++it)
        fill<T, kC, K>(ring, it, a.staged + (size_t)it * a.slot_bytes,
                       a.slot_bytes, rank);
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // This warpgroup's rays and tiles.
  const int tile = blockIdx.x * K::kWGs + wg, row0 = tile * 64;
  const int bar_id = 1 + wg;
  unsigned char* Hm = smem + wg * 64 * kLd * kU;
  unsigned char* Tm = smem + a.off_t + wg * 64 * kLd * kU;
  typename PT::P* h0s =
      static_cast<typename PT::P*>(a.h0) + (size_t)tile * 64 * (W / 2);
  const T* tail_w = static_cast<const T*>(a.tail_w);
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;
  const bool res = a.use_residual;

  T* const stash = static_cast<T*>(a.stash);
  // make this warpgroup's tile writes visible to its next product
  auto tiles_ready = [&]() {
    if constexpr (!K::kRegA) fence_async_smem();
    wg_bar(bar_id);
  };
  // K3: (x0, x1) rounded to T into stash row `row` at (r, c), c even, from
  // the registers
  auto stash2 = [&](int row, int r, int c, float x0, float x1) {
    if constexpr (kTrain) {
      const int g = row0 + r;
      if (g < a.n)
        *reinterpret_cast<typename PT::P*>(
            stash + ((size_t)row * a.n + g) * W + c) = PT::make(x0, x1);
    }
  };
  // K3 from the registers: the pair (x0, x1) of column group j of the
  // thread's row h in stash row `row`; with kStashQuad held until the
  // group's fourth of four, then each lane stores one group whole (bf16
  // 16 bytes, f32 32), a warp 64 (128) bytes of each of 8 rows
  // [h][f32: x, y; bf16: the pair][j % 4]
  [[maybe_unused]] uint32_t sq[2][2][4];
  auto stash_pair = [&](int row, int j, int h, float x0, float x1) {
    if constexpr (kTrain) {
      const int g = row0 + r0 + 8 * h, tq = lane % 4;
      if constexpr (kK3Stash<T> == kStashPairs) {
        stash2(row, r0 + 8 * h, 8 * j + 2 * tq, x0, x1);
        return;
      }
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
        sq[h][0][j % 4] = *reinterpret_cast<const uint32_t*>(&v);
      } else {
        sq[h][0][j % 4] = __float_as_uint(x0);
        sq[h][1][j % 4] = __float_as_uint(x1);
      }
      if (j % 4 != 3) return;
      uint4* p = reinterpret_cast<uint4*>(
          stash + ((size_t)row * a.n + g) * W + 8 * (j - 3 + tq));
      quad_transpose(sq[h][0], tq);
      if constexpr (sizeof(T) == 2) {
        if (g < a.n) *p = make_uint4(sq[h][0][0], sq[h][0][1], sq[h][0][2],
                                     sq[h][0][3]);
      } else {
        quad_transpose(sq[h][1], tq);
        if (g < a.n) {
          p[0] = make_uint4(sq[h][0][0], sq[h][1][0], sq[h][0][1],
                            sq[h][1][1]);
          p[1] = make_uint4(sq[h][0][2], sq[h][1][2], sq[h][0][3],
                            sq[h][1][3]);
        }
      }
    }
  };
  // (r, c), (r, c + 1) of a tile, stored rounded to T / loaded
  auto put2 = [&](unsigned char* t, int r, int c, float x0, float x1) {
    if constexpr (K::kRegA)
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(t) + r * kLd +
                                 c) = make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(t + cm_off(r, 2 * c, kLd)) =
          __floats2bfloat162_rn(x0, x1);
  };
  auto get2 = [&](const unsigned char* t, int r, int c) -> float2 {
    if constexpr (K::kRegA)
      return *reinterpret_cast<const float2*>(
          reinterpret_cast<const float*>(t) + r * kLd + c);
    else
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          t + cm_off(r, 2 * c, kLd)));
  };
  // column c of the head's input slice, which lies in T | H
  auto slot_of = [&](int& c) -> unsigned char* {
    if (c < W) return Tm;
    c -= W;
    return Hm;
  };
  auto put = [&](int r, int c, float v) {
    unsigned char* t = slot_of(c);
    if constexpr (K::kRegA)
      reinterpret_cast<float*>(t)[r * kLd + c] = v;
    else
      *reinterpret_cast<__nv_bfloat16*>(t + cm_off(r, 2 * c, kLd)) =
          __float2bfloat16_rn(v);
  };
  auto put4 = [&](int r, int c, float4 v) {  // c a multiple of 4
    unsigned char* t = slot_of(c);
    if constexpr (K::kRegA) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(t) + r * kLd +
                                 c) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(t + cm_off(r, 2 * c, kLd)) = u;
    }
  };
  // the thread's h0 pair (c, c + 1) of its row h, in the accumulator's order
  auto h0_at = [&](int h, int c) -> typename PT::P& {
    return h0s[((c / 8) * 2 + h) * kWG + wtid];
  };
  // the block output (t * res_scale + h) in f32 from the rounded t (K3:
  // the unrounded t)
  auto block_out = [&](float v, float b, float h) {
    const float t = __fadd_rn(v, b);
    return __fadd_rn(__fmul_rn(kTrain ? t : rnd<T>(t), a.res_scale), h);
  };

  float acc[W / 2];
  int it = 0;  // this warpgroup's place in the ring

  // ---- the head, over slices of 2W input columns in T | H ----
  const int in_w = kPE ? a.dp * (2 * a.L + 1) : a.in_dim;
  for (int c0 = 0; c0 < a.kpad; c0 += 2 * W) {
    const int sw = min(2 * W, a.kpad - c0);
    if (c0 > 0) wg_bar(bar_id);  // every warp's product read the last slice
    if constexpr (kPE) {
      // freq-major: column p*dp + s is part p (sin octave p, cos octave
      // p - L, or the identity) of scalar s
      for (int e = wtid; e < 64 * a.dp; e += kWG) {
        const int r = e / a.dp, s = e - r * a.dp, g = row0 + r;
        const float v = g < a.n ? a.in[(size_t)g * a.dp + s] : 0.f;
        auto emit = [&](int p, float x) {
          const int c = p * a.dp + s - c0;
          if (c >= 0 && c < sw) put(r, c, x);
        };
        r2l::pe_ladder(v, a.L, [&](int j, float sn, float cs) {
          emit(j, sn);
          emit(a.L + j, cs);
        });
        emit(2 * a.L, v);
      }
      const int z0 = max(in_w - c0, 0), nz = sw - z0;  // the zero padding
      if (nz > 0)
        for (int e = wtid; e < 64 * nz; e += kWG) {
          const int r = e / nz;
          put(r, z0 + e - r * nz, 0.f);
        }
    } else {
      const int q = sw / 4;
      for (int e = wtid; e < 64 * q; e += kWG) {
        const int r = e / q, c = 4 * (e - r * q), col = c0 + c;
        const int g = row0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < a.n) {
          const float* src = a.in + (size_t)g * a.in_dim + col;
          if (a.vec) {
            if (col < a.in_dim)
              v = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            if (col < a.in_dim) v.x = __ldg(src);
            if (col + 1 < a.in_dim) v.y = __ldg(src + 1);
            if (col + 2 < a.in_dim) v.z = __ldg(src + 2);
            if (col + 3 < a.in_dim) v.w = __ldg(src + 3);
          }
        }
        put4(r, c, v);
      }
    }
    tiles_ready();
    product<T, W, kC, K>(acc, Tm, kLd, W, Hm, kLd, sw, ring, it, wtid,
                         c0 > 0);
  }

  // The tail on the final h: hval(h, r, c, v0, v1, first) gives the
  // thread's final (rounded) h at (r, c), (r, c + 1) from its accumulator
  // pair (first: in the first pass over the outputs); the outputs four at
  // a time.
  auto tail = [&](auto hval) {
    for (int o0 = 0; o0 < a.out_dim; o0 += 4) {
      float p[2][4] = {};
      visit<W>(acc, wtid, [&](int h, int r, int c, float v0, float v1) {
        const float2 x = hval(h, r, c, v0, v1, o0 == 0);
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          if (o0 + o >= a.out_dim) break;
          dot2(p[h][o], x.x, x.y, head2(tail_w + (size_t)(o0 + o) * W + c));
        }
      });
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          if (o0 + o >= a.out_dim) break;
          const float sum = quad_sum(p[h][o]);
          const int g = row0 + r0 + 8 * h;
          if (lane % 4 == 0 && g < a.n) {
            const float v = __fadd_rn(sum, a.tail_b[o0 + o]);
            a.out[(size_t)g * a.out_dim + o0 + o] =
                a.linear_tail ? v : r2l::sigmoid(v);
          }
        }
    }
  };

  if (a.nb == 0) {  // h = h0 (+ h0)
    tail([&](int, int r, int c, float v0, float v1, bool first) {
      const float2 b = ldg2(a.head_b + c);
      float x0 = rnd<T>(fmaxf(__fadd_rn(v0, b.x), 0.f));
      float x1 = rnd<T>(fmaxf(__fadd_rn(v1, b.y), 0.f));
      if (first) stash2(0, r, c, x0, x1);
      if (res) {
        x0 = rnd<T>(__fadd_rn(x0, x0));
        x1 = rnd<T>(__fadd_rn(x1, x1));
      }
      return make_float2(x0, x1);
    });
  } else {
    epilogue<W>(acc, wtid, a.head_b,
                [&](int r, int c, float v0, float v1, float2 b, int j,
                    int h) {
                  const float x0 = fmaxf(__fadd_rn(v0, b.x), 0.f);
                  const float x1 = fmaxf(__fadd_rn(v1, b.y), 0.f);
                  put2(Hm, r, c, x0, x1);
                  stash_pair(0, j, h, x0, x1);
                  if (res) h0_at((r >> 3) & 1, c) = PT::make(x0, x1);
                });
  }

  // ---- the body ----
  for (int blk = 0; blk < a.nb; ++blk) {
    for (int j = 0; j < a.nl; ++j) {
      unsigned char* src = j == 0 ? Hm : Tm;
      const float* b = a.body_b + (size_t)(blk * a.nl + j) * W;
      tiles_ready();
      product<T, W, kC, K>(acc, src, kLd, W, src, kLd, W, ring, it,
                           wtid);
      if (j + 1 < a.nl) {  // inner layer: ReLU, round, into T
        epilogue<W>(acc, wtid, b,
                    [&](int r, int c, float v0, float v1, float2 bb, int jj,
                        int h) {
                      const float x0 = fmaxf(__fadd_rn(v0, bb.x), 0.f);
                      const float x1 = fmaxf(__fadd_rn(v1, bb.y), 0.f);
                      put2(Tm, r, c, x0, x1);
                      stash_pair(a.nb + 1 + blk, jj, h, x0, x1);
                    });
      } else if (blk + 1 < a.nb) {  // block tail, in place into H
        epilogue<W>(acc, wtid, b,
                    [&](int r, int c, float v0, float v1, float2 bb, int jj,
                        int h) {
                      const float2 hv = get2(Hm, r, c);
                      const float x0 = block_out(v0, bb.x, hv.x);
                      const float x1 = block_out(v1, bb.y, hv.y);
                      put2(Hm, r, c, x0, x1);
                      stash_pair(blk + 1, jj, h, x0, x1);
                    });
      } else {  // the last block's tail, the global residual, the tail
        tail([&](int h, int r, int c, float v0, float v1, bool first) {
          const float2 bb = ldg2(b + c), hv = get2(Hm, r, c);
          float x0 = rnd<T>(block_out(v0, bb.x, hv.x));
          float x1 = rnd<T>(block_out(v1, bb.y, hv.y));
          if (first) stash2(a.nb, r, c, x0, x1);
          if (res) {
            const float2 z = PT::get(h0_at(h, c));
            x0 = rnd<T>(__fadd_rn(x0, z.x));
            x1 = rnd<T>(__fadd_rn(x1, z.y));
          }
          return make_float2(x0, x1);
        });
      }
    }
  }
  cluster_sync();
}

// Launch over the n rays' blocks, padded to whole clusters, after checking
// the shape and the scratch (h0_elems values of T; none without the global
// residual).
template <typename T, int W, bool kPE, bool kTrain>
cudaError_t launch_as(Args a, long long h0_elems, cudaStream_t stream) {
  plan<T, W>(a);
  using K = typename ChainFor<T, kTrain>::type;
  constexpr int rows = 64 * K::kWGs;
  const long long blocks = blocks_of<T>(a.n);
  if (a.use_residual && h0_elems < blocks * rows * W)
    return cudaErrorInvalidValue;
  return launch_cluster<T, K::kC, K>(r2l_hopper_kernel<T, W, kPE, kTrain>, a,
                                     (int)blocks, a.smem, stream);
}

template <bool kPE, bool kTrain = false>
cudaError_t launch(const Args& a, int W, int weight_is_f32,
                   long long h0_elems, cudaStream_t stream) {
  if (a.n <= 0 || a.in_dim <= 0 || a.nb < 0 || a.nl < 1 || a.out_dim < 1)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a.staged) & 15)
    return cudaErrorMisalignedAddress;
  if (weight_is_f32) {
    switch (W) {
      case 64: return launch_as<float, 64, kPE, kTrain>(a, h0_elems, stream);
      case 128: return launch_as<float, 128, kPE, kTrain>(a, h0_elems, stream);
      case 256: return launch_as<float, 256, kPE, kTrain>(a, h0_elems, stream);
    }
  } else {
    using BF = __nv_bfloat16;
    switch (W) {
      case 64: return launch_as<BF, 64, kPE, kTrain>(a, h0_elems, stream);
      case 128: return launch_as<BF, 128, kPE, kTrain>(a, h0_elems, stream);
      case 256: return launch_as<BF, 256, kPE, kTrain>(a, h0_elems, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace r2lh
