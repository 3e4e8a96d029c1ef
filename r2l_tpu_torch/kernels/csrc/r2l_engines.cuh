// The block-wide dot-product engines shared by the R2L kernels: a tile of
// TT rays in shared memory (ray-major) times a weight matrix streamed from
// global memory, packed [out, in], one slice of input channels per stage.
//
//   EngineF32<W, TT>   f32 weights, scalar FMAs over a TileMap tile;
//   EngineBF16<W, TT>  bf16 weights, mma.sync m16n8k16 (f32 accumulation)
//                      over an MmaMap tile, stages copied by cp.async one
//                      ahead of the tensor-core work;
//   EngineS8<W, TT, KC> int8 weights, mma.sync m16n8k32 s8 (exact s32
//                      accumulation), KC input channels per stage.
//
// Each mm() ends with a barrier after the last use of its A operand and of
// the staging buffer, so the caller may overwrite A right after it.
//
// Activations live in shared memory ray-major: row r of a [TT][ld] matrix
// holds ray r's channels. Row strides are chosen so that the eight rows one
// fragment load touches fall in different banks.
#pragma once

#include "r2l_common.cuh"

namespace r2l {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The kThreads threads that run one block-wide product together, and their
// barrier: the whole block. tid() is a thread's index in the team (it
// picks the thread's fragments); ctid() and kCopyThreads are the threads
// that copy the weight stages, which the barrier covers.
struct BlockTeam {
  static constexpr int kCopyThreads = kThreads;
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int ctid() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Row stride, in 32-bit words, of a shared-memory matrix whose rows hold
// `bytes` bytes: rounded up to 8 words, plus 4 (so 8 rows at this stride
// start in 8 different 4-bank groups).
__host__ __device__ constexpr int ld_words(int bytes) {
  return (bytes + 31) / 32 * 8 + 4;
}

// Scalar layout of one [TT rays x W channels] output tile: NX threads
// across the channels, each owning channels 4tx..4tx+3 and
// W/2+4tx..W/2+4tx+3, and NY threads across the rays, each owning RM
// consecutive rays. acc[i][j] is (row(i), col(j)).
template <int W, int TT>
struct TileMap {
  static constexpr int NX = W / 8;
  static constexpr int NY = kThreads / NX;
  static constexpr int RM = TT / NY;
  static_assert(W % 64 == 0 && W <= 256 && NX * NY == kThreads, "width");
  static_assert(RM >= 1 && RM * NY == TT, "ray tile");
  __device__ __forceinline__ static int tx() { return threadIdx.x % NX; }
  __device__ __forceinline__ static int row(int i) {
    return (threadIdx.x / NX) * RM + i;
  }
  __device__ __forceinline__ static int col(int j) {  // j in [0, 8)
    return (j < 4 ? 0 : W / 2) + 4 * tx() + (j & 3);
  }
};

// Tensor-core layout of one [TT rays x W channels] output tile: warp w owns
// channels [w*W/8, (w+1)*W/8) of every ray, as MT x NT m16n8 accumulator
// tiles. acc[mt][nt][0..3] holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// of its tile, for g = lane/4, t = lane%4 (the mma.sync C fragment).
template <int W, int TT>
struct MmaMap {
  static constexpr int MT = TT / 16;
  static constexpr int NT = W / (8 * kWarps);
  static_assert(TT % 16 == 0 && NT >= 1 && NT * 8 * kWarps == W, "tile");
  template <typename Team = BlockTeam>
  __device__ __forceinline__ static int n0(Team team = Team()) {
    return (team.tid() / 32) * (W / kWarps);
  }
  template <typename Acc, typename F, typename Team = BlockTeam>
  __device__ __forceinline__ static void visit(Acc (&acc)[MT][NT][4], F f,
                                               Team team = Team()) {
    const int lane = team.tid() % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = mt * 16 + g, c = n0(team) + nt * 8 + 2 * t;
        f(r, c, acc[mt][nt][0]);
        f(r, c + 1, acc[mt][nt][1]);
        f(r + 8, c, acc[mt][nt][2]);
        f(r + 8, c + 1, acc[mt][nt][3]);
      }
  }
};

// D = A B + D for a 16x16 bf16 A (row), 16x8 bf16 B (col), f32 D.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A B + D for a 16x32 s8 A (row), 32x8 s8 B (col), s32 D (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ldg32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The K loop of a block-wide product with W = global [N][K] ([out, in],
// row stride `row_bytes`) in `nstage` stages: stage st holds columns
// [st*S, (st+1)*S) of every row, S = kStageRowBytes bytes, n-major at `ldw`
// words per row, in one of two shared-memory buffers. Stage st+1 is copied
// (cp.async, by the team's copying threads) while compute(st, stage) runs
// on stage st, by the threads of `team`. Ends with a team barrier after the
// last compute. (Prefetching the
// next product's first stage as well measured slower in both kernels:
// PERF.md.)
template <int N, int kStageRowBytes, int ldw, typename Compute,
          typename Team = BlockTeam>
__device__ __forceinline__ void pipelined_k_loop(const void* Wg,
                                                 size_t row_bytes,
                                                 int nstage, uint32_t* Ws,
                                                 Compute compute,
                                                 Team team = Team()) {
  constexpr int kPieces = kStageRowBytes / 16;
  const unsigned char* src = static_cast<const unsigned char*>(Wg);
  auto issue = [&](int st) {
    uint32_t* buf = Ws + (st & 1) * N * ldw;
    for (int e = team.ctid(); e < N * kPieces; e += Team::kCopyThreads) {
      const int n = e / kPieces, p = e % kPieces;
      cp_async16(buf + n * ldw + 4 * p,
                 src + n * row_bytes + (size_t)st * kStageRowBytes + 16 * p);
    }
    cp_async_commit();
  };
  issue(0);
  for (int st = 0; st < nstage; ++st) {
    if (st + 1 < nstage)
      issue(st + 1);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait_prior();
    team.sync();
    compute(st, Ws + (st & 1) * N * ldw);
    team.sync();
  }
}

// Copy a ray tile [TT][ld] of T from shared memory to rows row0.. of a
// global ray-major [n][W] matrix (16 bytes per thread and step, neighbouring
// threads on neighbouring addresses); rays at or past n are skipped. The
// global rows and the shared rows must start 16-byte aligned.
template <typename T, int W, int TT>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const T* src,
                                           int ld, int row0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  static_assert(W % kVec == 0, "row of whole 16-byte pieces");
  for (int e = threadIdx.x; e < TT * kPerRow; e += kThreads) {
    const int r = e / kPerRow, v = e - r * kPerRow;
    if (row0 + r < n)
      reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * W)[v] =
          reinterpret_cast<const uint4*>(src + r * ld)[v];
  }
}


constexpr int kKC = 64;     // input channels per weight stage (bf16)
constexpr int kKC32 = 32;  // input channels per weight step (f32)

template <typename T> __device__ __forceinline__ float ld(T v);
template <> __device__ __forceinline__ float ld<float>(float v) { return v; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
// Round to T and back: the cast to the compute dtype.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return ld<T>(st<T>(v));
}

// f32 weights: scalar FMAs over a TileMap tile; each step's weight rows are
// transposed into shared memory k-major, [kKC32][W], synchronously.
template <int W, int TT>
struct EngineF32 {
  using T = float;
  using M = TileMap<W, TT>;
  struct Acc { float v[M::RM][8]; };
  static constexpr size_t kStageBytes = (size_t)kKC32 * W * 4;

  // acc = A W^T for A = smem [TT][lda] and W = global [W][K] ([out, in],
  // K a multiple of kKC32). Ends with a barrier after the last use of A and
  // the staging buffer.
  __device__ static void mm(Acc& acc, const float* A, int lda,
                            const float* __restrict__ Wg, int K,
                            uint32_t* Ws_) {
    float* Ws = reinterpret_cast<float*>(Ws_);
#pragma unroll
    for (int i = 0; i < M::RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.f;
    const int r0 = M::row(0), c0 = 4 * M::tx();
    for (int k0 = 0; k0 < K; k0 += kKC32) {
      for (int e = threadIdx.x; e < W * kKC32 / 4; e += kThreads) {
        const int n = e % W, kq = e / W;
        const float4 v = __ldg(
            reinterpret_cast<const float4*>(Wg + (size_t)n * K + k0) + kq);
        Ws[(4 * kq) * W + n] = v.x;
        Ws[(4 * kq + 1) * W + n] = v.y;
        Ws[(4 * kq + 2) * W + n] = v.z;
        Ws[(4 * kq + 3) * W + n] = v.w;
      }
      __syncthreads();
      for (int kk = 0; kk < kKC32; ++kk) {
        float a[M::RM];
#pragma unroll
        for (int i = 0; i < M::RM; ++i) a[i] = A[(r0 + i) * lda + k0 + kk];
        const float4 wl = *reinterpret_cast<const float4*>(Ws + kk * W + c0);
        const float4 wh =
            *reinterpret_cast<const float4*>(Ws + kk * W + W / 2 + c0);
        const float w[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
        for (int i = 0; i < M::RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc.v[i][j] = fmaf(a[i], w[j], acc.v[i][j]);
      }
      __syncthreads();
    }
  }

  template <typename F>
  __device__ __forceinline__ static void visit(Acc& acc, F f) {
#pragma unroll
    for (int i = 0; i < M::RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) f(M::row(i), M::col(j), acc.v[i][j]);
  }
};

// bf16 weights: tensor cores (mma.sync m16n8k16, f32 accumulation) over an
// MmaMap tile. The packed [out, in] rows give n-major stages directly
// (pairs of k per word), so each B fragment register is one 32-bit
// shared-memory load, and a stage is a plain cp.async copy.
template <int W, int TT>
struct EngineBF16 {
  using T = __nv_bfloat16;
  using M = MmaMap<W, TT>;
  struct Acc { float v[M::MT][M::NT][4]; };
  static constexpr int kLdw = ld_words(kKC * 2);
  static constexpr size_t kStageBytes = 2 * (size_t)W * kLdw * 4;

  // acc = A W^T for A = smem [TT][lda] and W = global [W][K] ([out, in],
  // K a multiple of kKC), by the threads of `team` (the whole block by
  // default). Ends with a team barrier after the last use of A and the
  // stages.
  template <typename Team = BlockTeam>
  __device__ static void mm(Acc& acc, const T* A, int lda,
                            const T* __restrict__ Wg, int K, uint32_t* Ws,
                            Team team = Team()) {
#pragma unroll
    for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc.v[mt][nt][u] = 0.f;
    const int lane = team.tid() % 32, g = lane / 4, t = lane % 4;
    const int n0 = M::n0(team), lda32 = lda / 2;
    const uint32_t* A32 = reinterpret_cast<const uint32_t*>(A);
    pipelined_k_loop<W, kKC * 2, kLdw>(
        Wg, (size_t)K * 2, K / kKC, Ws, [&](int st, const uint32_t* buf) {
#pragma unroll
          for (int s = 0; s < kKC / 16; ++s) {
            uint32_t a[M::MT][4];
#pragma unroll
            for (int mt = 0; mt < M::MT; ++mt) {
              const uint32_t* ap =
                  A32 + (mt * 16 + g) * lda32 + st * (kKC / 2) + 8 * s + t;
              a[mt][0] = ap[0];
              a[mt][1] = ap[8 * lda32];
              a[mt][2] = ap[4];
              a[mt][3] = ap[8 * lda32 + 4];
            }
#pragma unroll
            for (int nt = 0; nt < M::NT; ++nt) {
              const uint32_t* bp = buf + (n0 + nt * 8 + g) * kLdw + 8 * s + t;
              const uint32_t b0 = bp[0], b1 = bp[4];
#pragma unroll
              for (int mt = 0; mt < M::MT; ++mt)
                mma_bf16(acc.v[mt][nt], a[mt], b0, b1);
            }
          }
        },
        team);
  }

  template <typename F, typename Team = BlockTeam>
  __device__ __forceinline__ static void visit(Acc& acc, F f,
                                               Team team = Team()) {
    M::visit(acc.v, f, team);
  }
};

template <int W, int TT, int KC>
struct EngineS8 {
  using M = MmaMap<W, TT>;
  // input channels per weight stage; divides the padded head
  static constexpr int kKC = KC;
  static constexpr int kLdw = ld_words(kKC);
  static constexpr size_t kStageBytes = 2 * (size_t)W * kLdw * 4;

  // acc = A W^T for A = smem int8 [TT][lda] and W = global int8 [W][K]
  // ([out, in], K a multiple of kKC): the packed rows give n-major stages
  // directly (4 k-values per word), copied by cp.async one stage ahead, by
  // the threads of `team` (the whole block by default). Ends with a team
  // barrier after the last use of A and the stages.
  template <typename Team = BlockTeam>
  __device__ static void mm(int (&acc)[M::MT][M::NT][4], const int8_t* A,
                            int lda, const int8_t* __restrict__ Wg, int K,
                            uint32_t* Ws, Team team = Team()) {
#pragma unroll
    for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mt][nt][u] = 0;
    const int lane = team.tid() % 32, g = lane / 4, t = lane % 4;
    const int n0 = M::n0(team), lda32 = lda / 4;
    const uint32_t* A32 = reinterpret_cast<const uint32_t*>(A);
    pipelined_k_loop<W, kKC, kLdw>(
        Wg, (size_t)K, K / kKC, Ws, [&](int st, const uint32_t* buf) {
#pragma unroll
          for (int s = 0; s < kKC / 32; ++s) {
            uint32_t a[M::MT][4];
#pragma unroll
            for (int mt = 0; mt < M::MT; ++mt) {
              const uint32_t* ap =
                  A32 + (mt * 16 + g) * lda32 + st * (kKC / 4) + 8 * s + t;
              a[mt][0] = ap[0];
              a[mt][1] = ap[8 * lda32];
              a[mt][2] = ap[4];
              a[mt][3] = ap[8 * lda32 + 4];
            }
#pragma unroll
            for (int nt = 0; nt < M::NT; ++nt) {
              const uint32_t* bp = buf + (n0 + nt * 8 + g) * kLdw + 8 * s + t;
              const uint32_t b0 = bp[0], b1 = bp[4];
#pragma unroll
              for (int mt = 0; mt < M::MT; ++mt)
                mma_s8(acc[mt][nt], a[mt], b0, b1);
            }
          }
        },
        team);
  }
};

}  // namespace r2l
