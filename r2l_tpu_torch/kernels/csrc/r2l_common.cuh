// Pieces shared by the R2L kernels (r2l_pe_fused.cu, r2l_fused.cu,
// r2l_int8_pe_fused.cu, r2l_train_fwd.cu, r2l_train_fwd_int8.cu,
// r2l_bwd_group.cu, r2l_bwd_qdx.cu): shared-memory
// row strides, the two thread layouts over an output tile, the tensor-core
// instructions, the positional-encoding ladder, the int8 epilogue and the
// coalesced tile store.
//
// Activations live in shared memory ray-major: row r of a [TT][ld] matrix
// holds ray r's channels. Row strides are chosen so that the eight rows one
// fragment load touches fall in different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace r2l {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The kThreads threads that run one block-wide product together, and their
// barrier: the whole block by default. tid() is a thread's index in the
// team (it picks the thread's fragments); ctid() and kCopyThreads are the
// threads that copy the weight stages, which the barrier covers. A kernel
// that runs several teams per block passes its own type with the same
// members: probe_chain.cu's warp groups, each with its own stages and a
// named barrier; StreamTeam below, whose teams share the block's stages.
struct BlockTeam {
  static constexpr int kCopyThreads = kThreads;
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int ctid() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// One of S teams of kThreads threads in a block of S * kThreads, each
// running its own rows through the same products: the whole block copies
// each weight stage once and steps the stages together (one block barrier),
// so the S teams' tensor-core work and epilogues interleave in the SM.
template <int S>
struct StreamTeam {
  static constexpr int kCopyThreads = S * kThreads;
  __device__ __forceinline__ int tid() const { return threadIdx.x % kThreads; }
  __device__ __forceinline__ int ctid() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Row stride, in 32-bit words, of a shared-memory matrix whose rows hold
// `bytes` bytes: rounded up to 8 words, plus 4 (so 8 rows at this stride
// start in 8 different 4-bank groups).
__host__ __device__ constexpr int ld_words(int bytes) {
  return (bytes + 31) / 32 * 8 + 4;
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
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

// The packed weights' input axis is padded to a multiple of this (the
// Python side's K_ALIGN), so every staged slice of a row is whole 16-byte
// pieces.
constexpr int kKAlign = 128;

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// sin/cos of p * 2^j for j in [0, L) by the double-angle recurrence
// (r2l_pallas.py::_pe_sin_cos_ladder): sin 2x = (2 sin x) cos x,
// cos 2x = 1 - (2 sin x) sin x, every product rounded on its own (no FMA
// contraction), so the result matches the plain PyTorch version bit for
// bit. emit(j, sin, cos) receives each octave.
template <typename Emit>
__device__ __forceinline__ void pe_ladder(float p, int L, Emit emit) {
  float s = sinf(p), c = cosf(p);
  emit(0, s, c);
  for (int j = 1; j < L; ++j) {
    const float s2 = __fmul_rn(2.0f, s);
    const float ns = __fmul_rn(s2, c);
    c = __fsub_rn(1.0f, __fmul_rn(s2, s));
    s = ns;
    emit(j, s, c);
  }
}

// The plain versions' sigmoid: 1 / (1 + exp(-x)) in f32.
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// round-half-even, clip to [-127, 127] (jnp.clip(jnp.round(y), -127, 127))
__device__ __forceinline__ int8_t q8(float y) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}

// int8 dequantize acc * m + b as one fused multiply-add, rounded once (as
// XLA contracts it, and as the plain versions compute it in float64).
__device__ __forceinline__ float dequant(int acc, float m, float b) {
  return __fmaf_rn(__int2float_rn(acc), m, b);
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

}  // namespace r2l
