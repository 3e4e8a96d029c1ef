// Pieces shared by the two PE-fused R2L kernels (r2l_pe_fused.cu,
// r2l_int8_pe_fused.cu): shared-memory row strides, the two thread layouts
// over an output tile, the tensor-core instructions and the
// positional-encoding ladder.
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
  __device__ __forceinline__ static int n0() {
    return (threadIdx.x / 32) * (W / kWarps);
  }
  template <typename Acc, typename F>
  __device__ __forceinline__ static void visit(Acc (&acc)[MT][NT][4], F f) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = mt * 16 + g, c = n0() + nt * 8 + 2 * t;
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
// (cp.async) while compute(st, stage) runs on stage st. Ends with a barrier
// after the last compute. (Prefetching the next product's first stage as
// well measured slower in both kernels: PERF.md.)
template <int N, int kStageRowBytes, int ldw, typename Compute>
__device__ __forceinline__ void pipelined_k_loop(const void* Wg,
                                                 size_t row_bytes,
                                                 int nstage, uint32_t* Ws,
                                                 Compute compute) {
  constexpr int kPieces = kStageRowBytes / 16;
  const unsigned char* src = static_cast<const unsigned char*>(Wg);
  auto issue = [&](int st) {
    uint32_t* buf = Ws + (st & 1) * N * ldw;
    for (int e = threadIdx.x; e < N * kPieces; e += kThreads) {
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
    __syncthreads();
    compute(st, Ws + (st & 1) * N * ldw);
    __syncthreads();
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

}  // namespace r2l
