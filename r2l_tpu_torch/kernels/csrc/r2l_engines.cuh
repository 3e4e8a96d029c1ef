// The pre-Hopper bf16 engine, kept for one instrument only: the mma.sync
// rounding probe (probe_mma_sync.cu, probe_shapes.mma_rounding), which
// exists to read how mma.sync rounds its f32 sum. Every kernel of the port
// runs on wgmma (hopper_ring.cuh, hopper_wgmma.cuh).
//
//   EngineBF16<W, TT>  a tile of TT rays in shared memory (ray-major) times
//                      a bf16 weight matrix streamed from global memory,
//                      packed [out, in]: mma.sync m16n8k16 (f32
//                      accumulation) over an MmaMap tile, stages of kKC
//                      input channels copied by cp.async one ahead of the
//                      tensor-core work, by the whole block.
//
// mm() ends with a barrier after the last use of its A operand and of the
// staging buffer, so the caller may overwrite A right after it.
//
// Activations live in shared memory ray-major: row r of a [TT][ld] matrix
// holds ray r's channels. Row strides are chosen so that the eight rows one
// fragment load touches fall in different banks.
#pragma once

#include "r2l_common.cuh"

namespace r2l {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 64;     // input channels per weight stage

// Row stride, in 32-bit words, of a shared-memory matrix whose rows hold
// `bytes` bytes: rounded up to 8 words, plus 4 (so 8 rows at this stride
// start in 8 different 4-bank groups).
__host__ __device__ constexpr int ld_words(int bytes) {
  return (bytes + 31) / 32 * 8 + 4;
}

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

// The K loop of a block-wide product with W = global [N][K] ([out, in],
// row stride `row_bytes`) in `nstage` stages: stage st holds columns
// [st*S, (st+1)*S) of every row, S = kStageRowBytes bytes, n-major at `ldw`
// words per row, in one of two shared-memory buffers. Stage st+1 is copied
// (cp.async, by every thread of the block) while compute(st, stage) runs on
// stage st. Ends with a barrier after the last compute.
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
  // K a multiple of kKC), by the whole block. Ends with a barrier after the
  // last use of A and the stages.
  __device__ static void mm(Acc& acc, const T* A, int lda,
                            const T* __restrict__ Wg, int K, uint32_t* Ws) {
#pragma unroll
    for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc.v[mt][nt][u] = 0.f;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int n0 = M::n0(), lda32 = lda / 2;
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
        });
  }
};

}  // namespace r2l
