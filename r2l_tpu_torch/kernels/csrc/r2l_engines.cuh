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
#pragma once

#include "r2l_common.cuh"

namespace r2l {

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
