// The dW and db passes of the R2L training backward, shared by K5
// (r2l_bwd_group.cu) and its int8-dL/dx probe (r2l_bwd_qdx.cu): both write
// each layer's output gradient (dt2 and dt1) to a scratch [2cnt][n][W] in
// the compute dtype and each ray tile's column sums of it to a per-tile
// partial of db in pass 1, then
//   pass 2: dW[l] = G_l^T A_l over all rays (G_l the layer's output grad
//     from the scratch, A_l its input from the stash), one block per
//     128x128 tile of dW (64x64 for f32 weights or a width below 128) and
//     per range of rays ("split"), rays in order within a range, on
//     mma.sync m16n8k16 fed by ldmatrix.trans from ray-major cp.async
//     stages (bf16) or on scalar FMAs (f32);
//   pass 3: the splits' partials of dW and the tiles' partials of db, each
//     summed in a fixed order.
// So two runs of the same inputs give bit-identical dW and db.
#pragma once

#include "r2l_engines.cuh"

namespace r2l {
namespace bwd {

// Pass 2: one block per BM (out) x BN (in) tile of dW[l] and per ray range.
template <int BM, int BN>
struct DwTile {
  int o0, i0, l, r_begin, r_end;
  __device__ DwTile(int W, int cnt, int n, int rays_per_split) {
    int b = blockIdx.x;
    const int it = b % (W / BN);
    b /= W / BN;
    const int ot = b % (W / BM);
    b /= W / BM;
    l = b % (2 * cnt);
    const int sp = b / (2 * cnt);
    o0 = ot * BM;
    i0 = it * BN;
    r_begin = sp * rays_per_split;
    r_end = min(n, r_begin + rays_per_split);
  }
};

// Four 8x8 b16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l/8, row l%8, and receives (row 2(l%4), col l/4)
// and (row 2(l%4)+1, col l/4) of each matrix.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Pass 2, bf16: dW[l] tile = G^T A over the block's rays, 32 rays per
// stage. Both operands are staged ray-major, as they lie in device memory
// (rows of BM bf16, padded by 16 bytes so that the 8 rows one ldmatrix
// reads fall in different banks), G by cp.async and A by cp.async too, or
// for the int8 stash through registers, dequantized (q * scale cast to
// bf16); the next stage is in flight while the tensor cores work on this
// one. ldmatrix.trans turns the ray-major tiles into mma.sync m16n8k16
// fragments (G^T as the row-major A operand, A as the column-major B).
// 8 warps as 2 (out) x 4 (in), each BM/2 x BN/4.
constexpr int kKR = 32;

template <typename S, int BM>
__global__ void __launch_bounds__(kThreads, 2) bwd_dw_bf16_kernel(
    const __nv_bfloat16* __restrict__ dts, const S* __restrict__ stash_h,
    const S* __restrict__ stash_t, const float* __restrict__ scale,
    float* __restrict__ part, int n, int W, int cnt, int rays_per_split) {
  constexpr int BN = BM;
  constexpr bool kQ = sizeof(S) == 1;
  constexpr int kRowB = BM * 2 + 16;              // bytes per staged ray
  constexpr int MT = BM / 2 / 16, NT = BN / 4 / 8;
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  __shared__ __align__(128) unsigned char Gs[2][kKR * kRowB];
  __shared__ __align__(128) unsigned char As[2][kKR * kRowB];
  const DwTile<BM, BN> tile(W, cnt, n, rays_per_split);
  const size_t rs = (size_t)n * W;
  const __nv_bfloat16* G = dts + (size_t)tile.l * rs;
  const S* A = ((tile.l & 1) ? stash_t : stash_h) + (size_t)(tile.l >> 1) * rs;
  const float* sc = kQ ? scale + (size_t)tile.l * W + tile.i0 : nullptr;
  const int tid = threadIdx.x;
  const int nst = tile.r_end > tile.r_begin
                      ? (tile.r_end - tile.r_begin + kKR - 1) / kKR : 0;

  // cp.async of one ray-major bf16 stage: rows of `cols` channels from
  // column c0 of a [n][W] matrix; rays past the range are zero.
  auto issue_rows = [&](unsigned char* dst, const __nv_bfloat16* src, int c0,
                        int rb) {
    constexpr int kPieces = BM / 8;  // 16-byte pieces per row
    for (int e = tid; e < kKR * kPieces; e += kThreads) {
      const int r = e / kPieces, p = e % kPieces;
      unsigned char* d = dst + r * kRowB + 16 * p;
      if (rb + r < tile.r_end)
        cp_async16(d, src + (size_t)(rb + r) * W + c0 + 8 * p);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  };
  // int8 A through registers: 16 q-values per thread and stage.
  constexpr int kQPieces = BN / 16;
  const int qr = tid / kQPieces, qv = tid % kQPieces;
  const bool q_loader = kQ && tid < kKR * kQPieces;
  uint4 qreg = make_uint4(0, 0, 0, 0);
  auto issue = [&](int stg, int buf) {
    const int rb = tile.r_begin + stg * kKR;
    issue_rows(Gs[buf], G, tile.o0, rb);
    if constexpr (kQ) {
      if (q_loader && rb + qr < tile.r_end)
        qreg = __ldg(reinterpret_cast<const uint4*>(
            A + (size_t)(rb + qr) * W + tile.i0 + 16 * qv));
      else
        qreg = make_uint4(0, 0, 0, 0);
    } else {
      issue_rows(As[buf], reinterpret_cast<const __nv_bfloat16*>(A),
                 tile.i0, rb);
    }
    cp_async_commit();
  };
  auto store_q = [&](int buf) {
    if (!q_loader) return;
    const int8_t* q = reinterpret_cast<const int8_t*>(&qreg);
    __nv_bfloat16 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = __float2bfloat16_rn(__fmul_rn((float)q[j], sc[16 * qv + j]));
    uint4* d = reinterpret_cast<uint4*>(As[buf] + qr * kRowB + 32 * qv);
    d[0] = *reinterpret_cast<const uint4*>(&v[0]);
    d[1] = *reinterpret_cast<const uint4*>(&v[8]);
  };

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int j = lane / 8, q = lane % 8;
  const int wm = warp / 4, wn = warp % 4;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mt][nt][u] = 0.f;

  if (nst > 0) {
    issue(0, 0);
    if constexpr (kQ) store_q(0);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int stg = 0; stg < nst; ++stg) {
    const int buf = stg & 1;
    if (stg + 1 < nst) issue(stg + 1, buf ^ 1);
#pragma unroll
    for (int s = 0; s < kKR / 16; ++s) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)   // (o, ray) tiles: G^T
        ldsm_x4_trans(a[mt], Gs[buf] + (16 * s + q + 8 * (j / 2)) * kRowB +
                                 2 * (wm * (BM / 2) + mt * 16 + 8 * (j % 2)));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {  // (ray, i) tiles, two n-tiles
        uint32_t b[4];
        ldsm_x4_trans(b, As[buf] + (16 * s + q + 8 * (j % 2)) * kRowB +
                             2 * (wn * (BN / 4) + np * 16 + 8 * (j / 2)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if constexpr (kQ) {
      if (stg + 1 < nst) store_q(buf ^ 1);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const int sp = tile.r_begin / rays_per_split;
  float* out = part + ((size_t)sp * 2 * cnt + tile.l) * W * W;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o = tile.o0 + wm * (BM / 2) + mt * 16 + g;
      const int i = tile.i0 + wn * (BN / 4) + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (size_t)o * W + i) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (size_t)(o + 8) * W + i) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// Pass 2, f32: scalar FMAs over a 64 x 64 tile, 16 rays per stage staged
// ray-major; each thread owns 4 out x 4 in entries. A bf16 stash (S) is
// widened to f32 as it is staged.
constexpr int kKR32 = 16;

template <typename S>
__device__ __forceinline__ float4 load4(const S* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename S>
__global__ void __launch_bounds__(kThreads) bwd_dw_f32_kernel(
    const float* __restrict__ dts, const S* __restrict__ stash_h,
    const S* __restrict__ stash_t, float* __restrict__ part, int n, int W,
    int cnt, int rays_per_split) {
  __shared__ __align__(16) float Gs[kKR32][64];
  __shared__ __align__(16) float As[kKR32][64];
  const DwTile<64, 64> tile(W, cnt, n, rays_per_split);
  const size_t rs = (size_t)n * W;
  const float* G = dts + (size_t)tile.l * rs;
  const S* A = ((tile.l & 1) ? stash_t : stash_h) + (size_t)(tile.l >> 1) * rs;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lr = tid / 16, lv = tid % 16;  // loader: ray lr, channels 4lv..
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int rb = tile.r_begin; rb < tile.r_end; rb += kKR32) {
    const bool ok = rb + lr < tile.r_end;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&Gs[lr][4 * lv]) =
        ok ? __ldg(reinterpret_cast<const float4*>(
                 G + (size_t)(rb + lr) * W + tile.o0 + 4 * lv))
           : z;
    *reinterpret_cast<float4*>(&As[lr][4 * lv]) =
        ok ? load4<S>(A + (size_t)(rb + lr) * W + tile.i0 + 4 * lv) : z;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKR32; ++k) {
      const float4 gv = *reinterpret_cast<const float4*>(&Gs[k][4 * ty]);
      const float4 av = *reinterpret_cast<const float4*>(&As[k][4 * tx]);
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
      const float aa[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(gg[a], aa[b], acc[a][b]);
    }
    __syncthreads();
  }
  const int sp = tile.r_begin / rays_per_split;
  float* out = part + ((size_t)sp * 2 * cnt + tile.l) * W * W;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(out + (size_t)(tile.o0 + 4 * ty + a) * W +
                               tile.i0 + 4 * tx) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
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
  const int grid = (int)((m + kThreads - 1) / kThreads);
  sum_parts_kernel<<<grid, kThreads, 0, stream>>>(in, out, parts, m);
  return cudaGetLastError();
}

// Passes 2 and 3 after a pass 1 that wrote the scratch `dts` ([2cnt][n][W]
// in T) and `ntiles` per-tile partials of db (`dbp`): dW [2cnt][W][W] and
// db [2cnt][W] through the partials `part` ([splits][2cnt][W][W]).
template <typename T, typename S, int W>
cudaError_t dw_passes(const void* dts, const void* stash_h,
                      const void* stash_t, const float* scale,
                      const float* dbp, float* part, float* dw, float* db,
                      int n, int cnt, int splits, int ntiles,
                      cudaStream_t stream) {
  const int rays_per_split = (n + splits - 1) / splits;
  if constexpr (sizeof(T) == 4) {
    const int grid = (W / 64) * (W / 64) * 2 * cnt * splits;
    bwd_dw_f32_kernel<S><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(dts), static_cast<const S*>(stash_h),
        static_cast<const S*>(stash_t), part, n, W, cnt, rays_per_split);
  } else {
    constexpr int BM = W % 128 == 0 ? 128 : 64;
    const int grid = (W / BM) * (W / BM) * 2 * cnt * splits;
    bwd_dw_bf16_kernel<S, BM><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(dts),
        static_cast<const S*>(stash_h), static_cast<const S*>(stash_t), scale,
        part, n, W, cnt, rays_per_split);
  }
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_parts(part, dw, splits, (size_t)2 * cnt * W * W, stream)) !=
      cudaSuccess)
    return err;
  return sum_parts(dbp, db, ntiles, (size_t)2 * cnt * W, stream);
}

}  // namespace bwd
}  // namespace r2l
