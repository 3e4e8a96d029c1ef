// Probe: K5 with both dL/dx products in int8, the dx half of the training
// backward at the int8 tensor-core rate.
//
// Replaces the Pallas TPU kernel exp/probe_bwd_qdx.py::bwd_group_qdx. For
// blocks b_start+cnt-1 .. b_start, top-down, per ray:
//   dt2  = (dh * res_scale).cast(bf16)
//   dW[2k+1] += dt2^T t1r,  db[2k+1] += sum dt2        (as K5)
//   dt1r = qdx(dh, 2k+1),   dt1 = (t1 > 0 ? dt1r : 0).cast(bf16)
//   dW[2k]   += dt1^T h_in, db[2k]   += sum dt1        (as K5)
//   dh   = dh + qdx(t1 > 0 ? dt1r : 0, 2k)
// on K4's int8 stash (h_in = (q * scale).cast(bf16), t1 = q * scale), where
// qdx(g, l) is layer l's input gradient from its output gradient g through
// the int8 weights q_l of the calibration:
//   u   = g * m_l               (m_l its per-column dequant multiplier,
//                                 res_scale folded into block tails)
//   s   = 127 / (max|u| + 1e-30), one scalar over a whole ray tile
//   u_q = clip(round_half_even(u * s), -127, 127)
//   qdx = (u_q @ q_l^T) * (scale_l / s)    (the per-column quotient first)
// and the add to dh is one fused multiply-add, as XLA on the CPU contracts
// dh + acc * c. The tile (512 rays in the probe) is a numerical parameter:
// another tile computes another function.
//
// Design: pass 1 is K5's dh walk over 64-ray blocks with the two dx
// products on EngineS8 (mma.sync m16n8k32 s8, exact s32 accumulation; the
// int8 weights transposed to [in][out], so that u_q q_l^T is the engine's
// A W^T). A ray tile is a thread-block cluster of tile/64 blocks (8 for 512
// rays, the portable limit) on neighbouring SMs. Each block reduces max|u|
// over its rays (warp shuffles, then its eight warps) into a slot of its
// shared memory; after a cluster barrier every thread reads the cluster's
// slots through distributed shared memory (map_shared_rank). Two slots used
// in turn make one barrier per quantization enough (a block rewrites a slot
// only after every block passed the barrier that follows the last read of
// it), plus one before exit. fc1's u is kept in registers, in the
// accumulator's layout, until its scale is known. Passes 2 and 3 (dW, db)
// are K5's (r2l_bwd_dw.cuh) on the bf16 scratch of dt2 and dt1, so the
// sums keep a fixed order and two runs are bit-identical.
//
// What bounds it: per layer 2*N*W^2 int8 operations (dx) and 2*N*W^2 bf16
// FLOP (dW); per 4-block call at 81,920 rays and W256 0.043 + 0.087 =
// 0.130 ms at the data sheet's 1,979 / 989 T/s. What this simple version
// leaves on the table: K5's (the dts round trip through device memory,
// mma.sync instead of wgmma), and four cluster barriers per block, each
// waiting for the slowest of eight SMs.
#include <cooperative_groups.h>

#include "r2l_bwd_dw.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace r2l;
using namespace r2l::bwd;

constexpr int kTT = 64;          // rays per block
constexpr int kMaxCluster = 8;   // blocks per ray tile (the portable limit)

template <int W>
using Engine = EngineS8<W, kTT, (W >= 128 ? 128 : 64)>;

// The largest of every thread's v (each >= 0) over the cluster. red
// [kWarps] and slot [2] lie in this block's shared memory; slot[buf]
// carries the block's largest to the others.
__device__ __forceinline__ float cluster_max(float v, float* red, float* slot,
                                             int buf,
                                             cg::cluster_group& cl) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = red[0];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
    slot[buf] = mx;
  }
  cl.sync();
  float mx = 0.f;
  for (unsigned r = 0; r < cl.num_blocks(); ++r)
    mx = fmaxf(mx, *cl.map_shared_rank(slot + buf, r));
  return mx;
}

// Pass 1: the dh walk over one block of 64 rays, one cluster per ray tile.
template <int W>
__global__ void __launch_bounds__(kThreads, 1) bwd_qdx_dh_kernel(
    const int8_t* __restrict__ q_t, const float* __restrict__ m,
    const int8_t* __restrict__ stash_t, const float* __restrict__ scale,
    const float* __restrict__ dh_in, float* __restrict__ dh_out,
    __nv_bfloat16* __restrict__ dts, float* __restrict__ dbp, int n, int cnt,
    float res_scale) {
  using E = Engine<W>;
  using M = typename E::M;
  using BF = __nv_bfloat16;
  constexpr int ldf = ld_words(W * 4);       // f32 elements per row
  constexpr int ldb = 2 * ld_words(W * 2);   // bf16 elements per row
  constexpr int ldq = 4 * ld_words(W);       // int8 elements per row
  extern __shared__ __align__(16) unsigned char smem[];
  float* DH = reinterpret_cast<float*>(smem);              // [kTT][ldf] dh
  BF* DT = reinterpret_cast<BF*>(DH + kTT * ldf);          // dt2 or dt1
  int8_t* U = reinterpret_cast<int8_t*>(DT + kTT * ldb);   // u_q
  uint32_t* Ws = reinterpret_cast<uint32_t*>(U + kTT * ldq);
  __shared__ float red[kWarps], slot[2], cq[W];
  cg::cluster_group cl = cg::this_cluster();
  const int row0 = blockIdx.x * kTT;   // n is a whole number of tiles
  const size_t row_stride = (size_t)n * W;
  int buf = 0;

  for (int e = threadIdx.x; e < kTT * W; e += kThreads) {
    const int r = e / W, c = e % W;
    DH[r * ldf + c] = dh_in[(size_t)(row0 + r) * W + c];
  }
  // DT is layer l's output grad: to the scratch, and its column sums (rays
  // in order) to this block's partial of db.
  auto emit = [&](int l) {
    __syncthreads();
    store_tile<BF, W, kTT>(dts + (size_t)l * row_stride, DT, ldb, row0, n);
    for (int c = threadIdx.x; c < W; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < kTT; ++r) s = __fadd_rn(s, ld<BF>(DT[r * ldb + c]));
      dbp[((size_t)blockIdx.x * 2 * cnt + l) * W + c] = s;
    }
  };
  // The tile's scale s from this thread's largest |u|, and layer l's
  // dequantize multipliers cq = scale_l / s (read after the next product,
  // whose barriers make them visible).
  auto quant_scale = [&](float mx, int l) {
    const float s =
        __fdiv_rn(127.f, __fadd_rn(cluster_max(mx, red, slot, buf, cl),
                                   1e-30f));
    buf ^= 1;
    for (int c = threadIdx.x; c < W; c += kThreads)
      cq[c] = __fdiv_rn(scale[(size_t)l * W + c], s);
    return s;
  };

  int acc[M::MT][M::NT][4];
  float uf[M::MT][M::NT][4];
  for (int k = cnt - 1; k >= 0; --k) {
    const int l2 = 2 * k + 1, l1 = 2 * k;
    const float* m2 = m + (size_t)l2 * W;
    const float* m1 = m + (size_t)l1 * W;
    // fc2: dt2 to the scratch; its dx quantizes u = dh * m2 (raw f32 dh).
    __syncthreads();  // DH is whole
    float mx = 0.f;
    for (int e = threadIdx.x; e < kTT * W; e += kThreads) {
      const int r = e / W, c = e % W;
      const float d = DH[r * ldf + c];
      DT[r * ldb + c] = __float2bfloat16_rn(__fmul_rn(d, res_scale));
      mx = fmaxf(mx, fabsf(__fmul_rn(d, m2[c])));
    }
    emit(l2);
    float s = quant_scale(mx, l2);
    for (int e = threadIdx.x; e < kTT * W; e += kThreads) {
      const int r = e / W, c = e % W;
      U[r * ldq + c] = q8(__fmul_rn(__fmul_rn(DH[r * ldf + c], m2[c]), s));
    }
    E::mm(acc, U, ldq, q_t + (size_t)l2 * W * W, W, Ws);
    // dt1r masked by the inner ReLU: dt1 to the scratch, and fc1's
    // u = dt1r * m1 kept in registers until its scale is known.
#pragma unroll
    for (int mt = 0; mt < M::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < M::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          uf[mt][nt][i] = __int2float_rn(acc[mt][nt][i]);
    const int8_t* tk = stash_t + (size_t)k * row_stride;
    const float* sc2 = scale + (size_t)l2 * W;
    mx = 0.f;
    M::visit(uf, [&](int r, int c, float& v) {
      const bool on =
          __fmul_rn((float)tk[(size_t)(row0 + r) * W + c], sc2[c]) > 0.f;
      const float g = on ? __fmul_rn(v, cq[c]) : 0.f;
      DT[r * ldb + c] = __float2bfloat16_rn(g);
      v = __fmul_rn(g, m1[c]);
      mx = fmaxf(mx, fabsf(v));
    });
    emit(l1);
    s = quant_scale(mx, l1);
    M::visit(uf, [&](int r, int c, float& v) {
      U[r * ldq + c] = q8(__fmul_rn(v, s));
    });
    E::mm(acc, U, ldq, q_t + (size_t)l1 * W * W, W, Ws);
    M::visit(acc, [&](int r, int c, int a) {
      float& d = DH[r * ldf + c];
      d = __fmaf_rn(__int2float_rn(a), cq[c], d);
    });
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTT * W; e += kThreads) {
    const int r = e / W, c = e % W;
    dh_out[(size_t)(row0 + r) * W + c] = DH[r * ldf + c];
  }
  cl.sync();  // no block leaves while another may still read its slots
}

template <int W>
cudaError_t launch(const int8_t* q_t, const float* m, const int8_t* stash_h,
                   const int8_t* stash_t, const float* scale,
                   const float* dh_in, float* dh_out, __nv_bfloat16* dts,
                   float* dbp, float* part, float* dw, float* db, int n,
                   int cnt, float res_scale, int tile, int splits,
                   cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)kTT * 4 * (ld_words(W * 4) + ld_words(W * 2) + ld_words(W)) +
      Engine<W>::kStageBytes;
  auto kern = bwd_qdx_dh_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = n / kTT;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = tile / kTT;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // A cluster that cannot be resident at this footprint would never run.
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg)) !=
      cudaSuccess)
    return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaLaunchKernelEx(&cfg, kern, q_t, m, stash_t, scale, dh_in,
                                dh_out, dts, dbp, n, cnt, res_scale)) !=
      cudaSuccess)
    return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return dw_passes<__nv_bfloat16, int8_t, W>(dts, stash_h, stash_t, scale,
                                             dbp, part, dw, db, n, cnt,
                                             splits, ntiles, stream);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// q_t: the group's 2cnt int8 weights, each transposed ([in][out]); m and
// scale: their [2cnt][W] dequant multipliers and 1/body_inv; stash_h and
// stash_t: the group's int8 stash rows of block inputs and inner
// activations, [cnt][n][W] each. n must be a whole number of tiles and the
// tile a multiple of 64 rays, at most 512. Scratch: dts [2cnt][n][W] bf16,
// dbp [n/64][2cnt][W] f32, part [splits][2cnt][W][W] f32. Returns a
// cudaError_t: a launch's own error, cudaErrorLaunchOutOfResources for a
// cluster that cannot be scheduled, or cudaErrorInvalidValue for a width or
// a shape the kernel does not take.
extern "C" int r2l_bwd_qdx_launch(
    const void* q_t, const float* m, const void* stash_h, const void* stash_t,
    const float* scale, const float* dh_in, float* dh_out, void* dts,
    float* dbp, float* part, float* dw, float* db, int n, int W, int cnt,
    float res_scale, int tile, int splits, void* stream) {
  if (n <= 0 || cnt < 1 || splits < 1 || tile < kTT || tile % kTT ||
      tile / kTT > kMaxCluster || n % tile || !m || !scale)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q_t) | reinterpret_cast<uintptr_t>(stash_h) |
       reinterpret_cast<uintptr_t>(stash_t) | reinterpret_cast<uintptr_t>(dts) |
       reinterpret_cast<uintptr_t>(part)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS                                                             \
  static_cast<const int8_t*>(q_t), m, static_cast<const int8_t*>(stash_h),   \
      static_cast<const int8_t*>(stash_t), scale, dh_in, dh_out,             \
      static_cast<__nv_bfloat16*>(dts), dbp, part, dw, db, n, cnt,           \
      res_scale, tile, splits, s
  switch (W) {
    case 64: return launch<64>(R2L_ARGS);
    case 128: return launch<128>(R2L_ARGS);
    case 256: return launch<256>(R2L_ARGS);
  }
#undef R2L_ARGS
  return cudaErrorInvalidValue;
}
