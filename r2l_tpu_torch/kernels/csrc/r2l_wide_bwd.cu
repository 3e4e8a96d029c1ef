// The wide form of K5: the R2L training backward through a group of ResMLP
// blocks for every student the chain kernels (r2l_bwd_hopper.cuh: W 64, 128
// and 256) do not hold, at any multiple of kWideChannels, with bf16 or f32
// weights and a stash in the weights' type, K8's bf16 stash under f32
// weights, or K4's int8 stash (body_scale).
//
// Replaces, at those widths, the Pallas TPU kernel r2l_tpu/kernels/
// r2l_train_pallas.py::bwd_group (:356). For blocks b_start+cnt-1 ..
// b_start, top-down, per ray (r2l_train.py, bwd_group_ref):
//   dt2 = (dh * res_scale).cast(cd)
//   dt1 = (t1 > 0 ? dt2 W2^T : 0).cast(cd)
//   dh += dt1 W1^T                                        (f32)
//   dW[2k+1] = dt2^T t1r, db[2k+1] = sum dt2; dW[2k] = dt1^T h_in, db[2k] =
//   sum dt1                                               (over all rays)
// With the int8 stash, h_in = (q * scale).cast(cd) and t1 = q * scale.
//
// Design. The dh walk runs on the pass skeleton of wide_hopper.cuh (wgmma
// fed by TMA, a producer warpgroup, two-block clusters sharing the weights'
// stages) against each layer's weights [in, out] row-major, the
// skeleton's B [N, K] for dt W^T (r2l_train.py, stage_bwd_weights, staged
// once per step; f32 as TF32 high and low parts), two passes a block with
// epilogues of their own: Mask, dt1 = (t1 > 0 ? dt2 W2^T : 0) rounded, the
// mask read from the stash at (ray, channel) in its own type; Dh, dh_out =
// dh_in + dt1 W1^T in f32 written by the epilogue itself, and the next
// block's dt2 = dh * res_scale rounded (the last block stores no dt2). Every
// dt goes to a scratch [2cnt][n][W] of the compute type. bf16 products are
// one running sum over K (the k16 order of the mma.sync pass before it);
// f32 sums each 32-channel stage apart and adds it in f32 (the skeleton's
// kSplit = 32: the tensor cores truncate every sum they add to, and over K
// = 512 one running sum reads past K5's f32 limit; PERF.md).
//
// Then dW = G^T A over `splits` ranges of rays, G the scratch's dt and A
// the layer's input from the stash, both ray-major, as K5's narrow pass 2
// (r2l_bwd_hopper.cuh) with the W columns of dW tiled (a block cannot hold
// them at W >= 384): bf16 (dw_bf16) a block of 128 rows of dW[l] x 256
// columns (the last tile 128 where W is 128 more than a multiple of 256),
// 64 rays a stage through four stages filled by TMA in 64 x 64 boxes of the
// 128-byte swizzle, which wgmma reads MN-major (both transpose bits set);
// the int8 stash through registers, dequantized (q * scale, rounded to
// bf16) one stage ahead. f32 (dw_tf32) 128 x 128 a block, 32 rays a stage,
// G copied ray-major by cp.async and split into TF32 parts in registers,
// the stash transposed on its way into shared memory as K-major core
// matrices (TF32 wgmma reads B K-major only), each stage's 3xTF32 products
// summed apart and added in f32. The blocks of the first column tile also
// sum G's columns for db, over each 32-ray group's two halves apart, then
// the halves. The ranges' partials are added in order (sum_splits), so two
// runs give bit-identical dh, dW and db; no atomics.
//
// What bounds it: 4 N W^2 operations a layer (the dh product and the dW
// product), at W512 and 81,920 rays 0.688 T a 4-block call (0.695 ms at 989
// bf16 TFLOP/s, 4.165 ms for f32 as 3xTF32); and this design's bytes: per
// block each pass reads dt and writes dt (the dh pass also dh in and out,
// the mask pass the stash row), the dW pass reads dt and the stash rows
// once a column tile, and the ranges' partials: about 4.5 GB a bf16 4-block
// call at W512 (1.35 ms at 3.35 TB/s), so bf16 is bound by bytes. PERF.md
// has the measured times.
#include <utility>

#include "r2l_bwd_hopper.cuh"
#include "wide_hopper.cuh"

namespace {

using namespace hopper;

// the stash's and the weights' types (r2l_fused.py, _WIDE_TYPES)
enum Type { kBF16 = 0, kF32 = 1, kS8 = 2 };

constexpr int kWideChannels = 128;  // the widths are multiples of this
// Rays a range of the dW pass is a multiple of: whole stages of either
// form (bf16 64, f32 32 rays a stage).
constexpr int kDwRays = 64;
constexpr int kBfRays = 64, kTfRays = 32;

struct Dw {
  void* dts;             // [2cnt][n][W] of T
  const void* stash_h;   // [cnt][n][W] of S
  const void* stash_t;   // [cnt][n][W] of S
  const float* scale;    // [2cnt][W] (int8 stash) or null
  float* part;           // [splits][2cnt][W][W]
  float* dbp;            // [splits][2cnt][W]
  int n, W, cnt, rays_per_split;
};

// ---- the dh walk's epilogues --------------------------------------------

// The epilogues read their side tensors through the non-coherent path, at
// a row clamped to the pass's, so that a tile's loads issue together ahead
// of their use (a plain load may not pass the previous pair's store to dh,
// which can alias it; each element is read once, by the thread that then
// writes it, so no read sees a write of the pass).
__device__ __forceinline__ float2 side2(const __nv_bfloat16* p, const float*) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 side2(const float* p, const float*) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 side2(const int8_t* p, const float* sc) {
  const char2 q = __ldg(reinterpret_cast<const char2*>(p));
  const float2 s = __ldg(reinterpret_cast<const float2*>(sc));
  return make_float2(__fmul_rn((float)q.x, s.x), __fmul_rn((float)q.y, s.y));
}

// dt1 = (t1 > 0 ? acc : 0), t1 at (row, col) of the stash in its own type
// (int8: q * scale); the skeleton rounds it to the compute type.
template <typename S>
struct Mask {
  struct Args {
    const S* t1;           // [rows][W]
    const float* scale;    // [W] or null
    int rows, W;
  };
  __device__ __forceinline__ static bool stores(const Args&) { return true; }
  __device__ __forceinline__ static void pair(const Args& e, int row, int col,
                                              float a0, float a1, float& v0,
                                              float& v1) {
    const float2 m = side2(e.t1 + (size_t)min(row, e.rows - 1) * e.W + col,
                           e.scale ? e.scale + col : nullptr);
    v0 = m.x > 0.f ? a0 : 0.f;
    v1 = m.y > 0.f ? a1 : 0.f;
  }
};

// dh_out = dh_in + acc in f32 at (row, col) (in place after the top block),
// and (where `store`) the next block's dt2 = dh_out * res_scale, which the
// skeleton rounds to the compute type.
struct Dh {
  struct Args {
    const float* hin;  // [rows][W]
    float* hout;       // [rows][W]
    int rows, W;
    float res_scale;
    int store;
  };
  __device__ __forceinline__ static bool stores(const Args& e) {
    return e.store != 0;
  }
  __device__ __forceinline__ static void pair(const Args& e, int row, int col,
                                              float a0, float a1, float& v0,
                                              float& v1) {
    const size_t o = (size_t)min(row, e.rows - 1) * e.W + col;
    const float2 h = side2(e.hin + o, nullptr);
    const float d0 = __fadd_rn(h.x, a0), d1 = __fadd_rn(h.y, a1);
    if (row < e.rows)
      *reinterpret_cast<float2*>(e.hout + o) = make_float2(d0, d1);
    v0 = __fmul_rn(d0, e.res_scale);
    v1 = __fmul_rn(d1, e.res_scale);
  }
};

// The top block's dt2 = (dh * res_scale) rounded to T.
template <typename T>
__global__ void scale_dh(const float* __restrict__ dh, T* dt, long long e,
                         float rs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < e / 2; i += (long long)gridDim.x * blockDim.x) {
    const float2 d = reinterpret_cast<const float2*>(dh)[i];
    wideh::put2<T>(reinterpret_cast<unsigned char*>(dt + 2 * i),
                   __fmul_rn(d.x, rs), __fmul_rn(d.y, rs));
  }
}

// ---- the dW pass, bf16 weights --------------------------------------------

// A block: 128 rows of dW[l] (two consumer warpgroups of 64) x NI columns;
// a stage: G's 128 and A's NI columns as 64-column boxes of 64 rays x 128
// bytes (8 KB each, 128-byte swizzle), four stages; then their full
// barriers and db's two halves.
template <int NI>
struct DwBf {
  static constexpr int kThreads = 2 * kWG, kBM = 128;
  static constexpr int kBoxBytes = 64 * kBfRays * 2;
  static constexpr int kGBytes = kBM / 64 * kBoxBytes;
  static constexpr int kStageBytes = kGBytes + NI / 64 * kBoxBytes;
  static constexpr int kStages = 4;
  static constexpr int kOffBar = kStages * kStageBytes;
  static constexpr int kOffRed = kOffBar + 128;
  static constexpr int kSmem = kOffRed + 2 * kBM * 4 + 1024;  // + alignment
};

// One block: (split, layer, row tile, column tile) from blockIdx.x, the
// column tiles i_base + NI * k for k < n_it. G's and the bf16 stash's rows
// arrive by TMA; the int8 stash goes through registers, dequantized, into
// the same layout one stage ahead. Rays past the range are zero: TMA fills
// past n, and a range is a whole number of stages.
template <typename S, int NI>
__global__ void __launch_bounds__(DwBf<NI>::kThreads, 1)
    dw_bf16(const __grid_constant__ CUtensorMap tg,
            const __grid_constant__ CUtensorMap th,
            const __grid_constant__ CUtensorMap tt, const Dw p, int i_base,
            int n_it) {
  using D = DwBf<NI>;
  constexpr bool kQ = sizeof(S) == 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int W = p.W, L2 = 2 * p.cnt;
  int b = blockIdx.x;
  const int it = b % n_it;
  b /= n_it;
  const int ot = b % (W / D::kBM);
  b /= W / D::kBM;
  const int l = b % L2, sp = b / L2;
  const int o0 = ot * D::kBM, i0 = i_base + it * NI;
  const int r_begin = sp * p.rays_per_split;
  const int r_end = min(p.n, r_begin + p.rays_per_split);
  const int nst = r_end > r_begin ? (r_end - r_begin + kBfRays - 1) / kBfRays
                                  : 0;
  const size_t rs = (size_t)p.n * W;
  const S* A = static_cast<const S*>((l & 1) ? p.stash_t : p.stash_h) +
               (size_t)(l >> 1) * rs;
  const CUtensorMap* ta = (l & 1) ? &tt : &th;
  const float* sc = kQ ? p.scale + (size_t)l * W + i0 : nullptr;
  const int tid = threadIdx.x, wg = tid / kWG, wtid = tid % kWG;
  const uint32_t full = smem_u32(smem + D::kOffBar);
  const bool db = i0 == 0;

  auto gbuf = [&](int s) { return smem + (s % D::kStages) * D::kStageBytes; };
  auto abuf = [&](int s) { return gbuf(s) + D::kGBytes; };
  // thread 0: stage s's boxes (G's; and the bf16 stash's)
  auto load_stage = [&](int s) {
    const uint32_t bar = full + 8 * (s % D::kStages);
    const int rb = r_begin + s * kBfRays;
    bar_expect_tx(bar, kQ ? D::kGBytes : D::kStageBytes);
    for (int i = 0; i < D::kBM / 64; ++i)
      r2lbh::tma_box(smem_u32(gbuf(s)) + i * D::kBoxBytes, &tg, o0 + 64 * i,
                     rb, l, bar);
    if (!kQ)
      for (int i = 0; i < NI / 64; ++i)
        r2lbh::tma_box(smem_u32(abuf(s)) + i * D::kBoxBytes, ta, i0 + 64 * i,
                       rb, l >> 1, bar);
  };
  // int8 A: 16 q-values (two 8-column chunks) a piece, through registers
  constexpr int kQPieces = kQ ? kBfRays * (NI / 16) / D::kThreads : 1;
  uint4 qreg[kQPieces];
  auto piece = [&](int i, int& r, int& c) {  // ray r, columns 16c..16c+15
    const int e = tid + i * D::kThreads;
    r = e / (NI / 16);
    c = e - r * (NI / 16);
  };
  auto load_q = [&](int s) {
    if constexpr (kQ) {
      const int rb = r_begin + s * kBfRays;
#pragma unroll
      for (int i = 0; i < kQPieces; ++i) {
        int r, c;
        piece(i, r, c);
        qreg[i] = s < nst && rb + r < r_end
                      ? __ldg(reinterpret_cast<const uint4*>(
                            A + (size_t)(rb + r) * W + i0 + 16 * c))
                      : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_q = [&](int s) {  // into the 128-byte swizzle of the boxes
    if constexpr (kQ) {
#pragma unroll
      for (int i = 0; i < kQPieces; ++i) {
        int r, c;
        piece(i, r, c);
        unsigned char* box = abuf(s) + (16 * c / 64) * D::kBoxBytes;
        const int q = (16 * c % 64) / 8;  // the first 16-byte chunk
        *reinterpret_cast<uint4*>(box + r * 128 + ((q ^ (r % 8)) * 16)) =
            r2lbh::dequant8(make_uint2(qreg[i].x, qreg[i].y), sc + 16 * c);
        *reinterpret_cast<uint4*>(box + r * 128 + (((q + 1) ^ (r % 8)) * 16)) =
            r2lbh::dequant8(make_uint2(qreg[i].z, qreg[i].w), sc + 16 * c + 8);
      }
      fence_async_smem();
    }
  };
  // db: column c = tid % 128 of G's tile, the rays of half tid / 128 of
  // each 32-ray group (G's box c / 64, 128-byte swizzled rows of 64 values)
  const int dbc = tid & 127, dbh = tid >> 7;
  float colsum = 0.f;
  auto sum_cols = [&](int s) {
    const unsigned char* g = gbuf(s) + (dbc >> 6) * D::kBoxBytes;
    for (int q = 0; q < kBfRays / 32; ++q)
      for (int r = 32 * q + 16 * dbh; r < 32 * q + 16 * dbh + 16; ++r)
        colsum = __fadd_rn(colsum, __bfloat162float(
                                       *reinterpret_cast<const __nv_bfloat16*>(
                                           g + wideh::sw128(r, (dbc & 63) * 2))));
  };

  float acc[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) acc[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < D::kStages; ++s) bar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < D::kStages && s < nst; ++s) load_stage(s);
  load_q(0);
  store_q(0);
  __syncthreads();
  for (int s = 0; s < nst; ++s) {
    bar_wait(full + 8 * (s % D::kStages), (s / D::kStages) & 1);
    load_q(s + 1);
    wgmma_fence();
    const uint32_t ga = smem_u32(gbuf(s)) + wg * D::kBoxBytes;
    const uint32_t aa = smem_u32(abuf(s));
#pragma unroll
    for (int ks = 0; ks < kBfRays / 16; ++ks)
      Wgmma<NI>::bf16_mn(acc, r2lbh::desc_sw128(ga + ks * 2048, D::kBoxBytes),
                         r2lbh::desc_sw128(aa + ks * 2048, D::kBoxBytes), 1);
    wgmma_commit();
    if (db) sum_cols(s);
    if (s + 1 < nst) store_q(s + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup's products read stage s
    if (tid == 0 && s + D::kStages < nst) load_stage(s + D::kStages);
  }

  float* out = p.part + ((size_t)sp * L2 + l) * W * W;
  const int lane = wtid % 32;
  const int o = o0 + 64 * wg + 16 * (wtid / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < NI / 8; ++j) {
    const int i = i0 + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + (size_t)o * W + i) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(o + 8) * W + i) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (db) {  // the two halves' sums, in order
    float* red = reinterpret_cast<float*>(smem + D::kOffRed);
    red[tid] = colsum;
    __syncthreads();
    if (tid < 128)
      p.dbp[((size_t)sp * L2 + l) * W + o0 + tid] =
          __fadd_rn(red[tid], red[128 + tid]);
  }
}

// ---- the dW pass, f32 weights (3xTF32) ------------------------------------

// A block: 128 rows (o) x 128 columns (i) of dW[l], 32 rays a stage: G's
// stage ray-major, double-buffered (rows padded by 8 floats, so the A
// fragments' reads fall in 32 banks), then the stash's stage as K-major
// core matrices, the TF32 high parts then the low parts.
struct DwTf {
  static constexpr int kThreads = 2 * kWG, kBM = 128, kBN = 128;
  static constexpr int kLdG = kBM + 8;       // floats a row of G's stage
  static constexpr int kGBytes = kTfRays * kLdG * 4;
  static constexpr int kBBytes = kBN * kTfRays * 4;  // one TF32 part
  static constexpr int kOffB = 2 * kGBytes;
  static constexpr int kSmem = kOffB + 2 * kBBytes;
  static constexpr int kAPer = kTfRays * kBN / kThreads;  // stash values
};

// One block: (split, layer, row tile, column tile) from blockIdx.x. Each
// thread reads its A fragment of G transposed and splits it (a_hi, a_lo);
// the stash's stage goes through registers one stage ahead, split and
// stored transposed (a warp's stores cover 4 rays x 8 columns, 32 banks).
// Per k8 step a_hi w_lo, a_lo w_hi, a_hi w_hi (a bf16 stash is exact in
// TF32: no w_lo), a stage's products from zero, added to the running sum in
// f32 (round to nearest).
template <typename S>
__global__ void __launch_bounds__(DwTf::kThreads, 1)
    dw_tf32(const Dw p) {
  using D = DwTf;
  constexpr int kKR = kTfRays, BN = D::kBN;
  constexpr bool kLoB = sizeof(S) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = p.W, L2 = 2 * p.cnt, nt = W / BN;
  int b = blockIdx.x;
  const int it = b % nt;
  b /= nt;
  const int ot = b % (W / D::kBM);
  b /= W / D::kBM;
  const int l = b % L2, sp = b / L2;
  const int o0 = ot * D::kBM, i0 = it * BN;
  const int r_begin = sp * p.rays_per_split;
  const int r_end = min(p.n, r_begin + p.rays_per_split);
  const int nst = r_end > r_begin ? (r_end - r_begin + kKR - 1) / kKR : 0;
  const size_t rs = (size_t)p.n * W;
  const float* G = static_cast<const float*>(p.dts) + (size_t)l * rs;
  const S* A = static_cast<const S*>((l & 1) ? p.stash_t : p.stash_h) +
               (size_t)(l >> 1) * rs;
  const int tid = threadIdx.x, wg = tid / kWG, wtid = tid % kWG;
  const int lane = wtid % 32, g = lane / 4, t = lane % 4;
  const int m0 = 64 * wg + 16 * (wtid / 32) + g;  // the fragment's row
  float* gs[2] = {reinterpret_cast<float*>(smem),
                  reinterpret_cast<float*>(smem + D::kGBytes)};
  unsigned char* bs = smem + D::kOffB;
  const uint32_t bh = smem_u32(bs), bl = bh + D::kBBytes;
  const bool db = it == 0;
  const int dbc = tid & 127, dbh = tid >> 7;
  float colsum = 0.f;

  // G's stage s: rows of 128 floats, 16 bytes a copy, zero past r_end
  auto copy_g = [&](int s) {
    const int rb = r_begin + s * kKR;
    for (int f = tid; f < kKR * D::kBM / 4; f += D::kThreads) {
      const int r = f / (D::kBM / 4), c = 4 * (f % (D::kBM / 4));
      float* dst = gs[s & 1] + r * D::kLdG + c;
      if (rb + r < r_end)
        r2l::cp_async16(dst, G + (size_t)(rb + r) * W + o0 + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    r2l::cp_async_commit();
  };
  // the stash's stage s into registers, as loaded (converted where stored,
  // so that no load is waited for before the products): element e = tid +
  // k * threads is column 8 (e / 32 % (BN / 8)) + e % 8 of ray
  // 4 (e / 32 / (BN / 8)) + e / 8 % 4
  S areg[D::kAPer];
  auto elem = [&](int k, int& r, int& c) {
    const int e = tid + k * D::kThreads, h = e / 32;
    c = 8 * (h % (BN / 8)) + e % 8;
    r = 4 * (h / (BN / 8)) + e / 8 % 4;
  };
  auto load_a = [&](int s) {
    const int rb = r_begin + s * kKR;
#pragma unroll
    for (int k = 0; k < D::kAPer; ++k) {
      int r, c;
      elem(k, r, c);
      areg[k] = s < nst && rb + r < r_end
                    ? __ldg(A + (size_t)(rb + r) * W + i0 + c)
                    : static_cast<S>(0.f);
    }
  };
  // ... split and stored as K-major core matrices: (column c, ray r) at
  // byte 4r of row c, rows of kKR * 4 bytes
  auto store_a = [&]() {
#pragma unroll
    for (int k = 0; k < D::kAPer; ++k) {
      int r, c;
      elem(k, r, c);
      const int off = cm_off(c, 4 * r, kKR * 4);
      const float x = r2lbh::stash_f(areg[k]);
      const uint32_t hi = tf32_rna(x);
      *reinterpret_cast<uint32_t*>(bs + off) = hi;
      if (kLoB)
        *reinterpret_cast<uint32_t*>(bs + D::kBBytes + off) =
            tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
    }
  };

  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
  if (nst > 0) copy_g(0);
  load_a(0);
  for (int s = 0; s < nst; ++s) {
    store_a();
    if (s + 1 < nst) copy_g(s + 1);
    else r2l::cp_async_commit();  // an empty group: wait_group 1 below
    load_a(s + 1);
    r2l::cp_async_wait_prior();
    fence_async_smem();
    __syncthreads();  // G's stage s and the stash's, for every warpgroup
    const float* gt = gs[s & 1];
    uint32_t hi[kKR / 8][4], lo[kKR / 8][4];
#pragma unroll
    for (int j = 0; j < kKR / 8; ++j) {
      const int k = 8 * j + t;
      const float x[4] = {gt[k * D::kLdG + m0], gt[k * D::kLdG + m0 + 8],
                          gt[(k + 4) * D::kLdG + m0],
                          gt[(k + 4) * D::kLdG + m0 + 8]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hi[j][q] = tf32_rna(x[q]);
        lo[j][q] = tf32_rna(__fsub_rn(x[q], __uint_as_float(hi[j][q])));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKR / 8; ++j) {
      const uint64_t dh = desc(bh + j * 256, kKR * 4 * 8);
      if (kLoB) {
        const uint64_t dl = desc(bl + j * 256, kKR * 4 * 8);
        Wgmma<BN>::tf32(acc, hi[j], dl, j > 0);
        Wgmma<BN>::tf32(acc, lo[j], dh, 1);
      } else {
        Wgmma<BN>::tf32(acc, lo[j], dh, j > 0);
      }
      Wgmma<BN>::tf32(acc, hi[j], dh, 1);
    }
    wgmma_commit();
    if (db)  // G's column, the rays of this thread's half of the stage
      for (int r = 16 * dbh; r < 16 * dbh + 16; ++r)
        colsum = __fadd_rn(colsum, gt[r * D::kLdG + dbc]);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < kKR / 8; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    __syncthreads();  // stage s read: its buffers may be written again
  }

  float* out = p.part + ((size_t)sp * L2 + l) * W * W;
  const int o = o0 + m0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int i = i0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(out + (size_t)o * W + i) =
        make_float2(sum[4 * j], sum[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(o + 8) * W + i) =
        make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
  if (db) {  // the two halves' sums, in order
    float* red = reinterpret_cast<float*>(smem);
    red[tid] = colsum;
    __syncthreads();
    if (tid < 128)
      p.dbp[((size_t)sp * L2 + l) * W + o0 + tid] =
          __fadd_rn(red[tid], red[128 + tid]);
  }
}

// out[i] = part[0][i] + part[1][i] + ... in order.
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, long long m,
                           int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[k * m + i]);
    out[i] = s;
  }
}

unsigned grid_for(long long m) {
  const long long b = (m + 255) / 256;
  return (unsigned)(b < 132 * 16 ? b : 132 * 16);
}

template <typename Kern>
cudaError_t set_smem(Kern kern, int smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The bf16 dW pass: the 256-column tiles, then a last one of 128 where W is
// 128 more than a multiple of 256. The stash's maps serve the bf16 stash
// only (int8 goes through the registers): G's stands in for them.
template <typename S>
cudaError_t run_dw_bf16(const Dw& d, int splits, cudaStream_t st) {
  const int W = d.W, L2 = 2 * d.cnt;
  CUtensorMap tg, th, tt;
  cudaError_t err = r2lbh::box_map(&tg, d.dts, d.n, W, L2);
  if (err != cudaSuccess) return err;
  th = tt = tg;
  if (sizeof(S) == 2 &&
      ((err = r2lbh::box_map(&th, d.stash_h, d.n, W, d.cnt)) != cudaSuccess ||
       (err = r2lbh::box_map(&tt, d.stash_t, d.n, W, d.cnt)) != cudaSuccess))
    return err;
  const long long rows = (long long)splits * L2 * (W / 128);
  const int full = W / 256;
  if ((err = set_smem(dw_bf16<S, 256>, DwBf<256>::kSmem)) != cudaSuccess)
    return err;
  dw_bf16<S, 256><<<(unsigned)(rows * full), DwBf<256>::kThreads,
                    DwBf<256>::kSmem, st>>>(tg, th, tt, d, 0, full);
  if ((err = cudaGetLastError()) != cudaSuccess || W % 256 == 0) return err;
  if ((err = set_smem(dw_bf16<S, 128>, DwBf<128>::kSmem)) != cudaSuccess)
    return err;
  dw_bf16<S, 128><<<(unsigned)rows, DwBf<128>::kThreads, DwBf<128>::kSmem,
                    st>>>(tg, th, tt, d, 256 * full, 1);
  return cudaGetLastError();
}

template <typename S>
cudaError_t run_dw_tf32(const Dw& d, int splits, cudaStream_t st) {
  cudaError_t err = set_smem(dw_tf32<S>, DwTf::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)splits * 2 * d.cnt * (d.W / 128) * (d.W / 128);
  dw_tf32<S><<<(unsigned)blocks, DwTf::kThreads, DwTf::kSmem, st>>>(d);
  return cudaGetLastError();
}

// The group's walk: dt2 of the top block, two passes a block on the
// skeleton, then dW and db over the ranges, the ranges added in order.
template <typename T, typename S>
cudaError_t run_bwd(const unsigned char* image, const Dw& d,
                    const float* dh_in, float* dh_out, int splits,
                    float res_scale, float* dw, float* db, cudaStream_t st) {
  constexpr bool kF = sizeof(T) == 4;
  constexpr int kSplit = kF ? 32 : 0;  // f32: each stage summed apart
  const int W = d.W, cnt = d.cnt, n = d.n;
  const long long e = (long long)n * W;
  T* dts = static_cast<T*>(d.dts);
  const size_t layer_bytes = (size_t)W * W * sizeof(T) * (kF ? 2 : 1);
  scale_dh<T><<<grid_for(e / 2), 256, 0, st>>>(dh_in, dts + (2 * cnt - 1) * e,
                                               e, res_scale);
  cudaError_t err = cudaGetLastError();
  const wideh::Pass p{n, W, W * (int)sizeof(T) / 128, 0};
  const S* stash_t = static_cast<const S*>(d.stash_t);
  CUtensorMap a, out, wb;
  for (int k = cnt - 1; k >= 0 && err == cudaSuccess; --k) {
    // dt1 = mask(dt2 W2^T)
    if ((err = wideh::act_map<T>(&a, dts + (2 * k + 1) * e, n, W)) !=
            cudaSuccess ||
        (err = wideh::act_map<T>(&out, dts + 2 * k * e, n, W)) !=
            cudaSuccess ||
        (err = wideh::weight_map<T>(&wb, image + (2 * k + 1) * layer_bytes,
                                    W, W)) != cudaSuccess)
      return err;
    err = wideh::launch_pass<T, Mask<S>, kSplit>(
        a, a, wb, out, p,
        {stash_t + k * e, d.scale ? d.scale + (size_t)(2 * k + 1) * W
                                  : nullptr, n, W},
        st);
    if (err != cudaSuccess) return err;
    // dh += dt1 W1^T, and the next block's dt2
    std::swap(a, out);
    if (k > 0 &&
        (err = wideh::act_map<T>(&out, dts + (2 * k - 1) * e, n, W)) !=
            cudaSuccess)
      return err;
    if ((err = wideh::weight_map<T>(&wb, image + 2 * k * layer_bytes, W,
                                    W)) != cudaSuccess)
      return err;
    err = wideh::launch_pass<T, Dh, kSplit>(
        a, a, wb, out, p,
        {k == cnt - 1 ? dh_in : dh_out, dh_out, n, W, res_scale, k > 0},
        st);
  }
  if (err != cudaSuccess) return err;
  if constexpr (kF)
    err = run_dw_tf32<S>(d, splits, st);
  else
    err = run_dw_bf16<S>(d, splits, st);
  if (err != cudaSuccess) return err;
  const long long mw = 2LL * cnt * W * W, mb = 2LL * cnt * W;
  sum_splits<<<grid_for(mw), 256, 0, st>>>(d.part, dw, mw, splits);
  sum_splits<<<grid_for(mb), 256, 0, st>>>(d.dbp, db, mb, splits);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// image: stage_bwd_weights' wide image (every body layer's weights [in,
// out] row-major; f32 its TF32 high parts, then its low parts, a layer at
// a time) from the group's first layer on; stash_h and stash_t: the
// group's stash rows of block inputs and inner activations, [cnt][n][W]
// each, of stash_type (0 bf16, 1 f32, 2 int8); scale: their [2cnt][W]
// dequant scales (int8 stash) or null. Scratch: dts [2cnt][n][W] of the
// weight type, part [splits][2cnt][W][W] and dbp [splits][2cnt][W] f32;
// dW is summed over `splits` ranges of rays (whole multiples of kDwRays,
// the last one short), then the ranges in order. Returns a cudaError_t: a
// launch's own error, cudaErrorNotSupported where a tensor map cannot be
// made, or cudaErrorInvalidValue for a width or a combination the wide
// form does not take.
extern "C" int r2l_wide_bwd_launch(
    const unsigned char* image, const void* stash_h, const void* stash_t,
    const float* scale, const float* dh_in, float* dh_out, void* dts,
    float* part, float* dbp, float* dw, float* db, int n, int W, int cnt,
    float res_scale, int weight_is_f32, int stash_type, int splits,
    void* stream) {
  const int per = (n + splits - 1) / (splits > 0 ? splits : 1);
  const int rays_per_split = (per + kDwRays - 1) / kDwRays * kDwRays;
  if (n <= 0 || W <= 0 || W % kWideChannels != 0 || cnt < 1 || splits < 1 ||
      (long long)(splits - 1) * rays_per_split >= n || stash_type < 0 ||
      stash_type > 2 || (stash_type == kS8) != (scale != nullptr) ||
      (weight_is_f32 && stash_type == kS8) ||
      (!weight_is_f32 && stash_type == kF32))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(image) |
       reinterpret_cast<uintptr_t>(stash_h) |
       reinterpret_cast<uintptr_t>(stash_t) | reinterpret_cast<uintptr_t>(dts) |
       reinterpret_cast<uintptr_t>(dh_in) | reinterpret_cast<uintptr_t>(dh_out) |
       reinterpret_cast<uintptr_t>(part)) & 15)
    return cudaErrorMisalignedAddress;
  Dw d{};
  d.dts = dts;
  d.stash_h = stash_h;
  d.stash_t = stash_t;
  d.scale = scale;
  d.part = part;
  d.dbp = dbp;
  d.n = n;
  d.W = W;
  d.cnt = cnt;
  d.rays_per_split = rays_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto sv) {
    using T = decltype(t);
    using S = decltype(sv);
    return run_bwd<T, S>(image, d, dh_in, dh_out, splits, res_scale, dw, db,
                         s);
  };
  if (weight_is_f32)
    return stash_type == kBF16 ? go(float(), __nv_bfloat16())
                               : go(float(), float());
  return stash_type == kS8 ? go(__nv_bfloat16(), int8_t())
                           : go(__nv_bfloat16(), __nv_bfloat16());
}
