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
// Design: the dh walk is the frame's wide passes (r2l_wide.cuh) against
// each layer's transpose, staged once per step in the wide form's tiles
// (r2l_train.py, stage_bwd_weights): per block a pass whose epilogue masks
// and rounds dt1 (kBwdMask) and one that adds dt1 W1^T to dh and rounds the
// next block's dt2 (kBwdDh); every dt goes to a scratch [2cnt][n][W] of the
// compute type. Then one pass (wide_dw) sums dW = G^T A over a range of
// rays a block, G the scratch's dt and A the layer's input from the stash,
// both ray-major: 128 x 128 outputs a block, 32 rays a stage through two
// shared-memory buffers filled by cp.async (the int8 stash, and K8's bf16
// one under f32 weights, through registers and converted on the way),
// bf16 fragments by ldmatrix.trans, f32 ones read
// as scalars and split into 3xTF32, each k8 step summed apart. The blocks
// of the first column tile also sum G's columns for db. The ranges'
// partials are then added in order (sum_splits), so two runs give
// bit-identical dh, dW and db; no atomics.
//
// What bounds it: 4 N W^2 operations a layer (the dh product and the dW
// product), at W512 and 81,920 rays 0.344 T a 4-block call (0.35 ms at 989
// bf16 TFLOP/s, 2.08 ms for f32 as 3xTF32), and the bytes: dh in and out,
// the stash rows read, dt written and read twice. PERF.md has the measured
// times.
#include "r2l_wide.cuh"

using namespace r2lw;

namespace {

constexpr int kDwRays = 32;  // rays a stage of the dW pass

// The dW pass's shared-memory rows: 128 values of T and a pad, so that
// ldmatrix's eight rows (bf16) or a warp's scalar fragment reads (f32: rows
// 136 words apart) fall in 32 banks.
template <int T>
__host__ __device__ constexpr int dw_pitch() {
  return T == kF32 ? 128 * 4 + 32 : 128 * 2 + 16;
}
template <int T>
__host__ __device__ constexpr int dw_smem() {
  return 4 * kDwRays * dw_pitch<T>();  // G and A, two buffers each
}

struct Dw {
  void* dts;             // [2cnt][n][W] of T
  const void* stash_h;   // [cnt][n][W] of S
  const void* stash_t;   // [cnt][n][W] of S
  const float* scale;    // [2cnt][W] (int8 stash) or null
  float* part;           // [splits][2cnt][W][W]
  float* dbp;            // [splits][2cnt][W]
  int n, W, cnt, rays_per_split;
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One 16-byte piece of A (S values) stored in shared memory as T at dst
// (16 / sizeof(S) values; the int8 stash dequantized by sc and rounded).
template <int T, int S>
__device__ __forceinline__ void put_a(unsigned char* dst, uint4 v,
                                      const float* sc) {
  if constexpr (S == T) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else if constexpr (S == kS8) {  // T bf16
    const int8_t* q = reinterpret_cast<const int8_t*>(&v);
    uint32_t w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(
          __fmul_rn((float)q[2 * k], sc[2 * k]),
          __fmul_rn((float)q[2 * k + 1], sc[2 * k + 1]));
      w[k] = *reinterpret_cast<const uint32_t*>(&b);
    }
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {  // S bf16, T f32
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float f[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(h[k]);
      f[2 * k] = x.x;
      f[2 * k + 1] = x.y;
    }
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// dW's partial over one range of rays: block (split, layer, o tile, i tile)
// computes part[split][l][o0 + 128)[i0 + 128) = sum_r G[r][o] A[r][i]; the
// blocks of i tile 0 also db's partial, sum_r G[r][o].
template <int T, int S>
__global__ void __launch_bounds__(kThreads) wide_dw(const Dw p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int es = elem_bytes(T), ss = elem_bytes(S);
  constexpr int kP = dw_pitch<T>(), kBuf = kDwRays * kP;
  constexpr int kG = kDwRays * 128 * es / 16 / kThreads;  // G pieces a thread
  constexpr int kA = kDwRays * 128 * ss / 16 / kThreads;  // A pieces a thread
  constexpr int kGRow = 128 * es / 16, kARow = 128 * ss / 16;  // a ray's
  const int nt = p.W / kWideChannels, L2 = 2 * p.cnt;
  int b = blockIdx.x;
  const int it = b % nt;
  b /= nt;
  const int ot = b % nt;
  b /= nt;
  const int l = b % L2, sp = b / L2;
  const int o0 = ot * kWideChannels, i0 = it * kWideChannels;
  const int r_begin = sp * p.rays_per_split;
  const int r_end = min(p.n, r_begin + p.rays_per_split);
  const int nst = r_end > r_begin ? (r_end - r_begin + kDwRays - 1) / kDwRays
                                  : 0;
  const size_t e = (size_t)p.n * p.W;
  const unsigned char* G =
      static_cast<const unsigned char*>(p.dts) + (size_t)l * e * es;
  const unsigned char* A =
      static_cast<const unsigned char*>((l & 1) ? p.stash_t : p.stash_h) +
      (size_t)(l >> 1) * e * ss;
  const float* sc = p.scale ? p.scale + (size_t)l * p.W + i0 : nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  unsigned char* sG[2] = {smem, smem + kBuf};
  unsigned char* sA[2] = {smem + 2 * kBuf, smem + 3 * kBuf};

  // G, and A where the stash is of the compute type, by cp.async; another
  // stash through registers, converted on the way into shared memory
  constexpr bool kCopyA = S == T;
  auto piece = [&](unsigned char* dst, const unsigned char* src, bool in) {
    if (in)
      r2l::cp_async16(dst, src);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  };
  auto issue = [&](int st, int buf) {
    const int r0 = r_begin + st * kDwRays;
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int c = tid + i * kThreads, r = c / kGRow, w = c % kGRow;
      piece(sG[buf] + r * kP + w * 16,
            G + ((size_t)(r0 + r) * p.W + o0) * es + w * 16, r0 + r < r_end);
    }
    if constexpr (kCopyA) {
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int c = tid + i * kThreads, r = c / kARow, w = c % kARow;
        piece(sA[buf] + r * kP + w * 16,
              A + ((size_t)(r0 + r) * p.W + i0) * ss + w * 16, r0 + r < r_end);
      }
    }
  };
  uint4 ar[kCopyA ? 1 : kA];
  auto load_a = [&](int st) {
    const int r0 = r_begin + st * kDwRays;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int c = tid + i * kThreads, r = c / kARow, w = c % kARow;
      ar[i] = r0 + r < r_end
                  ? *reinterpret_cast<const uint4*>(
                        A + ((size_t)(r0 + r) * p.W + i0) * ss + w * 16)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int c = tid + i * kThreads, r = c / kARow, w = c % kARow;
      const int col = w * 16 / ss;
      put_a<T, S>(sA[buf] + r * kP + col * es, ar[i], sc ? sc + col : nullptr);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  const bool db = it == 0;
  const int dbc = tid & 127, dbh = tid >> 7;  // db: a column, half the rays
  float colsum = 0.f;

  if (nst > 0) {
    issue(0, 0);
    if constexpr (!kCopyA) {
      load_a(0);
      store_a(0);
    }
  }
  r2l::cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    const int cur = st & 1;
    if (st + 1 < nst) {
      issue(st + 1, cur ^ 1);  // its buffer's last readers passed the barrier
      if constexpr (!kCopyA) load_a(st + 1);
    }
    r2l::cp_async_commit();
    r2l::cp_async_wait_prior();  // stage st has landed
    __syncthreads();
    const unsigned char* Gs = sG[cur];
    const unsigned char* As = sA[cur];
    if constexpr (T == kBF16) {
#pragma unroll
      for (int kk = 0; kk < kDwRays; kk += 16) {
        uint32_t a[4][4], bb[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldsm_x4_trans(a[i], Gs + (kk + (lane >> 4) * 8 + (lane & 7)) * kP +
                                  (wm * 64 + i * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t r[4];
          ldsm_x4_trans(r, As + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * kP +
                               (wn * 32 + j * 8 + (lane >> 4) * 8) * 2);
          bb[j][0] = r[0];
          bb[j][1] = r[1];
          bb[j + 1][0] = r[2];
          bb[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], bb[j]);
      }
    } else {
      const float* Gf = reinterpret_cast<const float*>(Gs);
      const float* Af = reinterpret_cast<const float*>(As);
      constexpr int kPw = kP / 4;
#pragma unroll 1  // one k8 step's fragments live at a time (registers)
      for (int kk = 0; kk < kDwRays; kk += 8) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn * 32 + j * 8 + g;
          tf32_split(__float_as_uint(Af[(kk + t) * kPw + c]), bh[j][0],
                     bl[j][0]);
          tf32_split(__float_as_uint(Af[(kk + t + 4) * kPw + c]), bh[j][1],
                     bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = wm * 64 + i * 16 + g;
          const uint32_t x[4] = {
              __float_as_uint(Gf[(kk + t) * kPw + m]),
              __float_as_uint(Gf[(kk + t) * kPw + m + 8]),
              __float_as_uint(Gf[(kk + t + 4) * kPw + m]),
              __float_as_uint(Gf[(kk + t + 4) * kPw + m + 8])};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) tf32_split(x[k], ah[k], al[k]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, bh[j]);
            mma_tf32(d, ah, bl[j]);
            mma_tf32(d, ah, bh[j]);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[i][j][k] = __fadd_rn(acc[i][j][k], d[k]);
          }
        }
      }
    }
    if (db) {
      for (int r = dbh * (kDwRays / 2); r < (dbh + 1) * (kDwRays / 2); ++r) {
        const unsigned char* x = Gs + r * kP + dbc * es;
        colsum = __fadd_rn(colsum,
                           T == kBF16 ? __bfloat162float(
                                            *reinterpret_cast<const __nv_bfloat16*>(x))
                                      : *reinterpret_cast<const float*>(x));
      }
    }
    if constexpr (!kCopyA)
      if (st + 1 < nst) store_a(cur ^ 1);
    __syncthreads();
  }

  float* P = p.part + ((size_t)(sp * L2 + l) * p.W) * p.W;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + wm * 64 + i * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = i0 + wn * 32 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(P + (size_t)o * p.W + col) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  if (db) {  // the two halves' sums, in order
    float* red = reinterpret_cast<float*>(smem);
    red[tid] = colsum;
    __syncthreads();
    if (tid < 128)
      p.dbp[((size_t)sp * L2 + l) * p.W + o0 + tid] =
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

// The top block's dt2 = (dh * res_scale) rounded to T.
template <int T>
__global__ void scale_dh(const float* __restrict__ dh, void* dt, long long e,
                         float rs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < e / 2; i += (long long)gridDim.x * blockDim.x) {
    const float2 d = reinterpret_cast<const float2*>(dh)[i];
    const float v[2] = {rnd<T>(__fmul_rn(d.x, rs)), rnd<T>(__fmul_rn(d.y, rs))};
    store2<T>(dt, 2 * i, v);
  }
}

unsigned grid_for(long long m) {
  const long long b = (m + 255) / 256;
  return (unsigned)(b < 132 * 16 ? b : 132 * 16);
}

template <int T, int S>
cudaError_t run_dw(const Dw& d, int splits, float* dw, float* db,
                   cudaStream_t st) {
  constexpr int smem = dw_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      wide_dw<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nt = d.W / kWideChannels;
  const long long blocks = (long long)splits * 2 * d.cnt * nt * nt;
  wide_dw<T, S><<<(unsigned)blocks, kThreads, smem, st>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long mw = 2LL * d.cnt * d.W * d.W, mb = 2LL * d.cnt * d.W;
  sum_splits<<<grid_for(mw), 256, 0, st>>>(d.part, dw, mw, splits);
  sum_splits<<<grid_for(mb), 256, 0, st>>>(d.dbp, db, mb, splits);
  return cudaGetLastError();
}

// The group's walk: dt2 of the top block, two passes a block, then dW, db.
template <int T>
cudaError_t run_bwd(const unsigned char* image, const Dw& d, int stype,
                    const float* dh_in, float* dh_out, int splits,
                    float res_scale, float* dw, float* db, cudaStream_t st) {
  constexpr int es = elem_bytes(T);
  const int W = d.W, cnt = d.cnt;
  const long long e = (long long)d.n * W;
  auto dt = [&](int l) {
    return static_cast<unsigned char*>(d.dts) + (size_t)l * e * es;
  };
  const size_t layer_bytes = (size_t)W * W * es;
  scale_dh<T><<<grid_for(e / 2), 256, 0, st>>>(dh_in, dt(2 * cnt - 1), e,
                                               res_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Params p{};
  p.n = d.n;
  p.W = W;
  p.Kb = W * es;
  p.res_scale = res_scale;
  for (int k = cnt - 1; k >= 0; --k) {
    Params pa = p;  // dt1 = mask(dt2 W2^T)
    pa.kind = kBwdMask;
    pa.w = image + (2 * k + 1) * layer_bytes;
    pa.a = dt(2 * k + 1);
    pa.mask = static_cast<const unsigned char*>(d.stash_t) +
              (size_t)k * e * elem_bytes(stype);
    pa.mask_type = stype;
    pa.mask_scale = d.scale ? d.scale + (size_t)(2 * k + 1) * W : nullptr;
    pa.out = dt(2 * k);
    err = pass<T, kBody, true>(pa, st);
    if (err != cudaSuccess) return err;
    Params pb = p;  // dh += dt1 W1^T, and the next block's dt2
    pb.kind = kBwdDh;
    pb.w = image + 2 * k * layer_bytes;
    pb.a = dt(2 * k);
    pb.hin = k == cnt - 1 ? dh_in : dh_out;
    pb.hout = dh_out;
    pb.out = k > 0 ? dt(2 * k - 1) : nullptr;
    err = pass<T, kBody, true>(pb, st);
    if (err != cudaSuccess) return err;
  }
  if constexpr (T == kF32)
    return stype == kBF16 ? run_dw<kF32, kBF16>(d, splits, dw, db, st)
                          : run_dw<kF32, kF32>(d, splits, dw, db, st);
  else
    return stype == kS8 ? run_dw<kBF16, kS8>(d, splits, dw, db, st)
                        : run_dw<kBF16, kBF16>(d, splits, dw, db, st);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// image: stage_bwd_weights' wide image (every body layer's transpose
// [in][out] in the wide form's tiles) from the group's first layer on;
// stash_h and stash_t: the group's stash rows of block inputs and inner
// activations, [cnt][n][W] each, of stash_type (0 bf16, 1 f32, 2 int8);
// scale: their [2cnt][W] dequant scales (int8 stash) or null. Scratch: dts
// [2cnt][n][W] of the weight type, part [splits][2cnt][W][W] and dbp
// [splits][2cnt][W] f32; dW is summed over `splits` ranges of rays (whole
// stages of kDwRays, the last one short), then the ranges in order.
// Returns a cudaError_t: a launch's own error, or cudaErrorInvalidValue for
// a width or a combination the wide form does not take.
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
  return weight_is_f32
             ? run_bwd<kF32>(image, d, stash_type, dh_in, dh_out, splits,
                             res_scale, dw, db, s)
             : run_bwd<kBF16>(image, d, stash_type, dh_in, dh_out, splits,
                              res_scale, dw, db, s);
}
