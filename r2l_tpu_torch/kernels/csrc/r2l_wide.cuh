// The wide form of the student's frame kernels: K1 (the positional
// encoding in the head), K9 (an encoded input) and K2 (static-scale int8)
// for every netwidth the chain kernels (r2l_hopper.cuh, r2l_int8_hopper.cuh:
// W 64, 128 and 256) do not hold, at any multiple of kWideChannels.
//
// Why another design: the chain kernels keep a ray tile's activations on
// the chip from the head to the tail, W/2 f32 accumulators a thread and two
// [rows x W] tiles in shared memory. At W512 that is 256 registers a
// thread; a bf16 [64 x W] tile is 128 KB at W1024, and the JAX package runs
// its int8 kernel up to W2180. So the wide form runs one pass a layer over
// activations in device memory: a tiled product and its epilogue
// (wide_layer), then a reduction for the tail (wide_tail). Each pass keeps
// the plain versions' rounding points (r2l_fused.py, _chain_ref and
// int8_pe_chain_ref):
//   bf16/f32: the bias added in f32, ReLU inside a block, the cast to the
//   compute type; at a block's end (t * res_scale + h) from the rounded t,
//   rounded; after the last block + h0, rounded; the tail an f32 dot.
//   int8: acc * m + b as one FMA, ReLU, the inner value in f32 (deployed) or
//   bf16, the next product's codes round-half-even and clipped to +-127
//   (times its inverse scale unless folded); at a block's end the bf16
//   residual stream; the tail's codes from h (+ the f32 h0).
//
// Products: mma.sync m16n8k16 bf16, m16n8k8 tf32 (f32 as 3xTF32: a_lo w_hi
// + a_hi w_lo + a_hi w_hi, both split by cvt.rna in registers) and m16n8k32
// s8, each reading 32 bytes of K a step: the same fragments in 32-bit
// words for all three types, loaded by ldmatrix. A block computes 128 rays
// x 128 channels with eight warps (64 x 32 each); a layer's weights come
// from an image staged once per model (r2l_fused.py, stage_wide_chain) in
// [128 x 128 byte] tiles, one 16 KB tile per stage of K, through a
// three-slot cp.async ring beside the activations' own. The head's input does not come
// from memory: the block produces it in slices of 1 KB a row in shared
// memory, K1 and K2 by the double-angle ladder (r2l::pe_ladder, bit for bit
// the plain version's values) in the head's freq-major column order, run
// once a (ray, scalar) a slice up to the highest octave the slice holds;
// K9 reads x [n, in_dim] f32 and rounds it to the compute type.
//
// The training forward's wide form (r2l_wide_train.cu), K5's and the
// teacher's run their layers on the Hopper pass skeleton (wide_hopper.cuh);
// r2l_wide_train.cu includes this header for wide_tail, nerf_wide.cu for
// its types and helpers.
//
// What bounds it: the products (2 W^2 operations a ray a layer) at the
// card's tensor rate; a pass also reads its input and writes its output,
// n * W * (element size) bytes each way, 164 MB at W512 bf16 on a
// 160,000-ray frame. Measured on an H100 (PERF.md), a pass runs at about
// 15% of the bf16 rate, and passes of rays sized for the 50 MB L2 were
// slower than one pass: the wrapper cuts the rays into passes (`rows`)
// only to bound the scratch. mma.sync stays below the card's wgmma rate.
#pragma once

#include <stddef.h>

#include <type_traits>

#include "r2l_common.cuh"

namespace r2lw {

enum Type { kBF16 = 0, kF32 = 1, kS8 = 2 };
enum Src { kBody = 0, kPE = 1, kX = 2 };   // where a pass's input comes from
// a pass's layer
enum Kind { kHead = 0, kInner = 1, kBlockEnd = 2 };
// K2's forms (r2l_fused.py, EPILOGUES)
enum Epi { kDeployed = 0, kFold = 1, kUnfolded = 2 };

// The widths the wide form runs at are multiples of this (its block's
// output channels); r2l_fused.py's WIDE_CHANNELS.
constexpr int kWideChannels = 128;
constexpr int kBM = 128, kBN = kWideChannels, kThreads = 256;
constexpr int kBKW = 32;             // 32-bit words of K a stage (128 bytes)
constexpr int kLd = kBKW + 4;        // words of a stage row in shared memory
constexpr int kStages = 3;
constexpr int kSliceW = 256;         // words of the head's input a slice
constexpr int kLdSlice = kSliceW + 4;
constexpr int kTileBytes = kBN * kBKW * 4;  // one staged weight tile, 16 KB
constexpr int kMaxOut = 8;           // the tail's outputs

__host__ __device__ constexpr int elem_bytes(int T) {
  return T == kF32 ? 4 : T == kBF16 ? 2 : 1;
}

// One pass: a layer's product and epilogue on n rays.
struct Params {
  int n;                   // rays of this pass
  int W;                   // output channels, a multiple of kWideChannels
  int Kb;                  // bytes of an input row (K * element size)
  const unsigned char* w;  // the layer's staged tiles
  const void* a;           // kBody: the input [n, K]
  const float* in;         // kPE: pts [n, dp]; kX: x [n, in_dim]
  int dp, L, in_dim;
  const float* head_inv;   // kPE int8: the head's inverse input scales
  const float* bias;       // bf16/f32: [W]; int8: (m, b) a channel
  int kind, final_, use_residual, epilogue;
  float res_scale;
  const void* hin;         // kBlockEnd: the block's input h [n, W]
  void* hout;              // kHead, kBlockEnd: h out [n, W]
  void* out;               // bf16/f32 kInner: t; int8: the next codes
  void* h0;                // kHead: written; a final kBlockEnd: read
  const float* inv;        // int8: the next product's inverse scales
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x -> (hi, lo) TF32 parts (staging.py, tf32_split)
__device__ __forceinline__ void tf32_split(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(__uint_as_float(x));
  lo = tf32_rna(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

template <int T>
using Acc = typename std::conditional<T == kS8, int, float>::type;

// Four 8 x 4-word matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; thread (g, t) receives word t of row g of
// each: the fragments' layout for all three types.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One 32-byte step of K for the warp's 64 x 32 outputs: A [rows][lda words]
// from row 0 of the block, B [channels][kLd words]; fragment (g, t) holds
// word t and t + 4 of its rows g and g + 8 (the m16n8 layouts of all three
// types, in words), loaded by ldmatrix.
template <int T>
__device__ __forceinline__ void mma_step(Acc<T> (&acc)[4][4][4],
                                         const uint32_t* A, int lda,
                                         const uint32_t* B, int kw, int wm,
                                         int wn, int lane) {
  uint32_t b[4][2];
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    uint32_t r[4];  // b0, b1 of n-tile j, then of j + 1
    ldsm_x4(r, B + (wn * 32 + (j + (lane >> 4)) * 8 + (lane & 7)) * kLd + kw +
                   ((lane >> 3) & 1) * 4);
    b[j][0] = r[0];
    b[j][1] = r[1];
    b[j + 1][0] = r[2];
    b[j + 1][1] = r[3];
  }
  // a0..a3 of m-tile i: rows 0-7 and 8-15, words 0-3, then 4-7
  const uint32_t* pa = A + (wm * 64 + (lane & 15)) * lda + kw + (lane >> 4) * 4;
  if constexpr (T == kF32) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) tf32_split(b[j][k], bh[j][k], bl[j][k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a[4], ah[4], al[4];
      ldsm_x4(a, pa + i * 16 * lda);
#pragma unroll
      for (int k = 0; k < 4; ++k) tf32_split(a[k], ah[k], al[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(acc[i][j], al, bh[j]);
        mma_tf32(acc[i][j], ah, bl[j]);
        mma_tf32(acc[i][j], ah, bh[j]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a[4];
      ldsm_x4(a, pa + i * 16 * lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (T == kBF16)
          mma_bf16(acc[i][j], a, b[j]);
        else
          mma_s8(acc[i][j], a, b[j]);
      }
    }
  }
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <int T>
__device__ __forceinline__ float rnd(float x) {
  return T == kBF16 ? bf16r(x) : x;
}

// Two neighbouring values of a [n, W] tensor of the compute type.
template <int T>
__device__ __forceinline__ void load2(const void* base, size_t o, float (&v)[2]) {
  if constexpr (T == kBF16) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(base) + o));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(
        static_cast<const float*>(base) + o);
    v[0] = f.x;
    v[1] = f.y;
  }
}
template <int T>
__device__ __forceinline__ void store2(void* base, size_t o, const float (&v)[2]) {
  if constexpr (T == kBF16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) + o) =
        __floats2bfloat162_rn(v[0], v[1]);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(base) + o) =
        make_float2(v[0], v[1]);
}

// The bf16/f32 epilogue of outputs (row, col) and (row, col + 1).
template <int T>
__device__ __forceinline__ void epilogue_float(const Params& p, int row,
                                               int col, float a0, float a1) {
  const size_t o = (size_t)row * p.W + col;
  const float2 b = *reinterpret_cast<const float2*>(p.bias + col);
  float v[2] = {__fadd_rn(a0, b.x), __fadd_rn(a1, b.y)};
  if (p.kind == kInner) {
    for (int k = 0; k < 2; ++k) v[k] = rnd<T>(fmaxf(v[k], 0.f));
    store2<T>(p.out, o, v);
    return;
  }
  float h0[2];
  if (p.kind == kHead) {
    for (int k = 0; k < 2; ++k) v[k] = h0[k] = rnd<T>(fmaxf(v[k], 0.f));
    if (p.use_residual) store2<T>(p.h0, o, v);
  } else {
    float h[2];
    load2<T>(p.hin, o, h);
    for (int k = 0; k < 2; ++k)
      v[k] = rnd<T>(__fadd_rn(__fmul_rn(rnd<T>(v[k]), p.res_scale), h[k]));
    if (p.final_ && p.use_residual) load2<T>(p.h0, o, h0);
  }
  if (p.final_ && p.use_residual)
    for (int k = 0; k < 2; ++k) v[k] = rnd<T>(__fadd_rn(v[k], h0[k]));
  store2<T>(p.hout, o, v);
}

// The int8 epilogue (K2's, by form) of outputs (row, col), (row, col + 1):
// the residual stream h in bf16, h0 in f32, and the codes the next product
// (or the tail) reads.
__device__ __forceinline__ void epilogue_s8(const Params& p, int row, int col,
                                            int a0, int a1) {
  const size_t o = (size_t)row * p.W + col;
  const float4 mb = *reinterpret_cast<const float4*>(p.bias + 2 * col);
  const float v[2] = {r2l::dequant(a0, mb.x, mb.y),
                      r2l::dequant(a1, mb.z, mb.w)};
  float x[2];  // what the next product quantizes, times its scale
  if (p.kind == kInner) {
    for (int k = 0; k < 2; ++k) {
      const float r = fmaxf(v[k], 0.f);
      const float t = p.epilogue == kDeployed ? r : bf16r(r);
      x[k] = p.epilogue == kUnfolded ? __fmul_rn(t, p.inv[col + k]) : t;
    }
  } else {
    float h[2], h0[2];
    if (p.kind == kHead) {
      for (int k = 0; k < 2; ++k) {
        h0[k] = fmaxf(v[k], 0.f);
        h[k] = bf16r(h0[k]);
      }
      if (p.use_residual)
        *reinterpret_cast<float2*>(static_cast<float*>(p.h0) + o) =
            make_float2(h0[0], h0[1]);
    } else {
      float hin[2];
      load2<kBF16>(p.hin, o, hin);
      for (int k = 0; k < 2; ++k) h[k] = bf16r(__fadd_rn(bf16r(v[k]), hin[k]));
      if (p.final_ && p.use_residual) load2<kF32>(p.h0, o, h0);
    }
    if (!p.final_) store2<kBF16>(p.hout, o, h);
    for (int k = 0; k < 2; ++k) {
      const float hf = p.final_ && p.use_residual ? __fadd_rn(h[k], h0[k])
                                                  : h[k];
      x[k] = __fmul_rn(hf, p.inv[col + k]);
    }
  }
  const char2 q = make_char2(r2l::q8(x[0]), r2l::q8(x[1]));
  *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + o) = q;
}

// One pass: the block's 128 rays x 128 output channels of one layer.
template <int T, int S>
__global__ void __launch_bounds__(kThreads) wide_layer(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int es = elem_bytes(T);
  constexpr int a_words = S == kBody ? kStages * kBM * kLd : kBM * kLdSlice;
  uint32_t* sA = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sB = sA + a_words;
  const int ntn = p.W / kBN;
  const int mt = blockIdx.x / ntn, nt = blockIdx.x - mt * ntn;
  const int row0 = mt * kBM, col0 = nt * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int KT = p.Kb / 128;  // stages over K
  const unsigned char* wt = p.w + (size_t)nt * KT * kTileBytes;

  auto load_stage = [&](int slot, int kt) {
    const unsigned char* bs = wt + (size_t)kt * kTileBytes;
    unsigned char* bd = reinterpret_cast<unsigned char*>(sB + slot * kBN * kLd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      r2l::cp_async16(bd + (c >> 3) * kLd * 4 + (c & 7) * 16, bs + c * 16);
    }
    if constexpr (S == kBody) {
      const unsigned char* a = static_cast<const unsigned char*>(p.a);
      unsigned char* ad =
          reinterpret_cast<unsigned char*>(sA + slot * kBM * kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = tid + i * kThreads, r = c >> 3;
        const int g = min(row0 + r, p.n - 1);  // rows past n: read, unused
        r2l::cp_async16(ad + r * kLd * 4 + (c & 7) * 16,
                        a + (size_t)g * p.Kb + (size_t)kt * 128 + (c & 7) * 16);
      }
    }
  };

  // The head's input, columns [c0, c0 + sw) of the block's rays, into the
  // slice: K1/K2 by the ladder (freq-major: column part * dp + s is part
  // `part` of scalar s: sin octave part, cos octave part - L, or the
  // identity), K9 from x; zero past in_dim.
  auto produce_slice = [&](int w0) {
    const int c0 = w0 * 4 / es;
    const int sw = min(kSliceW * 4 / es, p.Kb / es - c0);
    auto put = [&](int r, int c, float x) {
      unsigned char* row = reinterpret_cast<unsigned char*>(sA + r * kLdSlice);
      if constexpr (T == kBF16)
        reinterpret_cast<__nv_bfloat16*>(row)[c] = __float2bfloat16_rn(x);
      else if constexpr (T == kF32)
        reinterpret_cast<float*>(row)[c] = x;
      else
        reinterpret_cast<int8_t*>(row)[c] =
            r2l::q8(__fmul_rn(x, p.head_inv[c0 + c]));
    };
    auto zero = [&](int r, int c) {
      unsigned char* row = reinterpret_cast<unsigned char*>(sA + r * kLdSlice);
      for (int b = 0; b < es; ++b) row[c * es + b] = 0;
    };
    if constexpr (S == kPE) {
      const int P = 2 * p.L + 1;
      const int p_lo = c0 / p.dp, p_hi = min((c0 + sw - 1) / p.dp, P - 1);
      int jmax = -1;  // the highest octave the slice holds
      if (p_lo < p.L) jmax = min(p_hi, p.L - 1);
      if (p_hi >= p.L) jmax = max(jmax, min(p_hi - p.L, p.L - 1));
      const bool ident = p_hi == P - 1;
      for (int e = tid; e < kBM * p.dp; e += kThreads) {
        const int r = e / p.dp, s = e - r * p.dp, g = row0 + r;
        const float v = g < p.n ? __ldg(p.in + (size_t)g * p.dp + s) : 0.f;
        auto emit = [&](int part, float x) {
          const int c = part * p.dp + s - c0;
          if (c >= 0 && c < sw) put(r, c, x);
        };
        if (jmax >= 0)
          r2l::pe_ladder(v, jmax + 1, [&](int j, float sn, float cs) {
            emit(j, sn);
            emit(p.L + j, cs);
          });
        if (ident) emit(2 * p.L, v);
      }
      const int z0 = max(min(p.in_dim - c0, sw), 0), nz = sw - z0;
      for (int e = tid; e < kBM * nz; e += kThreads) {
        const int r = e / nz;
        zero(r, z0 + e - r * nz);
      }
    } else {
      for (int e = tid; e < kBM * sw; e += kThreads) {
        const int r = e / sw, c = e - r * sw, g = row0 + r, col = c0 + c;
        if (g < p.n && col < p.in_dim)
          put(r, c, __ldg(p.in + (size_t)g * p.in_dim + col));
        else
          zero(r, c);
      }
    }
  };

  Acc<T> acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    r2l::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    r2l::cp_async_wait_prior();  // stage kt has landed (three slots)
    __syncthreads();             // and every warp is done with kt - 1
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk);
    r2l::cp_async_commit();
    const uint32_t* A;
    int lda;
    if constexpr (S == kBody) {
      A = sA + (kt % kStages) * kBM * kLd;
      lda = kLd;
    } else {
      const int sl = kt % (kSliceW / kBKW);
      if (sl == 0) {
        produce_slice(kt * kBKW);
        __syncthreads();
      }
      A = sA + sl * kBKW;
      lda = kLdSlice;
    }
    const uint32_t* B = sB + (kt % kStages) * kBN * kLd;
#pragma unroll
    for (int kw = 0; kw < kBKW; kw += 8)
      mma_step<T>(acc, A, lda, B, kw, wm, wn, lane);
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= p.n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn * 32 + j * 8 + 2 * t;
        if constexpr (T == kS8) {
          epilogue_s8(p, row, col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          epilogue_float<T>(p, row, col, acc[i][j][2 * h],
                            acc[i][j][2 * h + 1]);
        }
      }
    }
}

// The tail: out[r, o] = sigmoid(h[r] . tail_w[o] + tail_b[o]) (int8: the
// codes' exact int32 dot, dequantized by one FMA); a warp a ray, 16 bytes a
// lane a step, the sums reduced by shuffles. bf16/f32 with h0 (K3): the
// input is h + h0 rounded to T (the global residual of the stash's rows).
template <int T>
__global__ void __launch_bounds__(256)
    wide_tail(const void* h, int n, int W, const void* tw, const float* tm,
              const float* tb, int out_dim, int linear_tail, float* out,
              const void* h0 = nullptr) {
  constexpr int es = elem_bytes(T), per = 16 / es;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;
  Acc<T> acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0;
  const unsigned char* hr = static_cast<const unsigned char*>(h) +
                            (size_t)row * W * es;
  const unsigned char* wb = static_cast<const unsigned char*>(tw);
  for (int c = lane * per; c < W; c += 32 * per) {
    const uint4 hv = *reinterpret_cast<const uint4*>(hr + (size_t)c * es);
    uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
    if constexpr (T != kS8) {
      if (h0) {
        const uint4 gv = *reinterpret_cast<const uint4*>(
            static_cast<const unsigned char*>(h0) + ((size_t)row * W + c) * es);
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (T == kBF16) {
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&gw[k]));
            const __nv_bfloat162 r = __floats2bfloat162_rn(
                __fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
            hw[k] = *reinterpret_cast<const uint32_t*>(&r);
          } else {
            hw[k] = __float_as_uint(__fadd_rn(__uint_as_float(hw[k]),
                                              __uint_as_float(gw[k])));
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o >= out_dim) break;
      const uint4 wv = *reinterpret_cast<const uint4*>(
          wb + ((size_t)o * W + c) * es);
      const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (T == kS8) {
          acc[o] = __dp4a(static_cast<int>(hw[k]), static_cast<int>(ww[k]),
                          acc[o]);
        } else if constexpr (T == kBF16) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ww[k]));
          acc[o] = fmaf(a.x, b.x, acc[o]);
          acc[o] = fmaf(a.y, b.y, acc[o]);
        } else {
          acc[o] = fmaf(__uint_as_float(hw[k]), __uint_as_float(ww[k]),
                        acc[o]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o)
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], m);
  if (lane == 0)
    for (int o = 0; o < out_dim; ++o) {
      float y;
      if constexpr (T == kS8)
        y = r2l::dequant(acc[o], tm[o], tb[o]);
      else
        y = __fadd_rn(acc[o], tb[o]);
      out[(size_t)row * out_dim + o] = linear_tail ? y : r2l::sigmoid(y);
    }
}

// Everything a call needs (the C entry point's arguments).
struct Chain {
  const float* in;   // pe: pts [n, dp]; else x [n, in_dim]
  int n, dp, L, in_dim, pe;
  const unsigned char* image;  // stage_wide_chain's
  const float* head_b;         // bf16/f32 [W]
  const float* body_b;         // bf16/f32 [nb * nl, W]
  const float* head_inv;       // int8 [in_dim]
  const float* body_inv;       // int8 [nb * nl, W]
  const void* tail_w;          // [out_dim, W], the weight type (int8: codes)
  const float* tail_m;         // int8 [out_dim]
  const float* tail_b;         // [out_dim]
  const float* tail_inv;       // int8 [W]
  float* out;                  // [n, out_dim]
  unsigned char* scratch;
  long long scratch_bytes;
  int rows;                    // rays a pass (0: all)
  int W, nb, nl, out_dim;
  float res_scale;
  int use_residual, linear_tail, epilogue;
};

__host__ __device__ constexpr long long aligned(long long b) {
  return (b + 255) / 256 * 256;
}

// The scratch a call of `rows` rays a pass needs (r2l_fused.py,
// wide_scratch_bytes): bf16/f32 two h, min(nl - 1, 2) t and h0 of the
// compute type; int8 two code buffers, two bf16 h and an f32 h0.
template <int T>
long long scratch_bytes(long long rows, int W, int nl, int use_residual) {
  const long long e = rows * W;
  if (T == kS8)
    return 2 * aligned(e) + 2 * aligned(2 * e) +
           (use_residual ? aligned(4 * e) : 0);
  const int bufs = 2 + (nl - 1 < 2 ? nl - 1 : 2) + (use_residual ? 1 : 0);
  return bufs * aligned(e * elem_bytes(T));
}

template <int T, int S>
cudaError_t pass(const Params& p, cudaStream_t st) {
  constexpr int smem =
      ((S == kBody ? kStages * kBM * kLd : kBM * kLdSlice) +
       kStages * kBN * kLd) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      wide_layer<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((p.n + kBM - 1) / kBM) * (p.W / kBN);
  wide_layer<T, S><<<(unsigned)blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// The head, nb * nl body passes and the tail, over the rays in passes of
// c.rows.
template <int T>
cudaError_t run(const Chain& c, cudaStream_t st) {
  constexpr int es = elem_bytes(T);
  const int W = c.W, nbl = c.nb * c.nl;
  const int rows = c.rows > 0 && c.rows < c.n ? c.rows : c.n;
  if (c.scratch_bytes < scratch_bytes<T>(rows, W, c.nl, c.use_residual))
    return cudaErrorInvalidValue;
  const int kpad = r2l::round_up(c.in_dim, r2l::kKAlign);
  const size_t head_bytes = (size_t)W * kpad * es;
  const size_t layer_bytes = (size_t)W * W * es;
  const float* table = reinterpret_cast<const float*>(
      c.image + head_bytes + nbl * layer_bytes);
  // the scratch's buffers
  unsigned char* s = c.scratch;
  const long long e = (long long)rows * W;
  void *H[2], *X[2] = {nullptr, nullptr}, *H0 = nullptr;
  if (T == kS8) {
    for (int i = 0; i < 2; ++i, s += aligned(e)) X[i] = s;  // the codes
    for (int i = 0; i < 2; ++i, s += aligned(2 * e)) H[i] = s;
    if (c.use_residual) H0 = s;
  } else {
    for (int i = 0; i < 2; ++i, s += aligned(e * es)) H[i] = s;
    for (int i = 0; i < 2 && i < c.nl - 1; ++i, s += aligned(e * es))
      X[i] = s;  // t
    if (c.use_residual) H0 = s;
  }
  const int in_w = c.pe ? c.dp : c.in_dim;
  for (int r0 = 0; r0 < c.n; r0 += rows) {
    Params p{};
    p.n = c.n - r0 < rows ? c.n - r0 : rows;
    p.W = W;
    p.res_scale = c.res_scale;
    p.use_residual = c.use_residual;
    p.epilogue = c.epilogue;
    p.h0 = H0;
    // the head
    Params hp = p;
    hp.Kb = kpad * es;
    hp.w = c.image;
    hp.in = c.in + (size_t)r0 * in_w;
    hp.dp = c.dp;
    hp.L = c.L;
    hp.in_dim = c.in_dim;
    hp.head_inv = c.head_inv;
    hp.bias = T == kS8 ? table : c.head_b;
    hp.kind = kHead;
    hp.final_ = c.nb == 0;
    hp.hout = H[0];
    hp.out = X[0];
    hp.inv = c.nb > 0 ? c.body_inv : c.tail_inv;
    cudaError_t err;
    if constexpr (T == kS8)
      err = pass<T, kPE>(hp, st);  // K2 encodes its points
    else
      err = c.pe ? pass<T, kPE>(hp, st) : pass<T, kX>(hp, st);
    if (err != cudaSuccess) return err;
    int cur = 0, q = 0;  // h's and (int8) the codes' buffer
    for (int b = 0; b < c.nb; ++b)
      for (int j = 0; j < c.nl; ++j) {
        const int idx = b * c.nl + j;
        const bool last = j == c.nl - 1;
        Params lp = p;
        lp.Kb = W * es;
        lp.w = c.image + head_bytes + idx * layer_bytes;
        lp.bias = T == kS8 ? table + 2 * (size_t)W * (1 + idx)
                           : c.body_b + (size_t)idx * W;
        lp.kind = last ? kBlockEnd : kInner;
        lp.final_ = last && b == c.nb - 1;
        if (T == kS8) {
          lp.a = X[q];
          lp.out = X[q ^ 1];
          lp.inv = lp.final_ ? c.tail_inv : c.body_inv + (size_t)(idx + 1) * W;
        } else {
          lp.a = j == 0 ? H[cur] : X[(j - 1) & 1];
          lp.out = last ? nullptr : X[j & 1];
        }
        if (last) {
          lp.hin = H[cur];
          lp.hout = H[cur ^ 1];
        }
        err = pass<T, kBody>(lp, st);
        if (err != cudaSuccess) return err;
        if (last) cur ^= 1;
        if (T == kS8) q ^= 1;
      }
    wide_tail<T><<<(p.n + 7) / 8, 256, 0, st>>>(
        T == kS8 ? X[q] : H[cur], p.n, W, c.tail_w, c.tail_m, c.tail_b,
        c.out_dim, c.linear_tail, c.out + (size_t)r0 * c.out_dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace r2lw
