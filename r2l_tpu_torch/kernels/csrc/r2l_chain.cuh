// The R2L forward chain shared by K1 (r2l_pe_fused.cu, positional encoding
// in the kernel) and K9 (r2l_fused.cu, the encoded input read from device
// memory): head Linear+ReLU -> nb ResMLP blocks (nl Linear layers with ReLU
// between, x res_scale, + block input) -> global residual -> Linear+sigmoid
// tail, on a tile of TT rays whose input X [TT][ldx] (kpad columns, the
// padding zero) is already in shared memory.
//
// Rounding follows the Pallas `_kernel_body`: activations are rounded to the
// weight type between layers, dots accumulate in f32, biases are added in
// f32 before the rounding (not as in `apply_r2l`, which rounds the dot
// first), and the block output is (t * res_scale + h) in f32 from the
// rounded t.
//
// Shared memory: region 0 holds X, then (aliasing it once the head has
// consumed it) h0, h and one or two inner activations [TT][ldb] each; the
// weight stages follow at byte `region`. Weights, packed [out, in], are
// read one layer at a time from global memory (the canonical body stays
// resident in the 50 MB L2 across blocks). Only [TT, out_dim] f32 is
// written back.
#pragma once

#include "r2l_engines.cuh"

namespace r2l {

template <typename T>
struct ChainParams {
  const T* __restrict__ head_w;
  const float* __restrict__ head_b;
  const T* __restrict__ body_w;
  const float* __restrict__ body_b;
  const T* __restrict__ tail_w;
  const float* __restrict__ tail_b;
  float* __restrict__ out;
  int n, nb, nl, out_dim;
  float res_scale;
  int use_residual, linear_tail;
};

// Row strides (elements) and shared-memory bytes of a tile.
struct ChainLayout {
  int ldx, ldb;
  size_t region, smem;
};

template <typename E, int W, int TT>
ChainLayout chain_layout(int kpad, int nl) {
  using T = typename E::T;
  constexpr int per_word = 4 / sizeof(T);
  ChainLayout c;
  c.ldx = ld_words(kpad * sizeof(T)) * per_word;
  c.ldb = ld_words(W * sizeof(T)) * per_word;
  const size_t nbuf = nl >= 3 ? 4 : 3;
  const size_t x_bytes = (size_t)TT * c.ldx * sizeof(T);
  const size_t buf_bytes = nbuf * TT * c.ldb * sizeof(T);
  c.region = x_bytes > buf_bytes ? x_bytes : buf_bytes;
  c.smem = c.region + E::kStageBytes;
  return c;
}

// The chain over the tile of rays row0.. whose input is X (at the start of
// smem). Every thread of the block calls it after writing its part of X.
template <typename E, int W, int TT>
__device__ __forceinline__ void r2l_chain(unsigned char* smem,
                                          const ChainParams<typename E::T>& p,
                                          int kpad, int ldx, int ldb,
                                          size_t region, int row0) {
  using T = typename E::T;
  T* X = reinterpret_cast<T*>(smem);
  T* H0 = X;
  T* H = X + TT * ldb;
  T* B1 = X + 2 * TT * ldb;
  T* B2 = X + 3 * TT * ldb;
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + region);

  typename E::Acc acc;
  E::mm(acc, X, ldx, p.head_w, kpad, Ws);
  E::visit(acc, [&](int r, int c, float v) {
    const T h = st<T>(fmaxf(__fadd_rn(v, p.head_b[c]), 0.f));
    H0[r * ldb + c] = h;
    H[r * ldb + c] = h;
  });

  for (int blk = 0; blk < p.nb; ++blk) {
    T* src = H;
    for (int j = 0; j < p.nl; ++j) {
      const int idx = blk * p.nl + j;
      E::mm(acc, src, ldb, p.body_w + (size_t)idx * W * W, W, Ws);
      const float* b = p.body_b + (size_t)idx * W;
      if (j < p.nl - 1) {  // inner layer: ReLU, round to T
        T* dst = src == B1 ? B2 : B1;
        E::visit(acc, [&](int r, int c, float v) {
          dst[r * ldb + c] = st<T>(fmaxf(__fadd_rn(v, b[c]), 0.f));
        });
        src = dst;
      } else {  // block tail: round, then (t * res_scale + h) in f32
        T* dst = src == H ? B1 : H;  // in place unless H is the input
        E::visit(acc, [&](int r, int c, float v) {
          const float tv = rnd<T>(__fadd_rn(v, b[c]));
          dst[r * ldb + c] = st<T>(
              __fadd_rn(__fmul_rn(tv, p.res_scale), ld<T>(H[r * ldb + c])));
        });
        if (dst != H) {
          B1 = H;
          H = dst;
        }
      }
    }
  }
  __syncthreads();

  if (p.use_residual) {
    for (int e = threadIdx.x; e < TT * W; e += kThreads) {
      const int i = (e / W) * ldb + e % W;
      H[i] = st<T>(__fadd_rn(ld<T>(H[i]), ld<T>(H0[i])));
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < TT * p.out_dim; e += kThreads) {
    const int r = e % TT, o = e / TT, g = row0 + r;
    float s = 0.f;
    for (int k = 0; k < W; ++k)
      s = fmaf(ld<T>(H[r * ldb + k]), ld<T>(p.tail_w[o * W + k]), s);
    float v = __fadd_rn(s, p.tail_b[o]);
    if (!p.linear_tail) v = sigmoid(v);
    if (g < p.n) p.out[(size_t)g * p.out_dim + o] = v;
  }
}

}  // namespace r2l
