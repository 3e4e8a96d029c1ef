// Pieces shared by the fused NeRF teacher kernels (nerf_render.cu, K6, and
// nerf_render_int8.cu, K7): the arguments, the shared-memory plan, the
// per-ray state, the teacher's positional-encoding ladder, the point and
// view-direction encodings, and the alpha compositing.
//
// A block owns R rays and walks their samples in groups of kG: the R*kG
// points of a group (TT rows, row r = ray r/kG, sample g0 + r%kG) go through
// the whole MLP together, then one thread per ray composites its kG samples
// in order, carrying transmittance, rgb, acc and depth in shared memory from
// group to group. Nothing carries across blocks.
#pragma once

#include "r2l_engines.cuh"

namespace nerf {

using namespace r2l;

constexpr int kG = 8;  // samples of each ray in one group

// Everything a launch needs, passed by value (the kernel parameter space).
struct Args {
  const float* rays_o;  // [n, 3]
  const float* rays_d;  // [n, 3]
  const float* z;       // [n, S], sorted along each ray
  int n, S;
  const void* pts_w;    // the D layers' [W, K_i] rows, one after another
  const float* pts_m;   // [D, W] (int8)
  const float* pts_b;   // [D, W]
  const float* pe_inv;  // [kp] (int8)
  const float* pts_inv; // [D, W]: row i, inverse scale of layer i's h input
  int D, skips;         // skips: bit i set if layer i's output is concatenated
  const void* alpha_w;  // [W]
  const float* alpha_m;
  const float* alpha_b;
  const void* feat_w;   // [W, W]
  const float* feat_m;
  const float* feat_b;
  const float* h_inv;   // [W]
  const void* views_w;  // [W/2, kv]
  const float* views_m;
  const float* views_b;
  const float* hv_inv;  // [kv]
  const void* rgb_w;    // [3, W/2]
  const float* rgb_m;
  const float* rgb_b;
  const float* hr_inv;  // [W/2]
  const void* out_w;    // [4, W]
  const float* out_m;
  const float* out_b;
  int Lp, Lv, viewdirs, white, fold;
  float* rgb;           // [n, 3]
  float* acc;           // [n]
  float* depth;         // [n]
  float* weights;       // [n, S]
  // layout, set by plan()
  int kp, kv, lds, ldh;
  int off_h, off_ws, off_out, off_ray, off_vpe, smem;
};

// One ray's state, in shared memory.
struct Ray {
  float o[3], d[3], dn, trans, rgb[3], acc, depth, pad;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) / 16 * 16; }

// Shared memory, in order: S [TT][lds] (the point encoding, then
// [encoding | h] for the layer after a skip, then [feature | view
// encoding] for the view layer), H [TT][ldh] (the activations), the weight
// stages, the rgb logits and sigma [TT][4] f32, the rays, and each ray's view
// encoding [R][kv - W]. Widths are in elements of size `es`.
inline void plan(Args& a, int W, int TT, int es, int stage_bytes) {
  const int per_word = 4 / es;
  a.kp = round_up(3 + 6 * a.Lp, 64);
  a.kv = a.viewdirs ? round_up(W + 3 + 6 * a.Lv, 64) : 0;
  const int cols = a.kp + W > a.kv ? a.kp + W : a.kv;
  a.lds = ld_words(cols * es) * per_word;
  a.ldh = ld_words(W * es) * per_word;
  const int R = TT / kG;
  a.off_h = align16(TT * a.lds * es);
  a.off_ws = a.off_h + align16(TT * a.ldh * es);
  a.off_out = a.off_ws + stage_bytes;
  a.off_ray = a.off_out + align16(TT * 4 * 4);
  a.off_vpe = a.off_ray + align16(R * (int)sizeof(Ray));
  a.smem = a.off_vpe + align16(R * (a.kv ? a.kv - W : 0) * es);
}

// sin/cos of p * 2^j for j in [0, L) by the teacher kernel's double-angle
// ladder (nerf_render_pallas.py:460-474): sin 2x = (2 sin x) cos x,
// cos 2x = (cos x - sin x)(cos x + sin x), each step rounded on its own, so
// the result matches the plain PyTorch version bit for bit.
template <typename Emit>
__device__ __forceinline__ void ladder(float p, int L, Emit emit) {
  float s = sinf(p), c = cosf(p);
  for (int j = 0; j < L; ++j) {
    emit(j, s, c);
    const float ns = __fmul_rn(__fmul_rn(2.0f, s), c);
    c = __fmul_rn(__fsub_rn(c, s), __fadd_rn(c, s));
    s = ns;
  }
}

// Encode value v into columns [k, 3+6j+k (sin), 6+6j+k (cos)] of a row
// through store(col, value).
template <typename Store>
__device__ __forceinline__ void encode(float v, int k, int L, Store store) {
  store(k, v);
  ladder(v, L, [&](int j, float s, float c) {
    store(3 + 6 * j + k, s);
    store(6 + 6 * j + k, c);
  });
}

template <int R>
__device__ void init_rays(const Args& a, int ray0, Ray* ray) {
  for (int t = threadIdx.x; t < R; t += kThreads) {
    Ray& r = ray[t];
    const int i = ray0 + t;
    const bool ok = i < a.n;
    for (int k = 0; k < 3; ++k) {
      r.o[k] = ok ? a.rays_o[3 * i + k] : 0.f;
      r.d[k] = ok ? a.rays_d[3 * i + k] : 0.f;
    }
    // |d| with the sum of squares contracted, as XLA computes it
    const float x2 = __fmul_rn(r.d[0], r.d[0]);
    r.dn = sqrtf(__fmaf_rn(r.d[2], r.d[2], __fmaf_rn(r.d[1], r.d[1], x2)));
    r.trans = 1.f;
    r.rgb[0] = r.rgb[1] = r.rgb[2] = 0.f;
    r.acc = r.depth = 0.f;
  }
}

// Each ray's view-direction encoding d/max(|d|, 1e-12), L = Lv, into
// store(t, col, value) for ray t, columns up to 3+6Lv; store(t, col, 0) for
// the padding up to `width`.
template <int R, typename Store>
__device__ void encode_views(const Args& a, const Ray* ray, int width,
                             Store store) {
  const int used = 3 + 6 * a.Lv;
  for (int e = threadIdx.x; e < R * 3; e += kThreads) {
    const int t = e / 3, k = e % 3;
    const float v = ray[t].d[k] / fmaxf(ray[t].dn, 1e-12f);
    encode(v, k, a.Lv, [&](int c, float x) { store(t, c, x); });
  }
  for (int e = threadIdx.x; e < R * (width - used); e += kThreads)
    store(e / (width - used), used + e % (width - used), 0.f);
}

// The points o + d*z (one FMA per coordinate) of group g0 and their
// encoding into store(r, col, value), L = Lp, with zeros in the padding up
// to kp. Rows past the last sample or ray take z = 0 (a finite point that is
// never composited).
template <int TT, typename Store>
__device__ void encode_points(const Args& a, const Ray* ray, int ray0, int g0,
                              Store store) {
  for (int e = threadIdx.x; e < TT * 3; e += kThreads) {
    const int r = e / 3, k = e % 3, t = r / kG, s = g0 + r % kG;
    const bool ok = ray0 + t < a.n && s < a.S;
    const float z = ok ? a.z[(size_t)(ray0 + t) * a.S + s] : 0.f;
    const float p = __fmaf_rn(ray[t].d[k], z, ray[t].o[k]);
    encode(p, k, a.Lp, [&](int c, float x) { store(r, c, x); });
  }
  const int used = 3 + 6 * a.Lp, pad = a.kp - used;
  for (int e = threadIdx.x; e < TT * pad; e += kThreads)
    store(e / pad, used + e % pad, 0.f);
}

// raw2outputs for the kG samples of group g0, in order, one thread per ray:
// alpha = 1 - exp(-relu(sigma) * dist), dist to the next sample (1e10 past
// the last) times |d|; w = alpha * T; rgb += w * sigmoid(logits), acc += w,
// depth += w * z (the two sums as FMAs, as XLA contracts them); T *= 1 -
// alpha + 1e-10. Writes each weight. out4 [TT][4]
// holds each row's rgb logits and sigma.
template <int R>
__device__ void composite(const Args& a, Ray* ray, int ray0, int g0,
                          const float* out4) {
  for (int t = threadIdx.x; t < R; t += kThreads) {
    const int i = ray0 + t;
    if (i >= a.n) continue;
    Ray& r = ray[t];
    const float* zr = a.z + (size_t)i * a.S;
    for (int u = 0; u < kG && g0 + u < a.S; ++u) {
      const int s = g0 + u, row = t * kG + u;
      const float z = zr[s];
      const float zn = s + 1 < a.S ? zr[s + 1] : __fadd_rn(z, 1e10f);
      const float dist = __fmul_rn(__fsub_rn(zn, z), r.dn);
      const float alpha =
          __fsub_rn(1.f, expf(__fmul_rn(-fmaxf(out4[4 * row + 3], 0.f), dist)));
      const float w = __fmul_rn(alpha, r.trans);
      a.weights[(size_t)i * a.S + s] = w;
      for (int k = 0; k < 3; ++k)
        r.rgb[k] = __fmaf_rn(w, sigmoid(out4[4 * row + k]), r.rgb[k]);
      r.acc = __fadd_rn(r.acc, w);
      r.depth = __fmaf_rn(w, z, r.depth);
      r.trans = __fmul_rn(r.trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
    }
  }
}

// Write each ray's rgb (+ 1 - acc on a white background), acc and depth.
template <int R>
__device__ void finish(const Args& a, const Ray* ray, int ray0) {
  for (int t = threadIdx.x; t < R; t += kThreads) {
    const int i = ray0 + t;
    if (i >= a.n) continue;
    const Ray& r = ray[t];
    for (int k = 0; k < 3; ++k)
      a.rgb[3 * i + k] =
          a.white ? __fadd_rn(r.rgb[k], __fsub_rn(1.f, r.acc)) : r.rgb[k];
    a.acc[i] = r.acc;
    a.depth[i] = r.depth;
  }
}

}  // namespace nerf
