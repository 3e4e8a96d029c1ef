// The Hopper skeleton of the fused NeRF teacher kernels (nerf_render.cu,
// K6, f32 or bf16 weights; nerf_render_int8.cu, K7, int8): one kernel
// template over the weight type T.
//
// Work: a block owns R rays (16 for bf16 and int8, 8 for f32) and walks
// their samples eight at a time. The R*8 points of a group go through the
// whole network together, then each ray's eight samples are composited in
// order; transmittance, rgb, acc and depth carry over in shared memory from
// group to group. Nothing carries across clusters.
//
// Threads: warp-specialised. One or two consumer warpgroups each own 64
// points (8 rays x 8 samples, wgmma's M) and their activations, in shared
// memory; one producer warpgroup, of which one thread copies the weights,
// gives its registers to the consumers (setmaxnreg).
//
// Weights: packed once per model (nerf_render.py, stage_weights) into a
// staged image, each layer cut into stages of KS input channels for all its
// outputs, each stage laid out exactly as wgmma reads B from shared memory
// (K-major 8x16-byte core matrices, no swizzle), so that one 1-D bulk copy
// (cp.async.bulk, completing on an mbarrier) moves it. A ring of kStages
// stages with a full and an empty barrier each runs without a break across
// layers, heads and groups. Two blocks form a cluster: each producer copies
// half of every stage into both blocks (.multicast::cluster), so a stage is
// read from L2 once per cluster; a slot is refilled when the consumers of
// both blocks released it (remote mbarrier arrives). A block with no rays
// takes part in every stage to the end.
//
// Products: bf16 wgmma m64nNk16 (f32 sums) and int8 m64nNk32 (exact s32
// sums) with both operands in shared memory, A being the activations that
// the previous epilogue wrote in the core-matrix layout. f32: 3xTF32, each
// operand split once into a high and a low TF32 part (the weights at
// packing, the activations in registers), a_hi w_lo + a_lo w_hi + a_hi w_hi
// summed in f32 by wgmma m64nNk8 tf32 with A from registers. The layer
// after a skip reads [encoding | h], the view layer [feature | view
// encoding], each as two k-ranges of one accumulation.
//
// Epilogues run on the accumulator registers: bias (int8: the one-FMA
// dequantize), ReLU, the cast or requantize, stored for the next product.
// The heads (sigma W->1, rgb W/2->3, output_linear W->4) are dot products of
// the values just stored with the head weights: each thread's partial sum
// over its columns, then two quad shuffles (an accumulator row's columns
// lie in one quad). Compositing is one thread per ray, the operations of
// volume.raw2outputs in order, after a barrier of the warpgroup alone.
//
// The ring, the bulk copies, the products and the launch are
// hopper_ring.cuh's, shared with the student's chain (r2l_hopper.cuh).
#pragma once

#include "hopper_ring.cuh"
#include "r2l_common.cuh"

namespace nerf {

using namespace hopper;
using r2l::dequant;
using r2l::q8;
using r2l::round_up;
using r2l::sigmoid;

constexpr int kG = 8;      // samples of each ray in one group

// Everything a launch needs, passed by value (the kernel parameter space).
struct Args {
  const float* rays_o;  // [n, 3]
  const float* rays_d;  // [n, 3]
  const float* z;       // [n, S], sorted along each ray
  int n, S;
  const unsigned char* staged;  // the staged image (stage_weights)
  const float* pts_m;   // [D, W] (int8)
  const float* pts_b;   // [D, W]
  const float* pe_inv;  // [kp] (int8)
  const float* pts_inv; // [D, W]: row i, inverse scale of layer i's h input
  int D, skips;         // skips: bit i set if layer i's output is concatenated
  const float* alpha_m;
  const float* alpha_b;
  const float* feat_m;
  const float* feat_b;
  const float* h_inv;   // [W]
  const float* views_m;
  const float* views_b;
  const float* hv_inv;  // [kv]
  const float* rgb_m;
  const float* rgb_b;
  const float* hr_inv;  // [W/2]
  const float* out_m;
  const float* out_b;
  int Lp, Lv, viewdirs, white, fold;
  float* rgb;           // [n, 3]
  float* acc;           // [n]
  float* depth;         // [n]
  float* weights;       // [n, S]
  // layout, set by plan()
  int kp, kpe;     // point-encoding width, and as staged (a multiple of KS)
  int kvw, kve;    // view-encoding width kv - W, and as staged
  int heads_off;   // byte offset of the head weights in the staged image
  int epi_off;     // int8: byte offset of its (m, b) pair table
  int ldE, ldH, ldV;  // tile row bytes (f32: row stride in floats)
  int off_h, off_v, off_ring, off_out, off_ray, off_bar, slot_bytes, smem;
};

// One ray's state, in shared memory.
struct Ray {
  float o[3], d[3], dn, trans, rgb[3], acc, depth, pad;
};

__host__ __device__ constexpr int align128(int x) {
  return (x + 127) / 128 * 128;
}

// Number of GEMM layers, and layer l's outputs and staged input width:
// the D point layers, then (viewdirs) the feature and the view layer.
__host__ __device__ inline int n_layers(const Args& a) {
  return a.D + (a.viewdirs ? 2 : 0);
}
__host__ __device__ inline int layer_n(const Args& a, int W, int l) {
  return l == a.D + 1 ? W / 2 : W;
}
__host__ __device__ inline int layer_k(const Args& a, int W, int l) {
  if (l == 0) return a.kpe;
  if (l < a.D) return ((a.skips >> (l - 1)) & 1) ? a.kpe + W : W;
  return l == a.D ? W : W + a.kve;
}

// Shared memory, in order: E (the point encoding), H (the activations), V
// (the rays' view encoding), the weight ring, sigma and the rgb logits
// [rows][4] f32, the rays, the barriers. bf16/int8 tiles are [rows][ld
// bytes] in the core-matrix layout; f32 tiles row-major at ld floats.
template <typename T>
inline void plan(Args& a, int W) {
  using K = Kind<T>;
  constexpr int es = sizeof(T);
  const int rows = 64 * K::kWGs, R = rows / kG;
  a.kp = round_up(3 + 6 * a.Lp, 64);
  a.kpe = round_up(a.kp, K::kKS);
  a.kvw = a.viewdirs ? round_up(W + 3 + 6 * a.Lv, 64) - W : 0;
  a.kve = round_up(a.kvw, K::kKS);
  int bytes = 0;
  for (int l = 0; l < n_layers(a); ++l)
    bytes += layer_n(a, W, l) * layer_k(a, W, l) * es * K::kParts;
  a.heads_off = bytes;
  const int heads = (a.viewdirs ? W + 3 * (W / 2) : 4 * W) * es;
  a.epi_off = round_up(bytes + heads, 16);
  if (K::kRegA) {  // +4 floats: the A fragment loads hit 32 banks
    a.ldE = a.kp + 4;
    a.ldH = W + 4;
    a.ldV = a.kvw + 4;
  } else {
    a.ldE = a.kpe * es;
    a.ldH = W * es;
    a.ldV = a.kve * es;
  }
  const int rb = K::kRegA ? 4 : 1;  // bytes per ld unit
  a.off_h = align128(rows * a.ldE * rb);
  a.off_v = a.off_h + align128(rows * a.ldH * rb);
  a.off_ring = a.off_v + (a.viewdirs ? align128(rows * a.ldV * rb) : 0);
  a.slot_bytes = W * K::kKSB * K::kParts;
  a.off_out = a.off_ring + K::kStages * a.slot_bytes;
  a.off_ray = a.off_out + align128(rows * 4 * 4);
  a.off_bar = a.off_ray + align128(R * (int)sizeof(Ray));
  a.smem = a.off_bar + 2 * K::kStages * 8;
}

// ---- the teacher's encodings and compositing -----------------------------

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

// The warpgroup's 8 rays (ray t of the warpgroup is ray ray0 + t), by its
// threads 0..7.
__device__ inline void init_rays(const Args& a, int ray0, Ray* ray,
                                 int wtid) {
  if (wtid >= kG) return;
  Ray& r = ray[wtid];
  const int i = ray0 + wtid;
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

// The view-direction encoding d/max(|d|, 1e-12), L = Lv, of the
// warpgroup's 8 rays into store(row, col, value) for each of a ray's 8
// sample rows, columns up to 3+6Lv, zeros up to `width`.
template <typename Store>
__device__ void encode_views(const Args& a, const Ray* ray, int width,
                             int wtid, Store store) {
  const int used = 3 + 6 * a.Lv;
  for (int e = wtid; e < kG * 3; e += kWG) {
    const int t = e / 3, k = e % 3;
    const float v = ray[t].d[k] / fmaxf(ray[t].dn, 1e-12f);
    encode(v, k, a.Lv, [&](int c, float x) {
      for (int u = 0; u < kG; ++u) store(t * kG + u, c, x);
    });
  }
  const int pad = width - used;
  for (int e = wtid; e < 64 * pad; e += kWG)
    store(e / pad, used + e % pad, 0.f);
}

// The points o + d*z (one FMA per coordinate) of group g0 of the
// warpgroup's rays, row r = ray r/8, sample g0 + r%8, and their encoding
// into store(r, col, value), L = Lp, zeros up to `width`. Rows past the last
// sample or ray take z = 0 (a finite point that is never composited).
template <typename Store>
__device__ void encode_points(const Args& a, const Ray* ray, int ray0, int g0,
                              int width, int wtid, Store store) {
  for (int e = wtid; e < 64 * 3; e += kWG) {
    const int r = e / 3, k = e % 3, t = r / kG, s = g0 + r % kG;
    const bool ok = ray0 + t < a.n && s < a.S;
    const float z = ok ? a.z[(size_t)(ray0 + t) * a.S + s] : 0.f;
    const float p = __fmaf_rn(ray[t].d[k], z, ray[t].o[k]);
    encode(p, k, a.Lp, [&](int c, float x) { store(r, c, x); });
  }
  const int used = 3 + 6 * a.Lp, pad = width - used;
  for (int e = wtid; e < 64 * pad; e += kWG)
    store(e / pad, used + e % pad, 0.f);
}

// raw2outputs for the kG samples of group g0 of the warpgroup's rays, in
// order, one thread per ray: alpha = 1 - exp(-relu(sigma) * dist), dist to
// the next sample (1e10 past the last) times |d|; w = alpha * T; rgb += w *
// sigmoid(logits), acc += w, depth += w * z (the two sums as FMAs, as XLA
// contracts them); T *= 1 - alpha + 1e-10. Writes each weight. out4
// [64][4] holds each row's rgb logits and sigma.
__device__ inline void composite(const Args& a, Ray* ray, int ray0, int g0,
                                 const float* out4, int wtid) {
  if (wtid >= kG) return;
  const int i = ray0 + wtid;
  if (i >= a.n) return;
  Ray& r = ray[wtid];
  const float* zr = a.z + (size_t)i * a.S;
  for (int u = 0; u < kG && g0 + u < a.S; ++u) {
    const int s = g0 + u, row = wtid * kG + u;
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

// Write each ray's rgb (+ 1 - acc on a white background), acc and depth.
__device__ inline void finish(const Args& a, const Ray* ray, int ray0,
                              int wtid) {
  if (wtid >= kG) return;
  const int i = ray0 + wtid;
  if (i >= a.n) return;
  const Ray& r = ray[wtid];
  for (int k = 0; k < 3; ++k)
    a.rgb[3 * i + k] =
        a.white ? __fadd_rn(r.rgb[k], __fsub_rn(1.f, r.acc)) : r.rgb[k];
  a.acc[i] = r.acc;
  a.depth[i] = r.depth;
}

// The producer: one thread walks the same stages as the consumers, in the
// same order, and copies its half of each into both blocks of the cluster.
template <typename T, int W>
__device__ void produce(const Args& a, const Ring& ring, uint32_t rank) {
  using K = Kind<T>;
  const int groups = (a.S + kG - 1) / kG, nl = n_layers(a);
  int it = 0;
  for (int g = 0; g < groups; ++g) {
    const unsigned char* src = a.staged;
    for (int l = 0; l < nl; ++l) {
      const int bytes = layer_n(a, W, l) * K::kKSB * K::kParts;
      const int nst = layer_k(a, W, l) / K::kKS;
      for (int st = 0; st < nst; ++st, ++it, src += bytes)
        fill<T, 2>(ring, it, src, bytes, rank);
    }
  }
}

// ---- epilogues ----------------------------------------------------------

// A layer's epilogue constants: dense, the bias; int8, (m[c], b[c],
// m[c+1], b[c+1]) of each column pair (the staged image's table) and,
// unfolded, the consumer's inverse input scale.
struct EpiConsts {
  const float* b;
  const float4* mb;
  const float* inv;
};

// int8 requantize: clip(round_half_even(y), -127, 127) as an integer
// (clipping first gives the same integer). Adding 1.5 * 2^23 rounds the
// clipped value to an integer, half to even, in the float's low bits (one
// add where a float-to-int conversion runs at a quarter of the rate).
__device__ __forceinline__ int q8i(float y) {
  const float c = fminf(fmaxf(y, -127.f), 127.f);
  return __float_as_int(__fadd_rn(c, 12582912.f)) - 0x4B400000;
}

// The epilogue of columns c, c+1 (c even): dense, x = relu?(v + b), which
// the tile store and the heads round to T; int8, x = q8(relu?(v m + b)
// [* inv]), the one-FMA dequantize.
template <typename T, bool kFold, bool kRelu, typename Acc, typename Out>
__device__ __forceinline__ void epi2(const EpiConsts& e, int c, Acc v0,
                                     Acc v1, Out& x0, Out& x1) {
  if constexpr (sizeof(T) == 1) {
    const float4 p = __ldg(e.mb + c / 2);
    float y0 = dequant(v0, p.x, p.y), y1 = dequant(v1, p.z, p.w);
    if (kRelu) {
      y0 = fmaxf(y0, 0.f);
      y1 = fmaxf(y1, 0.f);
    }
    if (!kFold) {
      const float2 inv = __ldg(reinterpret_cast<const float2*>(e.inv + c));
      y0 = __fmul_rn(y0, inv.x);
      y1 = __fmul_rn(y1, inv.y);
    }
    x0 = q8i(y0);
    x1 = q8i(y1);
  } else {
    const float2 b = __ldg(reinterpret_cast<const float2*>(e.b + c));
    float y0 = __fadd_rn(v0, b.x), y1 = __fadd_rn(v1, b.y);
    if (kRelu) {
      y0 = fmaxf(y0, 0.f);
      y1 = fmaxf(y1, 0.f);
    }
    x0 = y0;  // (stored as T; the heads round it first)
    x1 = y1;
  }
}

// ---- the kernel ----------------------------------------------------------

template <typename T, int W, bool kFold>
__global__ void __launch_bounds__(kWG * (Kind<T>::kWGs + 1), 1)
    nerf_hopper_kernel(const Args a) {
  using K = Kind<T>;
  using Acc = typename K::Acc;
  constexpr bool kInt8 = sizeof(T) == 1;
  using Out = typename std::conditional<kInt8, int, float>::type;
  constexpr int kRows = 64 * K::kWGs, kR = kRows / kG;
  constexpr int kU = K::kRegA ? 4 : 1;  // bytes per tile ld unit
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const uint32_t rank = cluster_rank();
  Ring ring;
  ring.slots = smem_u32(smem + a.off_ring);
  ring.full = smem_u32(smem + a.off_bar);
  ring.empty = ring.full + 8 * K::kStages;
  ring.slot_bytes = a.slot_bytes;

  if (threadIdx.x == 0) ring_init<T, 2>(ring);
  __syncthreads();
  cluster_sync();

  if (wg == K::kWGs) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0) produce<T, W>(a, ring, rank);
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // This warpgroup's rays, rows and tiles.
  const int ray0 = blockIdx.x * kR + wg * kG, bar_id = 1 + wg;
  Ray* ray = reinterpret_cast<Ray*>(smem + a.off_ray) + wg * kG;
  float* out4 = reinterpret_cast<float*>(smem + a.off_out) + wg * 64 * 4;
  unsigned char* E = smem + wg * 64 * a.ldE * kU;
  unsigned char* Hm = smem + a.off_h + wg * 64 * a.ldH * kU;
  unsigned char* V = smem + a.off_v + wg * 64 * a.ldV * kU;
  const T* heads = reinterpret_cast<const T*>(a.staged + a.heads_off);
  const float4* mb = reinterpret_cast<const float4*>(a.staged + a.epi_off);
  const int lane = wtid % 32, r0 = 16 * (wtid / 32) + lane / 4;

  // store one value (an encoding; int8: its code) into a tile
  auto put = [&](unsigned char* tile, int ld, int r, int c, float v) {
    if constexpr (K::kRegA)
      reinterpret_cast<float*>(tile)[r * ld + c] = v;
    else if constexpr (kInt8)
      reinterpret_cast<int8_t*>(tile)[cm_off(r, c, ld)] = (int8_t)v;
    else
      *reinterpret_cast<__nv_bfloat16*>(tile + cm_off(r, 2 * c, ld)) =
          __float2bfloat16_rn(v);
  };
  // store an epilogue's column pair into H
  auto put2 = [&](int r, int c, Out x0, Out x1) {
    if constexpr (K::kRegA) {
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(Hm) + r * a.ldH +
                                 c) = make_float2(x0, x1);
    } else if constexpr (kInt8) {
      *reinterpret_cast<uint16_t*>(Hm + cm_off(r, c, a.ldH)) =
          (uint16_t)((x0 & 0xff) | ((x1 & 0xff) << 8));
    } else {
      *reinterpret_cast<__nv_bfloat162*>(Hm + cm_off(r, 2 * c, a.ldH)) =
          __floats2bfloat162_rn(x0, x1);
    }
  };
  // an epilogue value as the heads read it: dense, rounded to T
  auto hx = [](Out x) -> Out {
    if constexpr (kInt8)
      return x;
    else
      return rnd<T>(x);
  };
  // make this warpgroup's tile writes visible to its next product
  auto tiles_ready = [&]() {
    if constexpr (!K::kRegA) fence_async_smem();
    wg_bar(bar_id);
  };
  // the head sums p[h][o] of the thread's two rows, finished over the
  // quad, into out4 column col(o) as f(o, sum)
  auto heads_out = [&](auto& p, int nh, auto col, auto f) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (o >= nh) break;
        const Acc sum = quad_sum(p[h][o]);
        if (lane % 4 == 0) out4[4 * (r0 + 8 * h) + col(o)] = f(o, sum);
      }
  };

  init_rays(a, ray0, ray, wtid);
  wg_bar(bar_id);
  if (a.viewdirs)
    encode_views(a, ray, K::kRegA ? a.kvw : a.kve, wtid,
                 [&](int r, int c, float v) {
                   if constexpr (kInt8)
                     put(V, a.ldV, r, c,
                         c < a.kvw ? (float)q8(__fmul_rn(v, a.hv_inv[W + c]))
                                   : 0.f);
                   else
                     put(V, a.ldV, r, c, v);
                 });

  int it = 0;  // this warpgroup's place in the ring
  const int kv_all = W + a.kve;
  for (int g0 = 0; g0 < a.S; g0 += kG) {
    encode_points(a, ray, ray0, g0, K::kRegA ? a.kp : a.kpe, wtid,
                  [&](int r, int c, float v) {
                    if constexpr (kInt8)
                      put(E, a.ldE, r, c,
                          c < a.kp ? (float)q8(__fmul_rn(v, a.pe_inv[c]))
                                   : 0.f);
                    else
                      put(E, a.ldE, r, c, v);
                  });
    Acc acc[W / 2];
    for (int li = 0; li < a.D; ++li) {
      tiles_ready();
      const bool from_e = li == 0 || ((a.skips >> (li - 1)) & 1);
      const int kin = layer_k(a, W, li);
      const int k0 = from_e ? (K::kRegA ? a.kp : a.kpe) : kin;
      product<T, W>(acc, from_e ? E : Hm, from_e ? a.ldE : a.ldH, k0, Hm,
                    a.ldH, kin, ring, it, wtid);
      const bool last = li + 1 == a.D;
      const EpiConsts ec{a.pts_b + li * W, mb + li * (W / 2),
                         last ? a.h_inv : a.pts_inv + (li + 1) * W};
      if (!last) {
        visit<W>(acc, wtid, [&](int, int r, int c, Acc v0, Acc v1) {
          Out x0, x1;
          epi2<T, kFold, true>(ec, c, v0, v1, x0, x1);
          put2(r, c, x0, x1);
        });
        continue;
      }
      // The last point layer: h for the feature layer, and the heads on it
      // (sigma with viewdirs, else output_linear's four outputs).
      const int nh = a.viewdirs ? 1 : 4;
      Acc p[2][4] = {};
      visit<W>(acc, wtid, [&](int h, int r, int c, Acc v0, Acc v1) {
        Out x0, x1;
        epi2<T, kFold, true>(ec, c, v0, v1, x0, x1);
        if (a.viewdirs) put2(r, c, x0, x1);
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          if (o >= nh) break;
          dot2(p[h][o], hx(x0), hx(x1), head2(heads + o * W + c));
        }
      });
      heads_out(p, nh, [&](int o) { return a.viewdirs ? 3 : o; },
                [&](int o, Acc sum) {
                  const float* m = a.viewdirs ? a.alpha_m : a.out_m;
                  const float* b = a.viewdirs ? a.alpha_b : a.out_b;
                  if constexpr (kInt8)
                    return dequant(sum, m[o], b[o]);
                  else
                    return __fadd_rn(sum, b[o]);
                });
    }

    if (a.viewdirs) {
      // feature = h W_f^T + b (no ReLU), into H
      tiles_ready();
      product<T, W>(acc, Hm, a.ldH, W, Hm, a.ldH, W, ring, it, wtid);
      const EpiConsts ef{a.feat_b, mb + a.D * (W / 2), a.hv_inv};
      visit<W>(acc, wtid, [&](int, int r, int c, Acc v0, Acc v1) {
        Out x0, x1;
        epi2<T, kFold, false>(ef, c, v0, v1, x0, x1);
        put2(r, c, x0, x1);
      });
      // the view layer on [feature | view encoding], then the rgb head
      tiles_ready();
      Acc accv[W / 4];
      product<T, W / 2>(accv, Hm, a.ldH, W, V, a.ldV, kv_all, ring, it,
                        wtid);
      const EpiConsts ev{a.views_b, mb + (a.D + 1) * (W / 2), a.hr_inv};
      const T* rw = heads + W;  // [3][W/2]
      Acc p[2][4] = {};
      visit<W / 2>(accv, wtid, [&](int h, int, int c, Acc v0, Acc v1) {
        Out x0, x1;
        epi2<T, kFold, true>(ev, c, v0, v1, x0, x1);
#pragma unroll
        for (int o = 0; o < 3; ++o)
          dot2(p[h][o], hx(x0), hx(x1), head2(rw + o * (W / 2) + c));
      });
      heads_out(p, 3, [](int o) { return o; }, [&](int o, Acc sum) {
        if constexpr (kInt8)
          return dequant(sum, a.rgb_m[o], a.rgb_b[o]);
        else
          return __fadd_rn(sum, a.rgb_b[o]);
      });
    }
    wg_bar(bar_id);
    composite(a, ray, ray0, g0, out4, wtid);
    wg_bar(bar_id);
  }
  finish(a, ray, ray0, wtid);
  cluster_sync();
}

// Launch over ceil(n / R) blocks, padded to whole 2-block clusters.
template <typename T, int W, bool kFold>
cudaError_t launch_as(const Args& a, cudaStream_t stream) {
  constexpr int kR = 64 * Kind<T>::kWGs / kG;
  return launch_cluster<T, 2>(nerf_hopper_kernel<T, W, kFold>, a,
                              (a.n + kR - 1) / kR, a.smem, stream);
}

template <typename T, int W>
cudaError_t launch(Args a, cudaStream_t stream) {
  plan<T>(a, W);
  if constexpr (sizeof(T) == 1)
    if (a.fold) return launch_as<T, W, true>(a, stream);
  return launch_as<T, W, false>(a, stream);
}

}  // namespace nerf
