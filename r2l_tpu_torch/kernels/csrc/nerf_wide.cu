// The wide form of K6 and K7: the fused volumetric NeRF teacher pass for
// every teacher wider than the chain kernels' widths (nerf_render.cu,
// nerf_render_int8.cu: W 128 and 256), at any multiple of kWideChannels
// (nerf_render.py sends every teacher wider than 256 here, padded with zero
// channels to that multiple; the view layer's W/2 outputs to the next
// multiple as well).
//
// Replaces, at those widths, the Pallas TPU kernel r2l_tpu/kernels/
// nerf_render_pallas.py::fused_nerf_render_t (:336): f32 weights (3xTF32),
// bf16, and int8 (folded and unfolded requantize), with the rounding points
// of the plain version (nerf_render.py, _mlp_dense, _heads_dense,
// _mlp_int8, fused_nerf_render_ref).
//
// Why another design than K6/K7's: they keep a 64-point tile's activations
// in shared memory and a W-wide wgmma accumulator in registers (N <= 256);
// at W1024 a 64-point bf16 tile is 128 KB. Here a layer is one pass over
// the points' activations in device memory, on the pass skeleton of
// wide_hopper.cuh (wgmma fed by TMA, a producer warpgroup and two consumer
// warpgroups, 128 points x 256 outputs a tile in bf16 and int8, 128 x 128
// in f32 as 3xTF32 with A split in registers, the epilogue staged in
// shared memory and stored by TMA):
//   * the point encoding (the point o + d*z, one FMA, volume.ray_points)
//     and the view encoding (d / max(|d|, 1e-12)), each by the teacher's
//     double-angle ladder in nerf_embed's order (nerf::encode, bit for bit
//     the plain version's pe_ladder), rounded to the compute type (int8:
//     its codes, q8(x * pe_inv[c]) and q8(x * hv_inv[W + c])), are written
//     once a pass of rays by a kernel of their own (wide_encode) into two
//     buffers [rows, ke] and [rows, kve], zeros past the used columns. The
//     layer after a skip reads [encoding | h], the view layer [feature |
//     view encoding]: two k-ranges of TMA loads, one accumulation. The
//     image holds each layer's weights [N, K] row-major (f32: its TF32 high
//     parts, then its low parts; int8: the codes).
//   * products: bf16 m64nNk16, int8 m64nNk32 s8 x s8 -> s32 (exact), f32
//     as 3xTF32 on the tensor cores' one running sum, as K6 f32.
//   * epilogues: (m, b, inv) a channel from the image's table. f32/bf16
//     (BiasRelu): the bias added in f32, ReLU (not after the feature
//     layer), rounded to the compute type. int8 (Requant): acc*m + b in one
//     FMA, ReLU, times the consumer's inverse scale (1 where folded),
//     round-half-even, clip, staged as s8 and stored by TMA; with
//     bf16_requant (RequantT<true>) acc*m + b in bf16, two roundings.
//   * pe_ladder=False (ladder 0): the encodings one sinf a value
//     (nerf::sin_rows) in place of the ladder, the same columns.
//   * heads: sigma (W -> 1), rgb (W/2 -> 3) or output_linear (W -> 4) as
//     the student's tail reduction (wide_tail, linear: an f32 dot of the
//     rounded activations, or int8's exact int32 dot and one-FMA
//     dequantize), sigma before the feature pass overwrites its input.
//   * compositing: one thread a ray walks its S samples in order, the
//     operations of volume.raw2outputs as K6 does them (nerf::composite).
// The wrapper cuts the rays into passes of whole rays to bound the scratch
// (two activation buffers, sigma and the logits, the encodings).
//
// What bounds it: the products. A point costs 2,300,928 multiply-adds at
// W512 and 9,058,304 at W1024 with viewdirs (8 layers, a skip at 4), so a
// 400x400 datagen pose of 64 + 192 samples is 188.5 and 742 TFLOP: 191 and
// 750 ms at the card's 989 bf16 TFLOP/s; and each pass's round trip of the
// activations, 4 W bytes a point in bf16 and 2 W in int8 (at W512, more
// time than the products: int8's 25.6 ms a 32,768-ray datagen chunk
// against its products' 19.5). PERF.md has the measured times.
#include <algorithm>
#include <vector>

#include "nerf_hopper.cuh"
#include "r2l_wide.cuh"
#include "wide_hopper.cuh"

using namespace r2lw;

namespace {

// raw2outputs for the pass's rays, one thread a ray walking its S samples
// in order (nerf::composite's operations): sigma of point r at sig[r * ss],
// its rgb logits at lg[r * ls + k].
__global__ void __launch_bounds__(128)
    teacher_composite(const float* rays_d, const float* z, int rays, int S,
                      const float* sig, int ss, const float* lg, int ls,
                      int white, float* rgb, float* acc, float* depth,
                      float* weights) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays) return;
  const float* d = rays_d + 3 * i;
  const float dn = sqrtf(
      __fmaf_rn(d[2], d[2], __fmaf_rn(d[1], d[1], __fmul_rn(d[0], d[0]))));
  float trans = 1.f, c[3] = {0.f, 0.f, 0.f}, a = 0.f, dep = 0.f;
  const size_t r0 = (size_t)i * S;
  for (int s = 0; s < S; ++s) {
    const size_t r = r0 + s;
    const float zs = z[r];
    const float zn = s + 1 < S ? z[r + 1] : __fadd_rn(zs, 1e10f);
    const float dist = __fmul_rn(__fsub_rn(zn, zs), dn);
    const float alpha =
        __fsub_rn(1.f, expf(__fmul_rn(-fmaxf(sig[r * ss], 0.f), dist)));
    const float w = __fmul_rn(alpha, trans);
    weights[r] = w;
    for (int k = 0; k < 3; ++k)
      c[k] = __fmaf_rn(w, r2l::sigmoid(lg[r * ls + k]), c[k]);
    a = __fadd_rn(a, w);
    dep = __fmaf_rn(w, zs, dep);
    trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
  }
  for (int k = 0; k < 3; ++k)
    rgb[3 * i + k] = white ? __fadd_rn(c[k], __fsub_rn(1.f, a)) : c[k];
  acc[i] = a;
  depth[i] = dep;
}

// ---- the encodings of a pass ---------------------------------------------

// The compute type of a form.
template <int T>
using Compute = typename std::conditional<
    T == kF32, float,
    typename std::conditional<T == kBF16, __nv_bfloat16, int8_t>::type>::type;

// Encoding column c's value x in C: f32 as it is, bf16 rounded, int8 its
// code q8(x * inv[c]) (the form's requantize of the plain version's
// _mlp_int8), 0 past the `used` columns.
template <typename C>
__device__ __forceinline__ C code(float x, const float* inv, int c, int used);
template <> __device__ __forceinline__ float code<float>(float x,
                                                         const float*, int,
                                                         int) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 code<__nv_bfloat16>(
    float x, const float*, int, int) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ int8_t code<int8_t>(float x,
                                                           const float* inv,
                                                           int c, int used) {
  return c < used ? r2l::q8(__fmul_rn(x, inv[c])) : 0;
}

// The point encoding E [rows, ke] and the view encoding V [rows, kve] (V
// null without viewdirs) of a pass's points in C (int8: quantized by
// pe_inv and hv_inv, the view encoding's own inverse scales), zeros past
// the used columns: `er` rows a block, three threads a row (one a
// coordinate) run the ladders into shared memory, then the block's rows,
// contiguous in E and in V, are copied out in order.
template <typename C>
__global__ void wide_encode(const float* rays_o, const float* rays_d,
                            const float* z, int rows, int S, int Lp, int Lv,
                            int ladder, int ke, int kve, int er,
                            const float* pe_inv, const float* hv_inv, C* E,
                            C* V) {
  extern __shared__ float enc[];  // [er][ke + 1], then [er][kve + 1]
  const int le = ke + 1, lv = kve + 1;
  float* ev = enc + er * le;
  const int row0 = blockIdx.x * er, nr = min(er, rows - row0);
  for (int i = threadIdx.x; i < er * (le + (V ? lv : 0)); i += blockDim.x)
    enc[i] = 0.f;
  __syncthreads();
  const int r = threadIdx.x / 3, k = threadIdx.x - 3 * r;
  if (r < nr) {
    const int g = row0 + r, ray = g / S;
    const float* d = rays_d + 3 * ray;
    nerf::encode(__fmaf_rn(d[k], z[g], rays_o[3 * ray + k]), k, Lp, ladder,
                 [&](int c, float x) { enc[r * le + c] = x; });
    if (V) {  // |d| with the sum of squares contracted, as K6
      const float dn = sqrtf(__fmaf_rn(
          d[2], d[2], __fmaf_rn(d[1], d[1], __fmul_rn(d[0], d[0]))));
      nerf::encode(d[k] / fmaxf(dn, 1e-12f), k, Lv, ladder,
                   [&](int c, float x) { ev[r * lv + c] = x; });
    }
  }
  __syncthreads();
  const int ue = 3 + 6 * Lp, uv = 3 + 6 * Lv;
  for (int i = threadIdx.x; i < nr * ke; i += blockDim.x)
    E[(size_t)row0 * ke + i] =
        code<C>(enc[(i / ke) * le + i % ke], pe_inv, i % ke, ue);
  if (V)
    for (int i = threadIdx.x; i < nr * kve; i += blockDim.x)
      V[(size_t)row0 * kve + i] =
          code<C>(ev[(i / kve) * lv + i % kve], hv_inv, i % kve, uv);
}

template <typename C>
cudaError_t encode_pass(const float* rays_o, const float* rays_d,
                        const float* z, int rows, int S, int Lp, int Lv,
                        int ladder, int ke, int kve, const float* pe_inv,
                        const float* hv_inv, void* E, void* V,
                        cudaStream_t st) {
  // rows a block: as many as keep the block's floats within 48 KB
  const int per_row = 4 * (ke + 1 + (V ? kve + 1 : 0));
  const int er = std::max(1, std::min(64, (48 << 10) / per_row));
  const int grid = (rows + er - 1) / er, smem = er * per_row;
  wide_encode<C><<<grid, 3 * er, smem, st>>>(
      rays_o, rays_d, z, rows, S, Lp, Lv, ladder, ke, kve, er, pe_inv,
      hv_inv, static_cast<C*>(E), static_cast<C*>(V));
  return cudaGetLastError();
}

// ---- a call ----------------------------------------------------------------

// Everything a call needs (the C entry point's arguments).
struct Call {
  const float *rays_o, *rays_d, *z;
  int n, S;
  const unsigned char* image;  // stage_wide_teacher's
  const int* skips;            // host [D]: layer i's output concatenated
  int D, W;
  const float *pe_inv, *hv_inv;
  const float *alpha_m, *alpha_b, *rgb_m, *rgb_b, *out_m, *out_b;
  int Lp, Lv, viewdirs, white, ladder;
  float *rgb, *acc, *depth, *weights;
  unsigned char* scratch;
  long long scratch_bytes;
  int rays;  // rays a pass
};

// The image's GEMM layers (nerf_render.py, wide_teacher_plan): N outputs,
// and the input's 128-byte stages from the point encoding, from h in
// device memory and from the view encoding, in that order along K.
struct Gemm {
  int N, st_e, st_m, st_v;
  size_t w_off, table_off;  // bytes; the table in float4 entries
};

// The scratch of passes of `rows` points (nerf_render.py,
// teacher_wide_scratch_bytes): two activation buffers, sigma, the logits,
// the point and view encodings (ke, kve columns).
long long scratch_bytes(long long rows, int W, int es, int ke, int kve) {
  return 2 * aligned(rows * W * es) + aligned(4 * rows) +
         aligned(16 * rows) + aligned(rows * ke * es) +
         aligned(rows * kve * es);
}

template <int T, bool kBrq = false>
cudaError_t run(const Call& c, cudaStream_t st) {
  constexpr int es = elem_bytes(T), parts = T == kF32 ? 2 : 1;
  using C = Compute<T>;
  using Epi = typename std::conditional<T == kS8, wideh::RequantT<kBrq>,
                                        wideh::BiasRelu>::type;
  const int W = c.W, V = r2l::round_up(W / 2, kWideChannels);
  const int kp = r2l::round_up(3 + 6 * c.Lp, 64);
  const int kvw = r2l::round_up(W + 3 + 6 * c.Lv, 64) - W;
  const int st_e = r2l::round_up(kp * es, 128) / 128;   // stages of each
  const int st_v = r2l::round_up(kvw * es, 128) / 128;  // encoding
  const int st_h = W * es / 128;
  std::vector<Gemm> layers;
  size_t w_off = 0, t_off = 0;
  auto add = [&](int N, int e, int m, int v) {
    layers.push_back({N, e, m, v, w_off, t_off});
    w_off += (size_t)N * (e + m + v) * 128 * parts;
    t_off += N;
  };
  add(W, st_e, 0, 0);
  for (int l = 1; l < c.D; ++l) add(W, c.skips[l - 1] ? st_e : 0, st_h, 0);
  if (c.viewdirs) {
    add(W, 0, st_h, 0);
    add(V, 0, st_h, st_v);
  }
  const unsigned char* heads = c.image + w_off;
  const size_t heads_bytes = (c.viewdirs ? W + 3 * V : 4 * W) * es;
  const float4* table = reinterpret_cast<const float4*>(heads + heads_bytes);
  // the encodings' columns, and each layer's weights as B
  const int ke = st_e * 128 / es, kve = c.viewdirs ? st_v * 128 / es : 0;
  std::vector<CUtensorMap> wmap(layers.size());
  for (size_t l = 0; l < layers.size(); ++l) {
    const Gemm& g = layers[l];
    const cudaError_t err = wideh::weight_map<C>(
        &wmap[l], c.image + g.w_off, g.N,
        (g.st_e + g.st_m + g.st_v) * 128 / es);
    if (err != cudaSuccess) return err;
  }

  const int rays = c.rays > 0 && c.rays < c.n ? c.rays : c.n;
  const long long rows_max = (long long)rays * c.S;
  if (c.scratch_bytes < scratch_bytes(rows_max, W, es, ke, kve))
    return cudaErrorInvalidValue;
  unsigned char* s = c.scratch;
  void* H[2];
  for (int i = 0; i < 2; ++i, s += aligned(rows_max * W * es)) H[i] = s;
  float* sig = reinterpret_cast<float*>(s);
  float* lg = reinterpret_cast<float*>(s + aligned(4 * rows_max));
  s += aligned(4 * rows_max) + aligned(16 * rows_max);
  void* E = s;
  void* Vb = kve ? s + aligned(rows_max * ke * es) : nullptr;

  for (int r0 = 0; r0 < c.n; r0 += rays) {
    const int nr = c.n - r0 < rays ? c.n - r0 : rays, rows = nr * c.S;
    const float* ro = c.rays_o + 3 * (size_t)r0;
    const float* rd = c.rays_d + 3 * (size_t)r0;
    const float* z = c.z + (size_t)r0 * c.S;
    // the pass's A sources, and the view layer's output [rows, V]
    CUtensorMap mE, mV, mH[2], mHV[2];
    cudaError_t err = encode_pass<C>(ro, rd, z, rows, c.S, c.Lp, c.Lv,
                                     c.ladder, ke, kve, c.pe_inv,
                                     c.hv_inv ? c.hv_inv + W : nullptr, E,
                                     Vb, st);
    if (err == cudaSuccess) err = wideh::act_map<C>(&mE, E, rows, ke);
    if (err == cudaSuccess && kve) err = wideh::act_map<C>(&mV, Vb, rows, kve);
    for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
      err = wideh::act_map<C>(&mH[i], H[i], rows, W);
      if (err == cudaSuccess && c.viewdirs)
        err = wideh::act_map<C>(&mHV[i], H[i], rows, V);
    }
    if (err != cudaSuccess) return err;
    int cur = 0;
    auto layer = [&](int l, int relu) {
      const Gemm& g = layers[l];
      const int in = cur;
      cur ^= 1;
      // [encoding | h], [h], or [h | view encoding] (never all three)
      const CUtensorMap& a0 = g.st_e ? mE : mH[in];
      const CUtensorMap& a1 = g.st_e ? mH[in] : mV;
      const wideh::Pass wp{rows, g.N, g.st_e ? g.st_e : g.st_m,
                           g.st_e ? g.st_m : g.st_v};
      return wideh::launch_pass<C, Epi>(
          a0, g.st_e || g.st_v ? a1 : a0, wmap[l], g.st_v ? mHV[cur] : mH[cur],
          wp, {table + g.table_off, relu}, st);
    };
    auto head = [&](int K, const void* w, const float* m, const float* b,
                    int out_dim, float* out) {
      wide_tail<T><<<(rows + 7) / 8, 256, 0, st>>>(H[cur], rows, K, w, m, b,
                                                   out_dim, 1, out);
      return cudaGetLastError();
    };
    cur = 1;  // layer 0 writes H[0]
    for (int l = 0; l < c.D && err == cudaSuccess; ++l) err = layer(l, 1);
    const float* sg;
    int ss, ls;
    if (c.viewdirs) {
      if (err == cudaSuccess)
        err = head(W, heads, c.alpha_m, c.alpha_b, 1, sig);
      if (err == cudaSuccess) err = layer(c.D, 0);      // feature, no ReLU
      if (err == cudaSuccess) err = layer(c.D + 1, 1);  // view layer
      if (err == cudaSuccess)
        err = head(V, heads + (size_t)W * es, c.rgb_m, c.rgb_b, 3, lg);
      sg = sig, ss = 1, ls = 3;
    } else {
      if (err == cudaSuccess) err = head(W, heads, c.out_m, c.out_b, 4, lg);
      sg = lg + 3, ss = 4, ls = 4;
    }
    if (err != cudaSuccess) return err;
    teacher_composite<<<(nr + 127) / 128, 128, 0, st>>>(
        rd, z, nr, c.S, sg, ss, lg, ls, c.white, c.rgb + 3 * (size_t)r0,
        c.acc + r0, c.depth + r0, c.weights + (size_t)r0 * c.S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// image: stage_wide_teacher's (nerf_render.py); skips: a host array of D
// flags (layer i's output concatenated with the encoding); dtype 0 bf16, 1
// f32, 2 int8; pe_inv, hv_inv and the heads' m: int8's, else null; scratch:
// teacher_wide_scratch_bytes(rays * S, W, dtype, ke, kve) bytes, 256-byte
// aligned; rays: rays a pass (0: all n); ladder: 1 the double-angle ladder
// (pe_ladder=True), 0 one sinf a value; brq: int8's bf16 dequantize
// (bf16_requant), ignored for f32 and bf16. Returns a cudaError_t: a launch's
// own error, or cudaErrorInvalidValue for a shape the wide form does not
// take (W not a multiple of 128, a skip at the last layer) or a scratch too
// small.
extern "C" int nerf_wide_launch(
    const float* rays_o, const float* rays_d, const float* z, int n, int S,
    const unsigned char* image, const int* skips, int D, int W, int dtype,
    const float* pe_inv, const float* hv_inv, const float* alpha_m,
    const float* alpha_b, const float* rgb_m, const float* rgb_b,
    const float* out_m, const float* out_b, int Lp, int Lv, int viewdirs,
    int white, int ladder, int brq, float* rgb, float* acc, float* depth,
    float* weights, unsigned char* scratch, long long scratch_bytes, int rays,
    void* stream) {
  if (n <= 0 || S <= 0 || D < 1 || W <= 0 || W % kWideChannels != 0 ||
      Lp < 1 || (viewdirs && Lv < 1) || dtype < 0 || dtype > 2 ||
      skips[D - 1] != 0)
    return cudaErrorInvalidValue;
  if (dtype == kS8 && (!pe_inv || (viewdirs && !hv_inv)))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(image) & 15 ||
      reinterpret_cast<uintptr_t>(scratch) & 255)
    return cudaErrorMisalignedAddress;
  Call c{rays_o, rays_d, z,     n,     S,     image, skips, D,
         W,      pe_inv, hv_inv, alpha_m, alpha_b, rgb_m, rgb_b, out_m,
         out_b,  Lp,     Lv,     viewdirs, white, ladder, rgb, acc, depth,
         weights, scratch, scratch_bytes, rays};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return run<kBF16>(c, s);
    case kF32: return run<kF32>(c, s);
    default: return brq ? run<kS8, true>(c, s) : run<kS8>(c, s);
  }
}
