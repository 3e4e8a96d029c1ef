// K7: the fused volumetric NeRF teacher pass in static-scale int8.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/nerf_render_pallas.py::
// fused_nerf_render_t with int8=True (fold_requant True or False), with
// parameters from prepare_fused_nerf(..., calib=...):
//   * the point encoding is quantized with pe_inv,
//     q = clip(round_half_even(x * inv), -127, 127); the view encoding with
//     the view layer's inverse input scale hv_inv[W:] (never folded);
//   * every product is int8 x int8 -> int32, exact;
//   * dequantize acc*m + b as one fused multiply-add, ReLU where the layer
//     has one, then requantize for the consumer: x * inv, round, clip; with
//     fold_requant the consumer's inverse scale is already in m and b, so
//     the requantize is round+clip alone;
//   * the layer after a skip takes [quantized encoding | requantized h];
//   * sigma and the rgb logits are acc*m + b in f32.
// The compositing is K6's (nerf_common.cuh).
//
// Design: K6's, with int8 activations in shared memory and K1's int8
// engine (mma.sync m16n8k32 s8, exact s32 accumulation) streaming each int8
// weight matrix 64 input channels per stage; the heads with 1-3 outputs are
// __dp4a dot products per point. A block owns 8 rays, 64 points per group.
//
// What bounds it: the 593,408 multiply-adds per point of K6, 48.6 T
// operations per 400x400 frame, 24.6 ms at the card's 1,979 int8 TOP/s. The
// padded int8 network is 0.6 MB, so 64-point groups stream about 390 GB from
// L2 per frame. On an H100 80GB HBM3 at 700 W a frame's ten launches take
// 250 ms (10% of the bound), 87% of the bf16 kernel's time for half its
// bytes: the 64-channel stage pipeline (two barriers per stage, one block
// per SM, mma.sync instead of wgmma) limits first.
#include "nerf_common.cuh"

namespace {

using namespace r2l;
using nerf::Args;
using nerf::kG;

constexpr int kTT = 64;  // points per group

template <int W>
__global__ void __launch_bounds__(kThreads, 1) nerf_render_int8_kernel(
    const Args a) {
  using E = EngineS8<W, kTT, 64>;
  using EH = EngineS8<W / 2, kTT, 64>;
  constexpr int R = kTT / kG;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* S = reinterpret_cast<int8_t*>(smem);
  int8_t* H = reinterpret_cast<int8_t*>(smem + a.off_h);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + a.off_ws);
  float* out4 = reinterpret_cast<float*>(smem + a.off_out);
  nerf::Ray* ray = reinterpret_cast<nerf::Ray*>(smem + a.off_ray);
  int8_t* vpe = reinterpret_cast<int8_t*>(smem + a.off_vpe);
  const int ray0 = blockIdx.x * R, lds = a.lds, ldh = a.ldh;
  const int kvp = a.kv - W;
  const bool fold = a.fold;
  // requantize v for a consumer whose inverse input scale is inv[c]
  auto rq = [&](float v, const float* inv, int c) {
    return fold ? q8(v) : q8(__fmul_rn(v, inv[c]));
  };
  // int32 dot of int8 row r of X (ld bytes) with int8 weights w [k]
  auto dot = [&](const int8_t* X, int ld, int r, const int8_t* w, int k) {
    const uint32_t* x32 = reinterpret_cast<const uint32_t*>(X + r * ld);
    int s = 0;
    for (int q = 0; q < k / 4; ++q)
      s = __dp4a((int)x32[q], (int)ldg32(w + 4 * q), s);
    return s;
  };

  nerf::init_rays<R>(a, ray0, ray);
  __syncthreads();
  if (a.viewdirs)
    nerf::encode_views<R>(a, ray, kvp, [&](int t, int c, float v) {
      vpe[t * kvp + c] = q8(__fmul_rn(v, a.hv_inv[W + c]));
    });

  for (int g0 = 0; g0 < a.S; g0 += kG) {
    nerf::encode_points<kTT>(a, ray, ray0, g0, [&](int r, int c, float v) {
      S[r * lds + c] = q8(__fmul_rn(v, a.pe_inv[c]));
    });
    int acc[E::M::MT][E::M::NT][4];
    const int8_t* w = static_cast<const int8_t*>(a.pts_w);
    for (int li = 0; li < a.D; ++li) {
      const bool from_s = li == 0 || ((a.skips >> (li - 1)) & 1);
      const int K = li == 0 ? a.kp : (from_s ? a.kp + W : W);
      E::mm(acc, from_s ? S : H, from_s ? lds : ldh, w, K, Ws);
      w += (size_t)W * K;
      const float* m = a.pts_m + li * W;
      const float* b = a.pts_b + li * W;
      const float* inv = li + 1 < a.D ? a.pts_inv + (li + 1) * W : a.h_inv;
      const bool to_s = (a.skips >> li) & 1;  // concatenated after this one
      int8_t* dst = to_s ? S + a.kp : H;
      const int ldd = to_s ? lds : ldh;
      E::M::visit(acc, [&](int r, int c, int v) {
        dst[r * ldd + c] = rq(fmaxf(dequant(v, m[c], b[c]), 0.f), inv, c);
      });
    }
    __syncthreads();

    if (a.viewdirs) {
      const int8_t* aw = static_cast<const int8_t*>(a.alpha_w);
      for (int r = threadIdx.x; r < kTT; r += kThreads)
        out4[4 * r + 3] = dequant(dot(H, ldh, r, aw, W), a.alpha_m[0],
                                  a.alpha_b[0]);
      E::mm(acc, H, ldh, static_cast<const int8_t*>(a.feat_w), W, Ws);
      E::M::visit(acc, [&](int r, int c, int v) {
        S[r * lds + c] =
            rq(dequant(v, a.feat_m[c], a.feat_b[c]), a.hv_inv, c);
      });
      for (int e = threadIdx.x; e < kTT * kvp; e += kThreads) {
        const int r = e / kvp, c = e - r * kvp;
        S[r * lds + W + c] = vpe[(r / kG) * kvp + c];
      }
      int acc2[EH::M::MT][EH::M::NT][4];
      EH::mm(acc2, S, lds, static_cast<const int8_t*>(a.views_w), a.kv, Ws);
      EH::M::visit(acc2, [&](int r, int c, int v) {
        H[r * ldh + c] = rq(
            fmaxf(dequant(v, a.views_m[c], a.views_b[c]), 0.f), a.hr_inv, c);
      });
      __syncthreads();
      const int8_t* rw = static_cast<const int8_t*>(a.rgb_w);
      for (int e = threadIdx.x; e < kTT * 3; e += kThreads) {
        const int r = e % kTT, o = e / kTT;
        out4[4 * r + o] = dequant(dot(H, ldh, r, rw + o * (W / 2), W / 2),
                                  a.rgb_m[o], a.rgb_b[o]);
      }
    } else {
      const int8_t* ow = static_cast<const int8_t*>(a.out_w);
      for (int e = threadIdx.x; e < kTT * 4; e += kThreads) {
        const int r = e % kTT, o = e / kTT;
        out4[4 * r + o] =
            dequant(dot(H, ldh, r, ow + o * W, W), a.out_m[o], a.out_b[o]);
      }
    }
    __syncthreads();
    nerf::composite<R>(a, ray, ray0, g0, out4);
    __syncthreads();
  }
  nerf::finish<R>(a, ray, ray0);
}

template <int W>
cudaError_t launch(Args a, cudaStream_t stream) {
  nerf::plan(a, W, kTT, 1, (int)EngineS8<W, kTT, 64>::kStageBytes);
  auto kern = nerf_render_int8_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.n + kTT / kG - 1) / (kTT / kG);
  kern<<<grid, kThreads, a.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// a shape the kernel does not take (W 128 or 256; skips before the last
// layer).
extern "C" int nerf_render_int8_launch(
    const float* rays_o, const float* rays_d, const float* z, int n, int S,
    const void* pts_w, const float* pts_m, const float* pts_b,
    const float* pe_inv, const float* pts_inv, int D, int skips, int W,
    const void* alpha_w, const float* alpha_m, const float* alpha_b,
    const void* feat_w, const float* feat_m, const float* feat_b,
    const float* h_inv, const void* views_w, const float* views_m,
    const float* views_b, const float* hv_inv, const void* rgb_w,
    const float* rgb_m, const float* rgb_b, const float* hr_inv,
    const void* out_w, const float* out_m, const float* out_b, int Lp, int Lv,
    int viewdirs, int white, int fold, float* rgb, float* acc, float* depth,
    float* weights, void* stream) {
  if (n <= 0 || S <= 0 || D < 1 || D > 31 || Lp < 1 || (viewdirs && Lv < 1) ||
      (skips >> (D - 1)) != 0)
    return cudaErrorInvalidValue;
  Args a = {};
  a.rays_o = rays_o; a.rays_d = rays_d; a.z = z; a.n = n; a.S = S;
  a.pts_w = pts_w; a.pts_m = pts_m; a.pts_b = pts_b; a.pe_inv = pe_inv;
  a.pts_inv = pts_inv; a.D = D; a.skips = skips;
  a.alpha_w = alpha_w; a.alpha_m = alpha_m; a.alpha_b = alpha_b;
  a.feat_w = feat_w; a.feat_m = feat_m; a.feat_b = feat_b; a.h_inv = h_inv;
  a.views_w = views_w; a.views_m = views_m; a.views_b = views_b;
  a.hv_inv = hv_inv; a.rgb_w = rgb_w; a.rgb_m = rgb_m; a.rgb_b = rgb_b;
  a.hr_inv = hr_inv; a.out_w = out_w; a.out_m = out_m; a.out_b = out_b;
  a.Lp = Lp; a.Lv = Lv; a.viewdirs = viewdirs; a.white = white; a.fold = fold;
  a.rgb = rgb; a.acc = acc; a.depth = depth; a.weights = weights;
  if ((reinterpret_cast<uintptr_t>(pts_w) | reinterpret_cast<uintptr_t>(feat_w) |
       reinterpret_cast<uintptr_t>(views_w)) & 15 ||
      (reinterpret_cast<uintptr_t>(alpha_w) | reinterpret_cast<uintptr_t>(rgb_w) |
       reinterpret_cast<uintptr_t>(out_w)) & 3)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 128: return launch<128>(a, s);
    case 256: return launch<256>(a, s);
  }
  return cudaErrorInvalidValue;
}
