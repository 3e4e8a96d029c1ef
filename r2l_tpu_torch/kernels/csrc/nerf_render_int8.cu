// K7: the fused volumetric NeRF teacher pass in static-scale int8.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/nerf_render_pallas.py::
// fused_nerf_render_t (:336) with int8=True (fold_requant True or False),
// with parameters from prepare_fused_nerf(..., calib=...):
//   * the point encoding is quantized with pe_inv,
//     q = clip(round_half_even(x * inv), -127, 127); the view encoding with
//     the view layer's inverse input scale hv_inv[W:] (never folded);
//   * every product is int8 x int8 -> int32, exact;
//   * dequantize acc*m + b as one fused multiply-add, ReLU where the layer
//     has one, then requantize for the consumer: x * inv, round, clip; with
//     fold_requant the consumer's inverse scale is already in m and b, so
//     the requantize is round+clip alone;
//   * the layer after a skip takes [quantized encoding | requantized h];
//   * sigma and the rgb logits are acc*m + b in f32, their dots exact.
// The compositing is K6's.
//
// Design: K6's skeleton (nerf_hopper.cuh) with int8 tiles: 128 points per
// block, two consumer warpgroups on wgmma m64nNk32 s8 (exact s32 sums), a
// producer thread bulk-copying 128-channel int8 stages (32 KB, the bytes of a
// bf16 stage) through a ring of four that two blocks of a cluster share.
//
// What bounds it: the 593,408 multiply-adds per point of K6, 48.6 T
// operations per 400x400 frame, 24.6 ms at the card's 1,979 int8 TOP/s. The
// staged int8 network is 0.65 MB, read from L2 once per cluster and group,
// about 100 GB per frame. On an H100 80GB HBM3 at 700 W a frame's ten
// launches take 133 ms (the parent design: 248 ms). The epilogue sets the
// pace: without the hidden layers' epilogues a frame takes 82 ms, without
// them and the products 58 ms; per value it dequantizes, clamps, rounds and
// packs, about twice bf16's work, while its warpgroup's products wait.
// PERF.md has the runs.
#include "nerf_hopper.cuh"

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// `staged` is the image of stage_weights (nerf_render.py). Returns a
// cudaError_t: the launch's own error, cudaErrorLaunchOutOfResources for a
// cluster that cannot be resident, or cudaErrorInvalidValue for a shape the
// kernel does not take (W 128 or 256; skips before the last layer).
extern "C" int nerf_render_int8_launch(
    const float* rays_o, const float* rays_d, const float* z, int n, int S,
    const void* staged, const float* pts_m, const float* pts_b,
    const float* pe_inv, const float* pts_inv, int D, int skips, int W,
    const float* alpha_m, const float* alpha_b, const float* feat_m,
    const float* feat_b, const float* h_inv, const float* views_m,
    const float* views_b, const float* hv_inv, const float* rgb_m,
    const float* rgb_b, const float* hr_inv, const float* out_m,
    const float* out_b, int Lp, int Lv, int viewdirs, int white, int fold,
    float* rgb, float* acc, float* depth, float* weights, void* stream) {
  if (n <= 0 || S <= 0 || D < 1 || D > 31 || Lp < 1 || (viewdirs && Lv < 1) ||
      (skips >> (D - 1)) != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(staged) & 15)
    return cudaErrorMisalignedAddress;
  nerf::Args a = {};
  a.rays_o = rays_o; a.rays_d = rays_d; a.z = z; a.n = n; a.S = S;
  a.staged = static_cast<const unsigned char*>(staged);
  a.pts_m = pts_m; a.pts_b = pts_b; a.pe_inv = pe_inv; a.pts_inv = pts_inv;
  a.D = D; a.skips = skips;
  a.alpha_m = alpha_m; a.alpha_b = alpha_b;
  a.feat_m = feat_m; a.feat_b = feat_b; a.h_inv = h_inv;
  a.views_m = views_m; a.views_b = views_b; a.hv_inv = hv_inv;
  a.rgb_m = rgb_m; a.rgb_b = rgb_b; a.hr_inv = hr_inv;
  a.out_m = out_m; a.out_b = out_b;
  a.Lp = Lp; a.Lv = Lv; a.viewdirs = viewdirs; a.white = white; a.fold = fold;
  a.rgb = rgb; a.acc = acc; a.depth = depth; a.weights = weights;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 128: return nerf::launch<int8_t, 128>(a, s);
    case 256: return nerf::launch<int8_t, 256>(a, s);
  }
  return cudaErrorInvalidValue;
}

// The dynamic shared memory a block of this launch shape takes, in bytes.
extern "C" int nerf_render_int8_smem(int W, int D, int skips, int Lp, int Lv,
                                     int viewdirs) {
  nerf::Args a = {};
  a.D = D; a.skips = skips; a.Lp = Lp; a.Lv = Lv; a.viewdirs = viewdirs;
  nerf::plan<int8_t>(a, W);
  return a.smem;
}
