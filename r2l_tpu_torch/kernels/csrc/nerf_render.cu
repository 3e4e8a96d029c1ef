// K6: the fused volumetric NeRF teacher pass, f32 or bf16 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/nerf_render_pallas.py::
// fused_nerf_render_t (:336, int8=False): for each ray and each of its S
// sorted depths z, the point o + d*z, its positional encoding by the
// double-angle ladder (L = Lp), the D-layer ReLU MLP with the encoding
// concatenated again after each skip layer, then either sigma
// (alpha_linear), the feature linear, the W/2 view layer on [feature |
// encoded view direction] and the rgb head, or output_linear (sigma in row
// 3); and the alpha compositing of volume.raw2outputs. Outputs rgb [n, 3],
// acc, depth [n], weights [n, S]. bf16: the encoding is cast to bf16, each
// layer is an f32 dot plus the f32 bias, ReLU, cast to bf16; sigma and the
// rgb logits stay f32. f32: each product as 3xTF32 (a_hi w_lo + a_lo w_hi +
// a_hi w_hi, about 21 mantissa bits, as the TPU kernel's multi-pass bf16
// keeps more than one bf16 pass), the rest in f32.
//
// Design (nerf_hopper.cuh): 128 points per block in bf16 (two consumer
// warpgroups on wgmma m64nNk16), 64 in f32 (one, on wgmma m64nNk8 tf32 with
// A split in registers), a producer thread that bulk-copies the weights,
// packed once per model into wgmma's shared-memory layout, through a ring
// of three 32 KB stages that two blocks of a cluster share (multicast).
//
// What bounds it: 593,408 multiply-adds per point with viewdirs at the
// canonical 8x256 (1.19 MFLOP), 40.96 M points per 400x400 frame at 64 + 192
// samples: 48.6 TFLOP, 49.2 ms at the card's 989 bf16 TFLOP/s; in f32, three
// TF32 products, 295 ms at 495 TF32 TFLOP/s (726 ms at the 67 f32 TFLOP/s of
// the CUDA cores). The weights stream from L2 once per cluster and group:
// 1.2 MB bf16 per 256 points, about 197 GB per frame; 4.8 MB of f32 hi/lo
// per 128 points, about 1.6 TB. On an H100 80GB HBM3 at 700 W a frame's ten
// launches take 110 ms in bf16 and 679 ms in f32 (the parent design, with
// 64-channel cp.async stages behind block barriers and mma.sync, took 287 ms
// and 2.45 s). Where it goes: without the hidden layers' epilogues (which
// stop their warpgroup's products) a frame takes 91 / 634 ms, without them
// and the products 54 / 224 ms; that remainder (the ring's copies, the
// encodings, heads and compositing) is not separated yet. PERF.md has the
// runs.
#include "nerf_hopper.cuh"

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// `staged` is the image of stage_weights (nerf_render.py). Returns a
// cudaError_t: the launch's own error, cudaErrorLaunchOutOfResources for a
// cluster that cannot be resident, or cudaErrorInvalidValue for a shape the
// kernel does not take (W 128 or 256; skips before the last layer).
extern "C" int nerf_render_launch(
    const float* rays_o, const float* rays_d, const float* z, int n, int S,
    const void* staged, const float* pts_b, int D, int skips, int W,
    const float* alpha_b, const float* feat_b, const float* views_b,
    const float* rgb_b, const float* out_b, int Lp, int Lv, int viewdirs,
    int white, int weight_is_f32, float* rgb, float* acc, float* depth,
    float* weights, void* stream) {
  if (n <= 0 || S <= 0 || D < 1 || D > 31 || Lp < 1 || (viewdirs && Lv < 1) ||
      (skips >> (D - 1)) != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(staged) & 15)
    return cudaErrorMisalignedAddress;
  nerf::Args a = {};
  a.rays_o = rays_o; a.rays_d = rays_d; a.z = z; a.n = n; a.S = S;
  a.staged = static_cast<const unsigned char*>(staged);
  a.pts_b = pts_b; a.D = D; a.skips = skips;
  a.alpha_b = alpha_b; a.feat_b = feat_b; a.views_b = views_b;
  a.rgb_b = rgb_b; a.out_b = out_b;
  a.Lp = Lp; a.Lv = Lv; a.viewdirs = viewdirs; a.white = white;
  a.rgb = rgb; a.acc = acc; a.depth = depth; a.weights = weights;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight_is_f32) {
    switch (W) {
      case 128: return nerf::launch<float, 128>(a, s);
      case 256: return nerf::launch<float, 256>(a, s);
    }
  } else {
    switch (W) {
      case 128: return nerf::launch<__nv_bfloat16, 128>(a, s);
      case 256: return nerf::launch<__nv_bfloat16, 256>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

// The dynamic shared memory a block of this launch shape takes, in bytes.
extern "C" int nerf_render_smem(int W, int weight_is_f32, int D, int skips,
                                int Lp, int Lv, int viewdirs) {
  nerf::Args a = {};
  a.D = D; a.skips = skips; a.Lp = Lp; a.Lv = Lv; a.viewdirs = viewdirs;
  if (weight_is_f32)
    nerf::plan<float>(a, W);
  else
    nerf::plan<__nv_bfloat16>(a, W);
  return a.smem;
}
