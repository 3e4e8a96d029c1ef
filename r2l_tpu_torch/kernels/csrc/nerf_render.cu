// K6: the fused volumetric NeRF teacher pass, f32 or bf16 weights.
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/nerf_render_pallas.py::
// fused_nerf_render_t (int8=False): for each ray and each of its S sorted
// depths z, the point o + d*z, its positional encoding by the double-angle
// ladder (L = Lp), the D-layer ReLU MLP with the encoding concatenated again
// after each skip layer, then either sigma (alpha_linear), the feature
// linear, the W/2 view layer on [feature | encoded view direction] and the
// rgb head, or output_linear (sigma in row 3); and the alpha compositing of
// volume.raw2outputs. Outputs rgb [n, 3], acc, depth [n], weights [n, S].
// bf16: the encoding is cast to bf16, each layer is an f32 dot plus the f32
// bias, ReLU, cast to bf16; sigma and the rgb logits stay f32. f32: true f32
// FMAs throughout (the TPU kernel's precision="highest").
//
// Design (nerf_common.cuh): a block owns TT/8 rays and walks their samples
// eight at a time; the TT points of a group (64 with bf16 weights, 32 with
// f32) go through the whole chain in shared memory, ray-major, with K1's
// engines (r2l_engines.cuh: mma.sync m16n8k16 for bf16, scalar FMAs for f32)
// streaming each weight matrix from global memory (L2) one 64-channel stage
// at a time. Sigma and the logits of the group land in shared memory; one
// thread per ray then composites its eight samples in order. The heads with
// 1-3 outputs are plain dot products per point. Every padded input width is
// a multiple of 64: the encoding (63 -> 64), the skip layer (64 + 256) and
// the view layer (256 + 27 -> 320), with zero weight columns.
//
// What bounds it: 593,408 multiply-adds per point with viewdirs at the
// canonical 8x256 (1.19 MFLOP), 40.96 M points per 400x400 frame at 64 + 192
// samples: 48.6 TFLOP, 49.2 ms at the card's 989 bf16 TFLOP/s (726 ms at 67
// f32 TFLOP/s). Each group re-reads the whole padded 1.2 MB bf16 network
// from L2: 655,360 groups of 64 points per frame stream about 785 GB. On an
// H100 80GB HBM3 at 700 W a frame's ten launches take 287 ms in bf16 (2.7
// TB/s from L2, 17.5% of the bound) and 2.44 s in f32; the int8 kernel
// streams half the bytes through as many 64-channel stages and takes 87% of
// the bf16 time, so the stage pipeline (two barriers per stage, one block
// per SM) limits before L2 bandwidth does. What this simple version leaves
// on the table: 128-point groups (225 KB of shared memory in bf16), wgmma
// with TMA-fed weight tiles, more than one block per SM.
#include "nerf_common.cuh"

namespace {

using namespace r2l;
using nerf::Args;
using nerf::kG;

template <typename E, typename EH, int W, int TT>
__global__ void __launch_bounds__(kThreads, 1) nerf_render_kernel(
    const Args a) {
  using T = typename E::T;
  constexpr int R = TT / kG;
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);
  T* H = reinterpret_cast<T*>(smem + a.off_h);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + a.off_ws);
  float* out4 = reinterpret_cast<float*>(smem + a.off_out);
  nerf::Ray* ray = reinterpret_cast<nerf::Ray*>(smem + a.off_ray);
  T* vpe = reinterpret_cast<T*>(smem + a.off_vpe);
  const int ray0 = blockIdx.x * R, lds = a.lds, ldh = a.ldh;
  const int kvp = a.kv - W;

  nerf::init_rays<R>(a, ray0, ray);
  __syncthreads();
  if (a.viewdirs)
    nerf::encode_views<R>(a, ray, kvp, [&](int t, int c, float v) {
      vpe[t * kvp + c] = st<T>(v);
    });

  for (int g0 = 0; g0 < a.S; g0 += kG) {
    nerf::encode_points<TT>(a, ray, ray0, g0, [&](int r, int c, float v) {
      S[r * lds + c] = st<T>(v);
    });
    // (each mm starts with a barrier before it reads A)
    typename E::Acc acc;
    const T* w = static_cast<const T*>(a.pts_w);
    for (int li = 0; li < a.D; ++li) {
      const bool from_s = li == 0 || ((a.skips >> (li - 1)) & 1);
      const int K = li == 0 ? a.kp : (from_s ? a.kp + W : W);
      E::mm(acc, from_s ? S : H, from_s ? lds : ldh, w, K, Ws);
      w += (size_t)W * K;
      const float* b = a.pts_b + li * W;
      const bool to_s = (a.skips >> li) & 1;  // concatenated after this one
      T* dst = to_s ? S + a.kp : H;
      const int ldd = to_s ? lds : ldh;
      E::visit(acc, [&](int r, int c, float v) {
        dst[r * ldd + c] = st<T>(fmaxf(__fadd_rn(v, b[c]), 0.f));
      });
    }
    __syncthreads();

    if (a.viewdirs) {
      const T* aw = static_cast<const T*>(a.alpha_w);
      for (int r = threadIdx.x; r < TT; r += kThreads) {
        float s = 0.f;
        for (int k = 0; k < W; ++k)
          s = fmaf(ld<T>(H[r * ldh + k]), ld<T>(aw[k]), s);
        out4[4 * r + 3] = __fadd_rn(s, a.alpha_b[0]);
      }
      E::mm(acc, H, ldh, static_cast<const T*>(a.feat_w), W, Ws);
      E::visit(acc, [&](int r, int c, float v) {
        S[r * lds + c] = st<T>(__fadd_rn(v, a.feat_b[c]));
      });
      for (int e = threadIdx.x; e < TT * kvp; e += kThreads) {
        const int r = e / kvp, c = e - r * kvp;
        S[r * lds + W + c] = vpe[(r / kG) * kvp + c];
      }
      typename EH::Acc acc2;
      EH::mm(acc2, S, lds, static_cast<const T*>(a.views_w), a.kv, Ws);
      EH::visit(acc2, [&](int r, int c, float v) {
        H[r * ldh + c] = st<T>(fmaxf(__fadd_rn(v, a.views_b[c]), 0.f));
      });
      __syncthreads();
      const T* rw = static_cast<const T*>(a.rgb_w);
      for (int e = threadIdx.x; e < TT * 3; e += kThreads) {
        const int r = e % TT, o = e / TT;
        float s = 0.f;
        for (int k = 0; k < W / 2; ++k)
          s = fmaf(ld<T>(H[r * ldh + k]), ld<T>(rw[o * (W / 2) + k]), s);
        out4[4 * r + o] = __fadd_rn(s, a.rgb_b[o]);
      }
    } else {
      const T* ow = static_cast<const T*>(a.out_w);
      for (int e = threadIdx.x; e < TT * 4; e += kThreads) {
        const int r = e % TT, o = e / TT;
        float s = 0.f;
        for (int k = 0; k < W; ++k)
          s = fmaf(ld<T>(H[r * ldh + k]), ld<T>(ow[o * W + k]), s);
        out4[4 * r + o] = __fadd_rn(s, a.out_b[o]);
      }
    }
    __syncthreads();
    nerf::composite<R>(a, ray, ray0, g0, out4);
    __syncthreads();
  }
  nerf::finish<R>(a, ray, ray0);
}

template <typename E, typename EH, int W, int TT>
cudaError_t launch(Args a, cudaStream_t stream) {
  nerf::plan(a, W, TT, sizeof(typename E::T), (int)E::kStageBytes);
  auto kern = nerf_render_kernel<E, EH, W, TT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.n + TT / kG - 1) / (TT / kG);
  kern<<<grid, kThreads, a.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// a shape the kernel does not take (W 128 or 256; skips before the last
// layer).
extern "C" int nerf_render_launch(
    const float* rays_o, const float* rays_d, const float* z, int n, int S,
    const void* pts_w, const float* pts_b, int D, int skips, int W,
    const void* alpha_w, const float* alpha_b, const void* feat_w,
    const float* feat_b, const void* views_w, const float* views_b,
    const void* rgb_w, const float* rgb_b, const void* out_w,
    const float* out_b, int Lp, int Lv, int viewdirs, int white,
    int weight_is_f32, float* rgb, float* acc, float* depth, float* weights,
    void* stream) {
  if (n <= 0 || S <= 0 || D < 1 || D > 31 || Lp < 1 || (viewdirs && Lv < 1) ||
      (skips >> (D - 1)) != 0)
    return cudaErrorInvalidValue;
  Args a = {};
  a.rays_o = rays_o; a.rays_d = rays_d; a.z = z; a.n = n; a.S = S;
  a.pts_w = pts_w; a.pts_b = pts_b; a.D = D; a.skips = skips;
  a.alpha_w = alpha_w; a.alpha_b = alpha_b;
  a.feat_w = feat_w; a.feat_b = feat_b;
  a.views_w = views_w; a.views_b = views_b;
  a.rgb_w = rgb_w; a.rgb_b = rgb_b; a.out_w = out_w; a.out_b = out_b;
  a.Lp = Lp; a.Lv = Lv; a.viewdirs = viewdirs; a.white = white;
  a.rgb = rgb; a.acc = acc; a.depth = depth; a.weights = weights;
  if ((reinterpret_cast<uintptr_t>(pts_w) | reinterpret_cast<uintptr_t>(feat_w) |
       reinterpret_cast<uintptr_t>(views_w)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight_is_f32) {
    switch (W) {
      case 128: return launch<EngineF32<128, 32>, EngineF32<64, 32>, 128, 32>(a, s);
      case 256: return launch<EngineF32<256, 32>, EngineF32<128, 32>, 256, 32>(a, s);
    }
  } else {
    switch (W) {
      case 128: return launch<EngineBF16<128, 64>, EngineBF16<64, 64>, 128, 64>(a, s);
      case 256: return launch<EngineBF16<256, 64>, EngineBF16<128, 64>, 256, 64>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}
