// The wide form of the training forward: K3 (bf16 and f32 weights) and K4 /
// K8 (static-scale int8, the q-value or the bf16 stash) for every student
// the chain kernels (r2l_hopper.cuh, r2l_int8_hopper.cuh: W 64, 128 and
// 256) do not hold, at any multiple of kWideChannels (r2l_train.py sends
// every training step wider than 256 here, and an int8 one whose 2L+1
// encoding parts overflow K4's head slice).
//
// Replaces, at those widths, the Pallas TPU kernels r2l_tpu/kernels/
// r2l_train_pallas.py::train_fwd (:54) and train_fwd_int8 (:182, stash_q
// True and False). Every layer is a pass of the Hopper pass skeleton
// (wide_hopper.cuh: wgmma fed by TMA, a producer warpgroup, two consumer
// warpgroups, two-block clusters multicasting the weights) with the
// training epilogues TrainK3 and TrainK48; the activations they would keep
// in a scratch are the stash [2nb+1, n, W] itself: h_0 in row 0, block b's
// inner t in row nb+1+b and its output in row b+1 (K4: the codes the
// products read, row nb the tail's). A call:
//   1. train_encode (r2l_wide.cuh) writes the head's input once, pts
//      [n, dp] encoded by the double-angle ladder into [n, kp] (kp = in_dim
//      rounded up to 128) in the head's freq-major column order, in the
//      compute type or,
//      for K4/K8, as the head's codes; the skeleton reads A only through
//      tensor maps.
//   2. 2nb+1 skeleton passes, the head then two a block, against the
//      image's weights [W, K] row-major (r2l_fused.py, stage_wide_train;
//      f32 its TF32 high parts, then its low parts, a layer at a time).
//      K3 stores each layer's output, rounded, to its stash row by TMA;
//      K4 stores the codes to the stash rows and keeps an f32 residual
//      stream in the scratch; K8 stores the codes to two scratch buffers in
//      turn and its bf16 t and h rows to the stash. K4's stream and K8's
//      rows travel as the passes' side tiles (128-wide tiles: the producer
//      loads h_in by TMA a tile ahead, the epilogue updates it in shared
//      memory, TMA stores it).
//   3. wide_tail (r2l_wide.cuh), a reduction to at most 8 outputs.
// The rounding points are train_fwd_ref's and train_fwd_int8_ref's
// (r2l_train.py); K4 and K8 compute them bit for bit. bf16 is one running
// sum over K (the k16 steps of the mma.sync pass before it); f32 is 3xTF32
// with each k8 step's three products summed apart and added in f32
// (kSplit = 8): the tensor cores truncate every sum they add to, and over
// the 88 layers of a W512 student a stash row reads past K3's f32 limit
// when a 32-channel stage is summed apart (PERF.md, K3's margins).
//
// What bounds it: the products, 2 W^2 operations a ray a layer (W512/D88 at
// 81,920 rays: 3.70 T, 3.74 ms at 989 bf16 TFLOP/s, 22.4 ms for f32 as
// 3xTF32 at 495, 1.87 ms in int8), and the bytes: the encoding written and
// read once, each pass its input row and its output row, a block's end
// also h (K3 bf16 at W512/D88: 18.6 GB, 5.6 ms at 3.35 TB/s; f32 37.2 GB;
// K4 22.4 GB with its f32 stream, K8 18.7 GB with its bf16 rows;
// chip_smoke.py's wide_fwd_design_bytes). PERF.md has the measured times.
#include "r2l_wide.cuh"
#include "wide_hopper.cuh"

namespace {

using r2lw::aligned;
using r2lw::kWideChannels;

// Everything a call needs (the C entry point's arguments).
struct Train {
  const float* pts;
  int n, dp, L, in_dim;
  const unsigned char* image;  // stage_wide_train's
  const float* head_b;         // bf16/f32 [W]
  const float* body_b;         // bf16/f32 [2nb, W]
  const float* head_inv;       // int8 [in_dim]
  const float* body_inv;       // int8 [2nb, W]
  const void* tail_w;          // [out_dim, W], the weight type (int8: codes)
  const float* tail_m;         // int8 [out_dim]
  const float* tail_b;         // [out_dim]
  const float* tail_inv;       // int8 [W]
  float* out;                  // [n, out_dim]
  unsigned char* stash;        // [2nb+1, n, W]
  unsigned char* scratch;
  int W, nb, out_dim;
  float res_scale;
  int use_residual, linear_tail, stash_q;
};

// ---- the passes --------------------------------------------------------------

// The scratch of a call (r2l_train.py, wide_train_scratch_bytes): the
// head's input [n, kp] of the compute type (int8: its codes); K4 an f32
// residual stream, K8 two code buffers, and with the global residual an f32
// h0; each 256-byte aligned.
long long train_scratch(long long n, int W, int kp, int dtype, int stash_q,
                        int use_residual) {
  const long long e = n * W;
  const long long enc = aligned(n * kp * r2lw::elem_bytes(dtype));
  if (dtype != r2lw::kS8) return enc;
  return enc + (stash_q ? aligned(4 * e) : 2 * aligned(e)) +
         (use_residual ? aligned(4 * e) : 0);
}

// K3: the encoding, the head, two passes a block, the tail; every pass's
// output a stash row.
template <typename C>
cudaError_t run_k3(const Train& c, cudaStream_t st) {
  constexpr int es = sizeof(C), parts = es == 4 ? 2 : 1;
  constexpr int kSplit = es == 4 ? 8 : 0;  // f32: each k8 step apart
  using Epi = wideh::TrainK3<C>;
  const int W = c.W, n = c.n;
  const int kp = r2l::round_up(c.in_dim, r2l::kKAlign);
  const size_t rowb = (size_t)n * W * es;
  auto row = [&](int r) { return c.stash + (size_t)r * rowb; };
  const size_t head_bytes = (size_t)W * kp * es * parts;
  const size_t layer_bytes = (size_t)W * W * es * parts;
  cudaError_t err =
      r2lw::encode<C>(c.pts, n, c.dp, c.L, kp, nullptr, c.scratch, st);
  CUtensorMap a;
  if (err == cudaSuccess) err = wideh::act_map<C>(&a, c.scratch, n, kp);
  if (err == cudaSuccess)
    err = wideh::layer_pass<C, Epi, kSplit>(
        a, c.image, n, W, kp, row(0), {c.head_b, nullptr, n, W, c.res_scale},
        st);
  for (int b = 0; b < c.nb && err == cudaSuccess; ++b)
    for (int j = 0; j < 2 && err == cudaSuccess; ++j) {
      const int in = j ? c.nb + 1 + b : b, out = j ? b + 1 : c.nb + 1 + b;
      err = wideh::act_map<C>(&a, row(in), n, W);
      if (err == cudaSuccess)
        err = wideh::layer_pass<C, Epi, kSplit>(
            a, c.image + head_bytes + (2 * b + j) * layer_bytes, n, W, W,
            row(out),
            {c.body_b + (size_t)(2 * b + j) * W,
             j ? reinterpret_cast<const C*>(row(b)) : nullptr, n, W,
             c.res_scale},
            st);
    }
  if (err != cudaSuccess) return err;
  constexpr int T = es == 4 ? r2lw::kF32 : r2lw::kBF16;
  r2lw::wide_tail<T><<<(n + 7) / 8, 256, 0, st>>>(
      row(c.nb), n, W, c.tail_w, nullptr, c.tail_b, c.out_dim,
      c.linear_tail, c.out, c.use_residual ? row(0) : nullptr);
  return cudaGetLastError();
}

// K4 (kQ) / K8: the encoding's codes, the int8 passes with the training
// epilogues, the tail on the last codes.
template <bool kQ>
cudaError_t run_k48(const Train& c, cudaStream_t st) {
  using Epi = wideh::TrainK48<kQ>;
  const int W = c.W, nb = c.nb, n = c.n;
  const long long e = (long long)n * W;
  const size_t rowb = (size_t)e * (kQ ? 1 : 2);
  auto row = [&](int r) { return c.stash + (size_t)r * rowb; };
  const int kp = r2l::round_up(c.in_dim, r2l::kKAlign);
  const size_t head_bytes = (size_t)W * kp;
  const size_t layer_bytes = (size_t)W * W;
  const float* table = reinterpret_cast<const float*>(
      c.image + head_bytes + 2 * nb * layer_bytes);
  unsigned char* s = c.scratch;
  unsigned char* enc = s;
  s += aligned((long long)n * kp);
  float* hs = nullptr;  // K4's f32 stream
  unsigned char* X[2] = {nullptr, nullptr};  // K8's codes
  if (kQ) {
    hs = reinterpret_cast<float*>(s);
    s += aligned(4 * e);
  } else {
    for (int i = 0; i < 2; ++i, s += aligned(e)) X[i] = s;
  }
  float* h0 = c.use_residual ? reinterpret_cast<float*>(s) : nullptr;
  // the h stream the side tiles carry: K4's f32 one in the scratch, K8's
  // bf16 stash rows (and its t rows)
  auto hrow = [&](int r) -> void* {
    return kQ ? static_cast<void*>(hs) : static_cast<void*>(row(r));
  };
  cudaError_t err =
      r2lw::encode<int8_t>(c.pts, n, c.dp, c.L, kp, c.head_inv, enc, st);
  CUtensorMap a;
  if (err == cudaSuccess) err = wideh::act_map<int8_t>(&a, enc, n, kp);
  if (err == cudaSuccess)
    err = wideh::layer_pass<int8_t, Epi>(
        a, c.image, n, W, kp, kQ ? row(0) : X[0],
        {table, nb > 0 ? c.body_inv : c.tail_inv, h0, Epi::kHead, nb == 0, n,
         W},
        st, nullptr, hrow(0));
  int q = 0;  // K8: the buffer of the codes the next product reads
  for (int b = 0; b < nb && err == cudaSuccess; ++b)
    for (int j = 0; j < 2 && err == cudaSuccess; ++j) {
      const int idx = 2 * b + j;
      const bool last = j == 1 && b == nb - 1;
      err = wideh::act_map<int8_t>(
          &a, kQ ? static_cast<void*>(row(j ? nb + 1 + b : b)) : X[q], n, W);
      const typename Epi::Args lp{
          table + 2 * (size_t)W * (1 + idx),
          last ? c.tail_inv : c.body_inv + (size_t)(idx + 1) * W, h0,
          j ? Epi::kEnd : Epi::kInner, last, n, W};
      // K4's inner layers carry no side tile; K8's write t, every block's
      // end reads h_in and writes h
      const void* s_in = j ? hrow(b) : nullptr;
      const void* s_out = j ? hrow(b + 1) : kQ ? nullptr : hrow(nb + 1 + b);
      if (err == cudaSuccess)
        err = wideh::layer_pass<int8_t, Epi>(
            a, c.image + head_bytes + idx * layer_bytes, n, W, W,
            kQ ? static_cast<void*>(row(j ? b + 1 : nb + 1 + b)) : X[q ^ 1],
            lp, st, s_in, s_out);
      q ^= 1;
    }
  if (err != cudaSuccess) return err;
  r2lw::wide_tail<r2lw::kS8><<<(n + 7) / 8, 256, 0, st>>>(
      kQ ? static_cast<const void*>(row(nb)) : X[q], n, W, c.tail_w,
      c.tail_m, c.tail_b, c.out_dim, c.linear_tail, c.out);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// pts [n, dp] f32 (in_dim = dp * (2L + 1)); dtype: 0 bf16, 1 f32 (K3), 2
// int8 (K4 with stash_q, else K8). image: stage_wide_train's weights of
// the head ([W, in_dim padded to 128], freq-major) and of every body layer,
// [W, K] row-major each (f32: its TF32 high parts, then its low parts),
// then for int8 the (m, b) table of the head and the body. stash [2nb+1,
// n, W]: the weight type (K3), int8 (K4) or bf16 (K8). scratch:
// wide_train_scratch_bytes(n, ...) bytes, 256-byte aligned. Returns a
// cudaError_t: a launch's own error, cudaErrorNotSupported where a tensor
// map cannot be made, or cudaErrorInvalidValue for a shape the wide form
// does not take (W not a multiple of 128, more than 8 outputs) or a
// scratch too small.
extern "C" int r2l_wide_train_fwd_launch(
    const float* pts, int n, int dp, int L, int dtype, int stash_q,
    const unsigned char* image, const float* head_b, const float* body_b,
    const float* head_inv, const float* body_inv, const void* tail_w,
    const float* tail_m, const float* tail_b, const float* tail_inv,
    float* out, void* stash, unsigned char* scratch, long long scratch_bytes,
    int W, int nb, int out_dim, float res_scale, int use_residual,
    int linear_tail, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || W <= 0 || W % kWideChannels != 0 ||
      nb < 0 || out_dim < 1 || out_dim > r2lw::kMaxOut || dtype < 0 ||
      dtype > 2)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(image) & 15 ||
      reinterpret_cast<uintptr_t>(stash) & 255 ||
      reinterpret_cast<uintptr_t>(scratch) & 255 ||
      reinterpret_cast<uintptr_t>(tail_w) & 15)
    return cudaErrorMisalignedAddress;
  const int in_dim = dp * (2 * L + 1);
  if (scratch_bytes < train_scratch(n, W, r2l::round_up(in_dim, r2l::kKAlign),
                                    dtype, stash_q, use_residual))
    return cudaErrorInvalidValue;
  Train c{};
  c.pts = pts;
  c.n = n;
  c.dp = dp;
  c.L = L;
  c.in_dim = in_dim;
  c.image = image;
  c.head_b = head_b;
  c.body_b = body_b;
  c.head_inv = head_inv;
  c.body_inv = body_inv;
  c.tail_w = tail_w;
  c.tail_m = tail_m;
  c.tail_b = tail_b;
  c.tail_inv = tail_inv;
  c.out = out;
  c.stash = static_cast<unsigned char*>(stash);
  c.scratch = scratch;
  c.W = W;
  c.nb = nb;
  c.out_dim = out_dim;
  c.res_scale = res_scale;
  c.use_residual = use_residual;
  c.linear_tail = linear_tail;
  c.stash_q = stash_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case r2lw::kBF16: return run_k3<__nv_bfloat16>(c, s);
    case r2lw::kF32: return run_k3<float>(c, s);
    default: return stash_q ? run_k48<true>(c, s) : run_k48<false>(c, s);
  }
}
