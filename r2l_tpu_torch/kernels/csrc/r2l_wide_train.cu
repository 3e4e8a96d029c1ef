// The wide form of the training forward: K3 (bf16 and f32 weights) and K4 /
// K8 (static-scale int8, the q-value or the bf16 stash) for every student
// the chain kernels (r2l_hopper.cuh, r2l_int8_hopper.cuh: W 64, 128 and
// 256) do not hold, at any multiple of kWideChannels (r2l_train.py sends
// every training step wider than 256 here, and an int8 one whose 2L+1
// encoding parts overflow K4's head slice).
//
// Replaces, at those widths, the Pallas TPU kernels r2l_tpu/kernels/
// r2l_train_pallas.py::train_fwd (:54) and train_fwd_int8 (:182, stash_q
// True and False). The passes are the frame's wide form (r2l_wide.cuh: one
// mma.sync pass a layer, 128 rays x 128 channels a block, the head encoding
// its points by the ladder), and the activations they would keep in a
// scratch are the stash [2nb+1, n, W] itself: h_0 in row 0, block b's inner
// t in row nb+1+b and its output in row b+1 (K4: the codes the products
// read, row nb the tail's). The rounding points are train_fwd_ref's and
// train_fwd_int8_ref's (r2l_train.py); K4 and K8 compute them bit for bit.
// f32 is 3xTF32, each k8 step's products summed apart (kSplit).
//
// What bounds it: the products, 2 W^2 operations a ray a layer (W512/D88 at
// 81,920 rays: 3.70 T, 3.74 ms at 989 bf16 TFLOP/s, 22.4 ms for f32 as
// 3xTF32 at 495, 1.87 ms in int8), and the stash, written once and read by
// the next pass: 7.30 GB bf16 (2.18 ms at 3.35 TB/s each way). PERF.md has
// the measured times.
#include "r2l_wide.cuh"

using namespace r2lw;

namespace {

// Everything a call needs (the C entry point's arguments).
struct Train {
  const float* pts;
  int n, dp, L, in_dim;
  const unsigned char* image;  // stage_wide_chain's
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

// K3: head, two passes a block, tail; every pass's output a stash row.
template <int T>
cudaError_t run_k3(const Train& c, cudaStream_t st) {
  constexpr int es = elem_bytes(T);
  const int W = c.W;
  const size_t rowb = (size_t)c.n * W * es;
  auto row = [&](int r) { return c.stash + (size_t)r * rowb; };
  const size_t head_bytes =
      (size_t)W * r2l::round_up(c.in_dim, r2l::kKAlign) * es;
  const size_t layer_bytes = (size_t)W * W * es;
  Params p{};
  p.n = c.n;
  p.W = W;
  p.res_scale = c.res_scale;
  p.train = 1;
  Params hp = p;
  hp.Kb = r2l::round_up(c.in_dim, r2l::kKAlign) * es;
  hp.w = c.image;
  hp.in = c.pts;
  hp.dp = c.dp;
  hp.L = c.L;
  hp.in_dim = c.in_dim;
  hp.bias = c.head_b;
  hp.kind = kHead;
  hp.hout = row(0);
  cudaError_t err = pass<T, kPE, true>(hp, st);
  if (err != cudaSuccess) return err;
  for (int b = 0; b < c.nb; ++b) {
    for (int j = 0; j < 2; ++j) {
      Params lp = p;
      lp.Kb = W * es;
      lp.w = c.image + head_bytes + (2 * b + j) * layer_bytes;
      lp.bias = c.body_b + (size_t)(2 * b + j) * W;
      if (j == 0) {
        lp.kind = kInner;
        lp.a = row(b);
        lp.out = row(c.nb + 1 + b);
      } else {
        lp.kind = kBlockEnd;
        lp.a = row(c.nb + 1 + b);
        lp.hin = row(b);
        lp.hout = row(b + 1);
      }
      err = pass<T, kBody, true>(lp, st);
      if (err != cudaSuccess) return err;
    }
  }
  wide_tail<T><<<(c.n + 7) / 8, 256, 0, st>>>(
      row(c.nb), c.n, W, c.tail_w, nullptr, c.tail_b, c.out_dim,
      c.linear_tail, c.out, c.use_residual ? row(0) : nullptr);
  return cudaGetLastError();
}

// The scratch of K4 (an f32 stream, and h0 with the global residual) or K8
// (two code buffers, and h0); r2l_train.py's wide_train_scratch_bytes.
long long k48_scratch(long long n, int W, int stash_q, int use_residual) {
  const long long e = n * W;
  return (stash_q ? aligned(4 * e) : 2 * aligned(e)) +
         (use_residual ? aligned(4 * e) : 0);
}

// K4 / K8: the int8 passes with the training epilogues.
cudaError_t run_k48(const Train& c, cudaStream_t st) {
  const int W = c.W, nb = c.nb;
  const long long e = (long long)c.n * W;
  const size_t rowb = (size_t)e * (c.stash_q ? 1 : 2);
  auto row = [&](int r) { return c.stash + (size_t)r * rowb; };
  const int kpad = r2l::round_up(c.in_dim, r2l::kKAlign);
  const size_t head_bytes = (size_t)W * kpad;
  const size_t layer_bytes = (size_t)W * W;
  const float* table = reinterpret_cast<const float*>(
      c.image + head_bytes + 2 * nb * layer_bytes);
  unsigned char* s = c.scratch;
  void *hs = nullptr, *X[2] = {nullptr, nullptr}, *h0 = nullptr;
  if (c.stash_q) {
    hs = s;
    s += aligned(4 * e);
  } else {
    for (int i = 0; i < 2; ++i, s += aligned(e)) X[i] = s;
  }
  if (c.use_residual) h0 = s;
  // the codes a pass writes and the next reads: K4's stash rows, K8's
  // scratch in turn
  int q = 0;
  auto codes_out = [&](int stash_row) -> void* {
    return c.stash_q ? static_cast<void*>(row(stash_row)) : X[q ^ 1];
  };
  Params p{};
  p.n = c.n;
  p.W = W;
  p.use_residual = c.use_residual;
  p.epilogue = c.stash_q ? kTrainQ : kTrainB;
  p.h0 = h0;
  Params hp = p;
  hp.Kb = kpad;
  hp.w = c.image;
  hp.in = c.pts;
  hp.dp = c.dp;
  hp.L = c.L;
  hp.in_dim = c.in_dim;
  hp.head_inv = c.head_inv;
  hp.bias = table;
  hp.kind = kHead;
  hp.final_ = nb == 0;
  hp.hout = c.stash_q ? hs : static_cast<void*>(row(0));
  hp.out = c.stash_q ? static_cast<void*>(row(0)) : X[0];
  hp.inv = nb > 0 ? c.body_inv : c.tail_inv;
  cudaError_t err = pass<kS8, kPE>(hp, st);
  if (err != cudaSuccess) return err;
  for (int b = 0; b < nb; ++b) {
    for (int j = 0; j < 2; ++j) {
      const int idx = 2 * b + j;
      Params lp = p;
      lp.Kb = W;
      lp.w = c.image + head_bytes + idx * layer_bytes;
      lp.bias = table + 2 * (size_t)W * (1 + idx);
      lp.a = c.stash_q ? static_cast<const void*>(row(j ? nb + 1 + b : b))
                       : X[q];
      if (j == 0) {
        lp.kind = kInner;
        lp.out = codes_out(nb + 1 + b);
        lp.hout = c.stash_q ? nullptr : static_cast<void*>(row(nb + 1 + b));
        lp.inv = c.body_inv + (size_t)(idx + 1) * W;
      } else {
        lp.kind = kBlockEnd;
        lp.final_ = b == nb - 1;
        lp.out = codes_out(b + 1);
        lp.hin = c.stash_q ? hs : static_cast<void*>(row(b));
        lp.hout = c.stash_q ? hs : static_cast<void*>(row(b + 1));
        lp.inv = lp.final_ ? c.tail_inv : c.body_inv + (size_t)(idx + 1) * W;
      }
      err = pass<kS8, kBody>(lp, st);
      if (err != cudaSuccess) return err;
      q ^= 1;
    }
  }
  wide_tail<kS8><<<(c.n + 7) / 8, 256, 0, st>>>(
      c.stash_q ? static_cast<const void*>(row(nb)) : X[q], c.n, W,
      c.tail_w, c.tail_m, c.tail_b, c.out_dim, c.linear_tail, c.out);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// pts [n, dp] f32 (in_dim = dp * (2L + 1)); dtype: 0 bf16, 1 f32 (K3), 2
// int8 (K4 with stash_q, else K8). image: stage_wide_chain's tiles of the
// head ([W, in_dim padded to 128], freq-major) and of every body layer,
// then for int8 the (m, b) table of the head and the body. stash [2nb+1, n,
// W]: the weight type (K3), int8 (K4) or bf16 (K8). scratch: int8 only,
// wide_train_scratch_bytes(n, ...) bytes, 256-byte aligned. Returns a
// cudaError_t: a launch's own error, or cudaErrorInvalidValue for a shape
// the wide form does not take (W not a multiple of 128, more than 8
// outputs) or a scratch too small.
extern "C" int r2l_wide_train_fwd_launch(
    const float* pts, int n, int dp, int L, int dtype, int stash_q,
    const unsigned char* image, const float* head_b, const float* body_b,
    const float* head_inv, const float* body_inv, const void* tail_w,
    const float* tail_m, const float* tail_b, const float* tail_inv,
    float* out, void* stash, unsigned char* scratch, long long scratch_bytes,
    int W, int nb, int out_dim, float res_scale, int use_residual,
    int linear_tail, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || W <= 0 || W % kWideChannels != 0 ||
      nb < 0 || out_dim < 1 || out_dim > kMaxOut || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(image) & 15 ||
      reinterpret_cast<uintptr_t>(stash) & 255 ||
      reinterpret_cast<uintptr_t>(scratch) & 255 ||
      reinterpret_cast<uintptr_t>(tail_w) & 15)
    return cudaErrorMisalignedAddress;
  if (dtype == kS8 &&
      scratch_bytes < k48_scratch(n, W, stash_q, use_residual))
    return cudaErrorInvalidValue;
  Train c{};
  c.pts = pts;
  c.n = n;
  c.dp = dp;
  c.L = L;
  c.in_dim = dp * (2 * L + 1);
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
    case kBF16: return run_k3<kBF16>(c, s);
    case kF32: return run_k3<kF32>(c, s);
    default: return run_k48(c, s);
  }
}
