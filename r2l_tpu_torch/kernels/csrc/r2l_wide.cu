// The wide form of K1, K9 and K2: the student's frame at any netwidth that
// is a multiple of 128 (r2l_fused.py sends every student wider than 256
// here, padded with zero channels to that multiple, and K2's students
// whose 2L+1 encoding parts overflow its head slice).
//
// Replaces, at those widths, the Pallas TPU kernels r2l_tpu/kernels/
// r2l_pallas.py::fused_r2l_apply_pe (:164; bf16 and f32 weights),
// fused_r2l_apply (:270; an encoded input, bf16 and f32) and
// fused_r2l_apply_int8_pe (:571; in _int8_pe_chain's three forms, each
// also with bf16_resid).
//
// Every layer is a pass of the Hopper pass skeleton (wide_hopper.cuh:
// wgmma fed by TMA, a producer warpgroup, two consumer warpgroups,
// two-block clusters multicasting the weights), as the training forward's
// (r2l_wide_train.cu). A call runs over the rays in passes of `rows` (the
// wrapper cuts them only to bound the scratch), each:
//   1. The head's input [rows, kp] written once (kp = in_dim rounded up to
//      128); the skeleton reads A only through tensor maps. K1 and K2:
//      train_encode (r2l_wide.cuh), the double-angle ladder in the head's
//      freq-major column order, in the compute type or as K2's head codes.
//      K9: cast_x, x rounded to the compute type in r2l_embed's order (its
//      head's), zeros past in_dim; K9 f32 with in_dim a multiple of 4 maps
//      x itself (TMA fills the columns past in_dim with zeros).
//   2. nb * nl + 1 skeleton passes, the head then each body layer, against
//      the image's weights [W, K] row-major (r2l_fused.py, stage_wide_train:
//      f32 its TF32 high parts, then its low parts, a layer at a time; the
//      training forward reads the same image). K1/K9 with the epilogue
//      TrainK3<T, true>, the rounding points of _chain_ref (r2l_fused.py):
//      the bias in f32, ReLU inside a block, the cast to the compute type;
//      at a block's end (t * res_scale + h) from the rounded t, rounded;
//      each layer's output to a scratch buffer in turn (h0, two h, up to
//      two t). K2 with FrameK2 (int8_pe_chain_ref's, in each form): its
//      codes to two scratch buffers in turn, its bf16 residual stream in
//      the passes' side tiles (128-wide tiles), its f32 h0 beside.
//   3. wide_tail (r2l_wide.cuh): a reduction to at most 8 outputs, K1/K9
//      of h + h0 rounded (after the last block + h0, rounded), K2 of the
//      codes of h + h0.
// Sums: bf16 one running sum over K; int8 exact; f32 3xTF32 on one running
// sum (kF32Split), K6 f32's route: an emulation of the tensor cores'
// truncating sums reads K1 f32 at W512/D12 and K9 f32 at W512/D24 far
// inside their 1e-4 limit on rgb that way (tests/test_torch_wide_train.py,
// PERF.md).
//
// What bounds it: the products (2 W^2 operations a ray a layer) at the
// card's tensor rate, and the bytes: the encoding written and read once,
// each pass its input row and its output row, a block's end also h (K2:
// its bf16 side tile read and written), the tail h and h0 (chip_smoke.py's
// wide_frame_design_bytes). PERF.md has the measured times.
#include "r2l_wide.cuh"
#include "wide_hopper.cuh"

using namespace r2lw;

namespace {

// f32's sum route (wide_hopper.cuh's kSplit): one running sum over K.
constexpr int kF32Split = 0;

// Everything a call needs (the C entry point's arguments).
struct Frame {
  const float* in;   // pe: pts [n, dp]; else x [n, in_dim]
  int n, dp, L, in_dim, pe;
  const unsigned char* image;  // stage_wide_train's
  const float* head_b;         // bf16/f32 [W]
  const float* body_b;         // bf16/f32 [nb * nl, W]
  const float* head_inv;       // int8 [in_dim]
  const float* body_inv;       // int8 [nb * nl, W]
  const void* tail_w;          // [out_dim, W], the weight type (int8: codes)
  const float* tail_m;         // int8 [out_dim]
  const float* tail_b;         // [out_dim]
  const float* tail_inv;       // int8 [W]
  float* out;                  // [n, out_dim]
  unsigned char* scratch;
  int rows;                    // rays a pass
  int W, nb, nl, out_dim;
  float res_scale;
  int use_residual, linear_tail, epilogue;
};

// Whether the head maps x [n, in_dim] itself (K9 f32, its rows a multiple
// of 16 bytes), writing no encoding.
bool maps_x(int dtype, int pe, int in_dim) {
  return !pe && dtype == kF32 && in_dim % 4 == 0;
}

// The scratch of passes of `rows` rays (r2l_fused.py, wide_scratch_bytes):
// the head's input [rows, kp] of the compute type (int8: its codes; none
// where the head maps x); bf16/f32 then h0 (with the global residual), two
// h and min(nl - 1, 2) t of the compute type; int8 two code buffers, the
// bf16 residual stream and an f32 h0 (with the global residual); each
// [rows, W], 256-byte aligned.
long long frame_scratch(long long rows, int W, int in_dim, int dtype, int pe,
                        int nl, int use_residual) {
  const long long e = rows * W;
  const int es = elem_bytes(dtype);
  const long long enc =
      maps_x(dtype, pe, in_dim)
          ? 0
          : aligned(rows * r2l::round_up(in_dim, r2l::kKAlign) * es);
  if (dtype == kS8)
    return enc + 2 * aligned(e) + aligned(2 * e) +
           (use_residual ? aligned(4 * e) : 0);
  const int bufs = 2 + (nl - 1 < 2 ? nl - 1 : 2) + (use_residual ? 1 : 0);
  return enc + bufs * aligned(e * es);
}

// K9's head input: x [n, in_dim] f32 rounded to C into E [n, kp], zeros
// past in_dim; its plain twin is r2l_fused.py's wide_cast_ref.
template <typename C>
__global__ void __launch_bounds__(256)
    cast_x(const float* __restrict__ x, long long n, int in_dim, int kp,
           C* __restrict__ E) {
  const long long total = n * kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / kp;
    const int c = (int)(i - r * kp);
    E[i] = head_code<C>(c < in_dim ? __ldg(x + r * in_dim + c) : 0.f,
                        nullptr, c);
  }
}

template <typename C>
cudaError_t cast(const float* x, long long n, int in_dim, int kp, void* E,
                 cudaStream_t st) {
  const long long blocks = (n * kp + 255) / 256;
  cast_x<C><<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), 256, 0,
              st>>>(x, n, in_dim, kp, static_cast<C*>(E));
  return cudaGetLastError();
}

// K1/K9 (bf16, f32): per pass of rays the head's input, the head, every
// body layer, the tail.
template <typename C>
cudaError_t run_float(const Frame& c, cudaStream_t st) {
  constexpr int es = sizeof(C), parts = es == 4 ? 2 : 1;
  constexpr int T = es == 4 ? kF32 : kBF16;
  constexpr int kSplit = es == 4 ? kF32Split : 0;
  using Epi = wideh::TrainK3<C, true>;
  const int W = c.W, nl = c.nl, rows = c.rows;
  const int kp = r2l::round_up(c.in_dim, r2l::kKAlign);
  const bool direct = maps_x(T, c.pe, c.in_dim);
  const size_t head_bytes = (size_t)W * kp * es * parts;
  const size_t layer_bytes = (size_t)W * W * es * parts;
  const long long e = (long long)rows * W;
  unsigned char* s = c.scratch;
  unsigned char* enc = s;
  if (!direct) s += aligned((long long)rows * kp * es);
  unsigned char* h0 = nullptr;
  if (c.use_residual) {
    h0 = s;
    s += aligned(e * es);
  }
  unsigned char *H[2], *X[2] = {nullptr, nullptr};
  for (int i = 0; i < 2; ++i, s += aligned(e * es)) H[i] = s;
  for (int i = 0; i < 2 && i < nl - 1; ++i, s += aligned(e * es)) X[i] = s;
  const int in_w = c.pe ? c.dp : c.in_dim;
  cudaError_t err = cudaSuccess;
  for (int r0 = 0; r0 < c.n && err == cudaSuccess; r0 += rows) {
    const int n = c.n - r0 < rows ? c.n - r0 : rows;
    const float* in = c.in + (size_t)r0 * in_w;
    CUtensorMap a;
    if (c.pe)
      err = encode<C>(in, n, c.dp, c.L, kp, nullptr, enc, st);
    else if (!direct)
      err = cast<C>(in, n, c.in_dim, kp, enc, st);
    if (err == cudaSuccess)
      err = direct ? wideh::act_map<float>(&a, in, n, c.in_dim)
                   : wideh::act_map<C>(&a, enc, n, kp);
    // the head's output is h0, block 0's input; a block's end writes the
    // h buffer its input is not
    unsigned char* cur = c.use_residual ? h0 : H[0];
    int nx = c.use_residual ? 0 : 1;
    if (err == cudaSuccess)
      err = wideh::layer_pass<C, Epi, kSplit>(
          a, c.image, n, W, kp, cur, {c.head_b, nullptr, n, W, c.res_scale},
          st);
    for (int b = 0; b < c.nb && err == cudaSuccess; ++b)
      for (int j = 0; j < nl && err == cudaSuccess; ++j) {
        const int idx = b * nl + j;
        const bool last = j == nl - 1;
        err = wideh::act_map<C>(&a, j == 0 ? cur : X[(j - 1) & 1], n, W);
        if (err == cudaSuccess)
          err = wideh::layer_pass<C, Epi, kSplit>(
              a, c.image + head_bytes + idx * layer_bytes, n, W, W,
              last ? H[nx] : X[j & 1],
              {c.body_b + (size_t)idx * W,
               last ? reinterpret_cast<const C*>(cur) : nullptr, n, W,
               c.res_scale},
              st);
        if (last) {
          cur = H[nx];
          nx ^= 1;
        }
      }
    if (err != cudaSuccess) break;
    wide_tail<T><<<(n + 7) / 8, 256, 0, st>>>(
        cur, n, W, c.tail_w, nullptr, c.tail_b, c.out_dim, c.linear_tail,
        c.out + (size_t)r0 * c.out_dim, c.use_residual ? h0 : nullptr);
    err = cudaGetLastError();
  }
  return err;
}

// K2 (int8, c.epilogue its form): per pass of rays the head's codes, the
// head, every body layer, the tail on the last codes.
cudaError_t run_k2(const Frame& c, cudaStream_t st) {
  using Epi = wideh::FrameK2;
  const int W = c.W, nl = c.nl, nb = c.nb, rows = c.rows;
  const int kp = r2l::round_up(c.in_dim, r2l::kKAlign);
  const size_t head_bytes = (size_t)W * kp, layer_bytes = (size_t)W * W;
  const float* table = reinterpret_cast<const float*>(
      c.image + head_bytes + (size_t)nb * nl * layer_bytes);
  const long long e = (long long)rows * W;
  unsigned char* s = c.scratch;
  unsigned char* enc = s;
  s += aligned((long long)rows * kp);
  unsigned char* X[2];  // the codes
  for (int i = 0; i < 2; ++i, s += aligned(e)) X[i] = s;
  unsigned char* hs = s;  // the bf16 residual stream
  s += aligned(2 * e);
  float* h0 = c.use_residual ? reinterpret_cast<float*>(s) : nullptr;
  cudaError_t err = cudaSuccess;
  for (int r0 = 0; r0 < c.n && err == cudaSuccess; r0 += rows) {
    const int n = c.n - r0 < rows ? c.n - r0 : rows;
    CUtensorMap a;
    err = encode<int8_t>(c.in + (size_t)r0 * c.dp, n, c.dp, c.L, kp,
                         c.head_inv, enc, st);
    if (err == cudaSuccess) err = wideh::act_map<int8_t>(&a, enc, n, kp);
    if (err == cudaSuccess)
      err = wideh::layer_pass<int8_t, Epi>(
          a, c.image, n, W, kp, X[0],
          {table, nb > 0 ? c.body_inv : c.tail_inv, h0, Epi::kHead, nb == 0,
           n, W, c.epilogue},
          st, nullptr, hs);
    int q = 0;  // the buffer of the codes the next product reads
    for (int b = 0; b < nb && err == cudaSuccess; ++b)
      for (int j = 0; j < nl && err == cudaSuccess; ++j) {
        const int idx = b * nl + j;
        const bool last = j == nl - 1, final_ = last && b == nb - 1;
        err = wideh::act_map<int8_t>(&a, X[q], n, W);
        const Epi::Args lp{
            table + 2 * (size_t)W * (1 + idx),
            final_ ? c.tail_inv : c.body_inv + (size_t)(idx + 1) * W, h0,
            last ? Epi::kEnd : Epi::kInner, final_, n, W, c.epilogue};
        // a block's end reads h_in and writes h in place; an inner layer
        // carries no side tile
        if (err == cudaSuccess)
          err = wideh::layer_pass<int8_t, Epi>(
              a, c.image + head_bytes + idx * layer_bytes, n, W, W, X[q ^ 1],
              lp, st, last ? hs : nullptr, last ? hs : nullptr);
        q ^= 1;
      }
    if (err != cudaSuccess) break;
    wide_tail<kS8><<<(n + 7) / 8, 256, 0, st>>>(
        X[q], n, W, c.tail_w, c.tail_m, c.tail_b, c.out_dim, c.linear_tail,
        c.out + (size_t)r0 * c.out_dim);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// in: pe ? pts [n, dp] (in_dim = dp * (2L + 1)) : x [n, in_dim], f32 (K9
// f32 with in_dim a multiple of 4: 16-byte aligned). dtype: 0 bf16, 1 f32
// (weights and compute), 2 int8 (pe only; epilogue one of K2's forms,
// FrameK2::Form, plus FrameK2::kBf16Resid for bf16_resid). image:
// stage_wide_train's weights of the head ([W, in_dim padded to 128] in the
// fields' column order) and of every body layer,
// [W, K] row-major each (f32: its TF32 high parts, then its low parts), then
// for int8 the (m, b) table of the head and the body. scratch:
// wide_scratch_bytes(rows, ...) bytes, 256-byte aligned; rows: rays a pass
// (0: all n). Returns a cudaError_t: a launch's own error,
// cudaErrorNotSupported where a tensor map cannot be made, or
// cudaErrorInvalidValue for a shape the wide form does not take (W not a
// multiple of 128, no layer a block, more than 8 outputs) or a scratch too
// small.
extern "C" int r2l_wide_launch(
    const float* in, int n, int dp, int L, int in_dim, int pe, int dtype,
    const unsigned char* image, const float* head_b, const float* body_b,
    const float* head_inv, const float* body_inv, const void* tail_w,
    const float* tail_m, const float* tail_b, const float* tail_inv,
    float* out, unsigned char* scratch, long long scratch_bytes, int rows,
    int W, int nb, int nl, int out_dim, float res_scale, int use_residual,
    int linear_tail, int epilogue, void* stream) {
  if (n <= 0 || W <= 0 || W % kWideChannels != 0 || nb < 0 || nl < 1 ||
      out_dim < 1 || out_dim > kMaxOut || in_dim <= 0 || dtype < 0 ||
      dtype > 2 || epilogue < 0 ||
      (epilogue & ~wideh::FrameK2::kBf16Resid) > 2)
    return cudaErrorInvalidValue;
  if (pe && (dp <= 0 || L <= 0 || in_dim != dp * (2 * L + 1)))
    return cudaErrorInvalidValue;
  if (dtype == kS8 && !pe) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(image) & 15 ||
      reinterpret_cast<uintptr_t>(scratch) & 255 ||
      reinterpret_cast<uintptr_t>(tail_w) & 15 ||
      (maps_x(dtype, pe, in_dim) && reinterpret_cast<uintptr_t>(in) & 15))
    return cudaErrorMisalignedAddress;
  rows = rows > 0 && rows < n ? rows : n;
  if (scratch_bytes <
      frame_scratch(rows, W, in_dim, dtype, pe, nl, use_residual))
    return cudaErrorInvalidValue;
  Frame c{};
  c.in = in;
  c.n = n;
  c.dp = dp;
  c.L = L;
  c.in_dim = in_dim;
  c.pe = pe;
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
  c.scratch = scratch;
  c.rows = rows;
  c.W = W;
  c.nb = nb;
  c.nl = nl;
  c.out_dim = out_dim;
  c.res_scale = res_scale;
  c.use_residual = use_residual;
  c.linear_tail = linear_tail;
  c.epilogue = epilogue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return run_float<__nv_bfloat16>(c, s);
    case kF32: return run_float<float>(c, s);
    default: return run_k2(c, s);
  }
}
