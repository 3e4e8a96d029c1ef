// Probe: the bf16 chain at N=512 (does a wider product lift K1's engine?),
// on Hopper's wgmma.
//
// Replaces the Pallas TPU kernel exp/probe_mxu.py::make_bign (its body
// bign_kernel): x [N, 256] f32, rounded to bf16, through n_pairs pairs
//   a = bf16(relu(h W1_p^T))   [T, 512]
//   h = bf16(relu(a W2_p^T))   [T, 256]
// with bf16 weights packed [out, in] (W1 [n_pairs, 512, 256], W2
// [n_pairs, 256, 512]), then f32 [N, 256]. JAX asks a bf16 accumulation;
// as in probe_chain.cu the port sums in f32 and rounds once.
//
// Design: probe_hopper.cuh's bf16 skeleton with an N=512 stage pair. Two
// 64-ray consumer warpgroups a block and a producer that bulk-copies the
// image (probe_mxu.stage_bign: per pair W1's two 256-row halves, four
// 32 KB stages each, then W2's eight) into K1's ring of three 32 KB slots
// multicast over a 2-block cluster. Each product is wgmma m64n256k16 into
// one f32 accumulator of 128 registers. The 512-wide a does not fit beside
// h and the ring (h 64 KB and a 128 KB a block), so a's first half goes to
// a tile A0 and its second half over h, in place (its product has read h
// at wgmma.wait_group, and each thread writes its warpgroup's rows only);
// the second product reads K = 512 from A0, then h, and writes h in place.
// Shared memory: h 64 KB, A0 64 KB, three slots 96 KB: 224 KB. Three slots
// cannot hold a product's four or eight stages, which a ping-pong needs (a
// slot refills only once every warpgroup of the cluster released it), so
// the two warpgroups run in lockstep.
//
// What bounds it: 2 * 2 * 256 * 512 multiply-adds per ray and pair, 3.69
// TFLOP for the probe's 163,840 rays x 43 pairs, against 336 MB of f32
// input and output: 3.735 ms at the data-sheet 989 bf16 TFLOP/s,
// compute-bound. The image (22.5 MB) is read from L2 once per cluster:
// 14.4 GB a frame.
#include "probe_hopper.cuh"

using namespace probe_h;

namespace {

constexpr int kPairStages = 16;  // W1's halves 4 + 4, W2 8
constexpr int kTile = 64 * kW * 2;  // a warpgroup's [64 x 256] bf16

struct BignArgs {
  const float* x;  // [n, 256] f32
  int n;
  const unsigned char* staged;  // n_pairs x 16 stages of bf16 weights
  float* out;      // [n, 256] f32
  int n_pairs;
};

__global__ void __launch_bounds__(kWG * 3, 1)
    probe_bign_kernel(const BignArgs a) {
  using K = Kind<__nv_bfloat16>;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  if (!start<__nv_bfloat16, K>(smem, 4 * kTile, a.staged,
                               a.n_pairs * kPairStages, ring))
    return;
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const int row0 = (blockIdx.x * 2 + wg) * 64, bar_id = 1 + wg;
  const int r0 = 16 * (wtid / 32) + wtid % 32 / 4;
  unsigned char* H = smem + wg * kTile;         // h; a's second half
  unsigned char* A0 = smem + (2 + wg) * kTile;  // a's first half
  const Turns<false> turns{wg};

  each_own(row0, a.n, wtid, [&](int, int h, int c, int g) {
    const float2 v = load2(a.x, g, c);
    at2(H, r0 + 8 * h, c) = __floats2bfloat162_rn(v.x, v.y);
  });

  float acc[kW / 2];
  int it = 0;
  // acc = A B^T over kin channels of A: the first 256 from t0, the rest
  // from H; then bf16(relu(acc)) into tile `to`
  auto layer = [&](const unsigned char* t0, int kin, unsigned char* to,
                   int i) {
    fence_async_smem();  // the epilogue's writes, before wgmma reads them
    wg_bar(bar_id);
    turns.before(i);
    product<__nv_bfloat16, kW, kC, K>(acc, t0, 2 * kW, kW, H, 2 * kW, kin,
                                      ring, it, wtid);
    turns.after();
    visit<kW>(acc, wtid, [&](int, int r, int c, float v0, float v1) {
      at2(to, r, c) = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
  };
  for (int p = 0; p < a.n_pairs; ++p) {
    layer(H, kW, A0, 3 * p);              // a[:, :256] (W1_p rows 0-255)
    layer(H, kW, H, 3 * p + 1);           // a[:, 256:] over h
    layer(A0, 2 * kW, H, 3 * p + 2);      // h = relu(a W2_p^T), K = 512
  }
  turns.finish();
  each_own(row0, a.n, wtid, [&](int, int h, int c, int g) {
    store2(a.out, g, c, __bfloat1622float2(at2(H, r0 + 8 * h, c)));
  });
  cluster_sync();
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: probe_mxu.stage_bign's image of the n_pairs pairs of W1 [512,
// 256] and W2 [256, 512] bf16. Returns a cudaError_t: the launch's own
// error, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int probe_bign_launch(const float* x, int n, const void* staged,
                                 float* out, int n_pairs, void* stream) {
  if (n <= 0 || n_pairs < 1) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(staged) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  BignArgs a{};
  a.x = x;
  a.n = n;
  a.staged = static_cast<const unsigned char*>(staged);
  a.out = out;
  a.n_pairs = n_pairs;
  using K = Kind<__nv_bfloat16>;
  return launch_cluster<__nv_bfloat16, kC, K>(
      probe_bign_kernel, a, blocks_of(n), smem_bytes<K>(4 * kTile),
      static_cast<cudaStream_t>(stream));
}
