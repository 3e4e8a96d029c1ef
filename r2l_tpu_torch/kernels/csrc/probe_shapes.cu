// Probe: tensor-core rate by product shape and dtype, unchained or chained,
// on Hopper's wgmma.
//
// Replaces the Pallas TPU kernel exp/probe_shapes.py::run_shape (its body
// unchained_kernel): a fixed input x [rows, K] (bf16 or int8) against
// n_layers weight matrices W_i [K, N] of the same type; out [rows] f32:
//   free     acc = sum over i, in layer order, of f32(x W_i) (f32 adds;
//            an int8 dot is an exact int32, below 2^24 for K <= 1024), then
//            the sum of acc over N;
//   chained  (K = N) h = x, then h = cast(h W_i) n_layers times (int8 wraps
//            modulo 256, bf16 rounds to nearest even), then the sum of
//            f32(h) over N.
// The sum over N is taken in float64 and rounded once to f32: for int8 its
// terms are integers below 2^31, so it is exact in any order and the kernel
// equals the plain version bit for bit.
//
// Design (the student's Hopper skeleton, hopper_ring.cuh and
// hopper_wgmma.cuh): a block holds kWGs consumer warpgroups of 64 rows
// (wgmma's M) and one producer warpgroup, of which one thread bulk-copies
// the weight stages into a ring of four 16 KB slots; two blocks form a
// cluster and share every stage by multicast, so the weights are read from
// L2 once per cluster. The weights come as a staged image
// (probe_shapes.stage_shape_weights): the output columns cut into chunks of
// 128 (wgmma's N here), each chunk's [128, K] rows cut into stages of 128
// bytes of K (64 bf16 or 128 int8 channels) laid out as wgmma reads B
// (K-major core matrices), in the order the consumers take them: free,
// chunk by chunk, each through every layer; chained, layer by layer, each
// through every chunk. Products are wgmma m64n128k16 bf16 -> f32 and
// m64n128k32 s8 -> s32, B in shared memory; A, the x tile, in registers in
// the free form where a row's K is 256 or 512 bytes (64 registers at
// most: each thread loads its fragments once, for every product, so A is
// never read from shared memory, which the stages' copies and B's reads
// share), else A in shared memory too (h, the chain's, always) in the
// core-matrix layout.
//
// The free form's sum order is the function: each product gets its own
// accumulator (scale-d 0 at its first k-step), which is then added to the
// running f32 sum of its chunk in layer order. Both live in registers, 64
// each a thread at 128 columns (256 columns would take 2 x 128). The
// chained form writes each chunk's cast output into the other of two h
// tiles, so a layer reads h whole while the next h is written; its last
// layer's outputs go into the row sums as they are cast.
//
// Shared memory: the x tile (free, A not in registers) or two h tiles
// (chained), 64 x K bytes of the type per warpgroup, then the ring (64
// KB). Two consumer warpgroups where that fits in 227 KB; one where it
// does not (bf16 free at K = 1024, bf16 chained at K = N = 512), with half
// the rows a block. With A in registers the consumers take the producer's
// registers (setmaxnreg: 232 a thread for A, the accumulator and the sum).
//
// What bounds it: rows * K * N * n_layers multiply-adds; at the probe's
// (M, K, N) = (1024, 256, 256), 32,768 rows and 64 layers, 0.275 T
// operations: 0.278 ms at the data-sheet 989 bf16 TFLOP/s, 0.139 ms at
// 1,979 int8 TOP/s, compute-bound (the 8 MB of bf16 weights stay in L2).
// There, 128-row blocks in 2-block clusters make 256 blocks, one an SM:
// two waves on 132 SMs, the second 124 blocks (94% full). Split runs
// (r2l_tpu_torch/exp/shape_variants.py; PERF.md) put the ring's copies
// alone near half the time, the products with the ring near all of it:
// the stages' copies and the operands' reads share each SM's shared
// memory, which A in registers relieves.
#include <type_traits>

#include "hopper_ring.cuh"

namespace {

using namespace hopper;

constexpr int kNC = 128;   // output columns per chunk: wgmma's N
constexpr int kC = 2;      // blocks of a cluster

// The ring's shape (hopper::Kind's members): stages of 128 bytes of K for
// 128 output rows, kWGs consumer warpgroups.
template <typename T, int kWGs_>
struct ShapeRing {
  using Acc = typename std::conditional<sizeof(T) == 1, int, float>::type;
  static constexpr int kKSB = 128, kKS = kKSB / (int)sizeof(T);
  static constexpr int kWGs = kWGs_, kStages = 4, kParts = 1;
  static constexpr bool kRegA = false;
};

constexpr int kSlotBytes = kNC * 128;

struct Args {
  const unsigned char* x;       // [n, K] of T
  int n, K, N, n_layers;
  const unsigned char* staged;  // stage_shape_weights' image
  float* out;                   // [n]
  int tile_bytes, off_ring, off_bar, stages;
};

__device__ __forceinline__ float as_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// d = A B^T over a product's stages with A from registers (a, kSteps
// k-steps) and B from the ring, as hopper::mm_ss: each stage's products
// one group, the previous stage released once its group completed.
template <int kSteps, typename R>
__device__ __forceinline__ void product_rs(typename R::Acc (&d)[kNC / 2],
                                           uint32_t (&a)[kSteps][4],
                                           const Ring& ring, int& it,
                                           int wtid, int accumulate = 0) {
  constexpr int kJ = R::kKSB / 32;  // k-steps a stage
  int pend = -1;
  fence_regs(d);
#pragma unroll
  for (int st = 0; st < kSteps / kJ; ++st, ++it) {
    const int slot = it % R::kStages, ph = (it / R::kStages) & 1;
    bar_wait(ring.full + 8 * slot, ph);
    wgmma_fence();
    const uint32_t b = ring.slots + slot * ring.slot_bytes;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      if constexpr (std::is_same<typename R::Acc, int>::value)
        Wgmma<kNC>::s8_rs(d, a[st * kJ + j], desc(b + j * 256, R::kKSB * 8),
                          st > 0 || j > 0 || accumulate);
      else
        Wgmma<kNC>::bf16_rs(d, a[st * kJ + j],
                            desc(b + j * 256, R::kKSB * 8),
                            st > 0 || j > 0 || accumulate);
    wgmma_commit();
    if (pend >= 0) {
      wgmma_wait<1>();
      release<kC>(ring, pend, wtid);
    }
    pend = slot;
  }
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) fence_regs(a[s]);
  release<kC>(ring, pend, wtid);
}

// kAB: the bytes of K a free form holds in registers as A (256 or 512:
// the x tile is then never in shared memory), or 0: A from shared memory.
template <typename T, bool kChained, int kWGs, int kAB>
__global__ void __launch_bounds__(kWG * (kWGs + 1), 1)
    probe_shapes_kernel(const Args a) {
  using R = ShapeRing<T, kWGs>;
  using Acc = typename R::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const uint32_t rank = cluster_rank();
  Ring ring;
  ring.slots = smem_u32(smem + a.off_ring);
  ring.full = smem_u32(smem + a.off_bar);
  ring.empty = ring.full + 8 * R::kStages;
  ring.slot_bytes = kSlotBytes;

  if (threadIdx.x == 0) ring_init<T, kC, R>(ring);
  __syncthreads();
  cluster_sync();

  if (wg == kWGs) {  // the producer: every stage, in the consumers' order
    if constexpr (kAB > 0)  // its registers to the consumers
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0)
      for (int it = 0; it < a.stages; ++it)
        fill<T, kC, R>(ring, it, a.staged + (size_t)it * kSlotBytes,
                       kSlotBytes, rank);
    cluster_sync();
    return;
  }

  if constexpr (kAB > 0)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int row0 = (blockIdx.x * kWGs + wg) * 64, bar_id = 1 + wg;
  const int ld = a.K * (int)sizeof(T);  // bytes of a tile row
  unsigned char* tiles = smem + wg * (kChained ? 2 : 1) * a.tile_bytes;
  // x into the (first) tile in the core-matrix layout, 16 bytes a thread
  // (or, with kAB, into each thread's A fragments); rows past n are zero
  const int pieces = kAB > 0 ? 0 : ld / 16;
  for (int e = wtid; e < 64 * pieces; e += kWG) {
    const int r = e / pieces, p = e - r * pieces;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < a.n)
      v = __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)(row0 + r) * ld) +
                p);
    *reinterpret_cast<uint4*>(tiles + cm_off(r, 16 * p, ld)) = v;
  }
  fence_async_smem();
  wg_bar(bar_id);

  Acc acc[kNC / 2];
  double part[2] = {0.0, 0.0};  // the thread's two rows, over its columns
  int it = 0;                   // this warpgroup's place in the ring

  if constexpr (kChained) {
    int cur = 0;
    for (int i = 0; i < a.n_layers; ++i) {
      const unsigned char* hc = tiles + cur * a.tile_bytes;
      unsigned char* hn = tiles + (cur ^ 1) * a.tile_bytes;
      const bool last = i + 1 == a.n_layers;
      for (int c0 = 0; c0 < a.N; c0 += kNC) {
        product<T, kNC, kC, R>(acc, hc, ld, a.K, hc, ld, a.K, ring, it,
                               wtid);
        visit<kNC>(acc, wtid, [&](int h, int r, int c, Acc v0, Acc v1) {
          unsigned char* p = hn + cm_off(r, (c0 + c) * (int)sizeof(T), ld);
          float f0, f1;
          if constexpr (sizeof(T) == 1) {  // the int32 wraps modulo 256
            *reinterpret_cast<uint16_t*>(p) =
                (uint16_t)__byte_perm(v0, v1, 0x0040);
            f0 = (float)(int8_t)(v0 & 0xff);
            f1 = (float)(int8_t)(v1 & 0xff);
          } else {
            const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(p) = b;
            f0 = __low2float(b);
            f1 = __high2float(b);
          }
          if (last) part[h] += (double)f0 + (double)f1;
        });
      }
      fence_async_smem();
      wg_bar(bar_id);  // h whole before the next layer reads it
      cur ^= 1;
    }
  } else {
    constexpr int kSteps = kAB > 0 ? kAB / 32 : 1;
    uint32_t afr[kSteps][4];
    if constexpr (kAB > 0) {  // the fragments of the thread's rows g, g + 8
      const int g = (wtid % 32) / 4, t = wtid % 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * (wtid / 32) + g + 8 * h;
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(a.x + (size_t)row * ld);
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            afr[s][h + 2 * half] =
                row < a.n ? __ldg(src + 8 * s + 4 * half + t) : 0u;
      }
    }
    float sum[kNC / 2];
    for (int c0 = 0; c0 < a.N; c0 += kNC) {
#pragma unroll
      for (int q = 0; q < kNC / 2; ++q) sum[q] = 0.f;
      for (int i = 0; i < a.n_layers; ++i) {
        if constexpr (kAB > 0)
          product_rs<kSteps, R>(acc, afr, ring, it, wtid);
        else
          product<T, kNC, kC, R>(acc, tiles, ld, a.K, tiles, ld, a.K, ring,
                                 it, wtid);
#pragma unroll
        for (int q = 0; q < kNC / 2; ++q)
          sum[q] = __fadd_rn(sum[q], as_f32(acc[q]));
      }
      visit<kNC>(sum, wtid, [&](int h, int, int, float v0, float v1) {
        part[h] += (double)v0 + (double)v1;
      });
    }
  }

  const int r0 = 16 * (wtid / 32) + (wtid % 32) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const double s = quad_sum(part[h]);
    const int g = row0 + r0 + 8 * h;
    if (wtid % 4 == 0 && g < a.n) a.out[g] = (float)s;
  }
  cluster_sync();
}

template <typename T, bool kChained, int kWGs, int kAB = 0>
cudaError_t launch_as(Args a, cudaStream_t stream) {
  using R = ShapeRing<T, kWGs>;
  a.tile_bytes = kAB > 0 ? 0 : 64 * a.K * (int)sizeof(T);
  a.off_ring = kWGs * (kChained ? 2 : 1) * a.tile_bytes;
  a.off_bar = a.off_ring + R::kStages * kSlotBytes;
  const int smem = a.off_bar + 2 * R::kStages * 8;
  a.stages = (a.N / kNC) * a.n_layers * (a.K / R::kKS);
  auto kern = probe_shapes_kernel<T, kChained, kWGs, kAB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (kAB > 0) {  // setmaxnreg moves registers within the block's share
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess) return err;
    if (fa.numRegs * kWG * (kWGs + 1) < kWG * (40 + 232 * kWGs))
      return cudaErrorLaunchOutOfResources;
  }
  const int blocks = (a.n + 64 * kWGs - 1) / (64 * kWGs);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kC;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + kC - 1) / kC * kC);
  cfg.blockDim = dim3(kWG * (kWGs + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int clusters = 0;  // a cluster that cannot be resident is never scheduled
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg)) !=
      cudaSuccess)
    return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaLaunchKernelEx(&cfg, kern, a)) != cudaSuccess) return err;
  return cudaGetLastError();
}

// The form of (T, kChained): free with A in registers where a row's K is
// 256 or 512 bytes (64 registers at most beside the accumulator and the
// sum); else with tiles beside the ring, two consumer warpgroups where they
// fit, else one.
template <typename T, bool kChained>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int kb = a.K * (int)sizeof(T);
  if (!kChained && kb == 256) return launch_as<T, false, 2, 256>(a, stream);
  if (!kChained && kb == 512) return launch_as<T, false, 2, 512>(a, stream);
  const long long tiles = (kChained ? 2LL : 1LL) * 64 * a.K * sizeof(T);
  const long long ring = ShapeRing<T, 1>::kStages * (kSlotBytes + 16LL);
  if (2 * tiles + ring <= 232448)
    return launch_as<T, kChained, 2>(a, stream);
  if (tiles + ring <= 232448) return launch_as<T, kChained, 1>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// x [n, K] is int8 when is_int8, else bf16; staged is
// probe_shapes.stage_shape_weights' image of the n_layers weights [N, K]
// in the form's order (chained or free); K a multiple of 128 (at most
// 1,024; a bf16 chain at most 512), N of 128; chained needs K == N. Returns a
// cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int probe_shapes_launch(const void* x, int n, int K, int N,
                                   const void* staged, int n_layers,
                                   float* out, int is_int8, int chained,
                                   void* stream) {
  if (n <= 0 || n_layers < 1 || K <= 0 || K % 128 || K > 1024 || N <= 0 ||
      N % kNC || (chained && K != N))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(staged)) &
      15)
    return cudaErrorMisalignedAddress;
  Args a{};
  a.x = static_cast<const unsigned char*>(x);
  a.n = n;
  a.K = K;
  a.N = N;
  a.n_layers = n_layers;
  a.staged = static_cast<const unsigned char*>(staged);
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return chained ? launch<int8_t, true>(a, s) : launch<int8_t, false>(a, s);
  return chained ? launch<__nv_bfloat16, true>(a, s)
                 : launch<__nv_bfloat16, false>(a, s);
}
