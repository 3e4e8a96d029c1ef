// Probe: K5 with both dL/dx products in int8, the dx half of the training
// backward at the int8 tensor-core rate.
//
// Replaces the Pallas TPU kernel exp/probe_bwd_qdx.py::bwd_group_qdx. For
// blocks b_start+cnt-1 .. b_start, top-down, per ray:
//   dt2  = (dh * res_scale).cast(bf16)
//   dW[2k+1] += dt2^T t1r,  db[2k+1] += sum dt2        (as K5)
//   dt1r = qdx(dh, 2k+1),   dt1 = (t1 > 0 ? dt1r : 0).cast(bf16)
//   dW[2k]   += dt1^T h_in, db[2k]   += sum dt1        (as K5)
//   dh   = dh + qdx(t1 > 0 ? dt1r : 0, 2k)
// on K4's int8 stash (h_in = (q * scale).cast(bf16), t1 = q * scale), where
// qdx(g, l) is layer l's input gradient from its output gradient g through
// the int8 weights q_l of the calibration:
//   u   = g * m_l               (m_l its per-column dequant multiplier,
//                                 res_scale folded into block tails)
//   s   = 127 / (max|u| + 1e-30), one scalar over a whole ray tile
//   u_q = clip(round_half_even(u * s), -127, 127)
//   qdx = (u_q @ q_l^T) * (scale_l / s)    (the per-column quotient first)
// and the add to dh is one fused multiply-add, as XLA on the CPU contracts
// dh + acc * c. The tile (512 rays in the probe) is a numerical parameter:
// another tile computes another function.
//
// Design: pass 1 is K5's Hopper dh walk (r2l_bwd_hopper.cuh, the bf16
// form) with both dx products on wgmma m64nWk32 s8. A block owns 128 rays,
// two consumer warpgroups of 64, dh in the accumulator registers (parked in
// dh_out across a block's two products, as K5). A is u_q, written by the
// epilogue into shared memory in the core-matrix layout K2's Q uses; B is
// each layer's q^T, [in][out], staged once per calibration as wgmma reads
// it (stage_qdx_weights: stages of 128 output channels, 64 at W64) and
// bulk-copied through hopper_ring.cuh's ring by the producer warpgroup, the
// layers top-down. The tile's largest |u| is the new part. Every warp
// reduces its own by shuffles and sends it to every warpgroup of its tile
// (a store into that warpgroup's slot array, distributed shared memory
// where it lies in another block, then an arrive on its mbarrier, release
// at cluster scope); each warpgroup waits on its own mbarrier for its
// tile's 4 x tile/64 values and takes their largest. So a 64-ray tile is
// one warpgroup's own, 128 the block's, 256 the 2-block cluster's, and 512
// a 4-block cluster's, whose ring is still multicast within pairs (4-block
// multicast measured 44-49% slower for the shape probe, PERF.md). Two
// slot arrays and barrier phases in turn make one exchange per quantization
// enough: a warp writes a slot again only two quantizations on, after every
// warpgroup of its tile has arrived for the one between, which each does
// after reading its slots. The producer takes no part, so no cluster
// barrier waits on it. fc1's u stays in the accumulator registers until its
// scale is known. dt2 and dt1 go to the bf16 scratch from the registers, as
// K5's do; the ReLU mask's stash rows are prefetched by cp.async under the
// first product, as K5's. Passes 2 and 3 (dW, db) are K5's Hopper passes
// unchanged (dw_passes, the int8-stash form), so the top layer's dW and db,
// whose dt2 is K5's too, are K5's bit for bit, and two runs are
// bit-identical.
//
// What bounds it: per layer 2*N*W^2 int8 operations (dx) and 2*N*W^2 bf16
// FLOP (dW); per 4-block call at 81,920 rays and W256 0.043 + 0.087 =
// 0.130 ms at the data sheet's 1,979 / 989 T/s.
#include "r2l_bwd_hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRing = 2;       // blocks that share a ring (multicast pairs)
constexpr int kMaxTileWarps = 32;  // warps of a 512-ray tile

// The ring's shape: 128 output channels of the layer a stage (64 at W64),
// four slots, two consumer warpgroups, the accumulator int32.
template <int W>
struct QdxRing {
  using Acc = int;
  static constexpr int kKS = W >= 128 ? 128 : 64;
  static constexpr int kKSB = kKS, kWGs = 2, kStages = 4;
  static constexpr bool kRegA = false;
};

// Everything a launch needs, passed by value (the kernel parameter space).
struct Args {
  const unsigned char* staged;  // the group's layers' q^T image, layer lo first
  const float* m;               // [2cnt][W] dequant multipliers
  const int8_t* stash_t;        // [cnt][n][W] inner activations' q
  const float* scale;           // [2cnt][W] (1 / body_inv)
  const float* dh_in;           // [n, W]
  float* dh_out;                // [n, W]
  __nv_bfloat16* dts;           // [2cnt][n][W]
  int n, cnt, tile_wgs;         // tile_wgs: warpgroups of a tile (tile / 64)
  float res_scale;
  // layout, set by plan()
  int layer_bytes, off_st, off_cq, off_mx, off_ring, off_bar, slot_bytes;
  int smem;
};

template <int W>
__host__ __device__ constexpr int stash_ld() {  // a stash row: W bytes, 16
  return W + 16;
}

template <int W>
inline void plan(Args& a) {
  using K = QdxRing<W>;
  a.layer_bytes = W * W;
  a.off_st = 2 * 64 * W;                                // U: [128][W] int8
  a.off_cq = a.off_st + 2 * 64 * stash_ld<W>();         // ST
  a.off_mx = a.off_cq + 2 * W * 4;                      // cq: [2][W] f32
  a.off_ring = r2l::round_up(a.off_mx + 2 * 2 * kMaxTileWarps * 4, 128);
  a.slot_bytes = W * K::kKSB;
  a.off_bar = a.off_ring + K::kStages * a.slot_bytes;
  // the ring's full and empty barriers, then each warpgroup's two maxima
  a.smem = a.off_bar + 2 * K::kStages * 8 + 2 * 2 * 8;
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// A warp's value v into slot `val` of the warpgroup whose slots and barrier
// lie at `val` and `bar` in the cluster's block `cta`, then an arrive on
// that barrier that releases the store at cluster scope.
__device__ __forceinline__ void send_max(uint32_t val, uint32_t bar,
                                         uint32_t cta, float v) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\n"
      "mapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\n"
      "st.shared::cluster.f32 [ra], %3;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rb];\n}\n"
      ::"r"(val), "r"(bar), "r"(cta), "f"(v) : "memory");
}
// Wait for the phase of `parity` of this block's barrier, acquiring what
// the cluster's arrivals released.
__device__ __forceinline__ void wait_cluster(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// Pass 1: the dh walk over one block of 128 rays; kCl blocks a cluster.
template <int W, int kCl>
__global__ void __launch_bounds__(kWG * 3, 1) bwd_qdx_dh_kernel(const Args a) {
  using K = QdxRing<W>;
  constexpr int kLdS = stash_ld<W>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  const uint32_t rank = cluster_rank();
  Ring ring;
  ring.slots = smem_u32(smem + a.off_ring);
  ring.full = smem_u32(smem + a.off_bar);
  ring.empty = ring.full + 8 * K::kStages;
  ring.slot_bytes = a.slot_bytes;
  ring.base = rank / kRing * kRing;
  // each warpgroup's two barriers of its tile's maxima, [wg][buf]
  const uint32_t mx_bar = ring.empty + 8 * K::kStages;
  const int G = a.tile_wgs;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) bar_init(mx_bar + 8 * i, 4 * G);
    ring_init<int8_t, kRing, K>(ring);  // and the fence for all of them
  }
  __syncthreads();
  cluster_sync();

  if (wg == K::kWGs) {  // the producer: the layers top-down, in stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (wtid == 0) {
      int it = 0;
      for (int k = a.cnt - 1; k >= 0; --k)
        for (int l = 2 * k + 1; l >= 2 * k; --l)
          for (int st = 0; st < W / K::kKS; ++st)
            fill<int8_t, kRing, K>(ring, it++,
                                   a.staged + (size_t)l * a.layer_bytes +
                                       (size_t)st * a.slot_bytes,
                                   a.slot_bytes, rank);
    }
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int tile = blockIdx.x * K::kWGs + wg, row0 = tile * 64;
  const int bar_id = 1 + wg;
  unsigned char* U = smem + wg * 64 * W;
  unsigned char* ST = smem + a.off_st + wg * 64 * kLdS;
  float* cq = reinterpret_cast<float*>(smem + a.off_cq) + wg * W;
  const uint32_t vals = smem_u32(smem + a.off_mx);  // [wg][buf][32] f32
  const int lane = wtid % 32, warp = wtid / 32, t = lane % 4;
  const int r0 = 16 * warp + lane / 4;
  const size_t rs = (size_t)a.n * W;

  auto tiles_ready = [&]() {
    fence_async_smem();
    wg_bar(bar_id);
  };
  // a pair of values' q8 (round half even, clip to +-127) into U at
  // (r, c), c even: clipped first (the same integer), then rounded by an
  // add of 1.5 * 2^23 into the float's low byte (K2's q8b)
  auto putq = [&](int r, int c, float y0, float y1) {
    auto q8b = [](float y) {
      return __float_as_int(
          __fadd_rn(fminf(fmaxf(y, -127.f), 127.f), 12582912.f));
    };
    *reinterpret_cast<uint16_t*>(U + cm_off(r, c, W)) =
        (uint16_t)__byte_perm(q8b(y0), q8b(y1), 0x0040);
  };
  // block k's stash rows of the mask into ST, in flight under the block's
  // first product
  auto prefetch = [&](int k) {
    constexpr int kP = W / 16;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a.stash_t + k * rs);
#pragma unroll 1
    for (int e = wtid; e < 64 * kP; e += kWG) {
      const int r = e / kP, p = e - r * kP, g = row0 + r;
      if (g < a.n)
        r2l::cp_async16(ST + r * kLdS + 16 * p, src + (size_t)g * W + 16 * p);
    }
    r2l::cp_async_commit();
  };
  // The tile's largest of every thread's v (each >= 0): this warp's to
  // each of the tile's G warpgroups (slot (member, warp) of buffer q % 2),
  // then this warpgroup's 4G once they have all arrived.
  const int g0 = tile / G * G;           // the tile's first warpgroup
  const uint32_t cta0 = rank - (uint32_t)(blockIdx.x - g0 / 2);
  int q = 0;                             // quantizations so far
  auto tile_max = [&](float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int buf = q & 1;
    __syncwarp();  // every lane read the slots this buffer held last
    if (lane == 0)
      for (int m = 0; m < G; ++m) {
        const int mw = (g0 + m) % 2;   // the member's warpgroup in its block
        send_max(vals + ((mw * 2 + buf) * kMaxTileWarps +
                         (tile - g0) * 4 + warp) * 4,
                 mx_bar + 8 * (mw * 2 + buf), cta0 + (g0 % 2 + m) / 2, v);
      }
    wait_cluster(mx_bar + 8 * (wg * 2 + buf), (q >> 1) & 1);
    const float* got = reinterpret_cast<const float*>(
        smem + a.off_mx) + (wg * 2 + buf) * kMaxTileWarps;
    float mx = 0.f;
    for (int i = 0; i < 4 * G; ++i) mx = fmaxf(mx, got[i]);
    ++q;
    return mx;
  };
  // The tile's scale s from this thread's largest |u|, and layer l's
  // dequantize multipliers cq = scale_l / s, read after the next product
  // (whose barrier makes them visible; the exchange above is the barrier
  // after the last read of the previous ones).
  auto quant_scale = [&](float mx, int l) {
    const float s = __fdiv_rn(127.f, __fadd_rn(tile_max(mx), 1e-30f));
    for (int c = wtid; c < W; c += kWG)
      cq[c] = __fdiv_rn(a.scale[(size_t)l * W + c], s);
    return s;
  };
  auto f = [](int x) { return __int_as_float(x); };
  auto bits = [](float x) { return __float_as_int(x); };
  // a product's int32 sum as f32: |acc| <= W * 127 * 127 < 2^22, so the
  // bits of 1.5 * 2^23 + acc, less 1.5 * 2^23, are exact (two adds where
  // the conversion runs at a quarter of the rate)
  auto i2f = [](int x) {
    return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.f);
  };

  int acc[W / 2];  // dh (f32 bits), a product's int32 sums, or fc1's u
  // Block k's entry, one sweep: dh = dh_of(j, h, c, g) into the registers
  // and parked in dh_out, dt2 = (dh * res_scale).cast(bf16) to the scratch,
  // and the largest |dh * m2| of fc2's u (the raw f32 dh).
  auto enter = [&](int k, auto dh_of) {
    const float* m2 = a.m + (size_t)(2 * k + 1) * W;
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 mm = ldg2(m2 + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = row0 + r0 + 8 * h;
        const float2 d = dh_of(j, h, c, g);
        acc[4 * j + 2 * h] = bits(d.x);
        acc[4 * j + 2 * h + 1] = bits(d.y);
        if (g < a.n) {
          *reinterpret_cast<float2*>(a.dh_out + (size_t)g * W + c) = d;
          *reinterpret_cast<__nv_bfloat162*>(
              a.dts + (2 * k + 1) * rs + (size_t)g * W + c) =
              __floats2bfloat162_rn(__fmul_rn(d.x, a.res_scale),
                                    __fmul_rn(d.y, a.res_scale));
        }
        mx = fmaxf(mx, fmaxf(fabsf(__fmul_rn(d.x, mm.x)),
                             fabsf(__fmul_rn(d.y, mm.y))));
      }
    }
    return mx;
  };
  // dh + acc * cq, one FMA, from the parked dh
  auto dh_new = [&](int j, int h, int c, int g) {
    const float2 cc = *reinterpret_cast<const float2*>(cq + c);
    float2 d = make_float2(0.f, 0.f);
    if (g < a.n)
      d = *reinterpret_cast<const float2*>(a.dh_out + (size_t)g * W + c);
    return make_float2(__fmaf_rn(i2f(acc[4 * j + 2 * h]), cc.x, d.x),
                       __fmaf_rn(i2f(acc[4 * j + 2 * h + 1]), cc.y, d.y));
  };

  float mx = enter(a.cnt - 1, [&](int, int, int c, int g) {
    return g < a.n ? *reinterpret_cast<const float2*>(a.dh_in +
                                                      (size_t)g * W + c)
                   : make_float2(0.f, 0.f);
  });
  int it = 0;  // this warpgroup's place in the ring
  for (int k = a.cnt - 1; k >= 0; --k) {
    const int l2 = 2 * k + 1, l1 = 2 * k;
    const float* m2 = a.m + (size_t)l2 * W;
    const float* m1 = a.m + (size_t)l1 * W;
    prefetch(k);
    // fc2's dx: u = dh * m2 quantized with the tile's scale
    float s = quant_scale(mx, l2);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 mm = ldg2(m2 + c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        putq(r0 + 8 * h, c,
             __fmul_rn(__fmul_rn(f(acc[4 * j + 2 * h]), mm.x), s),
             __fmul_rn(__fmul_rn(f(acc[4 * j + 2 * h + 1]), mm.y), s));
    }
    tiles_ready();
    product<int8_t, W, kRing, K>(acc, U, W, W, U, W, W, ring, it, wtid);
    // dt1 = (t1 > 0 ? acc * cq : 0).cast(bf16) to the scratch; fc1's
    // u = dt1r * m1 stays in the registers until its scale is known
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    wg_bar(bar_id);  // every thread's rows of ST landed
    const float* sc2 = a.scale + (size_t)l2 * W;
    mx = 0.f;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 mm = ldg2(m1 + c), sc = ldg2(sc2 + c);
      const float2 cc = *reinterpret_cast<const float2*>(cq + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, g = row0 + r;
        float2 live = make_float2(0.f, 0.f);
        if (g < a.n) {
          const char2 tq = *reinterpret_cast<const char2*>(ST + r * kLdS + c);
          live = make_float2(__fmul_rn((float)tq.x, sc.x),
                             __fmul_rn((float)tq.y, sc.y));
        }
        const float u0 =
            live.x > 0.f ? __fmul_rn(i2f(acc[4 * j + 2 * h]), cc.x) : 0.f;
        const float u1 =
            live.y > 0.f ? __fmul_rn(i2f(acc[4 * j + 2 * h + 1]), cc.y)
                         : 0.f;
        if (g < a.n)
          *reinterpret_cast<__nv_bfloat162*>(a.dts + l1 * rs +
                                             (size_t)g * W + c) =
              __floats2bfloat162_rn(u0, u1);
        const float v0 = __fmul_rn(u0, mm.x), v1 = __fmul_rn(u1, mm.y);
        acc[4 * j + 2 * h] = bits(v0);
        acc[4 * j + 2 * h + 1] = bits(v1);
        mx = fmaxf(mx, fmaxf(fabsf(v0), fabsf(v1)));
      }
    }
    s = quant_scale(mx, l1);
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        putq(r0 + 8 * h, 8 * j + 2 * t, __fmul_rn(f(acc[4 * j + 2 * h]), s),
             __fmul_rn(f(acc[4 * j + 2 * h + 1]), s));
    tiles_ready();
    product<int8_t, W, kRing, K>(acc, U, W, W, U, W, W, ring, it, wtid);
    // dh's update, in the next block's entry sweep, or into dh_out
    if (k > 0) {
      mx = enter(k - 1, dh_new);
      continue;
    }
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * t, g = row0 + r0 + 8 * h;
        const float2 d = dh_new(j, h, c, g);
        if (g < a.n)
          *reinterpret_cast<float2*>(a.dh_out + (size_t)g * W + c) = d;
      }
  }
  cluster_sync();  // no block leaves while another may still write its slots
}

// Pass 1 over the n rays' blocks in clusters of kCl, then K5's passes 2
// and 3.
template <int W, int kCl>
cudaError_t launch(Args a, const void* stash_h, float* dbp, float* part,
                   float* dw, float* db, int splits, cudaStream_t stream) {
  plan<W>(a);
  const int blocks = (a.n + 127) / 128;
  cudaError_t err = launch_cluster<int8_t, kCl, QdxRing<W>>(
      bwd_qdx_dh_kernel<W, kCl>, a, blocks, a.smem, stream);
  if (err != cudaSuccess) return err;
  return r2lbh::dw_passes<__nv_bfloat16, int8_t, W>(
      a.dts, stash_h, a.stash_t, a.scale, dbp, part, dw, db, a.n, a.cnt,
      splits, 0, stream);
}

template <int W>
cudaError_t launch_w(const Args& a, int tile, const void* stash_h,
                     float* dbp, float* part, float* dw, float* db,
                     int splits, cudaStream_t s) {
  // a tile of 512 rays: four blocks; any other: a block's or a pair's
  if (tile == 512)
    return launch<W, 4>(a, stash_h, dbp, part, dw, db, splits, s);
  return launch<W, 2>(a, stash_h, dbp, part, dw, db, splits, s);
}

}  // namespace

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: stage_qdx_weights' image of every body layer's q^T, from the
// group's first layer on; m and scale: the group's [2cnt][W] dequant
// multipliers and 1/body_inv; stash_h and stash_t: the group's int8 stash
// rows of block inputs and inner activations, [cnt][n][W] each. The tile is
// 64, 128, 256 or 512 rays and n a whole number of tiles. Scratch: dts
// [2cnt][n][W] bf16, dbp [splits][2cnt][W] f32, part [splits][2cnt][W][W]
// f32. Returns a cudaError_t: a launch's own error,
// cudaErrorLaunchOutOfResources for a cluster that cannot be scheduled, or
// cudaErrorInvalidValue for a width or a shape the kernel does not take.
extern "C" int r2l_bwd_qdx_launch(
    const void* staged, const float* m, const void* stash_h,
    const void* stash_t, const float* scale, const float* dh_in,
    float* dh_out, void* dts, float* dbp, float* part, float* dw, float* db,
    int n, int W, int cnt, float res_scale, int tile, int splits,
    void* stream) {
  if (n <= 0 || cnt < 1 || splits < 1 || !m || !scale ||
      (tile != 64 && tile != 128 && tile != 256 && tile != 512) || n % tile)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(staged) |
       reinterpret_cast<uintptr_t>(stash_h) |
       reinterpret_cast<uintptr_t>(stash_t) | reinterpret_cast<uintptr_t>(dts) |
       reinterpret_cast<uintptr_t>(dh_in) |
       reinterpret_cast<uintptr_t>(dh_out) |
       reinterpret_cast<uintptr_t>(part)) & 15)
    return cudaErrorMisalignedAddress;
  Args a{};
  a.staged = static_cast<const unsigned char*>(staged);
  a.m = m;
  a.stash_t = static_cast<const int8_t*>(stash_t);
  a.scale = scale;
  a.dh_in = dh_in;
  a.dh_out = dh_out;
  a.dts = static_cast<__nv_bfloat16*>(dts);
  a.n = n;
  a.cnt = cnt;
  a.tile_wgs = tile / 64;
  a.res_scale = res_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R2L_ARGS a, tile, stash_h, dbp, part, dw, db, splits, s
  switch (W) {
    case 64: return launch_w<64>(R2L_ARGS);
    case 128: return launch_w<128>(R2L_ARGS);
    case 256: return launch_w<256>(R2L_ARGS);
  }
#undef R2L_ARGS
  return cudaErrorInvalidValue;
}
