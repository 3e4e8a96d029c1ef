// K4 and K8: the PE-fused static-scale int8 R2L training forward, with an
// int8 stash (K4, stash_q=True) or a bf16 one (K8, stash_q=False).
//
// Replaces the Pallas TPU kernel r2l_tpu/kernels/r2l_train_pallas.py::
// train_fwd_int8, parameters from calibrate_r2l_int8_pe(...,
// fold_requant=False). The kernel is K2's (r2l_int8_hopper.cuh, its forms
// kTrainQ and kTrainB, which also describes how they differ from K2's):
// wgmma s8 in 128-ray blocks of two consumer warpgroups, two blocks a
// cluster sharing a ring into which one producer thread bulk-copies the s8
// image staged after each per-step calibration (stage_int8_train, with the
// body's inverse scales), the stash stored from the epilogues' registers.
//
// What bounds it: 11.8 M int8 multiply-adds per ray, 0.97 T operations for
// a canonical step's 81,920 rays (0.49 ms at 1,979 int8 TOP/s), and the
// stash write: 1.83 GB int8 (0.55 ms at 3.35 TB/s) or 3.65 GB bf16 (1.09
// ms), so bytes-bound either way. The parent design (mma.sync m16n8k32 s8,
// 64-ray tiles, 64-channel stages behind block barriers, stash slabs copied
// after a barrier) took 7.195 ms (K4) and 7.858 (K8) on an H100 80GB HBM3
// at 700 W; PERF.md has this one's runs.
#include "r2l_int8_hopper.cuh"

using namespace r2l8h;

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// staged: stage_int8_train's image (the s8 weights at the kind's stage
// width, the (m, b) table, the body's inverse scales); h0: a scratch of
// h0_elems floats ([blocks * 128 * W], blocks padded to whole 2-block
// clusters; none without the global residual); stash [2nb+1, n, W]: int8
// with stash_q (K4), bf16 without (K8). Returns a cudaError_t: the launch's
// own error, or cudaErrorInvalidValue for a width or depth the kernel does
// not take (two layers per block).
extern "C" int r2l_train_fwd_int8_launch(
    const float* pts, int n, int dp, int L, const unsigned char* staged,
    const float* head_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, float* h0,
    long long h0_elems, void* stash, int W, int nb, int out_dim,
    int use_residual, int linear_tail, int stash_q, void* stream) {
  if (n <= 0 || dp <= 0 || L <= 0 || nb < 0 || out_dim < 1 ||
      2 * L + 1 > 2 * W)  // a head slice holds a scalar's parts at least
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(staged) & 15 ||
      reinterpret_cast<uintptr_t>(tail_q) & 1 ||
      reinterpret_cast<uintptr_t>(stash) & 15)
    return cudaErrorMisalignedAddress;
  Args a{};
  a.pts = pts;
  a.n = n;
  a.dp = dp;
  a.L = L;
  a.staged = staged;
  a.head_inv = head_inv;
  a.tail_q = tail_q;
  a.tail_m = tail_m;
  a.tail_b = tail_b;
  a.tail_inv = tail_inv;
  a.out = out;
  a.h0 = h0;
  a.stash = stash;
  a.nb = nb;
  a.nl = 2;
  a.out_dim = out_dim;
  a.use_residual = use_residual;
  a.linear_tail = linear_tail;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stash_q ? launch_width<kTrainQ>(a, W, h0_elems, s)
                 : launch_width<kTrainB>(a, W, h0_elems, s);
}
