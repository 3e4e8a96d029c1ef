// Probe: K2 with each 64-ray tile split into S ray streams.
//
// Replaces the Pallas TPU kernel exp/probe_pipe_lib.py::
// apply_int8_pe_streams: K2 whole (PE, head, the 43 blocks, tail) in its
// deployed form (fold_requant + nobf16_inner), each ray tile split into S
// streams whose products are issued together per layer, so that one
// stream's epilogue can hide under another's tensor-core work. Rows never
// mix, so at every S the output is K2's, bit for bit.
//
// Design: r2l_int8_chain.cuh's kernel with S teams of 256 threads per
// block, team s owning 64/S of the block's 64 rays (S = 1, 2, 4: 256, 512
// or 1,024 threads, at most 255, 128 or 64 registers a thread), sharing
// K2's weight stages and stepping the layers together (StreamTeam). The
// JAX probe splits one tile the same way (exp/probe_pipe_lib.py:27); S
// tiles of 64 rays with their own stages would need S x 209 KB of shared
// memory (208,896 bytes each), above the 227 KB a block may have.
//
// What bounds it: K2's work, about 1.89 T int8 operations per 400x400
// frame (0.953 ms at the data-sheet 1,979 TOP/s), compute-bound.
#include "r2l_int8_chain.cuh"

using namespace r2l;
using namespace r2l::int8chain;

// C entry point (loaded with ctypes by r2l_tpu_torch/kernels/_build.py).
// W must be 256 and S one of 1, 2, 4. Returns a cudaError_t: the launch's
// own error, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int probe_pipe_launch(
    const float* pts, int n, int dp, int L, const int8_t* head_q,
    const float* head_m, const float* head_b, const float* head_inv,
    const int8_t* body_q, const float* body_m, const float* body_b,
    const float* body_inv, const int8_t* tail_q, const float* tail_m,
    const float* tail_b, const float* tail_inv, float* out, int W, int nb,
    int nl, int out_dim, int use_residual, int linear_tail, int streams,
    void* stream) {
  cudaError_t err = check_args(n, dp, L, nb, nl, out_dim, head_q, body_q,
                               tail_q);
  if (err != cudaSuccess) return err;
  if (W != 256) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (streams) {
    case 1: return launch<256, kDeployed, 1>(R2L_INT8_CHAIN_ARGS);
    case 2: return launch<256, kDeployed, 2>(R2L_INT8_CHAIN_ARGS);
    case 4: return launch<256, kDeployed, 4>(R2L_INT8_CHAIN_ARGS);
  }
  return cudaErrorInvalidValue;
}
