// Per-block bloom keep over a packed bloom plane (vl_plane_keep) or a
// sealed part's split-block plane (vl_plane_keep_sb).
//
// Replaces the JAX package's TPU kernel tpu/bloom_device.py
// plane_keep_pallas (body _probe_kernel).  The bit test and its
// semantics are in probe.cuh, shared with the gated scan (scan.cu),
// which runs the same test inside the scan's launch on the main path;
// this standalone launch serves a bloom leaf that gates no scan.
//
// Bound: bytes, and latency: the work is B*p random 4-byte gathers from
// a plane that usually sits in L2 (B*wp*4 bytes), plus 8*B*p bytes of
// probe arguments.  Design: one thread per block, looping over its
// probes and stopping at the first clear bit; the probe arguments of a
// block are contiguous, and nwords == 0 skips the loop.
//
// The split-block probe replaces the JAX package's plane_keep_sb
// (tpu/bloom_device.py; jnp inside its fused program, not a Pallas
// kernel).  Bound: bytes, one 32-byte sector of the plane a (block,
// token), the block's t lane bases, its word count and 1 byte of result;
// the t x 32-byte mask table is shared by every block (L1/L2).  Design:
// one thread a block, as the classic probe; a token's 8 lanes are one
// sector, read in order, stopping at the first token that misses.  This
// launch is the gate's oracle on the card: the main path runs the same
// test inside the gated scan and pair.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

__global__ void plane_keep_kernel(vl::BloomProbe g, int nblocks,
                                  bool* __restrict__ out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  out[b] = vl::block_keep(g, b);
}

__global__ void plane_keep_sb_kernel(vl::SbProbe g, int nblocks,
                                     bool* __restrict__ out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  out[b] = vl::sb_keep(g, b);
}

}  // namespace

extern "C" int vl_plane_keep(const void* plane, int nblocks, int wp,
                             const void* idx, const void* shift, int p,
                             const void* nwords, void* out, void* stream) {
  if (nblocks == 0) return 0;
  const int threads = 128;
  const int blocks = (nblocks + threads - 1) / threads;
  const vl::BloomProbe g = {static_cast<const uint32_t*>(plane),
                            static_cast<const int32_t*>(nwords),
                            static_cast<const int32_t*>(idx),
                            static_cast<const int32_t*>(shift), wp, p};
  plane_keep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, nblocks, static_cast<bool*>(out));
  return (int)cudaGetLastError();
}

// The split-block keep of each block: plane [nblocks, lp] uint32 lanes,
// sbidx [nblocks, t], mask [t, 8], nsb [nblocks] -> out [nblocks].
extern "C" int vl_plane_keep_sb(const void* plane, int nblocks, int lp,
                                const void* sbidx, const void* mask, int t,
                                const void* nsb, void* out, void* stream) {
  if (nblocks < 0 || t < 0 || lp < 0) return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return 0;
  const int threads = 128;
  const int blocks = (nblocks + threads - 1) / threads;
  const vl::SbProbe g = {static_cast<const uint32_t*>(plane),
                         static_cast<const int32_t*>(nsb),
                         static_cast<const int32_t*>(sbidx),
                         static_cast<const uint32_t*>(mask), lp, t};
  plane_keep_sb_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, nblocks, static_cast<bool*>(out));
  return (int)cudaGetLastError();
}
