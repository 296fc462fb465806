// The bloom probes' tests, shared by the standalone probes (probe.cu)
// and the gated scan and pair (scan.cu), so the semantics have one copy.
//
// The classic probe (BloomProbe):
// plane[b * wp + i] is uint32 lane i of block b's bloom filter (each
// uint64 filter word as two little-endian lanes, zero-padded to wp).
// Block b is kept when nwords[b] == 0 (no bloom: the block may hold
// anything) or when every probe j < p finds bit shift[b, j] set in lane
// idx[b, j]; a lane index outside [0, wp) reads as a zero lane.
#pragma once

#include <cstdint>

namespace vl {

struct BloomProbe {
  const uint32_t* plane;   // [blocks, wp]
  const int32_t* nwords;   // [blocks]
  const int32_t* idx;      // [blocks, p]
  const int32_t* shift;    // [blocks, p]
  int wp;
  int p;
};

__device__ __forceinline__ bool probe_bit(const BloomProbe& g, int b, int j) {
  const size_t k = (size_t)b * g.p + j;
  const int i = g.idx[k];
  const uint32_t w = (i >= 0 && i < g.wp) ? g.plane[(size_t)b * g.wp + i] : 0u;
  return (w >> (g.shift[k] & 31)) & 1u;
}

// One thread: the probes of block b in order, stopping at the first
// clear bit.
__device__ __forceinline__ bool block_keep(const BloomProbe& g, int b) {
  if (g.nwords[b] == 0) return true;
  for (int j = 0; j < g.p; ++j)
    if (!probe_bit(g, b, j)) return false;
  return true;
}

// One whole warp, every lane with the same b: one probe a lane, 32 at a
// time, stopping after the first round with a clear bit.  The word count
// is read beside the first round's probes, not before them.  The result
// is the same in every lane.
__device__ __forceinline__ bool warp_block_keep(const BloomProbe& g, int b,
                                                int lane) {
  const bool no_bloom = g.nwords[b] == 0;
  for (int j0 = 0; j0 < g.p; j0 += 32) {
    const int j = j0 + lane;
    const bool set = j >= g.p || probe_bit(g, b, j);
    if (no_bloom) return true;
    if (!__all_sync(0xFFFFFFFFu, set)) return false;
  }
  return true;
}

// The split-block probe (SbProbe) of a sealed part's filter index:
// plane[b * lp + i] is uint32 lane i of block b's split-block filters
// (256-bit blocks of 8 lanes, zero-padded to lp).  Token t selects, in
// block b, the 8 lanes from sbidx[b, t]; its 6 probe bits are the set
// bits of mask[t, 0..8).  Block b is kept when nsb[b] == 0 (no filter)
// or when every token finds all its mask bits set in its 8 lanes; a lane
// index outside [0, lp) reads as a zero lane.  Item j < 8 * t of a block
// is lane j & 7 of token j >> 3, so a token's 8 items are contiguous
// lanes of one 32-byte sector and mask[t, k] is mask[j].
struct SbProbe {
  const uint32_t* plane;   // [blocks, lp]
  const int32_t* nsb;      // [blocks]
  const int32_t* sbidx;    // [blocks, t]
  const uint32_t* mask;    // [t, 8]
  int lp;
  int t;
};

__device__ __forceinline__ bool sb_item(const SbProbe& g, int b, int j) {
  const int i = g.sbidx[(size_t)b * g.t + (j >> 3)] + (j & 7);
  const uint32_t w = (i >= 0 && i < g.lp) ? g.plane[(size_t)b * g.lp + i] : 0u;
  const uint32_t m = g.mask[j];
  return (w & m) == m;
}

// One thread: block b's items in order, stopping at the first miss.
__device__ __forceinline__ bool sb_keep(const SbProbe& g, int b) {
  if (g.nsb[b] == 0) return true;
  for (int j = 0; j < 8 * g.t; ++j)
    if (!sb_item(g, b, j)) return false;
  return true;
}

// One whole warp, every lane with the same b: one item a lane, 32 (four
// tokens) a round, as warp_block_keep of a BloomProbe.
__device__ __forceinline__ bool warp_block_keep(const SbProbe& g, int b,
                                                int lane) {
  const bool no_filter = g.nsb[b] == 0;
  const int n = 8 * g.t;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool set = j >= n || sb_item(g, b, j);
    if (no_filter) return true;
    if (!__all_sync(0xFFFFFFFFu, set)) return false;
  }
  return true;
}

}  // namespace vl
