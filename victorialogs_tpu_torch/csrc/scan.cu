// Per-row string match over a lane-major staged column.
//
// Replaces the JAX package's TPU kernel tpu/kernels_pallas.py
// match_scan_pallas (body _scan_kernel), and with `fold` also the
// production leaf kernels32.match_scan_t.
//
// Layout: lanes[q * r + row] is the little-endian uint32 of bytes
// [4q, 4q+4) of `row`; bytes past the row's length are 0xFF padding.
// lengths[row] is the staged (possibly truncated) byte length.  Modes:
// 0 phrase, 1 prefix, 2 substring, 3 exact, 4 exact-prefix.  A row hits
// only if length >= pat_len (exact: ==).  Word bytes are [A-Za-z0-9_]
// and every byte >= 0x80 except the 0xFF padding; `fold` lowers ASCII
// A-Z in the data (the pattern arrives lowered and holds no 0xFF).
//
// Bound: bytes.  The scan needs each row's bytes up to the one that
// decides it, plus 4 bytes of length and 1 of result a row, at a few
// integer operations a byte.
//
// Design (phrase, prefix, substring): one thread per row, walking the
// row as a Shift-And automaton, so no window is ever re-read and no
// branch depends on the data.  The state holds one bit per pattern
// prefix; a 256-entry table in shared memory gives, for each byte, the
// prefixes it extends (with `fold` applied to the data byte), whether a
// window may start after it (the start word boundary) and whether it
// may follow a match (the end word boundary).  The pattern sits at the
// top of the state: the match is always bit 30 of the last word and the
// end flag bit 31 of the table entry, so the shift that extends the
// prefixes also carries a match onto the end flag of the next byte
// (bit 31: a match closed by a boundary), and a pattern of up to 30 bytes
// (the main path's) needs one 32-bit word, up to 62 two, up to 128 five
// (NW below).  ASCII letters of one case fall in 26 different shared
// memory banks, so table lookups of text rarely conflict.  A byte costs
// about six instructions: a byte permute and a multiply-add give its
// entry's shared address, one load, a shift and a three-input logic op
// step the state, and an or keeps the closed-match bit.
//
// Bytes stay in flight whatever the automaton does: a thread loads its
// row kChunk lane words (32 bytes) at a time, all loads issued before
// any is used, and stops loading past its row's length or once its row
// has hit.  A warp's 32 threads read 32 consecutive rows of one lane
// word, one coalesced 128-byte line; rows need no alignment and no
// ragged-edge handling beyond `row < r`.  The grid is capped at 8
// blocks per SM with a grid-stride loop, so each block builds its table
// once for many rows.  Exact modes compare the first pat_len bytes a
// word at a time (SWAR case fold).
//
// The gated scan (vl_match_scan_gated) is the same scan behind a bloom
// gate, in one launch.  It replaces the JAX package's TPU kernel
// tpu/bloom_device.py plane_keep_pallas together with
// the pair that consumed its keep-mask on the TPU: the gather of the
// mask to rows through the block-id column and its AND with the scan
// (`keep[bid] & scan`).  The probe alone moves a few kilobytes, far
// below any launch, so no probe kernel can approach its bound; fused,
// its launch, the gather's and the AND's are gone, and the scan skips
// the bytes of every block the bloom rules out.  Bound: bytes, the
// kept rows' bytes up to each row's deciding byte (plus their lengths),
// 1 byte of result a row, and the probe's sectors.
//
// Design: the scan's own CTAs, grid-stride loop and Shift-And body, with
// a gate in front of each warp's rows.  Up to kStartsCap - 1 blocks (64 a
// part on the main path) a CTA first copies the block starts to shared
// memory; above that the search reads them from global memory.  The 32
// rows of a warp are consecutive: each lane finds its row's block by
// binary search, and the warp probes each distinct block of its rows
// once, in order, one probe a lane, 32 a round, combined by __all_sync
// (all but about one warp in 490 at 15,625-row blocks see one block, so
// one round of P <= 32 probes: the word count, lane index and shift
// loads in parallel, then the plane word).  The probe work is one round
// a warp-iteration whatever the part's block count: no CTA probes blocks
// its rows do not touch.  A ruled-out row writes false (and false to the
// maybe channel) and reads neither its length nor its lanes, so a
// ruled-out warp makes no loads and never diverges: whole blocks are
// contiguous.  Rows whose value was truncated (`ovf`) are maybe rows and
// are not scanned.
//
// On a sealed part the gate is the split-block probe of its filter
// index (vl_match_scan_gated_sb, vl_match_pair_gated_sb; probe.cuh
// SbProbe): the same kernels, templated on the probe, whose warp tests
// a token's 8 lanes (one 32-byte sector) in 8 lanes of the warp, four
// tokens a round.  They replace the JAX package's bloom_sb node
// (tpu/bloom_device.py plane_keep_sb gathered to rows and ANDed with
// the scan or the pair inside its fused program; not a Pallas kernel).
//
// The ordered pair (vl_match_pair) decides the regexp `A.*B` with
// literal A and B (1-64 bytes each) per row.  It replaces the JAX
// package's device function tpu/kernels32.py match_ordered_pair_t (not a
// Pallas kernel; XLA fused it on the TPU), which no single PyTorch call
// computes: a composition builds R x W window tensors.  ordered: A and B
// occur inside the row's length and A's first occurrence ends at or
// before the start of B's last; newline: the row holds 0x0A, which `.`
// does not cross.  definite = ordered & ~newline, maybe = ordered &
// newline (the host settles it with re.search).  Bound: bytes, every
// byte of every row (no byte decides a row early: B's last occurrence
// and a newline may come at the end), its 4-byte length and 2 bytes of
// results.
//
// Design: one Shift-And automaton for A `.*` B.  "A's first occurrence
// ends at or before the start of B's last" holds exactly when some
// occurrence of A ends at e and some occurrence of B starts at s >= e,
// which is what the automaton accepts.  State bit 0 is always set and
// starts A; bits [1, la + 1) are A's prefixes; bit la, A's accepting
// bit, is also the `.*` state and keeps itself; bits [la + 1, la + lb +
// 1) are B's prefixes, entered from bit la by the same shift (so B may
// start right after A ends).  A byte is one step, D = ((D << 1) & T[c])
// | (D & G): a shift and two logic ops.  G keeps five bits: bit 0, A's
// and B's accepting bits (once B's is set, the row is ordered), and
// bits 30 and 31 of the top word.  Bit 30 is set from the start and
// never leaves, so bit 31 is entered on every byte whose entry has it:
// the newline's.  The newline test is thus part of the step, and a
// row's two answers are two bits of its final state.  One 32-bit word
// holds la + lb <= 29 (the main path's `error.*timeout`: 12), two
// words <= 61, five <= 128 (A and B of 64 bytes), the words carried
// into each other as the scan's.  The table holds one entry (NW words)
// a byte value, 4 bytes for one word, so ASCII letters of one case fall
// in different banks as the scan's do.  Each byte costs a byte permute,
// an address, one shared load, the shift and two logic ops; no byte
// index and no select.  A row's words past its length are not stepped:
// the warp steps the words of its longest row (its count from one warp
// reduction, so every word's test is the same in the warp and no word
// opens a divergent region), and a lane past its own row loads nothing
// and steps 0xFFFFFFFF, which is in no pattern and not a newline, as are
// the layout's padding bytes past a row's length in its last word.
//
// The gated pair (vl_match_pair_gated) is the same body behind the
// gated scan's per-warp bloom gate, in one launch: a row of a block the
// bloom rules out writes false to both outputs and reads neither its
// length nor its lanes.  With an `ovf` column (either form), a
// truncated row is a maybe row (behind the gate: where its block is
// kept) and is not scanned.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "probe.cuh"

namespace {

constexpr int kMaxPattern = 128;
constexpr int kThreads = 256;
constexpr int kChunk = 8;            // lane words per row per load batch
constexpr int kStartsCap = 1024;     // block starts a CTA keeps in shared memory
constexpr uint32_t kMatch = 1u << 30;     // of the last state word
constexpr uint32_t kClosed = 1u << 31;    // kMatch, then a boundary

struct Pattern {
  uint32_t w[kMaxPattern / 4];       // little-endian words, zero-filled
};

__device__ __forceinline__ bool is_word(unsigned c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || (c >= 0x80 && c != 0xFF);
}

// ASCII A-Z -> a-z in each byte of w; bytes >= 0x80 stay as they are.
__device__ __forceinline__ uint32_t swar_lower(uint32_t w) {
  uint32_t h = w & 0x7F7F7F7Fu;
  uint32_t up = ((h + 0x3F3F3F3Fu) ^ (h + 0x25252525u)) & ~w & 0x80808080u;
  return w | (up >> 2);
}

__device__ __forceinline__ unsigned pat_byte(const uint32_t* p, int j) {
  return (p[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

// The automaton's table, built by the whole CTA; its barriers also
// publish any shared memory the CTA wrote before the call.
// state bit o: a window may start at the next byte; bit o+1+j: the
// bytes so far end with pattern bytes [0, j]; bit o+pat_len == 30 of
// word NW-1: a match ends at this byte; bit 31 of word NW-1: a match
// ended at the byte before and this byte may follow it
template <int NW>
__device__ __forceinline__ void build_table(uint32_t* tab, uint32_t* sp,
                                            const Pattern& pat, int pat_len,
                                            int o, int need_start,
                                            int need_end, int fold) {
  for (int i = threadIdx.x; i < kMaxPattern / 4; i += blockDim.x)
    sp[i] = pat.w[i];
  __syncthreads();
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    uint32_t* e = tab + c * NW;
    for (int i = 0; i < NW; ++i) e[i] = 0;
    unsigned fc = (fold && c >= 'A' && c <= 'Z') ? c + 0x20 : c;
    for (int j = 0; j < pat_len; ++j)
      if (pat_byte(sp, j) == fc) e[(o + 1 + j) >> 5] |= 1u << ((o + 1 + j) & 31);
    bool nonword = !is_word(c);
    if (!need_start || nonword) e[o >> 5] |= 1u << (o & 31);
    if (!need_end || nonword) e[NW - 1] |= 1u << 31;
  }
  __syncthreads();
}

// One row of length len >= pat_len through the automaton: true when it
// holds a match.
template <int NW>
__device__ __forceinline__ bool scan_row(const uint32_t* __restrict__ lanes,
                                         size_t rs, int row, int len,
                                         const uint32_t* tab,
                                         const uint32_t (&start)[NW],
                                         uint32_t done) {
  const int nw = (len + 3) >> 2;
  uint32_t d[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) d[i] = start[i];
  uint32_t acc = 0;              // kClosed: some byte closed a match
  for (int q0 = 0; q0 < nw && !((acc | d[NW - 1]) & done); q0 += kChunk) {
    uint32_t w[kChunk];
    const uint32_t* p = lanes + (size_t)q0 * rs + row;
#pragma unroll
    for (int k = 0; k < kChunk; ++k, p += rs)
      w[k] = q0 + k < nw ? __ldg(p) : 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint32_t* e = tab + __byte_perm(w[k], 0, 0x4440 | a) * NW;
        uint32_t t[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) t[i] = e[i];
#pragma unroll
        for (int i = NW - 1; i > 0; --i)
          d[i] = (__funnelshift_l(d[i - 1], d[i], 1) | start[i]) & t[i];
        d[0] = ((d[0] << 1) | start[0]) & t[0];
        acc |= d[NW - 1];
      }
    }
  }
  // bytes past the last loaded word are padding or the row's end: a
  // boundary either way
  return ((acc & kClosed) | (d[NW - 1] & kMatch)) != 0;
}

template <int NW>
__device__ __forceinline__ void start_state(uint32_t (&start)[NW], int o) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
    start[i] = (i == (o >> 5)) ? 1u << (o & 31) : 0u;
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
match_scan_kernel(const uint32_t* __restrict__ lanes,
                  const int32_t* __restrict__ lengths, int r, Pattern pat,
                  int pat_len, int need_start, int need_end, int fold,
                  bool* __restrict__ out) {
  __shared__ uint32_t tab[256 * NW];
  __shared__ uint32_t sp[kMaxPattern / 4];
  const int o = 32 * NW - 2 - pat_len;
  build_table<NW>(tab, sp, pat, pat_len, o, need_start, need_end, fold);
  uint32_t start[NW];
  start_state<NW>(start, o);
  // without an end boundary a match decides the row at once
  const uint32_t done = need_end ? kClosed : kClosed | kMatch;
  const size_t rs = r;

  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < r;
       row += gridDim.x * blockDim.x) {
    const int len = lengths[row];
    bool hit = false;
    if (len >= pat_len)
      hit = scan_row<NW>(lanes, rs, row, len, tab, start, done);
    out[row] = hit;
  }
}

__device__ __forceinline__ bool exact_row(const uint32_t* __restrict__ lanes,
                                          const int32_t* __restrict__ lengths,
                                          int r, int row, const Pattern& pat,
                                          int pat_len, int prefix, int fold) {
  const int len = lengths[row];
  bool hit = prefix ? len >= pat_len : len == pat_len;
  for (int q = 0; hit && 4 * q < pat_len; ++q) {
    uint32_t w = __ldg(lanes + (size_t)q * r + row);
    if (fold) w = swar_lower(w);
    const int rem = pat_len - 4 * q;
    const uint32_t m = rem >= 4 ? 0xFFFFFFFFu : (1u << (8 * rem)) - 1;
    hit = ((w ^ pat.w[q]) & m) == 0;
  }
  return hit;
}

__global__ void __launch_bounds__(kThreads)
exact_kernel(const uint32_t* __restrict__ lanes,
             const int32_t* __restrict__ lengths, int r, Pattern pat,
             int pat_len, int prefix, int fold, bool* __restrict__ out) {
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < r;
       row += gridDim.x * blockDim.x)
    out[row] = exact_row(lanes, lengths, r, row, pat, pat_len, prefix, fold);
}

// ---------------- the bloom gate ----------------
// The gated kernels take their struct parameters as __grid_constant__:
// they pass them on by reference, which would otherwise copy them to
// local memory in every thread.

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// A gate: a probe (classic or split-block, probe.cuh), the block starts
// and the block count.  Every gated kernel takes either.
template <class Probe>
struct GateT {
  Probe probe;
  const int32_t* starts;             // [nb + 1], nondecreasing
  int nb;
};
using Gate = GateT<vl::BloomProbe>;
using SbGate = GateT<vl::SbProbe>;

// The block starts the row loop searches: copied to s when the gate has
// at most kStartsCap - 1 blocks (the caller's next barrier publishes
// them), else the global array.  The same in every thread.
template <class G>
__device__ __forceinline__ const int32_t* stage_starts(const G& g,
                                                       int32_t* s) {
  if (g.nb + 1 > kStartsCap) return g.starts;
  for (int i = threadIdx.x; i <= g.nb; i += blockDim.x) s[i] = g.starts[i];
  return s;
}

// -1 before the first block, nb from the end of the last one on, else
// the last b with s[b] <= row.  Nondecreasing in row.
__device__ __forceinline__ int block_of(const int32_t* s, int nb, int row) {
  if (row < s[0]) return -1;
  if (row >= s[nb]) return nb;
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s[mid] <= row) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The gated row loop: hit(row) runs only for rows of kept blocks that
// are not maybe rows.  Every lane of a warp runs every iteration (the
// loop bound is the warp's first row) and every turn of the walk over
// the warp's blocks (cur is the same in every lane), so the warp-wide
// probe is safe.
// The bloom keep of the lane's row, every lane of the warp together
// (rows past r take the last row's block).
template <class G>
__device__ __forceinline__ bool warp_keep(const G& g, const int32_t* st,
                                          int r, int row, int lane) {
  const int b = block_of(st, g.nb, min(row, r - 1));
  bool keep = false;
  // lane 0 holds the warp's first block; the next is the least block
  // past cur that a lane holds, until none is left
  for (int cur = __shfl_sync(kFullWarp, b, 0); cur != INT_MAX;
       cur = __reduce_min_sync(kFullWarp, b > cur ? b : INT_MAX)) {
    const bool k = cur >= 0 && cur < g.nb &&
                   vl::warp_block_keep(g.probe, cur, lane);
    if (b == cur) keep = k;
  }
  return keep;
}

template <class G, typename Hit>
__device__ __forceinline__ void gated_rows(const G& g, const int32_t* st,
                                           int r, const bool* __restrict__ ovf,
                                           bool* __restrict__ out,
                                           bool* __restrict__ maybe, Hit hit) {
  const int lane = threadIdx.x & 31;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < r;
       base += gridDim.x * blockDim.x) {
    const int row = base + lane;
    const bool keep = warp_keep(g, st, r, row, lane);
    if (row >= r) continue;
    bool h = false, m = false;
    if (keep) {
      m = ovf != nullptr && ovf[row];
      h = !m && hit(row);
    }
    out[row] = h;
    if (maybe != nullptr) maybe[row] = m;
  }
}

template <int NW, class G>
__global__ void __launch_bounds__(kThreads)
gated_scan_kernel(const uint32_t* __restrict__ lanes,
                  const int32_t* __restrict__ lengths, int r,
                  const __grid_constant__ Pattern pat, int pat_len,
                  int need_start, int need_end, int fold,
                  const __grid_constant__ G g,
                  const bool* __restrict__ ovf,
                  bool* __restrict__ out, bool* __restrict__ maybe) {
  __shared__ uint32_t tab[256 * NW];
  __shared__ uint32_t sp[kMaxPattern / 4];
  __shared__ int32_t starts[kStartsCap];
  const int32_t* st = stage_starts(g, starts);
  const int o = 32 * NW - 2 - pat_len;
  build_table<NW>(tab, sp, pat, pat_len, o, need_start, need_end, fold);
  uint32_t start[NW];
  start_state<NW>(start, o);
  const uint32_t done = need_end ? kClosed : kClosed | kMatch;
  const size_t rs = r;
  gated_rows(g, st, r, ovf, out, maybe, [&](int row) {
    const int len = lengths[row];
    bool hit = false;
    if (len >= pat_len)
      hit = scan_row<NW>(lanes, rs, row, len, tab, start, done);
    return hit;
  });
}

template <class G>
__global__ void __launch_bounds__(kThreads)
gated_exact_kernel(const uint32_t* __restrict__ lanes,
                   const int32_t* __restrict__ lengths, int r,
                   const __grid_constant__ Pattern pat, int pat_len,
                   int prefix, int fold, const __grid_constant__ G g,
                   const bool* __restrict__ ovf, bool* __restrict__ out,
                   bool* __restrict__ maybe) {
  __shared__ int32_t starts[kStartsCap];
  const int32_t* st = stage_starts(g, starts);
  __syncthreads();
  gated_rows(g, st, r, ovf, out, maybe, [&](int row) {
    return exact_row(lanes, lengths, r, row, pat, pat_len, prefix, fold);
  });
}

// ---------------- the ordered pair ----------------

constexpr uint32_t kPairOne = 1u << 30;      // of the top word: always set
constexpr uint32_t kPairNewline = 1u << 31;  // of the top word: a 0x0A seen
// what the pair writes for a row: bit 0 to definite, bit 1 to maybe
constexpr uint32_t kDefinite = 1u, kMaybe = 2u;

// Bit k of the state, as word i's share of it.
__device__ __forceinline__ uint32_t state_bit(int k, int i) {
  return (k >> 5) == i ? 1u << (k & 31) : 0u;
}

// The A.*B table, built by the whole CTA: entry c (NW words) holds bit
// 1 + j where A[j] == c, bit 1 + la + j where B[j] == c, and the
// newline bit for 0x0A.  The barrier at the end also publishes any
// shared memory the CTA wrote before the call.
template <int NW>
__device__ __forceinline__ void build_pair_table(uint32_t* tab,
                                                 const Pattern& pa, int la,
                                                 const Pattern& pb, int lb) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    uint32_t e[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      e[i] = i == NW - 1 && c == 0x0A ? kPairNewline : 0u;
      for (int j = 0; j < la; ++j)
        if (pat_byte(pa.w, j) == (unsigned)c) e[i] |= state_bit(1 + j, i);
      for (int j = 0; j < lb; ++j)
        if (pat_byte(pb.w, j) == (unsigned)c)
          e[i] |= state_bit(1 + la + j, i);
      tab[c * NW + i] = e[i];
    }
  }
  __syncthreads();
}

// One row's words [0, nw) through the automaton, every lane of the warp
// together (a lane whose row is done or absent steps 0xFFFFFFFF words,
// which change nothing it reports): its kDefinite/kMaybe code.
template <int NW>
__device__ __forceinline__ uint32_t pair_row(const uint32_t* __restrict__ lanes,
                                             size_t rs, int row, int nw,
                                             const uint32_t* tab,
                                             const uint32_t (&g)[NW],
                                             const uint32_t (&fin)[NW]) {
  const int wnw = __reduce_max_sync(kFullWarp, nw);   // the same in the warp
  uint32_t d[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i)
    d[i] = state_bit(0, i) | (i == NW - 1 ? kPairOne : 0u);
  for (int q0 = 0; q0 < wnw; q0 += kChunk) {
    uint32_t w[kChunk];
    const uint32_t* p = lanes + (size_t)q0 * rs + row;
#pragma unroll
    for (int k = 0; k < kChunk; ++k, p += rs)
      w[k] = q0 + k < nw ? __ldg(p) : 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (q0 + k >= wnw) break;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint32_t* e = tab + __byte_perm(w[k], 0, 0x4440 | a) * NW;
        uint32_t t[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) t[i] = e[i];
#pragma unroll
        for (int i = NW - 1; i > 0; --i)
          d[i] = (__funnelshift_l(d[i - 1], d[i], 1) & t[i]) | (d[i] & g[i]);
        d[0] = ((d[0] << 1) & t[0]) | (d[0] & g[0]);
      }
    }
  }
  uint32_t hit = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) hit |= d[i] & fin[i];
  if (!hit) return 0u;
  return (d[NW - 1] & kPairNewline) ? kMaybe : kDefinite;
}

// The one pair body, gated or not; tab holds 256 * NW words, starts
// kStartsCap when gated.  Every lane of a warp runs every
// iteration of the row loop (the bound is the warp's first row), so the
// gate's probe and the row's warp-wide word count are safe.
template <int NW, bool kGated, class G>
__device__ __forceinline__ void pair_body(
    const uint32_t* __restrict__ lanes, const int32_t* __restrict__ lengths,
    int r, int nl, const Pattern& pa, int la, const Pattern& pb, int lb,
    const G& g, const bool* __restrict__ ovf,
    bool* __restrict__ definite, bool* __restrict__ maybe, uint32_t* tab,
    int32_t* starts) {
  const int32_t* st = kGated ? stage_starts(g, starts) : nullptr;
  build_pair_table<NW>(tab, pa, la, pb, lb);
  // kept bits: the start bit, A's and B's accepting bits, the one and
  // the newline bit
  uint32_t gk[NW], fin[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    fin[i] = state_bit(la + lb, i);
    gk[i] = state_bit(0, i) | state_bit(la, i) | fin[i] |
            (i == NW - 1 ? kPairOne | kPairNewline : 0u);
  }
  const int lane = threadIdx.x & 31;
  const size_t rs = r;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < r;
       base += gridDim.x * blockDim.x) {
    const int row = base + lane;
    const bool in = row < r;
    bool keep = true;
    if constexpr (kGated) keep = warp_keep(g, st, r, row, lane);
    const bool ov = in && keep && ovf != nullptr && ovf[row];
    const bool need = in && keep && !ov;
    // bytes past a row's length are the layout's 0xFF padding, in no
    // pattern and not a newline
    const int nw = need ? (max(0, min(lengths[row], 4 * nl)) + 3) >> 2 : 0;
    uint32_t c = pair_row<NW>(lanes, rs, row, nw, tab, gk, fin);
    if (!need) c = ov ? kMaybe : 0u;
    if (in) {
      definite[row] = c & kDefinite;
      maybe[row] = c >> 1;
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
match_pair_kernel(const uint32_t* __restrict__ lanes,
                  const int32_t* __restrict__ lengths, int r, int nl,
                  const __grid_constant__ Pattern pa, int la,
                  const __grid_constant__ Pattern pb, int lb,
                  const bool* __restrict__ ovf, bool* __restrict__ definite,
                  bool* __restrict__ maybe) {
  __shared__ uint32_t tab[256 * NW];
  const Gate none = {};
  pair_body<NW, false, Gate>(lanes, lengths, r, nl, pa, la, pb, lb, none, ovf,
                       definite, maybe, tab, nullptr);
}

template <int NW, class G>
__global__ void __launch_bounds__(kThreads)
gated_pair_kernel(const uint32_t* __restrict__ lanes,
                  const int32_t* __restrict__ lengths, int r, int nl,
                  const __grid_constant__ Pattern pa, int la,
                  const __grid_constant__ Pattern pb, int lb,
                  const __grid_constant__ G g,
                  const bool* __restrict__ ovf, bool* __restrict__ definite,
                  bool* __restrict__ maybe) {
  __shared__ uint32_t tab[256 * NW];
  __shared__ int32_t starts[kStartsCap];
  pair_body<NW, true, G>(lanes, lengths, r, nl, pa, la, pb, lb, g, ovf,
                      definite, maybe, tab, starts);
}

Pattern make_pattern(const void* pattern, int pat_len) {
  Pattern pat = {};
  const unsigned char* p = static_cast<const unsigned char*>(pattern);
  for (int j = 0; j < pat_len; ++j) pat.w[j >> 2] |= (uint32_t)p[j] << (8 * (j & 3));
  return pat;
}

int grid_blocks(int r) {
  const int blocks = (r + kThreads - 1) / kThreads;
  const int cap = 8 * vl::sm_count();
  return blocks > cap ? cap : blocks;
}

// The state words of A.*B: the start bit and la + lb pattern bits below
// the top word's one and newline bits; 0 when a pattern is out of 1..64
// bytes or holds 0xFF.
int pair_words(const void* pat_a, int len_a, const void* pat_b, int len_b) {
  if (len_a <= 0 || len_a > 64 || len_b <= 0 || len_b > 64) return 0;
  for (int j = 0; j < len_a; ++j)
    if (static_cast<const unsigned char*>(pat_a)[j] == 0xFF) return 0;
  for (int j = 0; j < len_b; ++j)
    if (static_cast<const unsigned char*>(pat_b)[j] == 0xFF) return 0;
  const int n = len_a + len_b;
  return n <= 29 ? 1 : n <= 61 ? 2 : 5;
}

template <class G>
int launch_scan_gated(const void* lanes, const void* lengths, int r,
                      const void* pattern, int pat_len, int mode,
                      int starts_tok, int ends_tok, int fold, const G& g,
                      const void* ovf, void* out, void* maybe, void* stream) {
  if (pat_len <= 0 || pat_len > kMaxPattern || g.nb < 0 ||
      (ovf == nullptr) != (maybe == nullptr))
    return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const Pattern pat = make_pattern(pattern, pat_len);
  const int blocks = grid_blocks(r);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* l = static_cast<const uint32_t*>(lanes);
  const int32_t* n = static_cast<const int32_t*>(lengths);
  const bool* ov = static_cast<const bool*>(ovf);
  bool* o = static_cast<bool*>(out);
  bool* m = static_cast<bool*>(maybe);
  if (mode == 3 || mode == 4) {
    gated_exact_kernel<G><<<blocks, kThreads, 0, st>>>(
        l, n, r, pat, pat_len, mode == 4, fold, g, ov, o, m);
    return (int)cudaGetLastError();
  }
  const int ns = starts_tok && (mode == 0 || mode == 1);
  const int ne = ends_tok && mode == 0;
  if (pat_len <= 30)
    gated_scan_kernel<1, G><<<blocks, kThreads, 0, st>>>(
        l, n, r, pat, pat_len, ns, ne, fold, g, ov, o, m);
  else if (pat_len <= 62)
    gated_scan_kernel<2, G><<<blocks, kThreads, 0, st>>>(
        l, n, r, pat, pat_len, ns, ne, fold, g, ov, o, m);
  else
    gated_scan_kernel<5, G><<<blocks, kThreads, 0, st>>>(
        l, n, r, pat, pat_len, ns, ne, fold, g, ov, o, m);
  return (int)cudaGetLastError();
}

template <class G>
int launch_pair_gated(const void* lanes, const void* lengths, int r, int nl,
                      const void* pat_a, int len_a, const void* pat_b,
                      int len_b, const G& g, const void* ovf, void* definite,
                      void* maybe, void* stream) {
  const int nw = pair_words(pat_a, len_a, pat_b, len_b);
  if (nw == 0 || nl < 0 || g.nb < 0) return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const Pattern pa = make_pattern(pat_a, len_a);
  const Pattern pb = make_pattern(pat_b, len_b);
  const int blocks = grid_blocks(r);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* l = static_cast<const uint32_t*>(lanes);
  const int32_t* n = static_cast<const int32_t*>(lengths);
  const bool* ov = static_cast<const bool*>(ovf);
  bool* d = static_cast<bool*>(definite);
  bool* m = static_cast<bool*>(maybe);
  if (nw == 1)
    gated_pair_kernel<1, G><<<blocks, kThreads, 0, st>>>(
        l, n, r, nl, pa, len_a, pb, len_b, g, ov, d, m);
  else if (nw == 2)
    gated_pair_kernel<2, G><<<blocks, kThreads, 0, st>>>(
        l, n, r, nl, pa, len_a, pb, len_b, g, ov, d, m);
  else
    gated_pair_kernel<5, G><<<blocks, kThreads, 0, st>>>(
        l, n, r, nl, pa, len_a, pb, len_b, g, ov, d, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vl_match_scan(const void* lanes, const void* lengths, int r,
                             const void* pattern, int pat_len, int mode,
                             int starts_tok, int ends_tok, int fold,
                             void* out, void* stream) {
  if (pat_len <= 0 || pat_len > kMaxPattern) return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const Pattern pat = make_pattern(pattern, pat_len);
  const int blocks = grid_blocks(r);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* l = static_cast<const uint32_t*>(lanes);
  const int32_t* n = static_cast<const int32_t*>(lengths);
  bool* o = static_cast<bool*>(out);
  if (mode == 3 || mode == 4) {
    exact_kernel<<<blocks, kThreads, 0, st>>>(l, n, r, pat, pat_len,
                                              mode == 4, fold, o);
    return (int)cudaGetLastError();
  }
  const int ns = starts_tok && (mode == 0 || mode == 1);
  const int ne = ends_tok && mode == 0;
  if (pat_len <= 30)
    match_scan_kernel<1><<<blocks, kThreads, 0, st>>>(l, n, r, pat, pat_len,
                                                      ns, ne, fold, o);
  else if (pat_len <= 62)
    match_scan_kernel<2><<<blocks, kThreads, 0, st>>>(l, n, r, pat, pat_len,
                                                      ns, ne, fold, o);
  else
    match_scan_kernel<5><<<blocks, kThreads, 0, st>>>(l, n, r, pat, pat_len,
                                                      ns, ne, fold, o);
  return (int)cudaGetLastError();
}

// `A.*B` per row: definite[row] = ordered & ~newline & ~ovf and
// maybe[row] = (ordered & newline) | ovf (see the note at the top); ovf
// may be null.  nl lane words a row; A and B of 1-64 bytes, none of
// them 0xFF.
extern "C" int vl_match_pair(const void* lanes, const void* lengths, int r,
                             int nl, const void* pat_a, int len_a,
                             const void* pat_b, int len_b, const void* ovf,
                             void* definite, void* maybe, void* stream) {
  const int nw = pair_words(pat_a, len_a, pat_b, len_b);
  if (nw == 0 || nl < 0) return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const Pattern pa = make_pattern(pat_a, len_a);
  const Pattern pb = make_pattern(pat_b, len_b);
  const int blocks = grid_blocks(r);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* l = static_cast<const uint32_t*>(lanes);
  const int32_t* n = static_cast<const int32_t*>(lengths);
  const bool* ov = static_cast<const bool*>(ovf);
  bool* d = static_cast<bool*>(definite);
  bool* m = static_cast<bool*>(maybe);
  if (nw == 1)
    match_pair_kernel<1><<<blocks, kThreads, 0, st>>>(
        l, n, r, nl, pa, len_a, pb, len_b, ov, d, m);
  else if (nw == 2)
    match_pair_kernel<2><<<blocks, kThreads, 0, st>>>(
        l, n, r, nl, pa, len_a, pb, len_b, ov, d, m);
  else
    match_pair_kernel<5><<<blocks, kThreads, 0, st>>>(
        l, n, r, nl, pa, len_a, pb, len_b, ov, d, m);
  return (int)cudaGetLastError();
}

// The scan gated by a bloom leaf: definite[row] = hit & ~ovf & keep,
// maybe[row] = ovf & keep with keep = the probe.cuh keep of the row's
// block (block_of over starts[0..nblocks]); ovf and maybe may be null
// together.  plane/nwords/idx/shift hold at least nblocks blocks.
extern "C" int vl_match_scan_gated(
    const void* lanes, const void* lengths, int r, const void* pattern,
    int pat_len, int mode, int starts_tok, int ends_tok, int fold,
    const void* plane, int wp, const void* nwords, const void* idx,
    const void* shift, int p, const void* starts, int nblocks,
    const void* ovf, void* out, void* maybe, void* stream) {
  if (p < 0) return (int)cudaErrorInvalidValue;
  const Gate g = {{static_cast<const uint32_t*>(plane),
                   static_cast<const int32_t*>(nwords),
                   static_cast<const int32_t*>(idx),
                   static_cast<const int32_t*>(shift), wp, p},
                  static_cast<const int32_t*>(starts), nblocks};
  return launch_scan_gated(lanes, lengths, r, pattern, pat_len, mode,
                           starts_tok, ends_tok, fold, g, ovf, out, maybe,
                           stream);
}

// The same scan behind a split-block gate (probe.cuh SbProbe): plane
// [>= nblocks, lp] lanes, nsb, sbidx [., t] and mask [t, 8].
extern "C" int vl_match_scan_gated_sb(
    const void* lanes, const void* lengths, int r, const void* pattern,
    int pat_len, int mode, int starts_tok, int ends_tok, int fold,
    const void* plane, int lp, const void* nsb, const void* sbidx,
    const void* mask, int t, const void* starts, int nblocks,
    const void* ovf, void* out, void* maybe, void* stream) {
  if (t < 0) return (int)cudaErrorInvalidValue;
  const SbGate g = {{static_cast<const uint32_t*>(plane),
                     static_cast<const int32_t*>(nsb),
                     static_cast<const int32_t*>(sbidx),
                     static_cast<const uint32_t*>(mask), lp, t},
                    static_cast<const int32_t*>(starts), nblocks};
  return launch_scan_gated(lanes, lengths, r, pattern, pat_len, mode,
                           starts_tok, ends_tok, fold, g, ovf, out, maybe,
                           stream);
}

// The pair gated by a bloom leaf: definite[row] = keep & ordered &
// ~newline & ~ovf, maybe[row] = keep & ((ordered & newline) | ovf), with
// keep as vl_match_scan_gated's; ovf may be null.
extern "C" int vl_match_pair_gated(
    const void* lanes, const void* lengths, int r, int nl, const void* pat_a,
    int len_a, const void* pat_b, int len_b, const void* plane, int wp,
    const void* nwords, const void* idx, const void* shift, int p,
    const void* starts, int nblocks, const void* ovf, void* definite,
    void* maybe, void* stream) {
  if (p < 0) return (int)cudaErrorInvalidValue;
  const Gate g = {{static_cast<const uint32_t*>(plane),
                   static_cast<const int32_t*>(nwords),
                   static_cast<const int32_t*>(idx),
                   static_cast<const int32_t*>(shift), wp, p},
                  static_cast<const int32_t*>(starts), nblocks};
  return launch_pair_gated(lanes, lengths, r, nl, pat_a, len_a, pat_b, len_b,
                           g, ovf, definite, maybe, stream);
}

// The same pair behind a split-block gate, arguments as
// vl_match_scan_gated_sb's.
extern "C" int vl_match_pair_gated_sb(
    const void* lanes, const void* lengths, int r, int nl, const void* pat_a,
    int len_a, const void* pat_b, int len_b, const void* plane, int lp,
    const void* nsb, const void* sbidx, const void* mask, int t,
    const void* starts, int nblocks, const void* ovf, void* definite,
    void* maybe, void* stream) {
  if (t < 0) return (int)cudaErrorInvalidValue;
  const SbGate g = {{static_cast<const uint32_t*>(plane),
                     static_cast<const int32_t*>(nsb),
                     static_cast<const int32_t*>(sbidx),
                     static_cast<const uint32_t*>(mask), lp, t},
                    static_cast<const int32_t*>(starts), nblocks};
  return launch_pair_gated(lanes, lengths, r, nl, pat_a, len_a, pat_b, len_b,
                           g, ovf, definite, maybe, stream);
}
