// Fused scale-space blur ladder + DoG + scale-space NMS for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mustache_tpu/kernels/fused_ladder.py
// ::_fused_kernel (pallas_call in fused_ladder_nms_batched). Semantics, per
// batch slot b of sentinel-filled dense blocks cs[b] (N x N):
//   * every Gaussian blur G_k of the ladder (12 per octave; taps zero-padded
//     to the common radius R, sigma k's own radius radii[k]), scipy
//     'reflect' boundary;
//   * blur values outside the matrix set to 0, so the DoG planes
//     L_k = G_k - G_{k+1} and their 3x3 maxima see the constant-0 pad of
//     scipy's maximum_filter;
//   * the NMS predicate of the JAX kernel (fused_ladder.py:250-255), with the
//     running best response (best_v, best_sig) carried across octaves;
//   * per plane, partials over the support: min |L| and sum |L|.
// Valid == 0 slots (batch padding) do no work and write zero partials.
//
// A launch computes the row tiles [t_lo, t_hi) of each block from a window
// of its dense rows, [base, base + held) (the whole block: base 0, held N,
// all tiles). The reflect boundary stays the block's (N); only the read
// index shifts by base. The window holds the tiles' rows plus R + 1 on
// each side (the rows a tile's slab reads), so the tiles of a launch are
// bit for bit those of the whole-block launch: a block's rows can be split
// over devices on tile boundaries and the parts concatenated.
//
// What bounds it on the H100: FP32 FMAs. The ladder (1.6, 3.2) has 392
// nonzero taps over its 24 sigmas, so two separable passes cost 784 FMA per
// band cell against 16 bytes of input read once: compute-bound, ~67 TFLOP/s
// on the CUDA cores (no TF32: the reference blurs at Precision.HIGHEST).
//
// Design:
//   * one 256-thread block per (batch slot, 30 x 64 dense tile meeting the
//     band 0 <= j - i < DB); tile k of row tile ti starts at column
//     30 ti + 64 k. Its input is a (32 + 2R) x (66 + 2R) reflected slab in
//     shared memory, loaded once with the ladder's taps and radii;
//   * a tile without a support cell writes neutral partials and the empty
//     state and returns (no cell there can be a detection: exact);
//   * register blocking: in both blur passes a thread computes a strip of
//     outputs along the tap direction (8 in the vertical pass, 10 in the
//     horizontal one). The sigma's taps sit in registers (a template on
//     the tap count, unrolled; 16-byte loads), each input is loaded from
//     shared memory once and feeds every output it touches (the
//     horizontal pass loads four inputs at a time): ~0.2 loads per FMA at
//     the ladder's radii instead of 2. A sigma with more than 32 taps
//     (radius > 15) runs in segments that continue the same sums. Per
//     output the FMAs run in increasing tap order from 0, over the sigma's
//     nonzero taps only (adding a zero tap is exact, so skipping it
//     changes no result), as in the plain version's order of passes;
//   * the horizontal pass maps warp s to tile columns 8 s .. 8 s + 7 and
//     lane g to blur row g (rows -1 .. 30 of the tile), and also computes
//     the two neighbouring columns. So each thread holds its row's blur, DoG
//     values and horizontal 3-maxima in registers; the vertical 3-maxima
//     come from lanes g +- 1 by shuffles. The DoG/NMS state (best_v,
//     best_sig and the rolling planes) never leaves registers, and the 3x3
//     maxima are taken from the same DoG values the centre test uses, so
//     Lc == mC is exact. The vertical pass writes one of two buffers, so a
//     sigma costs one barrier;
//   * per-plane partials: per thread in a fixed order, per warp by a
//     shuffle tree (the min as an integer reduction: |L| >= 0 orders as
//     its bits do), stored per (plane, warp) and summed over warps in
//     order once at the end of the tile (no float atomics: deterministic);
//     the wrapper reduces over tiles with amin / sum;
//   * every launched tile writes all of its band cells band[b, i, j - i]
//     (the empty state (0, -1) where it computes none), staged through
//     shared memory so that a warp writes consecutive cells; the tiles
//     cover the band exactly, so the outputs need no pre-fill.
//
// Two modes of one kernel (a template argument, chosen by the wrapper from
// the ladder's radius R and octave count alone):
//   * slab (STREAM = false): the whole reflected slab and every sigma's
//     taps sit in shared memory, loaded once per tile. It holds ladders up
//     to the block's 232,448 B (the default ladder: R = 14);
//   * streamed (STREAM = true), for the larger ladders of the JAX kernel's
//     domain (R <= 127: the slab alone is 366 KB at R = 127), launched as
//     thread-block clusters of C = CLUSTER = 4 CTAs (fused_ladder.CLUSTER).
//     What bounds a lone tile there is its halo: its vertical pass
//     computes 66 + 2r columns for 64, 2.1 times the FMAs its cells need
//     over the -oc 5 ladder. So:
//     - the C CTAs of a cluster hold C neighbouring tiles of one row tile
//       (tile k starts at column 30 ti + 64 k, so their columns are
//       contiguous), and the cluster computes the vertical pass once over
//       the union of their columns, U = 64 m + 2 + 2r wide (m: the tiles
//       with cells; 1.45 times the cells' FMAs at C = 4). The union is cut
//       into 64-column pieces dealt to the ranks in turn; a rank computes
//       its pieces into its own shared memory (its "share"). After a
//       cluster barrier each CTA copies the 66 + 2r columns its horizontal
//       pass reads, 16 bytes at a time through distributed shared memory
//       (map_shared_rank), into its local buffer, and runs the pass and
//       the NMS from there as the slab mode does (reading the shares in
//       the pass itself instead moves every input across the SM-to-SM
//       network once per tap row: 1.5 times slower on an H100,
//       tools/stream_variants.py);
//     - a piece (one vertical unit per thread) is computed one 32-tap
//       segment at a time: segment j reads the slab rows [32 j, 32 j +
//       63), i.e. 32-row chunks j and j + 1. The chunks stream through a
//       ring of three 32-row slots, plus 31 rows after the third that
//       mirror the first's (a segment's two chunks are always contiguous).
//       A chunk inside the matrix and the window is one tensor copy (TMA,
//       issued by one thread); at the matrix's edges (reflection) and at a
//       window's clamp the threads copy it with cp.async. Either completes
//       on the slot's mbarrier. While a segment is computed, the chunk
//       after its two is in flight; a sigma's first three chunks are
//       fetched during the previous sigma's copy, horizontal pass and NMS;
//     - a thread keeps its unit's 8 sums in registers across a piece's
//       segments (no store and reload between them), and the passes keep
//       a tap in registers only while it is in use (a ring of 12 and 16
//       registers instead of a segment's 32): the streamed mode's
//       bookkeeping left no room for the 32;
//     - one cluster barrier a sigma: shares are double-buffered by
//       (sig & 1), and a CTA reaches sigma s + 2's vertical pass (which
//       overwrites buffer s & 1) only after the barrier of sigma s + 1,
//       which every CTA reaches only after its copy of sigma s. The same
//       barrier orders the local buffer (read by the horizontal pass of
//       sigma s, written by the copy of s + 1) and the ring (the next
//       sigma's prefetch starts after it). Only the current and the next
//       sigma's taps are held;
//     - every rank reaches every cluster barrier, and the last one before
//       it exits (its share may still be read). Whether a cluster runs at
//       all is decided by the cluster: it skips only when none of its
//       ranks has a support cell. A rank without one (or without cells,
//       or past tiles_per_row in the grid padded to whole clusters)
//       computes its pieces and skips its copy, horizontal pass and NMS;
//       padding ranks write nothing;
//     - shared memory: 109,636 B at R = 110 (-oc 5) and 114,612 B at the
//       domain's corner, so two CTAs fit an SM (each also takes the runtime's
//       1 KB reserve of the SM's 228 KB).
//     What bounds it now: the FMA rate, about a fifth of the card's FP32
//     peak as before. The passes read one input from shared memory per 8
//     (vertical) or 10 (horizontal) FMAs, which by count keeps the SM's
//     shared memory two thirds to three quarters as busy as its FP32
//     lanes; outside the two passes the copy is the largest part
//     (tools/stream_variants.py times each).
//     Each tmp column is still one thread's, in tap order from 0, in
//     segments of 32, and each horizontal output sums its taps in the same
//     order: both modes, and the plain version, give the same bits.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TR = 30;                // output tile rows
constexpr int TC = 64;                // output tile columns
constexpr int GR = TR + 2;            // blur rows: tile + NMS halo
constexpr int GC = TC + 2;            // blur columns: tile + NMS halo
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int V = 8;                  // vertical pass: outputs per thread
constexpr int CELLS = TC / NWARP;     // tile columns per warp (and thread)
constexpr int HW = CELLS + 2;         // horizontal pass: outputs per thread
constexpr int SEG = 32;               // taps per unrolled segment
constexpr int BLURS = 12;             // blurs per octave
constexpr int PLANES = BLURS - 3;     // detection planes per octave
constexpr int PW = 64;                // streamed mode: tmp columns a piece
constexpr int CH = 32;                // streamed mode: slab rows a chunk
constexpr int SLOTS = 3;              // streamed mode: ring slots, a chunk each
constexpr int RP = PW + 4;            // ring pitch: a piece from an aligned
                                      // column
constexpr int RING_ROWS = SLOTS * CH + CH - 1;  // + the mirror of slot 0
constexpr int CLUSTER = 4;            // streamed mode: CTAs a cluster
                                      // (fused_ladder.CLUSTER)
static_assert(GR == 32, "one blur row per lane");
static_assert(GR / V == 4, "vertical pass: four strips of rows");
static_assert(SEG % 4 == 0, "segments start on 16-byte tap boundaries");
static_assert((GR / V) * PW == THREADS, "one vertical unit per thread");
static_assert(CH == SEG, "segment j reads chunks j and j + 1");
static_assert(RP % 4 == 0, "16-byte ring rows");

// numpy 'symmetric' reflection of an index into [0, n); the clamp only
// affects slab cells that feed out-of-matrix blurs, which are zeroed
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -1 - i;
  if (i >= n) i = 2 * n - 1 - i;
  return min(max(i, 0), n - 1);
}

// The taps of sigmas [sig0, sig0 + nsig) into s_taps ([nsig][TW]): each
// sigma's nonzero taps (2r + 1 of the ladder's 2R + 1) first, zero-padded
// to TW
__device__ __forceinline__ void stage_taps(float* s_taps,
                                           const float* __restrict__ taps,
                                           const int* s_radii, int sig0,
                                           int nsig, int TW, int T, int R) {
#pragma unroll 4
  for (int k = threadIdx.x; k < nsig * TW; k += THREADS) {
    const int sig = k / TW, t = k - (k / TW) * TW;
    const int r = s_radii[sig0 + sig];
    s_taps[k] =
        t <= 2 * r ? __ldg(taps + (sig0 + sig) * T + R - r + t) : 0.f;
  }
}

// cp.async of 4 or 16 bytes from global to shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// mbarriers (shared::cta) and the tensor copy that completes on one
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_u32(bar))
      : "memory");
}

// Streamed mode: a rank's share of one sigma's vertical pass. The union
// of the cluster's tmp columns is U = 64 m + 2 + 2r wide (m: its tiles
// with cells), union column u is dense column uc0 + u. It is cut into
// pieces of PW columns (the last one narrower), dealt to the ranks in
// turn: rank q computes union pieces q, q + C, ..., its j-th at columns
// [PW j, PW j + PW) of its share buffer, each read as nch chunks of CH
// slab rows (n = np nch ring items in all). A rank with fewer pieces
// then finishes sooner and leaves its SM to a co-resident CTA (an even
// split of the columns gave every rank the sliver of a last piece).
// Mirrored in fused_ladder.py (share_columns).
struct Share {
  int r, U, C, rank, np, nch, n, uc0;
};

__device__ __forceinline__ Share share_of(int r, int C, int rank, int m,
                                          int cu0) {
  Share sh;
  sh.U = TC * m + 2 + 2 * r;
  sh.r = r;
  sh.C = C;
  sh.rank = rank;
  sh.np = max(0, ((sh.U + PW - 1) / PW - rank + C - 1) / C);
  sh.nch = (GR + 2 * r + CH - 1) / CH;
  sh.n = sh.np * sh.nch;
  sh.uc0 = cu0 - 1 - r;
  return sh;
}

// the first union column of a rank's j-th piece, and its width
__device__ __forceinline__ int piece_col(const Share& sh, int j) {
  return PW * (sh.rank + j * sh.C);
}

__device__ __forceinline__ int piece_width(const Share& sh, int j) {
  return min(PW, sh.U - piece_col(sh, j));
}

// Start copying ring item `it` of a share (piece it / nch, chunk it % nch;
// gidx: its index among all of the CTA's items) into slot gidx % SLOTS;
// it completes on that slot's mbarrier (phase gidx / SLOTS: thread 0's
// arrival and every thread's cp.async arrival, 1 + THREADS in all). The
// slot holds the piece from the aligned column below its first (RP per
// row); slot 0's first CH - 1 rows go to the mirror rows as well. A chunk
// whose rows and columns all lie inside the matrix and the window (every
// chunk but those within a radius of the matrix's edges) is one tensor
// copy (TMA) issued by thread 0: the 68 x 32 box starts at that aligned
// column, and what it reads past the piece or past the block (zero-
// filled) is never used. At the matrix's edges a slab row or column is a
// reflection, and in a row window a row may be clamped: there thread t
// copies row t / 8 of the chunk, four columns at a time (16-byte cp.async
// where they are inside the matrix and aligned, 4-byte ones at the
// reflect edge); slab row sr is dense row r0 - 1 - r + sr, read at
// reflect(...) - base, clamped to the window as the slab mode's load is.
static_assert(THREADS == 8 * CH, "eight threads a chunk row");
__device__ __forceinline__ void fetch_item(
    float* ring, uint64_t* bars, const Share& sh, int it, int gidx,
    const CUtensorMap* tm_chunk, const CUtensorMap* tm_mirror,
    const float* blk, int b, int r0, int N, int base, int held, bool vec) {
  const int p = it / sh.nch, c = it - p * sh.nch;
  const int slot = gidx % SLOTS;
  uint64_t* bar = bars + slot;
  const int gc = sh.uc0 + piece_col(sh, p);  // the piece's first column
  const int g4 = gc - (gc & 3);
  const int ng = ((gc & 3) + piece_width(sh, p) + 3) >> 2;
  const int rows = min(CH, GR + 2 * sh.r - CH * c);
  const int row_lo = r0 - 1 - sh.r + CH * c;
  float* dst = ring + slot * CH * RP;
  float* mirror = slot == 0 ? ring + SLOTS * CH * RP : nullptr;
  if (vec && g4 >= 0 && g4 + 4 * ng <= N && row_lo >= base &&
      row_lo + rows <= min(N, base + held)) {
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar, (mirror ? 2 * CH - 1 : CH) * RP * 4);
      tma_load(dst, tm_chunk, g4, row_lo - base, b, bar);
      if (mirror) tma_load(mirror, tm_mirror, g4, row_lo - base, b, bar);
    }
  } else {
    const int pr = threadIdx.x >> 3, q0 = threadIdx.x & 7;
    if (pr < rows) {
      const int gi =
          min(max(reflect(row_lo + pr, N) - base, 0), held - 1);
      const float* src = blk + (size_t)gi * N;
      float* d = dst + pr * RP;
      float* m = mirror && pr < CH - 1 ? mirror + pr * RP : nullptr;
      for (int q = q0; q < ng; q += 8) {
        const int col = g4 + 4 * q;
        if (vec && col >= 0 && col + 4 <= N) {
          cp_async16(d + 4 * q, src + col);
          if (m) cp_async16(m + 4 * q, src + col);
        } else {
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float* s4 = src + reflect(col + e4, N);
            cp_async4(d + 4 * q + e4, s4);
            if (m) cp_async4(m + 4 * q + e4, s4);
          }
        }
      }
    }
    if (threadIdx.x == 0) mbar_arrive(bar);
  }
  cp_async_mbar_arrive(bar);
}

// The L taps at w (16-byte aligned, zero-padded to a multiple of 4) into
// registers, four per shared-memory load.
template <int L>
__device__ __forceinline__ void load_taps(float (&wr)[L], const float* w) {
#pragma unroll
  for (int t = 0; t < L; t += 4) {
    const float4 v = *reinterpret_cast<const float4*>(w + t);
    wr[t] = v.x;
    if (t + 1 < L) wr[t + 1] = v.y;
    if (t + 2 < L) wr[t + 2] = v.z;
    if (t + 3 < L) wr[t + 3] = v.w;
  }
}

// Vertical pass, taps [t0, t0 + L) of the sigma (w points at tap t0):
//   tmp[g][c] (+)= sum_t w[t] slab[g + lo + t0 + t][lo + c]
// for g < GR and c < ncols. A unit is V consecutive g of one column; a
// later segment continues the sums in tmp.
template <int L>
__device__ __forceinline__ void vpass(const float* w, const float* slab,
                                      float* tmp, int SW, int TP, int lo,
                                      int t0, int ncols, bool first) {
  float wr[L];
  load_taps(wr, w);
  const int units = (GR / V) * ncols;
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int s = (u >= ncols) + (u >= 2 * ncols) + (u >= 3 * ncols);
    const int c = u - s * ncols;
    const float* x = slab + (s * V + lo + t0) * SW + lo + c;
    float* out = tmp + s * V * TP + c;
    float acc[V];
#pragma unroll
    for (int o = 0; o < V; ++o) acc[o] = first ? 0.f : out[o * TP];
#pragma unroll
    for (int q = 0; q < V + L - 1; ++q) {
      const float xv = x[q * SW];
#pragma unroll
      for (int o = 0; o < V; ++o) {
        const int t = q - o;
        if (t >= 0 && t < L) acc[o] = fmaf(wr[t], xv, acc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < V; ++o) out[o * TP] = acc[o];
  }
}

// Horizontal pass, taps [t0, t0 + L): acc[o] += sum_t w[t] x[o + t], where
// x (16-byte aligned) points at tap t0 of this thread's first output in
// its tmp row; the inputs come four per shared-memory load.
template <int L>
__device__ __forceinline__ void hpass(float (&acc)[HW], const float* w,
                                      const float* x) {
  float wr[L];
  load_taps(wr, w);
  float4 v;
#pragma unroll
  for (int q = 0; q < HW + L - 1; ++q) {
    if (q % 4 == 0) v = *reinterpret_cast<const float4*>(x + q);
    const float xv = q % 4 == 0 ? v.x : q % 4 == 1 ? v.y : q % 4 == 2 ? v.z
                                                                     : v.w;
#pragma unroll
    for (int o = 0; o < HW; ++o) {
      const int t = q - o;
      if (t >= 0 && t < L) acc[o] = fmaf(wr[t], xv, acc[o]);
    }
  }
}

// A sigma has 2r + 1 taps, split into segments of SEG = 32: every segment
// but the last has 32 taps and the last an odd count, so those are the
// only lengths the passes are instantiated for.
static_assert(SEG == 32, "MTT_TAP_COUNTS lists the odd counts below SEG");
#define MTT_TAP_COUNTS(X)                                                    \
  X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) X(19) X(21) X(23) X(25) \
  X(27) X(29) X(31) X(32)

__device__ __forceinline__ void vpass_n(int L, const float* w,
                                        const float* slab, float* tmp, int SW,
                                        int TP, int lo, int t0, int ncols,
                                        bool first) {
  switch (L) {
#define MTT_CASE(n) \
  case n: vpass<n>(w, slab, tmp, SW, TP, lo, t0, ncols, first); break;
    MTT_TAP_COUNTS(MTT_CASE)
#undef MTT_CASE
  }
}

__device__ __forceinline__ void hpass_n(int L, float (&acc)[HW],
                                        const float* w, const float* x) {
  switch (L) {
#define MTT_CASE(n) \
  case n: hpass<n>(acc, w, x); break;
    MTT_TAP_COUNTS(MTT_CASE)
#undef MTT_CASE
  }
}

// The streamed mode's passes: the same sums in the same order as vpass /
// hpass, but a tap is loaded (four at a time, a broadcast) just before
// its first use into a ring of registers that holds only the taps still
// in use (8 + 3 in the vertical pass, 10 + 3 in the horizontal one)
// instead of the segment's 32: the streamed mode's ring bookkeeping
// leaves no room for the 32 (ptxas then spills in these loops).
template <int L, int K>
__device__ __forceinline__ void tap_block(float (&wr)[K], const float* w,
                                          int q) {
  if (q % 4 == 0 && q < L) {
    const float4 v = *reinterpret_cast<const float4*>(w + q);
    wr[q % K] = v.x;
    if (q + 1 < L) wr[(q + 1) % K] = v.y;
    if (q + 2 < L) wr[(q + 2) % K] = v.z;
    if (q + 3 < L) wr[(q + 3) % K] = v.w;
  }
}

// One unit's segment: acc[o] += sum_t w[t] x[(o + t) SW], its V outputs
// staying in registers from one segment to the next (a thread keeps its
// unit over a piece's segments).
template <int L>
__device__ __forceinline__ void vpass_w(float (&acc)[V], const float* w,
                                        const float* x, int SW) {
  float wr[12];
#pragma unroll
  for (int q = 0; q < V + L - 1; ++q) {
    tap_block<L>(wr, w, q);
    const float xv = x[q * SW];
#pragma unroll
    for (int o = 0; o < V; ++o) {
      const int t = q - o;
      if (t >= 0 && t < L) acc[o] = fmaf(wr[t % 12], xv, acc[o]);
    }
  }
}

template <int L>
__device__ __forceinline__ void hpass_w(float (&acc)[HW], const float* w,
                                        const float* x) {
  float wr[16];
  float4 v;
#pragma unroll
  for (int q = 0; q < HW + L - 1; ++q) {
    tap_block<L>(wr, w, q);
    if (q % 4 == 0) v = *reinterpret_cast<const float4*>(x + q);
    const float xv = q % 4 == 0 ? v.x : q % 4 == 1 ? v.y : q % 4 == 2 ? v.z
                                                                     : v.w;
#pragma unroll
    for (int o = 0; o < HW; ++o) {
      const int t = q - o;
      if (t >= 0 && t < L) acc[o] = fmaf(wr[t % 16], xv, acc[o]);
    }
  }
}

__device__ __forceinline__ void vpass_wn(int L, float (&acc)[V],
                                         const float* w, const float* x,
                                         int SW) {
  switch (L) {
#define MTT_CASE(n) \
  case n: vpass_w<n>(acc, w, x, SW); break;
    MTT_TAP_COUNTS(MTT_CASE)
#undef MTT_CASE
  }
}

__device__ __forceinline__ void hpass_wn(int L, float (&acc)[HW],
                                         const float* w, const float* x) {
  switch (L) {
#define MTT_CASE(n) \
  case n: hpass_w<n>(acc, w, x); break;
    MTT_TAP_COUNTS(MTT_CASE)
#undef MTT_CASE
  }
}

// The tile's band cells band[b, i - row0, j - i] (0 <= j - i < DB, i < N)
// for rows i in [r0, r0 + TR) and columns j in [c0, c0 + TC), in the
// launch's band of out_rows rows from row0: from sv / ss (row-major, pitch
// TC + 1) or, when they are null, the empty state (0, -1). Neighbouring
// threads write neighbouring band cells.
__device__ __forceinline__ void store_band(float* __restrict__ band_v,
                                           int* __restrict__ band_sig, int b,
                                           int N, int DB, int row0,
                                           int out_rows, int r0, int c0,
                                           const float* sv, const int* ss) {
  for (int e = threadIdx.x; e < TR * TC; e += THREADS) {
    const int ir = e / TC, jc = e % TC;
    const int i = r0 + ir, d = c0 + jc - i;
    if (i < N && d >= 0 && d < DB) {
      const size_t at = ((size_t)b * out_rows + i - row0) * DB + d;
      band_v[at] = sv ? sv[ir * (TC + 1) + jc] : 0.f;
      band_sig[at] = ss ? ss[ir * (TC + 1) + jc] : -1;
    }
  }
}

template <bool STREAM>
__global__ void __launch_bounds__(THREADS, 2)
fused_ladder_nms_kernel(const float* __restrict__ cs,
                        const float* __restrict__ nzf,
                        const int* __restrict__ valid,
                        const float* __restrict__ taps,
                        const int* __restrict__ radii,
                        float* __restrict__ band_v,
                        int* __restrict__ band_sig,
                        float* __restrict__ parts,
                        int N, int DB, int R, int n_octaves,
                        int tiles_per_row, int base, int held, int t_lo,
                        int out_rows, int vec,
                        const __grid_constant__ CUtensorMap tm_chunk,
                        const __grid_constant__ CUtensorMap tm_mirror) {
  extern __shared__ __align__(128) float smem[];
  const int T = 2 * R + 1;
  const int S = n_octaves * BLURS;
  const int P = n_octaves * PLANES;
  const int SW = GC + 2 * R;                 // slab row length (and pitch)
  const int SR = GR + 2 * R;                 // slab rows
  // tmp rows: 16-byte aligned, >= 4 words past the widest pass, and
  // TP = 4 (mod 32) so that eight lanes' 16-byte loads hit distinct banks
  const int TP = 32 * ((SW + 31) / 32) + 4;
  const int TW = 4 * ((T + 3) / 4);          // taps per sigma, padded
  // slab mode: every sigma's taps, two buffers of the vertical pass and
  // the whole slab; streamed: the current and the next sigma's taps, the
  // horizontal pass's input, the ring of chunks and two buffers of this
  // rank's share, WP columns each (room for the most 64-column pieces a
  // rank takes of any sigma)
  constexpr int C = STREAM ? CLUSTER : 1;
  const int WP = PW * (((TC * C + 2 + 2 * R + PW - 1) / PW + C - 1) / C);
  // (streamed: the ring 128-byte aligned for the tensor copies, and the
  // ring's three mbarriers after the shares)
  const int ST = STREAM ? 2 : S;
  float* s_taps = smem;                      // [ST][TW] nonzero taps first
  float* s_tmp = s_taps + (STREAM ? 32 * ((ST * TW + 31) / 32) : ST * TW);
  float* s_slab = s_tmp + (STREAM ? 1 : 2) * GR * TP;  // [SR][SW] or ring
  float* s_share = s_slab + (STREAM ? RING_ROWS * RP : SR * SW);
  uint64_t* s_bar = (uint64_t*)(s_share + 2 * GR * WP);
  int* s_radii = (int*)(s_share + (STREAM ? 2 * GR * WP + 8 : 0));  // [S]
  int* s_flag = s_radii + S;                 // streamed: has support
  float* s_part = (float*)(s_flag + (STREAM ? 1 : 0));   // [2][P][NWARP]

  const int b = blockIdx.y;
  const int tile = blockIdx.x;               // the launch's tile
  // streamed: the grid holds whole clusters per row tile (tpg >=
  // tiles_per_row; the rest are padding ranks)
  const int tpg = C * ((tiles_per_row + C - 1) / C);
  const int ti = t_lo + tile / tpg;
  const int kt = tile % tpg;                 // column tile
  const bool real = !STREAM || kt < tiles_per_row;
  const int row0 = t_lo * TR;                // the launch's first band row
  const int r0 = ti * TR;
  const int c0 = r0 + kt * TC;
  const int tid = threadIdx.x;
  const int g = tid & 31;                    // blur row: dense r0 - 1 + g
  const int warp = tid >> 5;                 // tile columns CELLS * warp + o
  float* part =
      parts + (STREAM ? ((size_t)b * (gridDim.x / tpg) + ti - t_lo) *
                                tiles_per_row + kt
                      : (size_t)b * gridDim.x + tile) * 2 * P;

  if (valid[b] == 0 || (!STREAM && c0 >= N)) {
    // pad slot: zero partials (as the JAX kernel writes); a tile past the
    // last column: neutral partials. Band cells: the empty state. (A pad
    // slot is the whole cluster's: no rank waits for another.)
    if (!real) return;
    const float mn = valid[b] == 0 ? 0.f : INFINITY;
    for (int p = tid; p < P; p += THREADS) {
      part[p] = mn;
      part[P + p] = 0.f;
    }
    store_band(band_v, band_sig, b, N, DB, row0, out_rows, r0, c0, nullptr,
               nullptr);
    return;
  }

  // this thread's tile cells: row i, columns j0 + o (lanes 0 and 31 hold
  // the halo rows and own no cell)
  const int i = r0 - 1 + g;
  const int j0 = c0 + CELLS * warp;
  const float* nzb = nzf + (size_t)b * held * N;
  unsigned nz = 0;
#pragma unroll
  for (int o = 0; o < CELLS; ++o) {
    const int d = j0 + o - i;
    if (real && g >= 1 && g <= TR && i < N && j0 + o < N && d >= 0 &&
        d < DB && __ldg(nzb + (size_t)(i - base) * N + j0 + o) > 0.5f)
      nz |= 1u << o;
  }
  bool active = true;                        // streamed: this rank's tile
  if constexpr (!STREAM) {
    if (!__syncthreads_or(nz != 0)) {
      // no support cell: no candidate, neutral partials
      for (int p = tid; p < P; p += THREADS) {
        part[p] = INFINITY;
        part[P + p] = 0.f;
      }
      store_band(band_v, band_sig, b, N, DB, row0, out_rows, r0, c0,
                 nullptr, nullptr);
      return;
    }
  } else {
    // the cluster runs unless none of its ranks has a support cell; a
    // real rank without one writes neutral partials and the empty state
    // now, and later only computes its share
    active = __syncthreads_or(nz != 0);
    if (tid == 0) *s_flag = active;
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    cluster.sync();
    const int any = __syncthreads_or(
        tid < C && *cluster.map_shared_rank(s_flag, tid) != 0);
    if (real && !active) {
      for (int p = tid; p < P; p += THREADS) {
        part[p] = INFINITY;
        part[P + p] = 0.f;
      }
      store_band(band_v, band_sig, b, N, DB, row0, out_rows, r0, c0,
                 nullptr, nullptr);
    }
    if (!any) {
      cluster.sync();                          // the flags are read
      return;
    }
  }

  // in flight together: this thread's sigma radius (S <= THREADS), then
  // (slab mode) the slab, eight loads per thread at a time; slab cell
  // (sr, sc) holds
  // dense (r0 - 1 - R + sr, c0 - 1 - R + sc), at row reflect(...) - base
  // of the window. Every cell that feeds a blur inside the matrix lies in
  // the window; the clamp keeps the other cells' reads in bounds (their
  // blurs are zeroed)
  const int rk = tid < S ? __ldg(radii + tid) : 0;
  const float* blk = cs + (size_t)b * held * N;
  constexpr int BATCH = 8;
  for (int k0 = tid; !STREAM && k0 < SR * SW; k0 += BATCH * THREADS) {
    float v[BATCH];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int k = k0 + e * THREADS;
      const int sr = k / SW, sc = k - (k / SW) * SW;
      const int gi =
          min(max(reflect(r0 - 1 - R + sr, N) - base, 0), held - 1);
      const int gj = reflect(c0 - 1 - R + sc, N);
      v[e] = k < SR * SW ? __ldg(blk + (size_t)gi * N + gj) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e)
      if (k0 + e * THREADS < SR * SW) s_slab[k0 + e * THREADS] = v[e];
  }
  if (tid < S) s_radii[tid] = rk;
  if (STREAM && tid == 0) {
    for (int q = 0; q < SLOTS; ++q) mbar_init(s_bar + q, 1 + THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage_taps(s_taps, taps, s_radii, 0, STREAM ? 1 : ST, TW, T, R);
  // streamed: this rank, the cluster's tiles with cells (a prefix of its
  // ranks, m of them) and the dense column of its first tile; sigma 0's
  // first chunks
  const int rank =
      STREAM ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const int kc = kt - rank;   // the cluster's first column tile
  const int m = max(0, min(C, min(tiles_per_row - kc,
                                  (N - r0 - TC * kc + TC - 1) / TC)));
  const int cu0 = r0 + TC * kc;
  int fetched = 0;                           // ring items of this sigma
  int gi0 = 0;                               // the CTA's items before it
  if constexpr (STREAM) {
    const Share sh = share_of(s_radii[0], C, rank, m, cu0);
    for (; fetched < min(SLOTS, sh.n); ++fetched)
      fetch_item(s_slab, s_bar, sh, fetched, fetched, &tm_chunk, &tm_mirror,
                 blk, b, r0, N, base, held, vec);
  }

  // per cell: best response and plane; the current plane Lc and its 3x3
  // max mC; as bits, whether the previous plane was its own max
  // (Lp == mP) and whether Lc > mP (the only uses of the previous plane)
  float bv[CELLS], Lc[CELLS], mC[CELLS];
  int bs[CELLS];
  unsigned pmax = 0, pgt = 0;
  float gprev[HW];                           // previous blur of this row
#pragma unroll
  for (int o = 0; o < CELLS; ++o) {
    bv[o] = 0.f;
    bs[o] = -1;
    Lc[o] = mC[o] = 0.f;
  }
  const bool row_in = i >= 0 && i < N;
  __syncthreads();

  for (int o = 0; o < n_octaves; ++o) {
    for (int k = 0; k < BLURS; ++k) {
      const int sig = o * BLURS + k;
      const int r = s_radii[sig];
      const int lo = R - r;
      const int nt = 2 * r + 1;
      const float* w = s_taps + (STREAM ? (sig & 1) : sig) * TW;
      float* tmp = s_tmp + (STREAM ? 0 : (sig & 1) * GR * TP);
      // tmp column c holds slab column lo + c, c < GC + 2r
      if constexpr (!STREAM) {
        for (int t0 = 0; t0 < nt; t0 += SEG)
          vpass_n(min(SEG, nt - t0), w + t0, s_slab, tmp, SW, TP, lo, t0,
                  GC + 2 * r, t0 == 0);
        __syncthreads();
      } else {
        // this rank's share: piece p, segment j = t0 / SEG reads ring
        // items it and it + 1 (chunks j and j + 1, contiguous through the
        // mirror); the item after them is in flight while it runs. A
        // thread keeps one unit (V rows of a column) of the piece, its
        // sums in registers across the segments
        const Share sh = share_of(r, C, rank, m, cu0);
        float* share = s_share + (sig & 1) * GR * WP;
        for (int p = 0; p < sh.np; ++p) {
          // this thread's unit of the piece: strip vs, column vc
          const int pw = piece_width(sh, p);
          const int vs = tid / pw, vc = tid - vs * pw;
          const float* piece =
              s_slab + ((sh.uc0 + piece_col(sh, p)) & 3) + vs * V * RP + vc;
          float acc[V];
#pragma unroll
          for (int o = 0; o < V; ++o) acc[o] = 0.f;
          for (int t0 = 0; t0 < nt; t0 += SEG) {
            const int it = p * sh.nch + t0 / SEG;
            const int need = min(it + 1, (p + 1) * sh.nch - 1);
            if (need >= fetched) {           // a piece's second chunk
              __syncthreads();               // its slot is read
              for (; fetched <= need; ++fetched)
                fetch_item(s_slab, s_bar, sh, fetched, gi0 + fetched,
                           &tm_chunk, &tm_mirror, blk, b, r0, N, base, held,
                           vec);
            }
            for (int q = gi0 + it; q <= gi0 + need; ++q)
              mbar_wait(s_bar + q % SLOTS, (q / SLOTS) & 1);
            __syncthreads();                 // the next slot is read
            for (; fetched < min(it + SLOTS, sh.n); ++fetched)
              fetch_item(s_slab, s_bar, sh, fetched, gi0 + fetched,
                         &tm_chunk, &tm_mirror, blk, b, r0, N, base, held,
                         vec);
            if (vs < GR / V)
              vpass_wn(min(SEG, nt - t0), acc, w + t0,
                       piece + ((gi0 + it) % SLOTS) * CH * RP, RP);
          }
          if (vs < GR / V) {
#pragma unroll
            for (int o = 0; o < V; ++o)
              share[(vs * V + o) * WP + PW * p + vc] = acc[o];
          }
        }
        cooperative_groups::cluster_group cluster =
            cooperative_groups::this_cluster();
        cluster.sync();                      // every share of sig is whole
        if (sig + 1 < S) {                   // the next sigma's taps and
          stage_taps(s_taps + ((sig + 1) & 1) * TW, taps, s_radii, sig + 1,
                     1, TW, T, R);           // first chunks
          const Share nx = share_of(s_radii[sig + 1], C, rank, m, cu0);
          gi0 += sh.n;
          for (fetched = 0; fetched < min(SLOTS, nx.n); ++fetched)
            fetch_item(s_slab, s_bar, nx, fetched, gi0 + fetched, &tm_chunk,
                       &tm_mirror, blk, b, r0, N, base, held, vec);
        }
        if (!active) continue;
        // this tile's tmp columns: union columns [64 rank, 64 rank + 66 +
        // 2r), four at a time from the rank that holds them (union piece
        // P is rank P % C's piece P / C; a group never straddles two)
        const int nq = (GC + 2 * r + 3) / 4;
        for (int e = tid; e < GR * nq; e += THREADS) {
          const int gg = e / nq, u = TC * rank + 4 * (e - gg * nq);
          const int P = u / PW;
          *reinterpret_cast<float4*>(s_tmp + gg * TP + u - TC * rank) =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(
                  share + gg * WP + PW * (P / C) + u % PW, P % C));
        }
        __syncthreads();
      }

      // blur at row g, blur columns CELLS * warp + o, o < HW (dense
      // column c0 - 1 + CELLS * warp + o); zero outside the matrix
      float G[HW];
#pragma unroll
      for (int e = 0; e < HW; ++e) G[e] = 0.f;
      const float* x = tmp + g * TP + CELLS * warp;
      for (int t0 = 0; t0 < nt; t0 += SEG) {
        if constexpr (STREAM)
          hpass_wn(min(SEG, nt - t0), G, w + t0, x + t0);
        else
          hpass_n(min(SEG, nt - t0), G, w + t0, x + t0);
      }
#pragma unroll
      for (int e = 0; e < HW; ++e) {
        const int gj = j0 - 1 + e;
        if (!(row_in && gj >= 0 && gj < N)) G[e] = 0.f;
      }
      if (k == 0) {
#pragma unroll
        for (int e = 0; e < HW; ++e) gprev[e] = G[e];
        continue;
      }

      // DoG L_{k-1} = G_{k-1} - G_k on the row; its 3x3 max at each cell:
      // across the row here, down the column from lanes g - 1 and g + 1
      float Lv[HW], mv[CELLS];
#pragma unroll
      for (int e = 0; e < HW; ++e) {
        Lv[e] = gprev[e] - G[e];
        gprev[e] = G[e];
      }
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        const float h = fmaxf(fmaxf(Lv[c], Lv[c + 1]), Lv[c + 2]);
        const float up = __shfl_up_sync(0xffffffffu, h, 1);
        const float dn = __shfl_down_sync(0xffffffffu, h, 1);
        mv[c] = fmaxf(fmaxf(up, h), dn);
      }
      if (k == 1) {                          // L_0: mC holds its max
        pmax = 0;
#pragma unroll
        for (int c = 0; c < CELLS; ++c) {
          if (Lv[c + 1] == mv[c]) pmax |= 1u << c;
          mC[c] = mv[c];
        }
        continue;
      }
      if (k == 2) {                          // L_1
        pgt = 0;
#pragma unroll
        for (int c = 0; c < CELLS; ++c) {
          if (Lv[c + 1] > mC[c]) pgt |= 1u << c;
          Lc[c] = Lv[c + 1];
          mC[c] = mv[c];
        }
        continue;
      }

      // plane k - 3 of this octave: Lc = L_{k-2}, Ln = L_{k-1}
      const int plane = o * PLANES + k - 3;
      float mn = INFINITY, sm = 0.f;
      unsigned cmax = 0, cgt = 0;
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        const float Ln = Lv[c + 1];
        const bool z = (nz >> c) & 1u;
        const float al = fabsf(Lc[c]);
        if (z) {
          mn = fminf(mn, al);
          sm += al;
        }
        const bool at_max = Lc[c] == mC[c];
        const bool will = z && Lc[c] > bv[c] && at_max &&
                          (((pmax >> c) & 1u) || Ln == mv[c]) &&
                          ((pgt >> c) & 1u) && Lc[c] > mv[c];
        if (will) {
          bv[c] = Lc[c];
          bs[c] = plane;
        }
        if (at_max) cmax |= 1u << c;
        if (Ln > mC[c]) cgt |= 1u << c;
        Lc[c] = Ln;
        mC[c] = mv[c];
      }
      pmax = cmax;
      pgt = cgt;
      // |L| >= 0: its bits order as the values do, so the min is exact
      mn = __uint_as_float(
          __reduce_min_sync(0xffffffffu, __float_as_uint(mn)));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sm += __shfl_xor_sync(0xffffffffu, sm, off);
      if (g == 0) {
        s_part[plane * NWARP + warp] = mn;
        s_part[(P + plane) * NWARP + warp] = sm;
      }
    }
  }

  // the tile's partials, warps in order; the band cells staged in the
  // (now free) vertical-pass buffer (streamed: the horizontal pass's
  // input and the ring, never a share a sibling may still read) and
  // written row by row. Cells that are not this thread's (j >= N, off the
  // band) hold the empty state.
  __syncthreads();
  if constexpr (STREAM) {
    if (!active) {
      cooperative_groups::this_cluster().sync();   // my share is read
      return;
    }
  }
  float* s_bv = s_tmp;                       // [TR][TC + 1]
  int* s_bs = (int*)(s_tmp + TR * (TC + 1));
  if (g >= 1 && g <= TR) {
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      s_bv[(g - 1) * (TC + 1) + CELLS * warp + c] = bv[c];
      s_bs[(g - 1) * (TC + 1) + CELLS * warp + c] = bs[c];
    }
  }
  __syncthreads();
  for (int p = tid; p < P; p += THREADS) {
    float tmn = s_part[p * NWARP], tsm = s_part[(P + p) * NWARP];
    for (int q = 1; q < NWARP; ++q) {
      tmn = fminf(tmn, s_part[p * NWARP + q]);
      tsm += s_part[(P + p) * NWARP + q];
    }
    part[p] = tmn;
    part[P + p] = tsm;
  }
  store_band(band_v, band_sig, b, N, DB, row0, out_rows, r0, c0, s_bv,
             s_bs);
  if constexpr (STREAM) cooperative_groups::this_cluster().sync();
}

// Each mode's shared-memory attributes, set once per device and again
// only when a launch needs more than was set.
int set_smem(int streamed, size_t smem_bytes) {
  constexpr int MAX_DEVICES = 64;
  static size_t smem_set[2][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const void* fn =
      streamed ? (const void*)fused_ladder_nms_kernel<true>
               : (const void*)fused_ladder_nms_kernel<false>;
  if (smem_bytes > smem_set[streamed][dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    smem_set[streamed][dev] = smem_bytes;
  }
  return 0;
}

// The streamed mode's tensor maps of cs [B, held, N] (f32): boxes of
// RP columns and CH rows (a chunk) or CH - 1 rows (its mirror), one
// block. Needs cs 16-byte aligned and N % 4 == 0 (else the kernel copies
// with cp.async only and never reads the maps).
int tensor_maps(const float* cs, int B, int N, int held, CUtensorMap* tm) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr)
      return (int)cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)held,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 4,
                                 (cuuint64_t)held * N * 4};
  const cuuint32_t ones[3] = {1, 1, 1};
  for (int k = 0; k < 2; ++k) {
    const cuuint32_t box[3] = {RP, (cuuint32_t)(k == 0 ? CH : CH - 1), 1};
    const CUresult r = encode(
        &tm[k], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(cs),
        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The launch configuration of the streamed mode: clusters of CLUSTER CTAs
// along x.
struct StreamLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  StreamLaunch(dim3 grid, size_t smem_bytes, cudaStream_t stream)
      : cfg(), attr() {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CLUSTER;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace

extern "C" {


// Launch on `stream`: the row tiles [t_lo, t_hi) of each block, from its
// dense rows [base, base + held) (cs and nzf are [B, held, N]); band_v and
// band_sig are [B, min(TR t_hi, N) - TR t_lo, DB], parts [B, (t_hi - t_lo)
// tiles_per_row, 2P]; `streamed` 0 runs the slab mode, 1 the streamed
// mode in clusters of CLUSTER CTAs (a grid of (t_hi - t_lo) CLUSTER
// ceil(tiles_per_row / CLUSTER) CTAs along x). Geometry (tiles_per_row,
// the mode, smem_bytes, the window) and
// the per-sigma radii come from the Python wrapper
// (mustache_tpu_torch/kernels/fused_ladder.py), the single source of those
// formulas. Returns cudaGetLastError() after the launch (a refused
// cluster launch included).
int mtt_fused_ladder_nms(const float* cs, const float* nzf, const int* valid,
                         const float* taps, const int* radii, float* band_v,
                         int* band_sig, float* parts, int B, int N, int DB,
                         int R, int n_octaves, int tiles_per_row, int base,
                         int held, int t_lo, int t_hi, int streamed,
                         size_t smem_bytes, void* stream) {
  if (B <= 0 || N <= 0 || DB <= 0 || R < 0 || n_octaves <= 0 ||
      BLURS * n_octaves > THREADS || tiles_per_row <= 0 || base < 0 ||
      held <= 0 || base + held > N || t_lo < 0 || t_hi <= t_lo ||
      t_hi > (N + TR - 1) / TR || (streamed != 0 && streamed != 1))
    return (int)cudaErrorInvalidValue;
  int e = set_smem(streamed, smem_bytes);
  if (e != 0) return e;
  const int out_rows = min(t_hi * TR, N) - t_lo * TR;
  // streamed: 16-byte and tensor copies of the slab, when every row of
  // every block starts 16-byte aligned
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(cs) % 16 == 0;
  CUtensorMap tm[2] = {};
  if (!streamed) {
    const dim3 grid((t_hi - t_lo) * tiles_per_row, B);
    fused_ladder_nms_kernel<false>
        <<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
            cs, nzf, valid, taps, radii, band_v, band_sig, parts, N, DB, R,
            n_octaves, tiles_per_row, base, held, t_lo, out_rows, vec, tm[0],
            tm[1]);
    return (int)cudaGetLastError();
  }
  if (vec) {
    e = tensor_maps(cs, B, N, held, tm);
    if (e != 0) return e;
  }
  const int tpg = CLUSTER * ((tiles_per_row + CLUSTER - 1) / CLUSTER);
  StreamLaunch L(dim3((t_hi - t_lo) * tpg, B), smem_bytes,
                 (cudaStream_t)stream);
  cudaError_t le = cudaLaunchKernelEx(
      &L.cfg, fused_ladder_nms_kernel<true>, cs, nzf, valid, taps, radii,
      band_v, band_sig, parts, N, DB, R, n_octaves, tiles_per_row, base,
      held, t_lo, out_rows, vec, tm[0], tm[1]);
  cudaError_t last = cudaGetLastError();
  return (int)(le != cudaSuccess ? le : last);
}

// Occupancy of a mode at `smem_bytes` (the attributes set as a launch sets
// them): CTAs per SM, and for the streamed mode the clusters of CLUSTER
// CTAs that can be resident at once (cudaOccupancyMaxActiveClusters; 0 for
// the slab mode).
int mtt_fused_ladder_occupancy(int streamed, size_t smem_bytes,
                               int* ctas_per_sm, int* max_clusters) {
  if (streamed != 0 && streamed != 1) return (int)cudaErrorInvalidValue;
  int e = set_smem(streamed, smem_bytes);
  if (e != 0) return e;
  const void* fn =
      streamed ? (const void*)fused_ladder_nms_kernel<true>
               : (const void*)fused_ladder_nms_kernel<false>;
  cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fn, THREADS, smem_bytes);
  if (ce != cudaSuccess) return (int)ce;
  *max_clusters = 0;
  if (!streamed) return 0;
  StreamLaunch L(dim3(CLUSTER * 64), smem_bytes, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                             fused_ladder_nms_kernel<true>,
                                             &L.cfg);
}

const char* mtt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
