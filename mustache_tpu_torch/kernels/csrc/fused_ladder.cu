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
//   * streamed slab (STREAM = true), for the larger ladders of the JAX
//     kernel's domain (R <= 127: the slab alone is 366 KB at R = 127).
//     Shared memory holds the current octave's 12 sigmas' taps and, per
//     sigma, one piece of the slab at a time: the rows that sigma reads
//     (32 + 2r), PW = 64 of its tmp columns. The vertical pass is per
//     column, so a piece's columns of tmp are finished from that piece
//     alone (no partial sums across pieces), in the same FMA order as the
//     slab mode: both modes give the same bits. A piece is fetched with
//     cp.async straight into shared memory (no registers, all of a
//     thread's copies in flight at once), and a sigma's first piece is
//     fetched while the previous sigma's horizontal pass and NMS run. The
//     slab is read once per sigma instead of once per tile (through L2:
//     the slabs of neighbouring tiles overlap). At R = 127 a block takes
//     172,192 B: one block per SM. What limits both modes at large radii
//     is the tile's halo: the vertical pass computes 66 + 2r columns for
//     64 tile columns (and the horizontal one 32 x 80 outputs for 30 x
//     64 cells), so a sigma of radius 110 costs a tile 3.0 times the FMAs
//     that its cells need (1.45 times at the default ladder's r = 14).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
static_assert(GR == 32, "one blur row per lane");
static_assert(GR / V == 4, "vertical pass: four strips of rows");
static_assert(SEG % 4 == 0, "segments start on 16-byte tap boundaries");
static_assert(THREADS % PW == 0, "a thread copies one column of a piece");
static_assert((GR / V) * PW == THREADS, "one vertical unit per thread");

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

// cp.async of one float from global to shared memory, and the wait for
// all of this thread's copies
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Streamed mode: start copying a slab piece, rows [0, rows) and columns
// [0, cols) (cols <= PW), pitch PW, holding dense (gr0 + pr, gc0 + pc) at
// the window row reflect(...) - base (clamped as the slab load is); a
// thread copies one column, so its column index is computed once
__device__ __forceinline__ void stage_piece(float* dst,
                                            const float* __restrict__ blk,
                                            int rows, int cols, int gr0,
                                            int gc0, int N, int base,
                                            int held) {
  const int pc = threadIdx.x % PW;
  if (pc >= cols) return;
  const float* src = blk + reflect(gc0 + pc, N);
  for (int pr = threadIdx.x / PW; pr < rows; pr += THREADS / PW) {
    const int gi = min(max(reflect(gr0 + pr, N) - base, 0), held - 1);
    cp_async4(dst + pr * PW + pc, src + (size_t)gi * N);
  }
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
                        int out_rows) {
  extern __shared__ float smem[];
  const int T = 2 * R + 1;
  const int S = n_octaves * BLURS;
  const int P = n_octaves * PLANES;
  const int SW = GC + 2 * R;                 // slab row length (and pitch)
  const int SR = GR + 2 * R;                 // slab rows
  // tmp rows: 16-byte aligned, >= 4 words past the widest pass, and
  // TP = 4 (mod 32) so that eight lanes' 16-byte loads hit distinct banks
  const int TP = 32 * ((SW + 31) / 32) + 4;
  const int TW = 4 * ((T + 3) / 4);          // taps per sigma, padded
  // slab mode: every sigma's taps and the whole slab; streamed: one
  // octave's taps and one piece of PW columns
  const int ST = STREAM ? BLURS : S;
  float* s_taps = smem;                      // [ST][TW] nonzero taps first
  float* s_tmp = s_taps + ST * TW;           // [2][GR][TP] vertical pass
  float* s_slab = s_tmp + 2 * GR * TP;       // [SR][SW] or [SR][PW]
  int* s_radii = (int*)(s_slab + SR * (STREAM ? PW : SW));   // [S]
  float* s_part = (float*)(s_radii + S);     // [2][P][NWARP]

  const int b = blockIdx.y;
  const int tile = blockIdx.x;               // the launch's tile
  const int ti = t_lo + tile / tiles_per_row;
  const int row0 = t_lo * TR;                // the launch's first band row
  const int r0 = ti * TR;
  const int c0 = r0 + (tile % tiles_per_row) * TC;
  const int tid = threadIdx.x;
  const int g = tid & 31;                    // blur row: dense r0 - 1 + g
  const int warp = tid >> 5;                 // tile columns CELLS * warp + o
  float* part = parts + ((size_t)b * gridDim.x + tile) * 2 * P;

  if (valid[b] == 0 || c0 >= N) {
    // pad slot: zero partials (as the JAX kernel writes); a tile past the
    // last column: neutral partials. Band cells: the empty state.
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
    if (g >= 1 && g <= TR && i < N && j0 + o < N && d >= 0 && d < DB &&
        __ldg(nzb + (size_t)(i - base) * N + j0 + o) > 0.5f)
      nz |= 1u << o;
  }
  if (!__syncthreads_or(nz != 0)) {
    // no support cell: no candidate, neutral partials
    for (int p = tid; p < P; p += THREADS) {
      part[p] = INFINITY;
      part[P + p] = 0.f;
    }
    store_band(band_v, band_sig, b, N, DB, row0, out_rows, r0, c0, nullptr,
               nullptr);
    return;
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
  __syncthreads();
  stage_taps(s_taps, taps, s_radii, 0, ST, TW, T, R);
  if (STREAM) {                              // sigma 0's first piece
    const int rn = s_radii[0];
    stage_piece(s_slab, blk, GR + 2 * rn, min(PW, GC + 2 * rn), r0 - 1 - rn,
                c0 - 1 - rn, N, base, held);
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
      const float* w = s_taps + (STREAM ? k : sig) * TW;
      float* tmp = s_tmp + (sig & 1) * GR * TP;
      // tmp column c holds slab column lo + c, c < GC + 2r
      if (!STREAM) {
        for (int t0 = 0; t0 < nt; t0 += SEG)
          vpass_n(min(SEG, nt - t0), w + t0, s_slab, tmp, SW, TP, lo, t0,
                  GC + 2 * r, t0 == 0);
      } else {
        if (k == 0 && o > 0) {               // this octave's taps, once
          __syncthreads();                   // the last octave's are read
          stage_taps(s_taps, taps, s_radii, sig, BLURS, TW, T, R);
        }
        // piece p0: tmp columns [p0, p0 + PW), from slab rows lo + [0,
        // GR + 2r) and columns lo + p0 + [0, PW); its first piece is in
        // flight since the previous sigma
        for (int p0 = 0; p0 < GC + 2 * r; p0 += PW) {
          const int pw = min(PW, GC + 2 * r - p0);
          if (p0 > 0) {
            __syncthreads();                 // the last piece is read
            stage_piece(s_slab, blk, GR + 2 * r, pw, r0 - 1 - r,
                        c0 - 1 - r + p0, N, base, held);
          }
          cp_async_wait_all();
          __syncthreads();
          for (int t0 = 0; t0 < nt; t0 += SEG)
            vpass_n(min(SEG, nt - t0), w + t0, s_slab, tmp + p0, PW, TP, 0,
                    t0, pw, t0 == 0);
        }
      }
      __syncthreads();
      if (STREAM && sig + 1 < S) {           // the next sigma's first piece
        const int rn = s_radii[sig + 1];
        stage_piece(s_slab, blk, GR + 2 * rn, min(PW, GC + 2 * rn),
                    r0 - 1 - rn, c0 - 1 - rn, N, base, held);
      }

      // blur at row g, blur columns CELLS * warp + o, o < HW (dense
      // column c0 - 1 + CELLS * warp + o); zero outside the matrix
      float G[HW];
#pragma unroll
      for (int e = 0; e < HW; ++e) G[e] = 0.f;
      const float* x = tmp + g * TP + CELLS * warp;
      for (int t0 = 0; t0 < nt; t0 += SEG)
        hpass_n(min(SEG, nt - t0), G, w + t0, x + t0);
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
  // (now free) vertical-pass buffer and written row by row. Cells that
  // are not this thread's (j >= N, off the band) hold the empty state.
  __syncthreads();
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
}

}  // namespace

extern "C" {

// Launch on `stream`: the row tiles [t_lo, t_hi) of each block, from its
// dense rows [base, base + held) (cs and nzf are [B, held, N]); band_v and
// band_sig are [B, min(TR t_hi, N) - TR t_lo, DB], parts [B, (t_hi - t_lo)
// tiles_per_row, 2P]; `streamed` 0 runs the slab mode, 1 the streamed
// slab. Geometry (tiles_per_row, the mode, smem_bytes, the window) and
// the per-sigma radii come from the Python wrapper
// (mustache_tpu_torch/kernels/fused_ladder.py), the single source of those
// formulas. Each mode's shared-memory attributes are set once per device,
// and again only when a launch needs more than was set. Returns
// cudaGetLastError() after the launch.
int mtt_fused_ladder_nms(const float* cs, const float* nzf, const int* valid,
                         const float* taps, const int* radii, float* band_v,
                         int* band_sig, float* parts, int B, int N, int DB,
                         int R, int n_octaves, int tiles_per_row, int base,
                         int held, int t_lo, int t_hi, int streamed,
                         size_t smem_bytes, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static size_t smem_set[2][MAX_DEVICES] = {};
  if (B <= 0 || N <= 0 || DB <= 0 || R < 0 || n_octaves <= 0 ||
      BLURS * n_octaves > THREADS || tiles_per_row <= 0 || base < 0 ||
      held <= 0 || base + held > N || t_lo < 0 || t_hi <= t_lo ||
      t_hi > (N + TR - 1) / TR || (streamed != 0 && streamed != 1))
    return (int)cudaErrorInvalidValue;
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
  const int out_rows = min(t_hi * TR, N) - t_lo * TR;
  const dim3 grid((t_hi - t_lo) * tiles_per_row, B);
  auto launch = streamed ? fused_ladder_nms_kernel<true>
                         : fused_ladder_nms_kernel<false>;
  launch<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      cs, nzf, valid, taps, radii, band_v, band_sig, parts, N, DB, R,
      n_octaves, tiles_per_row, base, held, t_lo, out_rows);
  return (int)cudaGetLastError();
}

const char* mtt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
