// Fused scale-space blur ladder + DoG + scale-space NMS for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mustache_tpu/kernels/fused_ladder.py
// ::_fused_kernel (pallas_call in fused_ladder_nms_batched). Semantics, per
// batch slot b of sentinel-filled dense blocks cs[b] (N x N):
//   * every Gaussian blur G_k of the ladder (12 per octave, taps zero-padded
//     to the common radius R), scipy 'reflect' boundary;
//   * blur values outside the matrix set to 0, so the DoG planes
//     L_k = G_k - G_{k+1} and their 3x3 maxima see the constant-0 pad of
//     scipy's maximum_filter;
//   * the NMS predicate of the JAX kernel (fused_ladder.py:250-255), with the
//     running best response (best_v, best_sig) carried across octaves;
//   * per plane, partials over the support: min |L| and sum |L|.
// Valid == 0 slots (batch padding) do no work and write zero partials.
//
// What bounds it on the H100: FP32 FMAs fed from shared memory. A 32x32
// output tile needs its blurs on a 34x34 tile (NMS halo) and the input on a
// (34+2R)^2 slab (conv halo), about 1.2 M FMAs per tile for the default
// two-octave ladder (R = 14) after skipping each sigma's zero taps, against
// ~15 KB of input read once from device memory. So the kernel is
// compute-bound and its inner loops are shared-memory load + FMA.
//
// Design (first, simple version; no tensor cores, no TF32: the reference
// runs its blurs at Precision.HIGHEST):
//   * one 256-thread block per (batch slot, 32x32 dense tile meeting the
//     band 0 <= j - i < DB); the TPU's staircase layout, Toeplitz matrices
//     and 128-lane partial packing are not carried over;
//   * the reflected input slab is loaded to shared memory once, then per
//     sigma a row pass (slab -> tmp) and a column pass (tmp -> 34x34 blur)
//     over only that sigma's nonzero taps (adding a zero tap is exact, so
//     skipping it changes no result);
//   * each thread owns 4 cells of the 32x32 tile and keeps their rolling
//     Lp/Lc and 3x3 maxima plus best_v/best_sig in registers; maxima are
//     taken from the same stored DoG values, so Lc == mC is exact;
//   * partials are reduced in the block in a fixed order (no float atomics)
//     and written per tile; the wrapper reduces over tiles with amin / sum;
//   * band outputs are written directly as band[b, i, j - i]; the wrapper
//     pre-fills the cells no tile covers (j >= N) with 0 / -1.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TILE = 32;              // dense tile edge (rows and cols)
constexpr int G = TILE + 2;           // blur tile edge: tile + NMS halo
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int CELLS = TILE * TILE / THREADS;   // 4 tile cells per thread
constexpr int BLURS = 12;             // blurs per octave
constexpr int PLANES = BLURS - 3;     // detection planes per octave

// numpy 'symmetric' reflection of an index into [0, n); the clamp only
// affects slab cells that feed out-of-matrix blurs, which are zeroed
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -1 - i;
  if (i >= n) i = 2 * n - 1 - i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(THREADS)
fused_ladder_nms_kernel(const float* __restrict__ cs,
                        const float* __restrict__ nzf,
                        const int* __restrict__ valid,
                        const float* __restrict__ taps,
                        float* __restrict__ band_v,
                        int* __restrict__ band_sig,
                        float* __restrict__ parts,
                        int N, int DB, int R, int n_octaves,
                        int tiles_per_row) {
  extern __shared__ float smem[];
  const int T = 2 * R + 1;
  const int SW = G + 2 * R;                  // slab edge
  const int S = n_octaves * BLURS;
  const int P = n_octaves * PLANES;
  float* s_taps = smem;                      // [S][T]
  float* s_slab = s_taps + S * T;            // [SW][SW]
  float* s_tmp = s_slab + SW * SW;           // [G][SW] row-pass output
  float* s_gbuf = s_tmp + G * SW;            // [2][G][G] blur planes
  float* s_L = s_gbuf + 2 * G * G;           // [G][G] DoG plane
  float* s_red = s_L + G * G;                // [2][NWARP]

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int ti = tile / tiles_per_row;
  const int tj = ti + tile % tiles_per_row;
  const int n_col_tiles = (N + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* part = parts + ((size_t)b * gridDim.x + tile) * 2 * P;

  if (valid[b] == 0 || tj >= n_col_tiles) {
    // pad slot: zero partials (as the JAX kernel writes); a tile past the
    // last column: neutral partials. Band outputs keep the pre-fill.
    const float mn = valid[b] == 0 ? 0.f : INFINITY;
    for (int p = tid; p < P; p += THREADS) {
      part[p] = mn;
      part[P + p] = 0.f;
    }
    return;
  }

  const int r0 = ti * TILE;
  const int c0 = tj * TILE;
  const float* blk = cs + (size_t)b * N * N;

  for (int k = tid; k < S * T; k += THREADS) s_taps[k] = taps[k];
  // slab cell (sr, sc) holds dense (r0 - 1 - R + sr, c0 - 1 - R + sc)
  for (int k = tid; k < SW * SW; k += THREADS) {
    const int sr = k / SW, sc = k - (k / SW) * SW;
    const int gi = reflect(r0 - 1 - R + sr, N);
    const int gj = reflect(c0 - 1 - R + sc, N);
    s_slab[k] = blk[(size_t)gi * N + gj];
  }

  // this thread's tile cells: row ir = warp + 8m, col ic = lane
  bool nz[CELLS];
  float bv[CELLS], Lp[CELLS], mP[CELLS], Lc[CELLS], mC[CELLS];
  int bs[CELLS];
#pragma unroll
  for (int m = 0; m < CELLS; ++m) {
    const int i = r0 + warp + 8 * m, j = c0 + lane;
    const int d = j - i;
    nz[m] = i < N && j < N && d >= 0 && d < DB &&
            nzf[(size_t)b * N * N + (size_t)i * N + j] > 0.5f;
    bv[m] = 0.f;
    bs[m] = -1;
    Lp[m] = mP[m] = Lc[m] = mC[m] = 0.f;
  }
  __syncthreads();

  for (int o = 0; o < n_octaves; ++o) {
    for (int k = 0; k < BLURS; ++k) {
      const float* w = s_taps + (o * BLURS + k) * T;
      // the sigma's nonzero taps are [lo, T - 1 - lo] (symmetric, padded)
      int lo = 0;
      while (lo < R && w[lo] == 0.f) ++lo;
      const int hi = T - 1 - lo;

      // row pass: tmp[r][c] = sum_t w[t] slab[r + t][c], for the columns
      // [lo, G - 1 + hi] the column pass reads
      const int ncols = G + hi - lo;
      for (int e = tid; e < G * ncols; e += THREADS) {
        const int r = e / ncols;
        const int c = lo + (e - r * ncols);
        const float* src = s_slab + (size_t)r * SW + c;
        float acc = 0.f;
        for (int t = lo; t <= hi; ++t) acc = fmaf(w[t], src[t * SW], acc);
        s_tmp[r * SW + c] = acc;
      }
      __syncthreads();

      // column pass into the 34x34 blur tile; zero outside the matrix;
      // DoG L_{k-1} = G_{k-1} - G_k on the same cells
      float* gcur = s_gbuf + (k & 1) * G * G;
      const float* gprev = s_gbuf + ((k + 1) & 1) * G * G;
      for (int e = tid; e < G * G; e += THREADS) {
        const int r = e / G, c = e - (e / G) * G;
        const float* src = s_tmp + r * SW + c;
        float acc = 0.f;
        for (int t = lo; t <= hi; ++t) acc = fmaf(w[t], src[t], acc);
        const int gi = r0 - 1 + r, gj = c0 - 1 + c;
        if (gi < 0 || gi >= N || gj < 0 || gj >= N) acc = 0.f;
        gcur[e] = acc;
        if (k > 0) s_L[e] = gprev[e] - acc;
      }
      __syncthreads();
      if (k == 0) continue;

      // this plane's value and 3x3 max at each owned cell
      float Lv[CELLS], mv[CELLS];
#pragma unroll
      for (int m = 0; m < CELLS; ++m) {
        const int r = warp + 8 * m + 1, c = lane + 1;
        Lv[m] = s_L[r * G + c];
        float mx = s_L[(r - 1) * G + c - 1];
#pragma unroll
        for (int dr = -1; dr <= 1; ++dr)
#pragma unroll
          for (int dc = -1; dc <= 1; ++dc)
            mx = fmaxf(mx, s_L[(r + dr) * G + c + dc]);
        mv[m] = mx;
      }
      if (k == 1) {
#pragma unroll
        for (int m = 0; m < CELLS; ++m) { Lp[m] = Lv[m]; mP[m] = mv[m]; }
        continue;
      }
      if (k == 2) {
#pragma unroll
        for (int m = 0; m < CELLS; ++m) { Lc[m] = Lv[m]; mC[m] = mv[m]; }
        continue;
      }

      // plane k - 3 of this octave: Lc = L_{k-2}, Ln = L_{k-1}
      const int plane = o * PLANES + k - 3;
      float mn = INFINITY, sm = 0.f;
#pragma unroll
      for (int m = 0; m < CELLS; ++m) {
        const float al = fabsf(Lc[m]);
        if (nz[m]) {
          mn = fminf(mn, al);
          sm += al;
        }
        const bool will = nz[m] && Lc[m] > bv[m] && Lc[m] == mC[m] &&
                          (Lp[m] == mP[m] || Lv[m] == mv[m]) &&
                          Lc[m] > mP[m] && Lc[m] > mv[m];
        if (will) {
          bv[m] = Lc[m];
          bs[m] = plane;
        }
        Lp[m] = Lc[m];
        mP[m] = mC[m];
        Lc[m] = Lv[m];
        mC[m] = mv[m];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        sm += __shfl_xor_sync(0xffffffffu, sm, off);
      }
      if (lane == 0) {
        s_red[warp] = mn;
        s_red[NWARP + warp] = sm;
      }
      __syncthreads();
      if (tid == 0) {
        float tmn = s_red[0], tsm = s_red[NWARP];
        for (int q = 1; q < NWARP; ++q) {
          tmn = fminf(tmn, s_red[q]);
          tsm += s_red[NWARP + q];
        }
        part[plane] = tmn;
        part[P + plane] = tsm;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < CELLS; ++m) {
    const int i = r0 + warp + 8 * m, j = c0 + lane;
    const int d = j - i;
    if (i < N && j < N && d >= 0 && d < DB) {
      const size_t at = ((size_t)b * N + i) * DB + d;
      band_v[at] = bv[m];
      band_sig[at] = bs[m];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Geometry (tiles_per_row, smem_bytes) comes from the
// Python wrapper (mustache_tpu_torch/kernels/fused_ladder.py), the single
// source of those formulas. Returns cudaGetLastError() after the launch.
int mtt_fused_ladder_nms(const float* cs, const float* nzf, const int* valid,
                         const float* taps, float* band_v, int* band_sig,
                         float* parts, int B, int N, int DB, int R,
                         int n_octaves, int tiles_per_row, size_t smem_bytes,
                         void* stream) {
  if (B <= 0 || N <= 0 || DB <= 0 || R < 0 || n_octaves <= 0 ||
      tiles_per_row <= 0)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ladder_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_row_tiles = (N + TILE - 1) / TILE;
  const dim3 grid(n_row_tiles * tiles_per_row, B);
  fused_ladder_nms_kernel<<<grid, THREADS, smem_bytes,
                            (cudaStream_t)stream>>>(
      cs, nzf, valid, taps, band_v, band_sig, parts, N, DB, R, n_octaves,
      tiles_per_row);
  return (int)cudaGetLastError();
}

const char* mtt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
