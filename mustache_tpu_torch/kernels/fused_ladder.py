"""Fused scale-space blur + DoG + NMS: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``mustache_tpu/kernels/fused_ladder.py::
_fused_kernel`` (launched by ``fused_ladder_nms_batched`` there). Given
the sentinel-filled dense blocks ``cs [B, N, N]`` and their support mask,
it computes every Gaussian blur of the ladder (scipy 'reflect' boundary),
the DoG planes and their 3x3 maxima, the scale-space NMS predicate, the
running best response across octaves, and the per-plane support partials
(min |L|, sum |L|) of the exponential fit, without ever holding the
``[S, N, N]`` blur stack in device memory.

Contract (same as the JAX function, but the ladder comes as its taps
``kernels [S, 2R+1]`` f32 instead of the TPU's Toeplitz matrices):
returns ``(band_v [B, N, DB] f32, band_sig [B, N, DB] i32, locs [B, P],
sums [B, P])`` in the exact band layout ``band[b, i, d] = dense[b, i,
i+d]``. Pad slots (``valid[b] == 0``) return the empty state (0, -1) and
zero partials. The support is taken to lie inside the band (0 <= d < DB),
which holds for every block the pipeline builds (data only on
d <= d_px + 1 < DB).

On a CUDA tensor :func:`fused_ladder_nms_batched` launches the kernel
(``csrc/fused_ladder.cu``) or raises; on a CPU tensor it runs
:func:`fused_ladder_nms_reference`. There is no fallback between the two.
``LAUNCHES`` counts kernel launches. The kernel takes every ladder the
JAX package fuses (:func:`kernel_fits`), in one of two modes that
:func:`ladder_mode` picks from the ladder alone: the whole input slab in
shared memory, or, for the large ladders, clusters of ``CLUSTER`` CTAs
that share one vertical pass over their tiles' columns and stream the
slab through shared memory in chunks.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# kernel geometry, mirrored in csrc/fused_ladder.cu: one 256-thread block
# per (batch slot, 30 x 64 dense tile that meets the band); tile k of row
# tile ti covers rows [30 ti, 30 ti + 30) and columns [30 ti + 64 k, ... + 64)
TILE_ROWS = 30
TILE_COLS = 64
THREADS = 256
BLURS_PER_OCTAVE = 12
SMEM_LIMIT = 232_448     # H100 dynamic shared memory per block, bytes
MAX_RADIUS = 127         # the JAX kernel's column pad less one (CPAD - 1)
STREAM_COLS = 64         # streamed mode: tmp columns a piece computes
CHUNK_ROWS = 32          # streamed mode: slab rows a ring item holds
RING_SLOTS = 3           # streamed mode: ring items resident at once
RING_PITCH = STREAM_COLS + 4   # a piece from the aligned column below it
# streamed mode: CTAs a thread-block cluster (the kernel's CLUSTER). At
# every ladder of that mode (R <= 127, at most 6 octaves: at most 114,612
# B a CTA) two CTAs of a 4-cluster fit an SM, and on an H100 4 ran faster
# than 2, 3, 5, 6 and 8 on every streamed shape (PERF.md, measured with
# tools/stream_variants.py). A grid whose tiles_per_row 4 does not divide
# (always: it is odd) is padded to whole clusters: the padding ranks
# compute their part of the vertical pass and write nothing.
CLUSTER = 4
MODES = ("slab", "stream")

LAUNCHES = 0


def tiles_per_row(DB: int) -> int:
    """Column tiles a row tile needs: tile k holds band offsets d = j - i
    from 64 k - 29 to 64 k + 63, so it meets 0 <= d < DB iff
    64 k < DB + 29."""
    return -(-(DB + TILE_ROWS - 1) // TILE_COLS)


def n_tiles(N: int, DB: int) -> int:
    return -(-N // TILE_ROWS) * tiles_per_row(DB)


def _ceil4(x: int) -> int:
    return 4 * -(-x // 4)


def share_pitch(R: int) -> int:
    """Streamed mode: the columns of one rank's share buffer: room for the
    most pieces a rank takes of any sigma (radius <= R)
    (:func:`share_columns` at r = R, m = CLUSTER)."""
    pieces = -(-(TILE_COLS * CLUSTER + 2 + 2 * R) // STREAM_COLS)
    return STREAM_COLS * -(-pieces // CLUSTER)


def share_columns(r: int, m: int = CLUSTER):
    """Streamed mode: how a cluster splits one sigma's vertical pass. Its
    ``m`` tiles with cells (a prefix of its CLUSTER ranks) read the union
    of tmp columns ``[0, U)``, U = 64 m + 2 + 2r (tile q reads ``[64 q, 64
    q + 66 + 2r)``). The union is cut into pieces of 64 columns (the last
    narrower), dealt to the ranks in turn: union piece P is rank ``P %
    CLUSTER``'s piece ``P // CLUSTER``, at columns ``[64 (P // CLUSTER),
    ...)`` of its share buffer. Returns ``(U, [[(first union column,
    width) of each piece] per rank])``; the kernel's ``share_of``
    (csrc/fused_ladder.cu) computes the same."""
    U = TILE_COLS * m + 2 + 2 * r
    ranks = [[] for _ in range(CLUSTER)]
    for P in range(-(-U // STREAM_COLS)):
        ranks[P % CLUSTER].append(
            (STREAM_COLS * P, min(STREAM_COLS, U - STREAM_COLS * P)))
    return U, ranks


def smem_bytes(R: int, n_octaves: int, mode: str | None = None) -> int:
    """Dynamic shared memory of one CTA (4-byte words) in ``mode``
    (default: the mode the ladder takes, :func:`ladder_mode`).

    "slab": the taps (2R + 1 per sigma, padded to a multiple of 4) of
    every sigma, two buffers of the vertical pass's output (32 rows,
    pitch TP = 32 ceil((66 + 2R) / 32) + 4), the reflected input slab
    (32 + 2R) x (66 + 2R), the radii and the per-warp partials of every
    plane. "stream" (clusters of ``CLUSTER`` CTAs): the taps of two
    sigmas (padded to 32 words: the ring after them is 128-byte aligned),
    the horizontal pass's input (32 x TP), the ring (three chunks of 32
    rows and 31 mirror rows, pitch 68), two buffers of the rank's share
    (32 x :func:`share_pitch`), the ring's mbarriers (8 words), the radii,
    the cluster's support flag and the partials."""
    mode = ladder_mode(R, n_octaves) if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    S = BLURS_PER_OCTAVE * n_octaves
    gr, gc = TILE_ROWS + 2, TILE_COLS + 2       # blurs: tile + NMS halo
    sw = gc + 2 * R                             # slab row: + conv radius
    tp = 32 * -(-sw // 32) + 4
    tw = _ceil4(2 * R + 1)
    planes = (BLURS_PER_OCTAVE - 3) * n_octaves
    parts = 2 * planes * (THREADS // 32)
    if mode == "slab":
        words = S * tw + 2 * gr * tp + (gr + 2 * R) * sw + S + parts
    else:
        ring = (RING_SLOTS * CHUNK_ROWS + CHUNK_ROWS - 1) * RING_PITCH
        words = (32 * -(-2 * tw // 32) + gr * tp + ring
                 + 2 * gr * share_pitch(R) + 8 + S + 1 + parts)
    return 4 * words


def grid_tiles_per_row(DB: int) -> int:
    """CTAs a row tile takes in the streamed mode's grid:
    ``tiles_per_row`` padded to whole clusters (the slab mode's grid takes
    ``tiles_per_row``)."""
    return CLUSTER * -(-tiles_per_row(DB) // CLUSTER)


def ladder_mode(R: int, n_octaves: int) -> str:
    """The kernel's mode for a ladder, from its radius and octaves alone:
    ``"slab"`` (the whole slab in shared memory, loaded once per tile)
    when it fits one block, else ``"stream"`` (clusters that share the
    vertical pass and stream the slab through shared memory in chunks;
    csrc/fused_ladder.cu)."""
    return ("slab" if smem_bytes(R, n_octaves, "slab") <= SMEM_LIMIT
            else "stream")


def kernel_fits(R: int, n_octaves: int) -> bool:
    """The gate, the JAX package's (``_resolve_pallas``): the per-plane
    partials of at most 6 octaves (2 x 10 lanes an octave in 128), a
    ladder radius inside the JAX kernel's column pad (R <= 127), and the
    ladder's blurs within one block's threads (one radius each). Every
    such ladder fits one block's shared memory in the mode it takes."""
    return (2 * 10 * n_octaves <= 128 and R <= MAX_RADIUS
            and BLURS_PER_OCTAVE * n_octaves <= THREADS)


def ladder_radii(kernels: torch.Tensor, R: int) -> torch.Tensor:
    """Each sigma's own radius r (its nonzero taps are [R - r, R + r] of
    the zero-padded [S, 2R+1] ladder), as an int32 tensor on the taps'
    device; computed there, so no host sync. For a caller that does not
    pass ``radii`` (the detector builds them once,
    ``scalespace.radii_tensor``)."""
    first = (kernels != 0).to(torch.int32).argmax(dim=1)
    return (R - first).to(torch.int32)


def row_tiles(N: int) -> int:
    """Row tiles of an ``N``-row block."""
    return -(-N // TILE_ROWS)


def row_cuts(N: int, n_parts: int) -> list[int]:
    """Balanced cuts of the block's row tiles into ``n_parts`` contiguous
    ranges: part p computes the tiles ``[cuts[p], cuts[p + 1])`` (an empty
    range when there are fewer tiles than parts). The cuts sit on
    multiples of ``TILE_ROWS``, so a part's tiles are exactly the tiles of
    the whole-block launch."""
    nt = row_tiles(N)
    return [p * nt // n_parts for p in range(n_parts + 1)]


def halo(R: int) -> int:
    """Rows a window holds beyond its tiles on each side: the ladder
    radius plus the NMS ring (the rows a tile's slab reads beyond it)."""
    return R + 1


def window_rows(N: int, t_lo: int, t_hi: int, R: int) -> tuple[int, int]:
    """The dense rows ``[w0, w1)`` that the tiles ``[t_lo, t_hi)`` read:
    their rows plus :func:`halo` on each side, clamped to the block."""
    return (max(0, t_lo * TILE_ROWS - halo(R)),
            min(N, t_hi * TILE_ROWS + halo(R)))


def _check(cs, nzf, kernels, valid, R, n_octaves, planes_per_octave, DB,
           N, base, t_lo, t_hi):
    B, held, N2 = cs.shape
    if N2 != N or nzf.shape != cs.shape:
        raise ValueError(f"cs {tuple(cs.shape)} / nzf {tuple(nzf.shape)} "
                         f"must both be [B, rows, N={N}]")
    if not (0 <= t_lo < t_hi <= row_tiles(N)):
        raise ValueError(f"row tiles [{t_lo}, {t_hi}) outside the block's "
                         f"{row_tiles(N)}")
    w0, w1 = window_rows(N, t_lo, t_hi, R)
    if base > w0 or base + held < w1:
        raise ValueError(f"rows [{base}, {base + held}) do not hold the "
                         f"window [{w0}, {w1}) of tiles [{t_lo}, {t_hi})")
    if planes_per_octave + 3 != BLURS_PER_OCTAVE:
        raise ValueError("the ladder has 12 blurs per octave (9 planes)")
    if kernels.shape != (BLURS_PER_OCTAVE * n_octaves, 2 * R + 1):
        raise ValueError(f"kernels {tuple(kernels.shape)} do not match "
                         f"{n_octaves} octaves of radius {R}")
    if not 0 < DB <= N or R >= N:
        raise ValueError(f"need 0 < DB <= N and R < N (N={N}, DB={DB}, "
                         f"R={R})")
    for name, t in (("cs", cs), ("nzf", nzf), ("kernels", kernels)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != cs.device:
            raise ValueError(f"{name} is on {t.device}, cs on {cs.device}")
    if valid is not None and (tuple(valid.shape) != (B,)
                              or valid.device != cs.device):
        raise ValueError(f"valid must be [B]={B} on {cs.device}")


def reduce_parts(parts: torch.Tensor, P: int):
    """``(locs, sums)`` ``[B, P]`` from the per-tile partials ``[B, T,
    2P]``: min over tiles (tiles without support carry +inf, pad slots 0)
    and sum over tiles. The sums go slot by slot: a reduction over the
    whole batch may split its work by the batch size, and a block's sums
    must not depend on the batch it rode in (a sharded run batches the
    same blocks differently)."""
    locs = parts[:, :, :P].amin(dim=1)
    sums = torch.stack([parts[b, :, P:].sum(dim=0)
                        for b in range(parts.shape[0])])
    return locs, sums


def fused_ladder_window(cs, nzf, kernels, *, R: int, n_octaves: int,
                        planes_per_octave: int, DB: int, N: int | None = None,
                        base: int = 0, t_lo: int = 0, t_hi: int | None = None,
                        valid=None, radii=None):
    """The row-window launch: the band state of the row tiles ``[t_lo,
    t_hi)`` of ``N``-row blocks from a window of their rows.

    ``cs``/``nzf``: ``[B, rows, N]`` f32, the dense rows ``[base, base +
    rows)`` of each sentinel-filled block and its support (they must hold
    :func:`window_rows`; the whole block by default). The reflect
    boundary stays the block's: only the read index shifts by ``base``.
    Returns ``(band_v [B, n, DB], band_sig [B, n, DB], parts [B, T,
    2P])``: the band rows ``[30 t_lo, min(30 t_hi, N))`` (n of them) and
    the per-tile partials of the window's T tiles, in tile order (min |L|
    then sum |L| per plane; :func:`reduce_parts` reduces them). Launches
    of the parts of a block, concatenated in order, equal the whole-block
    launch bit for bit. CPU tensors run the plain version, whose tiles
    are whole row tiles; CUDA tensors launch the kernel in the ladder's
    mode (:func:`ladder_mode`; the two modes give the same bits, so the
    plain version has none)."""
    global LAUNCHES
    B, held, Nc = cs.shape
    N = Nc if N is None else N
    t_hi = row_tiles(N) if t_hi is None else t_hi
    _check(cs, nzf, kernels, valid, R, n_octaves, planes_per_octave, DB,
           N, base, t_lo, t_hi)
    kw = dict(R=R, n_octaves=n_octaves, planes_per_octave=planes_per_octave,
              DB=DB, N=N, base=base, t_lo=t_lo, t_hi=t_hi, valid=valid)
    if cs.device.type == "cpu":
        return _plain_parts(cs, nzf, kernels, **kw)
    if cs.device.type != "cuda":
        raise ValueError(f"unsupported device {cs.device}")
    if not kernel_fits(R, n_octaves):
        raise ValueError(f"a ladder of radius {R} and {n_octaves} octaves is "
                         f"beyond the kernel's gate (R <= {MAX_RADIUS}, at "
                         f"most 6 octaves)")
    mode = ladder_mode(R, n_octaves)
    from mustache_tpu_torch.kernels.build import load

    lib = load("fused_ladder", bind)
    dev = cs.device
    P = n_octaves * planes_per_octave
    cs, nzf, kernels = cs.contiguous(), nzf.contiguous(), kernels.contiguous()
    if radii is None:
        radii = ladder_radii(kernels, R)
    elif (tuple(radii.shape) != (kernels.shape[0],)
          or radii.dtype != torch.int32 or radii.device != dev):
        raise ValueError(f"radii must be [S]={kernels.shape[0]} int32 on "
                         f"{dev}")
    radii = radii.contiguous()
    valid = (torch.ones(B, dtype=torch.int32, device=dev) if valid is None
             else valid.to(torch.int32).contiguous())
    rows = min(t_hi * TILE_ROWS, N) - t_lo * TILE_ROWS
    # the kernel writes every band cell of its rows (tiles cover the band
    # exactly)
    band_v = torch.empty((B, rows, DB), dtype=torch.float32, device=dev)
    band_sig = torch.empty((B, rows, DB), dtype=torch.int32, device=dev)
    parts = torch.empty((B, (t_hi - t_lo) * tiles_per_row(DB), 2 * P),
                        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mtt_fused_ladder_nms(
            cs.data_ptr(), nzf.data_ptr(), valid.data_ptr(),
            kernels.data_ptr(), radii.data_ptr(), band_v.data_ptr(),
            band_sig.data_ptr(), parts.data_ptr(), B, N, DB, R, n_octaves,
            tiles_per_row(DB), base, held, t_lo, t_hi, int(mode == "stream"),
            smem_bytes(R, n_octaves, mode), stream)
    if rc != 0:
        raise RuntimeError("fused_ladder_nms launch failed: "
                           + lib.mtt_error_string(rc).decode())
    LAUNCHES += 1
    return band_v, band_sig, parts


def occupancy(R: int, n_octaves: int, device=None) -> tuple[int, int]:
    """On the card: the CTAs per SM and the clusters resident at once
    (``cudaOccupancyMaxActiveClusters``; 0 in the slab mode) of the launch
    the ladder takes, with the attributes a launch sets."""
    from mustache_tpu_torch.kernels.build import load

    mode = ladder_mode(R, n_octaves)
    lib = load("fused_ladder", bind)
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.mtt_fused_ladder_occupancy(
            int(mode == "stream"), smem_bytes(R, n_octaves, mode),
            ctypes.byref(ctas), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError("fused_ladder_nms occupancy query failed: "
                           + lib.mtt_error_string(rc).decode())
    return ctas.value, clusters.value


def fused_ladder_nms_batched(cs, nzf, kernels, *, R: int, n_octaves: int,
                             planes_per_octave: int, DB: int, valid=None,
                             radii=None):
    """Band best-state from the sentinel-filled blocks (see module doc).

    ``cs``/``nzf``: [B, N, N] f32; ``kernels``: [S, 2R+1] f32 ladder taps
    (``scalespace.ladder_tensor``); ``valid``: optional [B] int tensor,
    0 marks a pad slot; ``radii``: optional [S] int32 tensor of each
    sigma's radius (``scalespace.radii_tensor``), derived from the taps
    when omitted. CPU tensors run the plain version; CUDA tensors launch
    the kernel (the whole-block case of :func:`fused_ladder_window`)."""
    band_v, band_sig, parts = fused_ladder_window(
        cs, nzf, kernels, R=R, n_octaves=n_octaves,
        planes_per_octave=planes_per_octave, DB=DB, valid=valid, radii=radii)
    return (band_v, band_sig) + reduce_parts(
        parts, n_octaves * planes_per_octave)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """ctypes signatures of csrc/fused_ladder.cu's C entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mtt_fused_ladder_nms.argtypes = [vp] * 8 + [ci] * 11 + [
        ctypes.c_size_t, vp]
    lib.mtt_fused_ladder_nms.restype = ci
    lib.mtt_fused_ladder_occupancy.argtypes = [ci, ctypes.c_size_t, vp,
                                               vp]
    lib.mtt_fused_ladder_occupancy.restype = ci
    lib.mtt_error_string.argtypes = [ci]
    lib.mtt_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _symmetric_pad(c: torch.Tensor, R: int) -> torch.Tensor:
    """numpy 'symmetric' (= scipy 'reflect': the edge sample repeats) pad
    of the last two dims by R (square or rectangular). torch's F.pad
    'reflect' omits the edge sample, so this indexes instead."""
    def index(N):
        idx = torch.arange(-R, N + R, device=c.device)
        idx = torch.where(idx < 0, -1 - idx, idx)
        return torch.where(idx >= N, 2 * N - 1 - idx, idx)
    return c[..., index(c.shape[-2]), :][..., index(c.shape[-1])]


def _max3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 window max with constant-0 padding over the last two dims
    (scipy ``maximum_filter(mode='constant')``)."""
    xp = F.pad(x, (0, 0, 1, 1))
    r = torch.maximum(torch.maximum(xp[..., :-2, :], xp[..., 1:-1, :]),
                      xp[..., 2:, :])
    rp = F.pad(r, (1, 1))
    return torch.maximum(torch.maximum(rp[..., :-2], rp[..., 1:-1]),
                         rp[..., 2:])


def _blur_octave(cpad: torch.Tensor, taps: torch.Tensor, N: int):
    """The octave's blurs [12, N, N] of one symmetric-padded block
    [N+2R, N+2R]: a row pass then a depthwise column pass, in full f32
    (TF32 off for cuDNN)."""
    S, T = taps.shape
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        g = F.conv2d(cpad[None, None], taps[:, None, :, None])  # [1,S,N,N+2R]
        g = F.conv2d(g, taps[:, None, None, :], groups=S)        # [1,S,N,N]
    return g[0]


def _reflect(idx: torch.Tensor, N: int) -> torch.Tensor:
    """numpy 'symmetric' reflection of indices in [-N, 2N) into [0, N)."""
    idx = torch.where(idx < 0, -1 - idx, idx)
    return torch.where(idx >= N, 2 * N - 1 - idx, idx)


def padded_window(win: torch.Tensor, N: int, R: int, base: int, g0: int,
                  rows: int) -> torch.Tensor:
    """The symmetric-padded ``N``-row block from padded row and column
    ``g0`` (``out[..., r, c] = padded[g0 + r, g0 + c]``), for the band
    rows ``[g0, g0 + rows)``, read from the dense rows ``[base, base +
    held)`` that ``win`` ``[..., held, N]`` holds: ``rows + 2R`` rows
    (fewer at the block's end) and every padded column from ``g0``. Rows
    outside ``win`` read its nearest row: they feed only band rows
    outside ``[g0, g0 + rows)`` that are within one slab of them, never
    those rows themselves. The whole block is ``base = g0 = 0``,
    ``rows = N`` (:func:`_symmetric_pad`)."""
    dev = win.device
    ri = torch.arange(g0 - R, min(g0 + rows + R, N + R), device=dev)
    ri = (_reflect(ri, N) - base).clamp(0, win.shape[-2] - 1)
    ci = _reflect(torch.arange(g0 - R, N + R, device=dev), N)
    return win[..., ri, :][..., ci]


def _plain_parts(cs, nzf, kernels, *, R: int, n_octaves: int,
                 planes_per_octave: int, DB: int, N: int, base: int,
                 t_lo: int, t_hi: int, valid=None):
    """The plain version of :func:`fused_ladder_window` (same arguments
    and outputs), one block and one octave at a time, on the band where
    the support lies: the octave's 12 blurs at the band cells of the
    window's rows and their NMS ring (``ladder.band_blur``, banded
    Toeplitz matmuls over the symmetric-padded block, the kernel's
    reflect boundary; started on a ``ladder.SLAB`` boundary, so each cell
    is the whole block's bit for bit), the DoG planes and their 3x3 maxima
    in band coordinates (``ladder.max3x3_band``, equal to the dense filter
    wherever the support can lie, 2 <= d <= DB - 3), then the NMS
    predicate, the running best and the support partials per plane and
    row tile (its tiles are whole row tiles). Detections need support, so
    nothing outside the band can change."""
    from mustache_tpu_torch.ladder import (
        SLAB, max3x3_band, nms_will, ring_rows, window_blur,
    )

    B = cs.shape[0]
    dev = cs.device
    P = n_octaves * planes_per_octave
    row0 = t_lo * TILE_ROWS
    rows = min(t_hi * TILE_ROWS, N) - row0
    nt = t_hi - t_lo
    band_v = torch.zeros((B, rows, DB), dtype=torch.float32, device=dev)
    band_sig = torch.full((B, rows, DB), -1, dtype=torch.int32, device=dev)
    parts = torch.zeros((B, nt, 2 * P), dtype=torch.float32, device=dev)
    # the blurs from a slab boundary at or before the window's NMS ring
    g0 = SLAB * (max(row0 - 1, 0) // SLAB)
    geom = ring_rows(N, DB, row0, rows, dev)
    i = torch.arange(row0, row0 + rows, device=dev)[:, None]
    j = i + torch.arange(DB, device=dev)
    pad_rows = nt * TILE_ROWS - rows
    inf = torch.tensor(float("inf"), device=dev)
    valid_h = None if valid is None else valid.cpu().tolist()
    for b in range(B):
        if valid_h is not None and not valid_h[b]:
            continue
        nz = (j < N) & (nzf[b, (i - base).expand(-1, DB),
                            j.clamp(max=N - 1)] > 0.5)
        nzw = nz.to(torch.float32)
        X = padded_window(cs[b], N, R, base, g0,
                          min(N, row0 + rows + 1) - g0)[None]
        best_v = band_v[b]
        best_sig = band_sig[b]
        for o in range(n_octaves):
            G = window_blur(X, kernels[o * BLURS_PER_OCTAVE:
                                       (o + 1) * BLURS_PER_OCTAVE], N, DB,
                            g0, row0, rows)[0]
            L = G[:-1] - G[1:]                  # [11, rows + 2, DB] DoG
            del G
            M = max3x3_band(geom, L)[:, 1:-1]
            L = L[:, 1:-1]
            for jj in range(1, planes_per_octave + 1):
                plane = o * planes_per_octave + jj - 1
                Lc = L[jj]
                al = Lc.abs()
                tmin = F.pad(torch.where(nz, al, inf), (0, 0, 0, pad_rows),
                             value=float("inf"))
                tsum = F.pad(al * nzw, (0, 0, 0, pad_rows))
                parts[b, :, plane] = tmin.reshape(nt, -1).amin(dim=1)
                parts[b, :, P + plane] = tsum.reshape(nt, -1).sum(dim=1)
                will = nms_will(L[jj - 1], Lc, L[jj + 1], M[jj - 1], M[jj],
                                M[jj + 1], nz, best_v)
                best_v.copy_(torch.where(will, Lc, best_v))
                best_sig.copy_(torch.where(will, plane, best_sig))
            del L, M
    return band_v, band_sig, parts


def fused_ladder_nms_reference(cs, nzf, kernels, *, R: int, n_octaves: int,
                               planes_per_octave: int, DB: int, valid=None,
                               N: int | None = None, base: int = 0,
                               t_lo: int = 0, t_hi: int | None = None):
    """Plain PyTorch version of the fused kernel: same contract as
    :func:`fused_ladder_nms_batched` (``(band_v, band_sig, locs,
    sums)``), and of a row window (``N``, ``base``, ``t_lo``, ``t_hi`` as
    :func:`fused_ladder_window` takes them: ``cs``/``nzf`` then hold the
    dense rows ``[base, ...)``, the band state covers the window's rows
    and ``locs``/``sums`` reduce its tiles only). See
    :func:`_plain_parts`."""
    N = cs.shape[-1] if N is None else N
    t_hi = row_tiles(N) if t_hi is None else t_hi
    band_v, band_sig, parts = _plain_parts(
        cs, nzf, kernels, R=R, n_octaves=n_octaves,
        planes_per_octave=planes_per_octave, DB=DB, N=N, base=base,
        t_lo=t_lo, t_hi=t_hi, valid=valid)
    return (band_v, band_sig) + reduce_parts(
        parts, n_octaves * planes_per_octave)
