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
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# kernel geometry, mirrored in csrc/fused_ladder.cu: one 256-thread block
# per (batch slot, 32x32 dense tile that meets the band)
TILE = 32
THREADS = 256
BLURS_PER_OCTAVE = 12
SMEM_LIMIT = 232_448     # H100 dynamic shared memory per block, bytes

LAUNCHES = 0


def tiles_per_row(DB: int) -> int:
    """Column tiles a row tile needs: tile (ti, ti + k) meets the band
    0 <= j - i < DB iff 0 <= k <= (DB + TILE - 2) // TILE."""
    return (DB + TILE - 2) // TILE + 1


def n_tiles(N: int, DB: int) -> int:
    return -(-N // TILE) * tiles_per_row(DB)


def smem_bytes(R: int, n_octaves: int) -> int:
    """Dynamic shared memory of one block: the ladder taps, the reflected
    input slab, the row-pass output, two blur planes, one DoG plane, and
    the partials' warp scratch (all f32)."""
    S = BLURS_PER_OCTAVE * n_octaves
    g = TILE + 2                       # blur tile edge: tile + NMS halo
    sw = g + 2 * R                     # slab edge: blur tile + conv radius
    floats = S * (2 * R + 1) + sw * sw + g * sw + 3 * g * g \
        + 2 * (THREADS // 32)
    return 4 * floats


def kernel_fits(R: int, n_octaves: int) -> bool:
    """The gate: the ladder radius fits one block's shared memory."""
    return smem_bytes(R, n_octaves) <= SMEM_LIMIT


def _check(cs, nzf, kernels, valid, R, n_octaves, planes_per_octave, DB):
    B, N, N2 = cs.shape
    if N != N2 or nzf.shape != cs.shape:
        raise ValueError(f"cs {tuple(cs.shape)} / nzf {tuple(nzf.shape)} "
                         "must both be [B, N, N]")
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


def fused_ladder_nms_batched(cs, nzf, kernels, *, R: int, n_octaves: int,
                             planes_per_octave: int, DB: int, valid=None):
    """Band best-state from the sentinel-filled blocks (see module doc).

    ``cs``/``nzf``: [B, N, N] f32; ``kernels``: [S, 2R+1] f32 ladder taps
    (``scalespace.ladder_tensor``); ``valid``: optional [B] int tensor,
    0 marks a pad slot. CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    global LAUNCHES
    _check(cs, nzf, kernels, valid, R, n_octaves, planes_per_octave, DB)
    if cs.device.type == "cpu":
        return fused_ladder_nms_reference(
            cs, nzf, kernels, R=R, n_octaves=n_octaves,
            planes_per_octave=planes_per_octave, DB=DB, valid=valid)
    if cs.device.type != "cuda":
        raise ValueError(f"unsupported device {cs.device}")
    if not kernel_fits(R, n_octaves):
        raise ValueError(f"ladder radius {R} needs {smem_bytes(R, n_octaves)}"
                         f" B of shared memory (limit {SMEM_LIMIT})")
    from mustache_tpu_torch.kernels.build import load

    lib = load("fused_ladder", bind)
    B, N, _ = cs.shape
    dev = cs.device
    P = n_octaves * planes_per_octave
    cs, nzf, kernels = cs.contiguous(), nzf.contiguous(), kernels.contiguous()
    valid = (torch.ones(B, dtype=torch.int32, device=dev) if valid is None
             else valid.to(torch.int32).contiguous())
    band_v = torch.zeros((B, N, DB), dtype=torch.float32, device=dev)
    band_sig = torch.full((B, N, DB), -1, dtype=torch.int32, device=dev)
    parts = torch.empty((B, n_tiles(N, DB), 2 * P), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mtt_fused_ladder_nms(
            cs.data_ptr(), nzf.data_ptr(), valid.data_ptr(),
            kernels.data_ptr(), band_v.data_ptr(), band_sig.data_ptr(),
            parts.data_ptr(), B, N, DB, R, n_octaves, tiles_per_row(DB),
            smem_bytes(R, n_octaves), stream)
    if rc != 0:
        raise RuntimeError("fused_ladder_nms launch failed: "
                           + lib.mtt_error_string(rc).decode())
    LAUNCHES += 1
    # deterministic cross-tile reduction of the per-tile partials (tiles
    # without support carry +inf / 0; pad slots 0 / 0)
    locs = parts[:, :, :P].amin(dim=1)
    sums = parts[:, :, P:].sum(dim=1)
    return band_v, band_sig, locs, sums


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """ctypes signatures of csrc/fused_ladder.cu's C entry points."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mtt_fused_ladder_nms.argtypes = [vp] * 7 + [ci] * 6 + [
        ctypes.c_size_t, vp]
    lib.mtt_fused_ladder_nms.restype = ci
    lib.mtt_error_string.argtypes = [ci]
    lib.mtt_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _symmetric_pad(c: torch.Tensor, R: int) -> torch.Tensor:
    """numpy 'symmetric' (= scipy 'reflect': the edge sample repeats) pad
    of the last two dims by R. torch's F.pad 'reflect' omits the edge
    sample, so this indexes instead."""
    N = c.shape[-1]
    idx = torch.arange(-R, N + R, device=c.device)
    idx = torch.where(idx < 0, -1 - idx, idx)
    idx = torch.where(idx >= N, 2 * N - 1 - idx, idx)
    return c[..., idx, :][..., idx]


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


def fused_ladder_nms_reference(cs, nzf, kernels, *, R: int, n_octaves: int,
                               planes_per_octave: int, DB: int, valid=None):
    """Plain PyTorch version of the fused kernel: same contract, one block
    and one octave at a time (the live set is one octave's 12 blur planes
    of one block, never the whole [S, N, N] stack)."""
    B, N, _ = cs.shape
    dev = cs.device
    P = n_octaves * planes_per_octave
    band_v = torch.zeros((B, N, DB), dtype=torch.float32, device=dev)
    band_sig = torch.full((B, N, DB), -1, dtype=torch.int32, device=dev)
    locs = torch.zeros((B, P), dtype=torch.float32, device=dev)
    sums = torch.zeros((B, P), dtype=torch.float32, device=dev)
    rows = torch.arange(N, device=dev)
    cols = rows[:, None] + torch.arange(DB, device=dev)[None, :]  # j = i + d
    in_mat = cols < N
    colc = cols.clamp(max=N - 1)
    d = rows[None, :] - rows[:, None]
    in_band = (d >= 0) & (d < DB)
    inf = torch.tensor(float("inf"), device=dev)
    valid_h = None if valid is None else valid.cpu().tolist()
    for b in range(B):
        if valid_h is not None and not valid_h[b]:
            continue
        nz = (nzf[b] > 0.5) & in_band
        nzw = nz.to(torch.float32)
        cpad = _symmetric_pad(cs[b], R)
        best_v = torch.zeros((N, N), dtype=torch.float32, device=dev)
        best_sig = torch.full((N, N), -1, dtype=torch.int32, device=dev)
        for o in range(n_octaves):
            G = _blur_octave(
                cpad, kernels[o * BLURS_PER_OCTAVE:(o + 1) * BLURS_PER_OCTAVE],
                N)
            L = G[:-1] - G[1:]                  # [11, N, N] DoG planes
            del G
            M = _max3x3(L)
            for j in range(1, planes_per_octave + 1):
                plane = o * planes_per_octave + j - 1
                Lp, Lc, Ln = L[j - 1], L[j], L[j + 1]
                mP, mC, mN = M[j - 1], M[j], M[j + 1]
                al = Lc.abs()
                locs[b, plane] = torch.where(nz, al, inf).amin()
                sums[b, plane] = (al * nzw).sum()
                will = (nz & (Lc > best_v) & (Lc == mC)
                        & ((Lp == mP) | (Ln == mN))
                        & (Lc > mP) & (Lc > mN))
                best_v = torch.where(will, Lc, best_v)
                best_sig = torch.where(will, plane, best_sig)
            del L, M
        band_v[b] = torch.where(in_mat, best_v[rows[:, None], colc], 0.0)
        band_sig[b] = torch.where(in_mat, best_sig[rows[:, None], colc], -1)
    return band_v, band_sig, locs, sums
