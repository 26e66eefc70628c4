#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the fused ladder/DoG/NMS kernel from csrc/ with nvcc and print
   ptxas's report for it (registers, shared memory, spills);
3. kernel vs its plain PyTorch version on the card, on sentinel-filled
   synthetic blocks at both main-path block shapes (N=2000/DB=512 at 5 kb,
   N=4000/DB=2048 at 1 kb), and at the 5 kb shape with a 3-octave ladder
   (radii up to 28: the kernel's path for sigmas of more than 32 taps),
   B=4 with a pad slot in the middle: band_sig
   equal on the support (a mismatch must be an f32 near-tie and sit on no
   significant candidate), band_v / locs / sums within rtol 2e-4, the pad
   slot empty, a second launch bit-identical; kernel, plain version and
   cuDNN's two-pass blur of the same blocks (blur only: no PyTorch call
   computes the fused function) timed with CUDA events; the kernel held
   against its FP32 bound from the FLOP the algorithm needs;
4. end to end: the bench headline workload (synthetic chr21 at 5 kb,
   6 blocks of 2000^2) through ``detect_loops_coo`` with no device given
   (the card by default) and ``write_loops``; the kernel must have
   launched, and the loop rows must equal the JAX package's CPU golden
   (tests/data/torch_port_chr21_5kb_golden.tsv, tools/make_torch_golden.py):
   anchors and scales exact, q within rtol 2e-4, the only allowed
   difference a row whose q is within rtol 2e-4 of pt.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

RTOL = 2e-4           # f32 tolerance of the JAX package's own parity tests
PT, ST = 0.1, 0.8     # bench headline thresholds (bench.py)
NEAR_TIE = 1e-5       # relative f64 margin below which f32 may decide
                      # either way (~100 f32 ulps)
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "torch_port_chr21_5kb_golden.tsv")
FP32_FLOPS = 67e12    # H100 SXM FP32 peak outside the tensor cores (700 W)
HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
# (label, N, d_px, resolution, n_bins, starts, ladder octaves); slot 2 is
# the pad slot
SHAPES = [("5kb", 2000, 400, 5000, 5000, [0, 1000, 0, 3000], (1.6, 3.2)),
          ("1kb", 4000, 2000, 1000, 8000, [0, 2000, 0, 4000], (1.6, 3.2)),
          ("5kb-3oct", 2000, 400, 5000, 5000, [0, 1000, 0, 3000],
           (1.6, 3.2, 6.4))]
VALID = [1, 1, 0, 1]


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def synthetic_blocks(dev, N, d_px, res, n_bins, starts, seed):
    """Sentinel-filled blocks [B, N, N] and their support, built the way the
    pipeline builds them (raw band -> device normalize -> slice -> densify
    -> sentinel fill), plus the band slices."""
    from synthetic import synthetic_hic
    from mustache_tpu_torch.bandnorm import bucket_rows, normalize_band_device
    from mustache_tpu_torch.detect import _preamble, band_width, dense_from_band
    from mustache_tpu_torch.pipeline import fill_raw_band, upload_band

    x, y, v, _ = synthetic_hic(n_bins, d_px, seed=seed, n_loops=60,
                               loop_strength=3.0, density=0.95)
    shape = (bucket_rows(n_bins), band_width(N, d_px))
    band = upload_band(fill_raw_band(x, y, v, shape), dev)
    band, _ = normalize_band_device(band, n_bins, res, d_px)
    slices = torch.stack([band[max(s, 0): max(s, 0) + N] for s in starts])
    cs, nz = _preamble(dense_from_band(slices), d_px)
    return cs, nz.to(torch.float32), slices


def band_support(nzf, DB):
    """Support in band layout [B, N, DB] (cells with j = i + d >= N are
    off-support)."""
    B, N, _ = nzf.shape
    i = torch.arange(N, device=nzf.device)[:, None]
    j = i + torch.arange(DB, device=nzf.device)[None, :]
    return (nzf[:, i, j.clamp(max=N - 1)] > 0.5) & (j < N)


def near_tie(cs_blk: np.ndarray, i: int, j: int, spec) -> float:
    """Smallest relative margin, in float64, among the comparisons the NMS
    makes at dense cell (i, j): each DoG plane's centre against its 3x3
    neighbours and the two adjacent planes, and against every other
    plane's centre (the running best). A mismatch between two f32
    implementations is legitimate only where this margin is within f32
    rounding."""
    N = cs_blk.shape[0]
    R = spec.radius
    idx_r = np.arange(i - 1 - R, i + 2 + R)
    idx_c = np.arange(j - 1 - R, j + 2 + R)

    def refl(a):
        a = np.where(a < 0, -1 - a, a)
        return np.clip(np.where(a >= N, 2 * N - 1 - a, a), 0, N - 1)

    win = cs_blk[np.ix_(refl(idx_r), refl(idx_c))].astype(np.float64)
    inside = np.outer((np.arange(i - 1, i + 2) >= 0) & (np.arange(i - 1, i + 2) < N),
                      (np.arange(j - 1, j + 2) >= 0) & (np.arange(j - 1, j + 2) < N))
    T = 2 * R + 1
    G = []
    for k in spec.kernels:                       # f64 taps
        rows = np.stack([win[r:r + T].T @ k for r in range(3)])    # [3, 3+2R]
        g = np.stack([rows[:, c:c + T] @ k for c in range(3)], 1)  # [3, 3]
        G.append(np.where(inside, g, 0.0))
    G = np.asarray(G)
    margins, scale = [], 1e-30
    centres = []
    for o in range(len(spec.octave_values)):
        L = G[o * 12:(o + 1) * 12 - 1] - G[o * 12 + 1:(o + 1) * 12]
        scale = max(scale, np.abs(L).max())
        for p in range(1, 10):
            c = L[p, 1, 1]
            centres.append(c)
            for q in (p - 1, p, p + 1):
                nb = np.delete(L[q].ravel(), 4) if q == p else L[q].ravel()
                margins.extend(np.abs(c - nb))
                if q != p:
                    margins.extend(np.abs(L[q, 1, 1] - np.delete(L[q].ravel(), 4)))
    centres = np.asarray(centres)
    margins.extend(np.abs(centres[:, None] - centres[None, :])[
        ~np.eye(len(centres), dtype=bool)])
    return float(np.min(margins) / scale)


def kernel_bound(spec, N, DB, n_real):
    """FLOP the algorithm needs, bytes it must move, and the least time
    the card could take for them: two separable passes over each sigma's
    nonzero taps (2r + 1) at every band cell (sum over rows of min(DB,
    N - i)) of every real slot, one FMA = 2 FLOP; cs and nzf read once
    and band_v and band_sig written once over the band, 4 bytes each."""
    from mustache_tpu_torch.scalespace import kernel_radius

    taps = sum(2 * kernel_radius(s) + 1 for s in spec.blur_sigmas)
    cells = sum(min(DB, N - i) for i in range(N)) * n_real
    flop = 2 * 2 * taps * cells
    nbytes = 16 * cells
    t_ops, t_bytes = flop / FP32_FLOPS, nbytes / HBM_BYTES
    return (flop, nbytes, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def blur_only(cs, taps, spec, valid):
    """cuDNN's two-pass blur of every real block, all octaves (allow_tf32
    off): the yardstick for the blur part alone."""
    from mustache_tpu_torch.kernels.fused_ladder import (
        BLURS_PER_OCTAVE, _blur_octave, _symmetric_pad,
    )
    N = cs.shape[-1]
    for b in range(cs.shape[0]):
        if valid[b]:
            cpad = _symmetric_pad(cs[b], spec.radius)
            for o in range(len(spec.octave_values)):
                _blur_octave(cpad, taps[o * BLURS_PER_OCTAVE:
                                        (o + 1) * BLURS_PER_OCTAVE], N)


def phase_kernel_vs_plain(dev):
    from mustache_tpu_torch.detect import _detect_one, band_width
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.scalespace import (
        build_ladder, ladder_tensor, radii_tensor,
    )

    report = {}
    for label, N, d_px, res, n_bins, starts, octaves in SHAPES:
        spec = build_ladder(octaves)
        taps = ladder_tensor(spec.kernels, dev)
        radii = radii_tensor(spec.blur_sigmas, dev)
        DB = band_width(N, d_px)
        cs, nzf, slices = synthetic_blocks(dev, N, d_px, res, n_bins, starts,
                                           seed=7)
        valid = torch.tensor(VALID, dtype=torch.int32, device=dev)
        kw = dict(R=spec.radius, n_octaves=len(spec.octave_values),
                  planes_per_octave=spec.planes_per_octave, DB=DB,
                  valid=valid)
        got = fl.fused_ladder_nms_batched(cs, nzf, taps, radii=radii, **kw)
        again = fl.fused_ladder_nms_batched(cs, nzf, taps, radii=radii, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{label}: two launches differ")
        del again
        want = fl.fused_ladder_nms_reference(cs, nzf, taps, **kw)
        torch.cuda.synchronize()
        gv, gs, gl, gsum = got
        wv, ws, wl, wsum = want

        # pad slot: empty state, zero partials
        if not ((gv[2] == 0).all() and (gs[2] == -1).all()
                and (gl[2] == 0).all() and (gsum[2] == 0).all()):
            fail(f"{label}: pad slot not empty")
        sup = band_support(nzf * valid[:, None, None], DB)
        mism = (gs != ws) & sup
        n_mis = int(mism.sum())
        say(f"[3] {label} N={N} DB={DB} R={spec.radius} B=4: support cells "
            f"{int(sup.sum())}, detections {int((ws >= 0).sum())}, band_sig mismatches {n_mis}")
        if int(((gs != ws) & ~sup).sum()):
            fail(f"{label}: band_sig differs off the support")

        # candidates with q < pt from both states must agree; no mismatch
        # may sit on one
        K = 8192
        st = float(np.float32(ST))
        lp = float(np.float32(math.log(PT)))
        n_sig = 0
        for b in (0, 1, 3):
            outs = [_detect_one(tuple(a[b] for a in state), slices[b],
                                det_ceil=spec.det_ceil, d_px=d_px, K=K,
                                st=st, log_pt=lp)
                    for state in (got, want)]
            sets = []
            for o in outs:
                if int(o["sig_count"]) > K:
                    fail(f"{label}: sig_count {int(o['sig_count'])} > {K}")
                ok = o["cand_valid"].cpu().numpy()
                xs, ys = o["cand_x"].cpu().numpy(), o["cand_y"].cpu().numpy()
                sg = o["cand_sigidx"].cpu().numpy()
                q = o["cand_logq"].cpu().numpy()
                sets.append({(int(a), int(c), int(s)): float(lq) for a, c, s,
                             lq, k in zip(xs, ys, sg, q, ok) if k})
            if set(sets[0]) != set(sets[1]):
                fail(f"{label} slot {b}: significant candidates differ")
            for key, lq in sets[1].items():
                if not math.isclose(sets[0][key], lq, rel_tol=RTOL,
                                    abs_tol=1e-4):
                    fail(f"{label} slot {b}: log q {sets[0][key]} vs {lq}")
            n_sig += len(sets[1])
            cells = {(x, y) for x, y, _ in sets[1]}
            mb = mism[b].nonzero().cpu().numpy()
            cs_b = cs[b].cpu().numpy() if len(mb) else None
            for i, d in mb[:200]:
                if (int(i), int(i + d)) in cells:
                    fail(f"{label} slot {b}: mismatch on a significant "
                         f"candidate at ({i}, {i + d})")
                m = near_tie(cs_b, int(i), int(i + d), spec)
                if m > NEAR_TIE:
                    fail(f"{label} slot {b}: mismatch at ({i}, {i + d}) is "
                         f"no near-tie (margin {m:.3g})")
            if len(mb) > 200:
                fail(f"{label} slot {b}: {len(mb)} band_sig mismatches")

        for name, a, w in (("band_v", gv, wv), ("locs", gl, wl),
                           ("sums", gsum, wsum)):
            if not torch.allclose(a, w, rtol=RTOL, atol=1e-6):
                fail(f"{label}: {name} max abs err "
                     f"{float((a - w).abs().max())}")
        err = float((gv - wv).abs().max())
        locs_err = float((gl - wl).abs().max())
        sums_rel = float(((gsum - wsum).abs()
                          / wsum.abs().clamp(min=1e-30)).max())
        del got, want, gv, gs, gl, gsum, wv, ws, wl, wsum
        ms = cuda_ms(lambda: fl.fused_ladder_nms_batched(
            cs, nzf, taps, radii=radii, **kw), reps=10)
        plain_ms = cuda_ms(
            lambda: fl.fused_ladder_nms_reference(cs, nzf, taps, **kw), reps=2)
        blur_ms = cuda_ms(lambda: blur_only(cs, taps, spec, VALID), reps=3)
        flop, nbytes, bound_ms, bound_by = kernel_bound(
            spec, N, DB, sum(VALID))
        say(f"[3] {label}: significant candidates {n_sig} equal; band_v max "
            f"abs err {err:.3g}, locs {locs_err:.3g}, sums rel "
            f"{sums_rel:.3g}; two launches bit-identical")
        say(f"[3] {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"cuDNN blur only {blur_ms:.3f} ms (B=4, one pad slot); "
            f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
            f"{bound_ms:.4f} ms ({bound_by}), share of bound "
            f"{bound_ms / ms:.3f}, {flop / ms / 1e9:.2f} TFLOP/s")
        report[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             blur_ms=blur_ms, bound_ms=bound_ms,
                             bound_by=bound_by, share=bound_ms / ms)
        del cs, nzf, slices
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def read_tsv(path):
    with open(path) as fh:
        header = fh.readline()
        rows = [ln.rstrip("\n").split("\t") for ln in fh if ln.strip()]
    return header, rows


def compare_to_golden(rows, golden):
    """Rows equal in order: anchors and scale strings exact, q within
    RTOL; a row present on one side only must have q within RTOL of pt."""
    def strip(rs, other):
        keys = {tuple(r[:6]) for r in other}
        kept = []
        for r in rs:
            if tuple(r[:6]) not in keys:
                if not math.isclose(float(r[6]), PT, rel_tol=RTOL):
                    fail(f"row {r[:6]} q={r[6]} only on one side")
                say(f"[4] near-pt row on one side only: {r}")
                continue
            kept.append(r)
        return kept

    a, b = strip(rows, golden), strip(golden, rows)
    if len(a) != len(b):
        fail(f"{len(a)} vs {len(b)} common rows")
    worst = 0.0
    for r, g in zip(a, b):
        if r[:6] != g[:6] or r[7] != g[7]:
            fail(f"row {r} != golden {g}")
        qr, qg = float(r[6]), float(g[6])
        if not (math.isfinite(qr) and 0 < qr < PT):
            fail(f"q out of range in {r}")
        worst = max(worst, abs(qr - qg) / qg)
        if worst > RTOL:
            fail(f"q {qr} vs golden {qg}")
    return len(a), worst


def phase_end_to_end():
    from synthetic import synthetic_hic
    from mustache_tpu_torch import DetectionConfig, detect_loops_coo, write_loops
    from mustache_tpu_torch.kernels import fused_ladder as fl

    x, y, v, _ = synthetic_hic(9629, 400, seed=2021, n_loops=300,
                               loop_strength=3.0)
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=PT,
                          st=ST, precision="float32")

    logs = []

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops = detect_loops_coo(x, y, v, cfg, log=logs.append)  # the card
        torch.cuda.synchronize()
        return loops, time.perf_counter() - t0

    fl.LAUNCHES = 0
    loops, cold = run()
    launches = fl.LAUNCHES
    say(f"[4] {logs[0]}")
    if "device=cuda" not in logs[0]:
        fail("detect_loops_coo without a device did not run on the card")
    if launches <= 0:
        fail("the main path did not launch the fused kernel")
    warm = []
    for _ in range(3):
        again, dt = run()
        warm.append(dt)
        if again != loops:
            fail("warm rerun gave other loops")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "loops.tsv")
        write_loops(out, [("chr21", "chr21", cfg.resolution, loops)])
        header, rows = read_tsv(out)
    gheader, golden = read_tsv(GOLDEN)
    if header != gheader or not rows:
        fail("bad TSV header or no loops")
    n_common, worst = compare_to_golden(rows, golden)
    say(f"[4] chr21 5kb: {len(rows)} loops ({len(golden)} golden, "
        f"{n_common} common rows equal, q max rel err {worst:.3g}); kernel "
        f"launches {launches}; wall cold {cold:.3f} s, warm "
        f"{' '.join(f'{w:.3f}' for w in warm)} s (median "
        f"{sorted(warm)[1]:.3f})")
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from mustache_tpu_torch.device import resolve_device
    from mustache_tpu_torch.kernels import build, fused_ladder

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.load("fused_ladder", fused_ladder.bind)
    say(f"[2] built fused_ladder in {time.perf_counter() - t0:.2f} s "
        f"({build.library_path('fused_ladder').name})")
    for ln in build.build_log("fused_ladder").splitlines():
        if "registers" in ln or "spill" in ln or "entry function" in ln:
            say(f"[2] {ln.strip()}")

    report = phase_kernel_vs_plain(dev)
    launches = phase_end_to_end()

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    r5, r1, r3 = report["5kb"], report["1kb"], report["5kb-3oct"]
    say(json.dumps({"kernels": [{
        "name": "fused_ladder_nms",
        "route": "cuda",
        "source": "mustache_tpu_torch/kernels/csrc/fused_ladder.cu",
        "replaces": "mustache_tpu/kernels/fused_ladder.py:104",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in report.values()),
        "ms": r5["ms"],
        "plain_ms": r5["plain_ms"],
        "bound_ms": r5["bound_ms"],
        "bound_by": r5["bound_by"],
        "library_ms": None,
        "share": r5["share"],
        "cudnn_blur_only_ms": r5["blur_ms"],
        "ms_1kb": r1["ms"],
        "plain_ms_1kb": r1["plain_ms"],
        "bound_ms_1kb": r1["bound_ms"],
        "share_1kb": r1["share"],
        "cudnn_blur_only_ms_1kb": r1["blur_ms"],
        "ms_3oct": r3["ms"],
        "plain_ms_3oct": r3["plain_ms"],
        "share_3oct": r3["share"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
