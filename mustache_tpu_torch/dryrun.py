"""Entry points of the port's compile check and multi-device dryrun.

Torch counterparts of ``__graft_entry__.py:59-196``, on the same seeded
inputs (``_example_block`` and ``_example_coo`` are copies):

``entry()``               -> ``(fn, example_args)``: one detection block
                             through the detector's route (the fused
                             kernel on the card) and epilogue.
``dryrun_multichip(n)``   -> the detector through the dense runner on a
                             ``(n / 2) x 2`` (block, row) mesh wherever the
                             JAX dryrun builds one (n even and >= 4,
                             ``__graft_entry__.py:102-106``; else n x 1),
                             held bit for bit to the unsharded ``fn`` and
                             to the ``n x 1`` mesh; the single-map
                             pipeline through the replicate placement, the
                             differential pipeline through both
                             placements and (``production=True``) the
                             production geometry through both, on the
                             ``n x 1`` mesh, each held to the unsharded
                             run on the mesh's first device: anchors,
                             scales and tags exact, q bit-identical for
                             replicate and within rtol 5e-3 for rowshard
                             (host vs device normalize).

    python -m mustache_tpu_torch.dryrun [--devices N] [--device cuda:0]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

RTOL_ROWSHARD = 5e-3   # the JAX dryrun's rowshard q tolerance


def _example_block(n=256, d_px=64, seed=0):
    rng = np.random.default_rng(seed)
    c = np.zeros((n, n), dtype=np.float32)
    for d in range(5, d_px + 1):
        m = n - d
        occ = rng.random(m) < 0.9
        idx = np.nonzero(occ)[0]
        c[idx, idx + d] = rng.standard_normal(len(idx)).astype(np.float32)
    return c


def _example_coo(n_bins, d_px, seed=0, n_loops=20):
    """COO triplets of a synthetic contact map with planted loops."""
    rng = np.random.default_rng(seed)
    xs, ys, vs = [], [], []
    for d in range(1, d_px + 1):
        m = n_bins - d
        if m <= 0:
            break
        idx = np.nonzero(rng.random(m) < 0.95)[0]
        lam = 60.0 * (1.0 + d) ** -0.9 + 1.0
        xs.append(idx)
        ys.append(idx + d)
        vs.append(rng.poisson(lam, size=len(idx)).astype(np.float64) + 1.0)
    x, y, v = np.concatenate(xs), np.concatenate(ys), np.concatenate(vs)
    # plant loops: multiply counts in a 5x5 bump around random anchors
    key = x * np.int64(n_bins) + y
    order = np.argsort(key)
    key_s = key[order]
    for _ in range(n_loops):
        ax = int(rng.integers(0, n_bins - d_px))
        ay = ax + int(rng.integers(10, d_px - 5))
        for dx in range(-2, 3):
            for dy in range(-2, 3):
                k = (ax + dx) * np.int64(n_bins) + (ay + dy)
                j = np.searchsorted(key_s, k)
                if j < len(key_s) and key_s[j] == k:
                    g = np.exp(-(dx * dx + dy * dy) / 2.0)
                    v[order[j]] *= 1.0 + 5.0 * g
    return x, y, v


def entry(device=None):
    """``(detector.fn_single, (block,))`` for one 256^2 block on
    ``device`` (the card by default)."""
    from mustache_tpu_torch.config import DetectionConfig
    from mustache_tpu_torch.detect import build_detector
    from mustache_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n, d_px = 256, 64
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=512)
    detector = build_detector(cfg, n, device=dev)
    return detector.fn_single, (torch.from_numpy(_example_block(n, d_px))
                                .to(dev),)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def _held(label, base, got, *, key, q, rtol=None) -> float:
    """``got`` rows against ``base``: ``key(row)`` exact and in order, q
    bit-identical (``rtol`` None) or within ``rtol``; returns the largest
    relative q distance."""
    if [key(r) for r in base] != [key(r) for r in got]:
        raise AssertionError(f"{label}: calls differ from the unsharded run")
    qb = np.asarray([q(r) for r in base], np.float64)
    qg = np.asarray([q(r) for r in got], np.float64)
    dist = float(np.max(np.abs(qg - qb) / qb)) if len(qb) else 0.0
    if rtol is None:
        if not np.array_equal(qb, qg):
            raise AssertionError(f"{label}: q not bit-identical "
                                 f"(max rel {dist:.3g})")
    else:
        np.testing.assert_allclose(qg, qb, rtol=rtol, err_msg=label)
    return dist


def dense_mesh_shape(n_devices: int) -> tuple[int, int]:
    """``(n_block, n_row)`` of the dense runner's mesh: blocks over
    ``block`` and each block's rows over a ``row`` pair wherever the JAX
    dryrun builds one (``__graft_entry__.py:102-106``)."""
    n_row = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return n_devices // n_row, n_row


def dryrun_multichip(n_devices: int, devices=None,
                     production: bool = True) -> dict:
    """The multi-device dryrun on the first ``n_devices`` of ``devices``
    (default: every visible CUDA device; a list may repeat one, e.g.
    ``["cuda:0"] * 4``). Raises on any disagreement; returns the measured
    q distances and row counts."""
    from mustache_tpu_torch.config import DetectionConfig
    from mustache_tpu_torch.detect import build_detector
    from mustache_tpu_torch.diff import detect_diff_loops_coo
    from mustache_tpu_torch.pipeline import detect_loops_coo
    from mustache_tpu_torch.sharding import make_mesh, make_runner

    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
    mesh = make_mesh(n_block=n_devices, n_row=1, devices=devices)
    dev0 = mesh.block_devices[0]
    n_block, n_row = dense_mesh_shape(n_devices)
    mesh2 = make_mesh(n_block=n_block, n_row=n_row, devices=devices)
    report = {"mesh": mesh.shape, "dense_mesh": mesh2.shape}
    print(f"dryrun_multichip: mesh={mesh.shape} dense-runner mesh="
          f"{mesh2.shape} devices={devices}")

    # --- the detector through the dense runner --------------------------
    n, d_px = 256, 64
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=512,
                          block_batch=n_devices)
    blocks = np.stack([_example_block(n, d_px, seed=s)
                       for s in range(n_devices)])
    base = {k: a.cpu().numpy() for k, a in build_detector(
        cfg, n, device=dev0).fn(torch.from_numpy(blocks).to(dev0)).items()}
    runs = {}
    for m in (mesh2, mesh) if n_row > 1 else (mesh,):
        runner = make_runner(m)
        dets = runner.per_device(lambda d: build_detector(cfg, n, device=d))
        out = runner(dets, blocks)
        assert out["cand_x"].shape == (n_devices, 512)
        assert np.isfinite(out["nz_count"]).all()
        assert (out["nz_count"] > 0).all()
        for k in base:
            if not _same(base[k], out[k]):
                raise AssertionError(f"dense runner on {m.shape}: {k} "
                                     f"differs from fn")
        runs[m.shape["row"]] = out
        report[f"dense_launches_row{m.shape['row']}"] = runner.launches
        report[f"dense_held_row{m.shape['row']}"] = runner.last_held
    print(f"dryrun_multichip detector OK: blocks={blocks.shape} "
          f"nz={out['nz_count'].tolist()} == unsharded fn"
          + (f"; the {mesh2.shape} row split == the {mesh.shape} mesh "
             f"(bit-identical), fused launches per entry "
             f"{report['dense_launches_row2']}" if n_row > 1 else ""))

    # --- the single-map pipeline through the replicate placement -------
    loop_key = lambda lp: (lp.bin1, lp.bin2, lp.scale)   # noqa: E731
    loop_q = lambda lp: lp.q                              # noqa: E731
    d_px2 = 128
    cfg2 = DetectionConfig(resolution=5000, distance_bp=d_px2 * 5000,
                           precision="float32")
    x, y, v = _example_coo(2500, d_px2, seed=7, n_loops=25)
    base = detect_loops_coo(x, y, v, cfg2, device=dev0)
    shard = detect_loops_coo(x, y, v, cfg2, runner=make_runner(mesh))
    assert len(base) > 0
    _held("pipeline replicate", base, shard, key=loop_key, q=loop_q)
    report["pipeline_rows"] = len(base)
    print(f"dryrun_multichip pipeline OK: loops={len(base)} "
          f"replicated==unsharded (q bit-identical)")

    # --- the differential pipeline through both placements -------------
    diff_key = lambda r: (r[0], r[1], r[3], r[4])       # noqa: E731
    diff_q = lambda r: r[2]                             # noqa: E731
    x2, y2, v2 = _example_coo(2500, d_px2, seed=8, n_loops=25)
    dbase = detect_diff_loops_coo(x, y, v, x2, y2, v2, cfg2, device=dev0)
    drep = detect_diff_loops_coo(x, y, v, x2, y2, v2, cfg2,
                                 runner=make_runner(mesh))
    drs = detect_diff_loops_coo(x, y, v, x2, y2, v2, cfg2,
                                runner=make_runner(mesh, "rowshard"))
    assert len(dbase) > 0
    _held("diff replicate", dbase, drep, key=diff_key, q=diff_q)
    dist = _held("diff rowshard", dbase, drs, key=diff_key, q=diff_q,
                 rtol=RTOL_ROWSHARD)
    report.update(diff_rows=len(dbase), diff_rowshard_q_dist=dist)
    print(f"dryrun_multichip diff OK: rows={len(dbase)} replicated=="
          f"unsharded (q bit-identical), rowshard tags equal, q max rel "
          f"distance {dist:.3g} (rtol {RTOL_ROWSHARD})")

    if not production:
        print("dryrun_multichip production geometry: not run "
              "(production=False)")
        return report
    # --- production geometry: 2000^2 blocks at d_px 400 on a chromosome
    # length on the band-row bucket edge (bucket_rows(10096) == 10096),
    # through both placements
    d_px3, n_bins3 = 400, 10096
    cfg3 = DetectionConfig(resolution=5000, distance_bp=d_px3 * 5000,
                           precision="float32")
    x3, y3, v3 = _example_coo(n_bins3, d_px3, seed=9, n_loops=40)
    base3 = detect_loops_coo(x3, y3, v3, cfg3, device=dev0)
    rep3 = detect_loops_coo(x3, y3, v3, cfg3, runner=make_runner(mesh))
    rs3 = detect_loops_coo(x3, y3, v3, cfg3,
                           runner=make_runner(mesh, "rowshard"))
    assert len(base3) > 0
    _held("production replicate", base3, rep3, key=loop_key, q=loop_q)
    dist3 = _held("production rowshard", base3, rs3, key=loop_key, q=loop_q,
                  rtol=RTOL_ROWSHARD)
    report.update(production_rows=len(base3),
                  production_rowshard_q_dist=dist3)
    print(f"dryrun_multichip production-geometry OK: n={n_bins3} "
          f"d_px={d_px3} blocks=2000^2 loops={len(base3)} replicated=="
          f"unsharded (q bit-identical), rowshard q max rel distance "
          f"{dist3:.3g}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh entries (0: every visible CUDA device)")
    ap.add_argument("--device", default="",
                    help="repeat this one device --devices times "
                         "(e.g. cuda:0, or cpu)")
    ap.add_argument("--no-production", action="store_true",
                    help="skip the production-geometry part")
    args = ap.parse_args(argv)
    n = args.devices or torch.cuda.device_count()
    devices = [args.device] * n if args.device else None
    dryrun_multichip(n, devices, production=not args.no_production)


if __name__ == "__main__":
    main()
