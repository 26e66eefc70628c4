#!/usr/bin/env python3
"""How far the float32 paths' q values sit from float64, on the CPU.

For each map (``synthetic_hic(n_bins, d_px, seed=..., n_loops=40)`` at
5 kb, ``pt=0.1, st=0.8``) runs the port's float32 default (the kernel
route's plain version), the port's float64 route (the judge: it equals
the JAX package's float64 path to ~1e-13, tests/test_torch_ladder_route.py)
and the JAX package's float32 path (its XLA ladder on the CPU, sort-mode
BH), and prints, for both float32 paths, the max relative q error against
float64 over the rows both have, and the rows on one side only.

With ``--inter N1 N2`` the maps are inter-chromosomal rectangles
(``synthetic_inter(N1, N2, seed=..., n_loops=10)``, ``pt=0.1, st=0.5``,
tiles of 512^2) through both packages' ``detect_inter_loops_coo``; their
q are tiny (1e-25 or so), so the relative q error is the absolute log q
error.

    JAX_PLATFORMS=cpu python tools/f32_tolerance.py [--seeds 1 2 3] [--n-bins 4000] [--d-px 64]
    JAX_PLATFORMS=cpu python tools/f32_tolerance.py --inter 1000 900 --seeds 3 7 11 12 13
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"


def compare(loops, judge):
    """(max rel q error over common rows, rows only in loops, rows only in
    judge)."""
    ref = {(lp.bin1, lp.bin2): lp.q for lp in judge}
    got = {(lp.bin1, lp.bin2): lp.q for lp in loops}
    common = set(ref) & set(got)
    err = max((abs(got[k] - ref[k]) / ref[k] for k in common), default=0.0)
    return err, len(set(got) - set(ref)), len(set(ref) - set(got))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    ap.add_argument("--n-bins", type=int, default=4000)
    ap.add_argument("--d-px", type=int, default=64)
    ap.add_argument("--inter", type=int, nargs=2, metavar=("N1", "N2"),
                    help="inter-chromosomal maps of N1 x N2 bins")
    args = ap.parse_args()
    if args.inter:
        return inter_main(args)

    import mustache_tpu.detect as jdetect
    from mustache_tpu.config import DetectionConfig as JaxConfig
    from mustache_tpu.pipeline import detect_loops_coo as jax_detect
    from mustache_tpu_torch import DetectionConfig, detect_loops_coo
    from synthetic import synthetic_hic

    jdetect._BH_MODE = "sort"
    kw = dict(resolution=5000, distance_bp=args.d_px * 5000, pt=0.1, st=0.8)
    for seed in args.seeds:
        x, y, v, _ = synthetic_hic(args.n_bins, args.d_px, seed=seed,
                                   n_loops=40)
        f64 = detect_loops_coo(x, y, v, DetectionConfig(
            **kw, precision="float64"), device="cpu")
        port = detect_loops_coo(x, y, v, DetectionConfig(**kw), device="cpu")
        jax32 = jax_detect(x, y, v.copy(), JaxConfig(**kw))
        e_p, p_only, p_miss = compare(port, f64)
        e_j, j_only, j_miss = compare(jax32, f64)
        e_pj, _, _ = compare(port, jax32)
        print(f"n_bins={args.n_bins} d_px={args.d_px} seed={seed}: "
              f"{len(f64)} f64 rows; port f32 max rel q err {e_p:.3e} "
              f"(+{p_only}/-{p_miss} rows), JAX f32 {e_j:.3e} "
              f"(+{j_only}/-{j_miss} rows), port vs JAX f32 {e_pj:.3e}",
              flush=True)


def inter_main(args):
    from mustache_tpu.config import DetectionConfig as JaxConfig
    from mustache_tpu.inter import detect_inter_loops_coo as jax_detect
    from mustache_tpu_torch import DetectionConfig, Loop
    from mustache_tpu_torch.inter import detect_inter_loops_coo
    from synthetic import synthetic_inter

    def loops(rows):
        return [Loop(int(r[0]), int(r[1]), r[2], r[3]) for r in rows]

    n1, n2 = args.inter
    kw = dict(resolution=5000, distance_bp=2_000_000, pt=0.1, st=0.5,
              min_tested=5000)
    for seed in args.seeds:
        x, y, v, _ = synthetic_inter(n1, n2, seed=seed, n_loops=10)
        f64 = loops(detect_inter_loops_coo(
            x, y, v.copy(), DetectionConfig(**kw, precision="float64"),
            chunk=512, device="cpu"))
        port = loops(detect_inter_loops_coo(
            x, y, v.copy(), DetectionConfig(**kw), chunk=512, device="cpu"))
        jax32 = loops(jax_detect(x, y, v.copy(), JaxConfig(**kw), chunk=512))
        e_p, p_only, p_miss = compare(port, f64)
        e_j, j_only, j_miss = compare(jax32, f64)
        e_pj, _, _ = compare(port, jax32)
        print(f"inter {n1} x {n2} seed={seed}: {len(f64)} f64 rows; port "
              f"f32 max rel q err {e_p:.3e} (+{p_only}/-{p_miss} rows), JAX "
              f"f32 {e_j:.3e} (+{j_only}/-{j_miss} rows), port vs JAX f32 "
              f"{e_pj:.3e}", flush=True)


if __name__ == "__main__":
    main()
