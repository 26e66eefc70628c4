"""``diff_mustache``-compatible CLI of the PyTorch/CUDA port: differential
loops between two conditions, four output files ``.loop1 .diffloop1
.loop2 .diffloop2``.

Torch port of ``mustache_tpu/diff_cli.py:34-269`` (diff_mustache.py:29-180
for the parser, :720-906 for the main flow) on the port's
``cli.build_parser(diff=True)``, ``load_contacts``, ``_chromosome_lists``,
``RunLog`` and ``RunManifest``. ``--engine-resume`` checkpoints per
chromosome in four per-file manifests under one fingerprint (a unit is
done only when all four parts exist); ingest retries and the one-deep
prefetch are the single-map CLI's. The run goes on the card unless
``--engine-platform cpu`` asks for the CPU; without CUDA it raises.

``--engine-precision float64`` runs the float64 route (host normalize,
the ladder in float64), as in the single-map CLI. A ``-ch2`` chromosome
that differs from its ``-ch`` one stops the run with the JAX CLI's
"Interchromosomal analysis is not supported." and exit code 1
(``mustache_tpu/diff_cli.py:173-175``). ``--engine-mesh`` and the
multi-process flags work as in the single-map CLI: a mesh holds both
conditions' bands on every device (``block``) or a slab pair on each
(``rowshard``), and N processes each take every N-th chromosome, write
the four files' parts, and process 0 assembles all four after the barrier
(``mustache_tpu/diff_cli.py:116-160, 250``).
"""

from __future__ import annotations

import os
import sys
import time

from mustache_tpu_torch.cli import (
    HEADER, PLATFORMS, _chromosome_lists, _profiler, build_parser,
    finish_processes, load_contacts, make_cli_runner, start_processes, warm,
)
from mustache_tpu_torch.config import DetectionConfig, clamp_distance_filter, parse_bp
from mustache_tpu_torch.device import resolve_device
from mustache_tpu_torch.diff import detect_diff_loops_coo
from mustache_tpu_torch.io.chrom import normalize_chrom

SUFFIXES = {1: ".loop1", 2: ".diffloop1", 3: ".loop2", 4: ".diffloop2"}


def parse_args(argv):
    return build_parser(diff=True).parse_args(argv)


def main(argv=None):
    start_time = time.time()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(PLATFORMS[args.platform])   # no CUDA: raises
    print("\n")

    f1, f2 = args.f_path1, args.f_path2
    if args.bed1 and args.mat1:
        f1 = args.mat1
    if args.bed2 and args.mat2:
        f2 = args.mat2
    if not f1 or not f2 or not os.path.exists(f1) or not os.path.exists(f2):
        print("Error: Couldn't find the specified contact files")
        return 1
    res = parse_bp(args.resolution)
    if not res:
        print("Error: Invalid resolution")
        return 1

    # differential clamp caps at 2000*res / 2Mb (diff_mustache.py:759-778)
    dist_bp = clamp_distance_filter(parse_bp(args.distFilter), res, diff=True)

    chr_list, chr_list2, chrSize_in_bp = _chromosome_lists(args, f1, res)
    if chr_list is None:
        return 1

    biasf1 = args.biasfile1 if args.biasfile1 and os.path.exists(args.biasfile1) else False
    if args.biasfile1 and not biasf1:
        print("Error: Couldn't find the specified bias file1")
        return 1
    biasf2 = args.biasfile2 if args.biasfile2 and os.path.exists(args.biasfile2) else False
    if args.biasfile2 and not biasf2:
        print("Error: Couldn't find the specified bias file2")
        return 1

    # validate BEFORE the process group forms (a process that errors out
    # after it strands its peers at the barrier)
    if any(str(c) != str(c2) for c, c2 in zip(chr_list, chr_list2)):
        print("Interchromosomal analysis is not supported.")
        return 1

    nprocs, procid = start_processes(args)
    from mustache_tpu_torch.runlog import RunLog
    log = RunLog(json_mode=args.json_log)
    runner = make_cli_runner(args.engine_mesh, dev, log)

    def ingest_one(chromosome, chromosome2):
        from mustache_tpu_torch.faults import maybe_fail

        attempts = max(0, args.ingest_retries) + 1
        for attempt in range(attempts):
            try:
                maybe_fail("ingest", chromosome=str(chromosome))
                chrm_size = False
                if chrSize_in_bp:
                    chrm_size = chrSize_in_bp.get(
                        "chr" + normalize_chrom(chromosome), False)
                a = load_contacts(f1, args.norm_method, chrm_size, dist_bp,
                                  chromosome, chromosome2, res, biasf1,
                                  bed=args.bed1 if args.mat1 else "")
                b = load_contacts(f2, args.norm_method, chrm_size, dist_bp,
                                  chromosome, chromosome2, res, biasf2,
                                  bed=args.bed2 if args.mat2 else "")
                return a, b
            except Exception as exc:
                if attempt + 1 == attempts:
                    raise
                log.event("ingest_retry", chromosome=str(chromosome),
                          attempt=attempt + 1, error=str(exc))
                time.sleep(0.1 * (2 ** attempt))

    manifests = None
    done = set()
    if args.resume or nprocs > 1:
        # four per-file manifests sharing one fingerprint; a unit counts
        # as completed only when ALL four parts carry a matching marker
        # (a crash between files leaves the unit incomplete -> rerun)
        from mustache_tpu_torch.manifest import RunManifest, config_fingerprint
        base_cfg = DetectionConfig(
            resolution=res, distance_bp=dist_bp, pt=args.pt, pt2=args.pt2,
            st=args.st, sigma0=args.s_z, octaves=args.octaves,
            precision=args.precision)
        fp = config_fingerprint(base_cfg, {
            "f1": os.path.abspath(f1), "f2": os.path.abspath(f2),
            "norm": str(args.norm_method),
            "bias1": os.path.abspath(biasf1) if biasf1 else "",
            "bias2": os.path.abspath(biasf2) if biasf2 else "",
            "bed1": os.path.abspath(args.bed1) if args.bed1 else "",
            "bed2": os.path.abspath(args.bed2) if args.bed2 else "",
        })
        manifests = {t: RunManifest(args.outdir + sfx, fp)
                     for t, sfx in SUFFIXES.items()}
        if args.resume:
            done = set.intersection(
                *[m.completed_chromosomes() for m in manifests.values()])
        if done:
            log.event("resume", skipping=sorted(done))

    pairs = list(zip(chr_list, chr_list2))
    if nprocs > 1:
        from mustache_tpu_torch.sharding import shard_chromosomes
        pairs = shard_chromosomes(pairs, procid, nprocs)
        log.event("shard", process=procid, nprocs=nprocs,
                  chromosomes=[str(c) for c, _ in pairs])
    pairs = [(c, c2) for c, c2 in pairs if str(c) not in done]
    if manifests is not None and not args.resume:
        # fresh run: a previous run's parts must not reach this assembly
        for m in manifests.values():
            m.invalidate([str(c) for c, _ in pairs])
    unit_order = [str(c) for c in chr_list]

    if args.engine_warmup:
        warm(dev, log)

    prof = None
    if args.profile_dir:
        prof = _profiler(args.profile_dir, dev)
        prof.start()

    # cross-chromosome software pipelining (see cli.main): chromosome
    # k+1's two-file decode overlaps chromosome k's device compute
    prefetch = None
    if not args.no_prefetch and len(pairs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        prefetch = ThreadPoolExecutor(max_workers=1)
    pending = None

    failed_units: list[str] = []
    wrote_header = False
    for i, (chromosome, chromosome2) in enumerate(pairs):
        unit_name = str(chromosome)
        ingest_err = None
        with log.phase("ingest", chromosome=unit_name,
                       prefetched=pending is not None):
            try:
                if pending is not None:
                    (x1, y1, v1, res_eff), (x2, y2, v2, res2) = \
                        pending.result()
                else:
                    (x1, y1, v1, res_eff), (x2, y2, v2, res2) = \
                        ingest_one(chromosome, chromosome2)
            except Exception as exc:  # retries exhausted inside ingest_one
                ingest_err = exc
        pending = None
        if prefetch is not None and i + 1 < len(pairs):
            pending = prefetch.submit(ingest_one, *pairs[i + 1])
        if ingest_err is not None:
            log.event("unit_failed", unit=unit_name, stage="ingest",
                      error=str(ingest_err))
            print(f"Error: chromosome {chromosome} failed after retries: "
                  f"{ingest_err}")
            failed_units.append(unit_name)
            continue
        # reference check (diff_mustache.py:614-616): whenever f2 is .cool,
        # its binsize must equal the effective resolution (the CLI -r, or
        # f1's binsize when f1 is .cool)
        if f2.endswith(".cool") and res_eff != res2:
            raise ValueError("Both contact maps should have the same resolution.")

        cfg = DetectionConfig(
            resolution=res_eff, distance_bp=dist_bp, pt=args.pt, pt2=args.pt2,
            st=args.st, sigma0=args.s_z, octaves=args.octaves,
            precision=args.precision, block_batch=args.block_batch,
        )
        t_detect = time.time()
        with log.phase("detect", chromosome=unit_name,
                       contacts=len(v1) + len(v2)):
            rows = detect_diff_loops_coo(
                x1, y1, v1, x2, y2, v2, cfg, device=dev, runner=runner,
                log=lambda m, c=unit_name: log.event(
                    "detect_plan", chromosome=c, detail=m)) \
                if len(v1) and len(v2) else []
        if len(v1) and len(v2):
            # genome Mb/s of the detect phase; both conditions are
            # ingested, normalized and scanned, so the Mb count twice
            # (as the JAX bench's diff leg counts them)
            n = max(int(max(x.max(), y.max())) + 1
                    for x, y in ((x1, y1), (x2, y2)))
            mb = 2 * n * res_eff / 1e6
            dt = max(time.time() - t_detect, 1e-9)
            log.event("throughput", chromosome=unit_name, mb=round(mb, 2),
                      mb_per_s=round(mb / dt, 3), rows=len(rows))

        counters = {1: 0, 2: 0, 3: 0, 4: 0}
        row_strs = {t: [] for t in SUFFIXES}
        for b1, b2, q, scale, tag in rows:
            counters[tag] += 1
            row_strs[tag].append(
                f"{chromosome}\t{b1*res_eff}\t{(b1+1)*res_eff}\t"
                f"{chromosome2}\t{b2*res_eff}\t{(b2+1)*res_eff}\t"
                f"{q}\t{scale}\n")
        elapsed = time.time() - start_time

        if manifests is not None:
            for t, m in manifests.items():
                m.mark_complete(unit_name, counters[t], elapsed,
                                "".join(row_strs[t]))
        else:
            if not wrote_header:
                wrote_header = True
                for sfx in SUFFIXES.values():
                    with open(args.outdir + sfx, "w") as out:
                        out.write(HEADER)
            for t, sfx in SUFFIXES.items():
                if row_strs[t]:
                    with open(args.outdir + sfx, "a") as out:
                        out.write("".join(row_strs[t]))

        if not rows:
            # reference prints the plain count line and skips the counters
            # line for empty chromosomes (diff_mustache.py:865-869)
            print("0 loops found for chrmosome={0}, fdr<{1} in {2}sec".format(
                chromosome, args.pt, "%.2f" % elapsed))
        else:
            print(f"({counters[1]},{counters[3]}) loops and "
                  f"({counters[2]},{counters[4]}) differential-loops found "
                  f"in chrmosome={chromosome} for detection-fdr<{args.pt} "
                  f"and difference-fdr<{args.pt2} in {elapsed:.2f}sec")
        start_time = time.time()

    if prefetch is not None:
        prefetch.shutdown(wait=False)
    if nprocs > 1:
        finish_processes(nprocs, procid, lambda: [
            m.assemble(unit_order, HEADER) for m in manifests.values()])
    elif manifests is not None:
        for m in manifests.values():
            m.assemble(unit_order, HEADER)
        if not failed_units:
            for m in manifests.values():
                m.cleanup(unit_order)
    if prof is not None:
        prof.stop()
    if failed_units:
        print("Error: {0} chromosome(s) failed after retries: {1}{2}".format(
            len(failed_units), ", ".join(failed_units),
            " (rerun with --engine-resume to retry exactly these)"
            if manifests is not None else ""))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
