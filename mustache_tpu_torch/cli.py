"""``mustache``-compatible command-line interface of the PyTorch/CUDA port.

Torch port of ``mustache_tpu/cli.py`` (single-map: ``build_parser``,
``_chromosome_lists`` :209-258, ``load_contacts`` :261-287 and ``main``
:290-577). Flags, defaults, error messages, chromosome discovery and the
output TSV mirror the reference driver (mustache.py:52-178 for the
parser, :963-1111 for the main flow); engine-only extras are prefixed
``--engine-*``. The run goes on the card unless ``--engine-platform cpu``
asks for the CPU; without CUDA it raises.

``--engine-precision float64`` runs the float64 route: the host
normalize and the ladder in float64 (``detect.resolve_route``). A
``-ch2`` chromosome that differs from its ``-ch`` one is an
inter-chromosomal unit (``inter.detect_inter_loops_coo``), from ``.hic``,
``.cool`` or ``.mcool`` input; from text or HiC-Pro input it prints the
reference's gate message and is recorded as a failed unit, as in the JAX
CLI.

``--engine-mesh`` (``make_cli_runner``, ``sharding.py``): ``auto`` splits
each chromosome's blocks over every visible CUDA device when there is
more than one, ``block`` (the band on every device) and ``rowshard``
(each device holds only its blocks' rows of it) force a mesh, of one
entry on one device; ``off`` runs on one device. The inter path takes no
mesh, as in the JAX CLI. ``--engine-nprocs N`` runs N processes (one per
host or per card; each meshes over the CUDA devices it sees) joined by a
``gloo`` group at ``--engine-coordinator host:port``: each process takes
every N-th unit, writes its part files through the manifest, and after a
barrier process 0 assembles the output (``mustache_tpu/cli.py:346-378,
553-557``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from mustache_tpu_torch.config import DetectionConfig, clamp_distance_filter, parse_bp
from mustache_tpu_torch.device import resolve_device
from mustache_tpu_torch.io.bias import read_bias
from mustache_tpu_torch.io.chrom import normalize_chrom, read_chrom_sizes
from mustache_tpu_torch.io.text import read_text_contacts
from mustache_tpu_torch.inter import detect_inter_loops_coo
from mustache_tpu_torch.pipeline import Loop, detect_loops_coo

HEADER = ("BIN1_CHR\tBIN1_START\tBIN1_END\tBIN2_CHROMOSOME\t"
          "BIN2_START\tBIN2_END\tFDR\tDETECTION_SCALE\n")
# --engine-platform value -> device ("" is the card)
PLATFORMS = {"": None, "cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def build_parser(diff: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Multi-scale chromatin loop detection on an NVIDIA GPU "
                    "(reference-compatible flags)")
    if diff:
        p.add_argument("-f1", "--file1", dest="f_path1", required=False,
                       help="first condition's contact map "
                            "(.hic/.cool/.mcool/text)")
        p.add_argument("-f2", "--file2", dest="f_path2", required=False,
                       help="second condition's contact map")
    else:
        p.add_argument("-f", "--file", dest="f_path", required=False,
                       help="contact map (.hic/.cool/.mcool/text)")
    p.add_argument("-d", "--distance", dest="distFilter", required=False,
                   help="largest anchor separation tested, in bp "
                        "(clamped to the reference's bounds)")
    p.add_argument("-o", "--outfile", dest="outdir", required=True,
                   help="output TSV path")
    p.add_argument("-r", "--resolution", dest="resolution", required=True,
                   help="bin size, e.g. 5kb or 5000 (.cool overrides this "
                        "with its own bin size)")
    if diff:
        p.add_argument("-bed1", "--bed1", dest="bed1", default="",
                       help="HiC-Pro bed (condition 1)")
        p.add_argument("-m1", "--matrix1", dest="mat1", default="",
                       help="HiC-Pro matrix (condition 1)")
        p.add_argument("-b1", "--biases1", dest="biasfile1", required=False,
                       help="ICE/KR bias vector for condition 1")
        p.add_argument("-bed2", "--bed2", dest="bed2", default="",
                       help="HiC-Pro bed (condition 2)")
        p.add_argument("-m2", "--matrix2", dest="mat2", default="",
                       help="HiC-Pro matrix (condition 2)")
        p.add_argument("-b2", "--biases2", dest="biasfile2", required=False,
                       help="ICE/KR bias vector for condition 2")
    else:
        p.add_argument("-bed", "--bed", dest="bed", default="",
                       help="HiC-Pro bed file (use with -m)")
        p.add_argument("-m", "--matrix", dest="mat", default="",
                       help="HiC-Pro matrix file (use with -bed)")
        p.add_argument("-b", "--biases", dest="biasfile", required=False,
                       help="per-locus ICE/KR bias vector; raw text counts "
                            "are divided by the factor at both anchors")
    p.add_argument("-cz", "--chromosomeSize", default="", dest="chrSize_file",
                   help="chromosome-sizes file (two columns: name, bp); "
                        "needed for text input without explicit sizes",
                   required=False)
    p.add_argument("-norm", "--normalization", default=False, dest="norm_method",
                   help=".hic norm vector name (KR, VC, SCALE, ...) or the "
                        "cooler balance column",
                   required=False)
    p.add_argument("-st", "--sparsityThreshold", dest="st", type=float,
                   default=0.88,
                   help="local-support fraction below which a candidate is "
                        "discarded; lower it (e.g. 0.8) for sparse maps "
                        "(default 0.88)")
    p.add_argument("-pt", "--pThreshold", dest="pt", type=float, default=0.2,
                   help="FDR (BH q-value) cutoff for reported loops "
                        "(default 0.2)")
    if diff:
        p.add_argument("-pt2", "--pThreshold2", dest="pt2", type=float,
                       default=0.1,
                       help="FDR cutoff for the differential calls "
                            "(default 0.1)")
    p.add_argument("-sz", "--sigmaZero", dest="s_z", type=float, default=1.6,
                   help="base scale sigma0 of the Gaussian ladder "
                        "(default 1.6, tuned for 5kb)")
    p.add_argument("-oc", "--octaves", dest="octaves", default=2, type=int,
                   help="number of scale-space octaves (default 2)")
    p.add_argument("-i", "--iterations", dest="s", default=10, type=int,
                   help="accepted for compatibility; the ladder depth is "
                        "fixed at 10 as in the reference (the flag is inert "
                        "there too, mustache.py:711)")
    p.add_argument("-p", "--processes", dest="nprocesses", default=4, type=int,
                   help="accepted for compatibility; the engine "
                        "parallelizes blocks on the device instead of forking")
    p.add_argument("-ch", "--chromosome", dest="chromosome", nargs="+",
                   default="n",
                   help="chromosome(s) to analyze; auto-discovered for "
                        ".hic/.cool/.mcool inputs")
    p.add_argument("-ch2", "--chromosome2", dest="chromosome2", nargs="+",
                   default="n",
                   help="second chromosome list, paired with -ch in "
                        "order: " + ("a pair that differs stops the run "
                                     "(interchromosomal analysis is not "
                                     "supported)" if diff else
                                     "inter-chromosomal analysis where they "
                                     "differ (.hic/.cool/.mcool input)"))
    p.add_argument("-v", "--verbose", dest="verbose", type=bool, default=True,
                   help="accepted for compatibility (the reference never "
                        "consults it, mustache.py:171-177)")
    # engine extras (no reference counterpart)
    p.add_argument("--engine-precision", dest="precision", default="float32",
                   choices=["float32", "float64"],
                   help="Numerics of the detection core: float32 (the fused "
                        "kernel, device normalize) or float64 (host "
                        "normalize and the ladder in float64, the "
                        "reference-exact golden mode).")
    p.add_argument("--engine-block-batch", dest="block_batch", type=int,
                   default=0, help="Blocks per device batch (0 = auto).")
    p.add_argument("--engine-profile-dir", dest="profile_dir", default="",
                   help="Write a torch.profiler trace of the run to this "
                        "dir (TensorBoard's trace format).")
    p.add_argument("--engine-resume", dest="resume", action="store_true",
                   help="Checkpoint per chromosome and skip chromosomes "
                        "already completed by a previous (crashed) run with "
                        "the same output path and parameters.")
    p.add_argument("--engine-json-log", dest="json_log", action="store_true",
                   help="Structured JSON event log on stderr.")
    p.add_argument("--engine-no-prefetch", dest="no_prefetch",
                   action="store_true",
                   help="Disable the one-chromosome ingest lookahead "
                        "(by default the next chromosome's file decode "
                        "overlaps the current chromosome's detection).")
    p.add_argument("--engine-warmup", dest="engine_warmup",
                   action="store_true",
                   help="Build the native libraries and (on the card) the "
                        "CUDA kernel before ingest starts "
                        "(mustache_tpu_torch.warmup), so the first "
                        "chromosome's time excludes the builds.")
    p.add_argument("--engine-ingest-retries", dest="ingest_retries",
                   type=int, default=2,
                   help="Retries per chromosome on ingest errors before "
                        "the chromosome is recorded as failed and skipped "
                        "(the run continues; rerun with --engine-resume "
                        "to retry failed chromosomes).")
    p.add_argument("--engine-platform", dest="platform", default="",
                   choices=sorted(PLATFORMS),
                   help="Device to run on: empty (the default), 'cuda' or "
                        "'gpu' mean the card; 'cpu' runs the plain PyTorch "
                        "versions on the CPU.")
    p.add_argument("--engine-mesh", dest="engine_mesh", default="auto",
                   choices=["auto", "block", "rowshard", "off"],
                   help="Multi-GPU placement: 'auto' splits the blocks over "
                        "every visible CUDA device when there is more than "
                        "one; 'block' (band replicated) and 'rowshard' "
                        "(each device holds its blocks' rows) always mesh; "
                        "'off' runs on one device.")
    p.add_argument("--engine-coordinator", dest="coordinator", default="",
                   help="host:port of process 0 for multi-process runs "
                        "(env MTPU_COORDINATOR).")
    p.add_argument("--engine-nprocs", dest="engine_nprocs", type=int,
                   default=0, help="Total engine processes in a multi-"
                                   "process run (env MTPU_NPROCS); each "
                                   "takes every N-th unit.")
    p.add_argument("--engine-procid", dest="engine_procid", type=int,
                   default=-1, help="This process's id in a multi-host run "
                                    "(env MTPU_PROCID).")
    return p


def resolve_distributed(args):
    """(coordinator, nprocs, procid) from flags, falling back to env."""
    nprocs = args.engine_nprocs or int(os.environ.get("MTPU_NPROCS", "1"))
    procid = args.engine_procid if args.engine_procid >= 0 else \
        int(os.environ.get("MTPU_PROCID", "0"))
    coordinator = args.coordinator or os.environ.get("MTPU_COORDINATOR", "")
    return coordinator or None, nprocs, procid


def parse_args(argv):
    return build_parser(diff=False).parse_args(argv)


def make_cli_runner(mode: str, dev, log=None):
    """The sharded runner of ``--engine-mesh`` (``mustache_tpu/cli.py:
    185-202``): a (block, row=1) mesh over this process's devices (every
    visible CUDA device; the CPU is one device). ``auto`` meshes only when
    there is more than one, ``block`` and ``rowshard`` always (a one-entry
    mesh on one device). None when meshing is off."""
    if mode == "off":
        return None
    from mustache_tpu_torch.sharding import make_mesh, make_runner

    if dev.type == "cuda":
        import torch
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    if mode == "auto" and len(devices) <= 1:
        return None
    placement = "rowshard" if mode == "rowshard" else "replicate"
    runner = make_runner(make_mesh(devices=devices), placement, log=log)
    if log is not None:
        log.event("mesh", devices=[str(d) for d in runner.devices],
                  placement=placement)
    return runner


def start_processes(args):
    """``(nprocs, procid)`` of this run, after joining the process group
    when there is more than one process."""
    coordinator, nprocs, procid = resolve_distributed(args)
    if nprocs > 1:
        from mustache_tpu_torch.sharding import initialize_distributed
        initialize_distributed(coordinator, nprocs, procid)
    return nprocs, procid


def finish_processes(nprocs: int, procid: int, assemble) -> None:
    """After every process has written its part files (the barrier),
    process 0 calls ``assemble()``; then the group is left."""
    from mustache_tpu_torch.sharding import barrier, finalize_distributed

    barrier("mustache-tpu-parts-complete")
    if procid == 0:
        assemble()
    finalize_distributed()


def _chromosome_lists(args, f, res):
    """Chromosome discovery, mirroring mustache.py:979-1054."""
    chrSize_in_bp = False
    chr_list = None
    if not args.chromosome or args.chromosome == "n":
        if f.endswith(".cool") or f.endswith(".mcool"):
            from mustache_tpu_torch.io.cool import cool_chrom_list
            chr_list = cool_chrom_list(f, res if f.endswith(".mcool") else None)
        elif not f.endswith(".hic"):
            print("Error: Please enter the chromosome name.")
            return None, None, None
    else:
        chr_list = list(args.chromosome)
    if (f.endswith(".cool") or f.endswith(".mcool")) and not chrSize_in_bp:
        from mustache_tpu_torch.io.cool import CoolFile
        clr = CoolFile(f, resolution=res if f.endswith(".mcool") else None)
        try:
            chrSize_in_bp = {
                "chr" + normalize_chrom(nm): int(sz)
                for nm, sz in zip(clr.chromnames, clr.chromsizes)}
        finally:
            clr.close()
    if f.endswith(".hic") and (chr_list is None or not chrSize_in_bp):
        # one open serves both discovery and sizes; always closed
        from mustache_tpu_torch.io.hic import HicFile
        hic = HicFile(f)
        try:
            if chr_list is None:
                chr_list = [c.name for c in hic.chromosomes[1:]]
            chrSize_in_bp = {
                "chr" + normalize_chrom(c.name): c.length
                for c in hic.chromosomes[1:]
            }
        finally:
            hic.close()

    if (args.chromosome2 and args.chromosome2 != "n") and \
            len(chr_list) != len(args.chromosome2):
        print("Error: the same number of chromosome1 and chromosome2 should be provided.")
        return None, None, None
    if isinstance(args.chromosome2, list):
        chr_list2 = list(args.chromosome2)
    else:
        chr_list2 = list(chr_list)

    if args.chrSize_file and not chrSize_in_bp:
        chrSize_in_bp = read_chrom_sizes(args.chrSize_file)
    return chr_list, chr_list2, chrSize_in_bp


def _unit(chromosome, chromosome2) -> str:
    """A run's unit of restart: the chromosome, or ``c1__x__c2`` for an
    inter-chromosomal pair (the JAX CLI's naming)."""
    if chromosome == chromosome2:
        return str(chromosome)
    return f"{chromosome}__x__{chromosome2}"


def load_contacts(f, norm_method, chrm_size, distance_bp, chromosome,
                  chromosome2, res, biasfile, bed=""):
    """Format dispatch (mustache.py:879-886). Returns (x, y, v, res).

    ``bed`` non-empty routes to the working HiC-Pro reader (the reference
    accepts -bed/-m but ignores the bed and misparses the matrix,
    mustache.py:969-970 + :282-288 — beyond-reference fix)."""
    if bed:
        from mustache_tpu_torch.io.hicpro import read_hicpro
        bias = read_bias(biasfile, chromosome, res)
        x, y, v = read_hicpro(f, bed, distance_bp, bias, chromosome, res)
    elif f.endswith(".hic"):
        from mustache_tpu_torch.io.hic import read_hic_file
        x, y, v = read_hic_file(
            f, norm_method, chrm_size, distance_bp, chromosome, chromosome2, res)
    elif f.endswith(".cool"):
        from mustache_tpu_torch.io.cool import read_cooler
        x, y, v, res = read_cooler(f, distance_bp, chromosome, chromosome2,
                                   norm_method)
    elif f.endswith(".mcool"):
        from mustache_tpu_torch.io.cool import read_mcooler
        x, y, v = read_mcooler(f, distance_bp, chromosome, chromosome2, res,
                               norm_method)
    else:
        bias = read_bias(biasfile, chromosome, res)
        x, y, v = read_text_contacts(f, distance_bp, bias, chromosome, res)
    return x, y, v, res


def warm(dev, log) -> None:
    """Build the native libraries and, on the card, the fused kernel
    (``warmup.warm``: the port's counterpart of the JAX package's AOT
    warmup; nothing compiles per shape here)."""
    from mustache_tpu_torch import warmup

    with log.phase("warmup", device=str(dev)):
        warmup.warm(dev)


def _profiler(profile_dir: str, dev):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))


def main(argv=None):
    start_time = time.time()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(PLATFORMS[args.platform])   # no CUDA: raises
    print("\n")

    f = args.f_path
    if args.bed and args.mat:
        f = args.mat
    if not f or not os.path.exists(f):
        print("Error: Couldn't find the specified contact files")
        return 1
    res = parse_bp(args.resolution)
    if not res:
        print("Error: Invalid resolution")
        return 1

    dist_bp = clamp_distance_filter(parse_bp(args.distFilter), res)

    chr_list, chr_list2, chrSize_in_bp = _chromosome_lists(args, f, res)
    if chr_list is None:
        return 1

    biasf = False
    if args.biasfile:
        if os.path.exists(args.biasfile):
            biasf = args.biasfile
        else:
            print("Error: Couldn't find specified bias file")
            return 1

    nprocs, procid = start_processes(args)
    from mustache_tpu_torch.runlog import RunLog
    log = RunLog(json_mode=args.json_log)
    runner = make_cli_runner(args.engine_mesh, dev, log)

    prof = None
    if args.profile_dir:
        prof = _profiler(args.profile_dir, dev)
        prof.start()

    manifest = None
    done = set()
    if args.resume or nprocs > 1:
        # a multi-process run always goes through the manifest: each
        # process writes its units' part files, process 0 assembles them
        # after the barrier
        from mustache_tpu_torch.manifest import RunManifest, config_fingerprint
        base_cfg = DetectionConfig(
            resolution=res, distance_bp=dist_bp, pt=args.pt, st=args.st,
            sigma0=args.s_z, octaves=args.octaves, precision=args.precision)
        # the fingerprint must cover everything that shapes the VALUES in
        # a part file, or resume would mix results computed under
        # different normalizations into one output
        manifest = RunManifest(
            args.outdir, config_fingerprint(base_cfg, {
                "f": os.path.abspath(f),
                "norm": str(args.norm_method),
                "bias": os.path.abspath(biasf) if biasf else "",
                "bed": os.path.abspath(args.bed) if args.bed else "",
            }))
        if args.resume:
            done = manifest.completed_chromosomes()
        if done:
            log.event("resume", skipping=sorted(done))
    else:
        with open(args.outdir, "w") as out:
            out.write(HEADER)

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
                return load_contacts(f, args.norm_method, chrm_size, dist_bp,
                                     chromosome, chromosome2, res, biasf,
                                     bed=args.bed if args.mat else "")
            except Exception as exc:
                if attempt + 1 == attempts:
                    raise
                log.event("ingest_retry", chromosome=str(chromosome),
                          attempt=attempt + 1, error=str(exc))
                time.sleep(0.1 * (2 ** attempt))

    pairs = list(zip(chr_list, chr_list2))
    if nprocs > 1:
        from mustache_tpu_torch.sharding import shard_chromosomes
        pairs = shard_chromosomes(pairs, procid, nprocs)
        log.event("shard", process=procid, nprocs=nprocs,
                  chromosomes=[_unit(c, c2) for c, c2 in pairs])
    todo = [(c, c2, _unit(c, c2)) for c, c2 in pairs
            if _unit(c, c2) not in done]
    if manifest and not args.resume:
        # fresh run: a previous run's parts must not reach this assembly
        manifest.invalidate([u for _, _, u in todo])

    if args.engine_warmup:
        warm(dev, log)

    # cross-chromosome software pipelining: chromosome k+1's file decode
    # (disk + zlib + bias math, all host-side) runs on a worker thread
    # while chromosome k detects on the device. One-deep lookahead bounds
    # peak memory to two chromosomes' COO triplets.
    prefetch = None
    if not args.no_prefetch and len(todo) > 1:
        from concurrent.futures import ThreadPoolExecutor
        prefetch = ThreadPoolExecutor(max_workers=1)
    pending = None
    failed_units: list[str] = []

    for i, (chromosome, chromosome2, unit_name) in enumerate(todo):
        inter = chromosome != chromosome2
        if inter and not f.endswith((".hic", ".cool", ".mcool")):
            # reference gate (mustache.py:869-871), recorded as a failed
            # unit as the JAX CLI does; the pending prefetch (THIS unit's
            # ingest) is discarded and the next unit's submitted, or unit
            # i+1 would consume unit i's contacts
            print("Interchromosomal analysis is only supported for .hic "
                  "and .cool input formats.")
            log.event("unit_failed", unit=unit_name, stage="gate",
                      error="inter-chromosomal needs .hic/.cool input")
            failed_units.append(unit_name)
            if pending is not None:
                try:
                    pending.result()
                except Exception:
                    pass
            pending = None
            if prefetch is not None and i + 1 < len(todo):
                pending = prefetch.submit(ingest_one, *todo[i + 1][:2])
            continue

        ingest_err = None
        with log.phase("ingest", chromosome=str(chromosome),
                       prefetched=pending is not None):
            try:
                if pending is not None:
                    x, y, v, res_eff = pending.result()
                else:
                    x, y, v, res_eff = ingest_one(chromosome, chromosome2)
            except Exception as exc:  # retries exhausted inside ingest_one
                ingest_err = exc
        pending = None
        if prefetch is not None and i + 1 < len(todo):
            pending = prefetch.submit(ingest_one, *todo[i + 1][:2])
        if ingest_err is not None:
            # elastic recovery: the chromosome is the unit of restart —
            # record the failure, keep the run alive, let a later
            # --engine-resume rerun retry exactly this unit
            log.event("unit_failed", unit=unit_name, stage="ingest",
                      error=str(ingest_err))
            failed_units.append(unit_name)
            continue

        cfg = DetectionConfig(
            resolution=res_eff, distance_bp=dist_bp, pt=args.pt, st=args.st,
            sigma0=args.s_z, octaves=args.octaves, precision=args.precision,
            block_batch=args.block_batch,
        )
        t_detect = time.time()
        try:
            with log.phase("detect", chromosome=str(chromosome),
                           contacts=len(v)):
                if not len(v):
                    loops = []
                elif inter:
                    # beyond the reference: working inter-chromosomal
                    # detection (its path crashes, mustache.py:689-694)
                    rows_i = detect_inter_loops_coo(
                        x, y, v, cfg, device=dev,
                        log=lambda m, c=unit_name: log.event(
                            "detect_plan", chromosome=c, detail=m))
                    loops = [Loop(int(r[0]), int(r[1]), float(r[2]),
                                  float(r[3])) for r in rows_i]
                else:
                    loops = detect_loops_coo(
                        x, y, v, cfg, device=dev, runner=runner,
                        log=lambda m, c=str(chromosome): log.event(
                            "detect_plan", chromosome=c, detail=m))
        except Exception as exc:
            log.event("unit_failed", unit=unit_name, stage="detect",
                      error=str(exc))
            failed_units.append(unit_name)
            continue

        if len(v):
            # throughput counters (genome Mb/s of the detect phase)
            mb = (int(max(x.max(), y.max())) + 1) * res_eff / 1e6
            dt = max(time.time() - t_detect, 1e-9)
            log.event("throughput", chromosome=str(chromosome),
                      mb=round(mb, 2), mb_per_s=round(mb / dt, 3),
                      loops=len(loops))

        rows = "".join(lp.to_row(chromosome, chromosome2, res_eff)
                       for lp in loops)
        elapsed = time.time() - start_time
        print("{0} loops found for chrmosome={1}, fdr<{2} in {3}sec".format(
            len(loops), chromosome, args.pt, "%.2f" % elapsed))
        if manifest:
            manifest.mark_complete(unit_name, len(loops), elapsed, rows)
        elif rows:
            with open(args.outdir, "a") as out:
                out.write(rows)
        start_time = time.time()

    if prefetch is not None:
        prefetch.shutdown(wait=False)
    unit_order = [_unit(c, c2) for c, c2 in zip(chr_list, chr_list2)]
    if nprocs > 1:
        # multi-process runs keep their parts: process 0 cannot see its
        # peers' failures
        finish_processes(nprocs, procid,
                         lambda: manifest.assemble(unit_order, HEADER))
    elif manifest:
        manifest.assemble(unit_order, HEADER)
        if not failed_units:
            # fully-successful run: the parts served their purpose;
            # leaving them would only feed stale data to later
            # differently-failing runs
            manifest.cleanup(unit_order)

    if prof is not None:
        prof.stop()
    if failed_units:
        print("Error: {0} chromosome(s) failed after retries: {1}{2}".format(
            len(failed_units), ", ".join(failed_units),
            " (rerun with --engine-resume to retry exactly these)"
            if manifest else ""))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
