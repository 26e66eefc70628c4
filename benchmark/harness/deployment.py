"""What the traffic kinds share: a deployment's settings, its maps, and
what the fused kernel needs for them."""

from __future__ import annotations

from benchmark.harness import flops, mapgen
from benchmark.reference.chromosome import Deployment, chunk_grid

def make_maps(cell, seed: int, device) -> list[dict]:
    """Each map of the cell's traffic as ``{"chrom", "n_bins", "x", "y",
    "v"}``, made from ``seed`` plus the map's ``seed_offset``. The
    traffic's ``depth`` gives the genome's contacts and loops, which a
    chromosome takes in proportion to its length ``bp``."""
    dep = Deployment(cell.config)
    depth = cell.traffic["depth"]
    out = []
    for m in cell.traffic["maps"]:
        bp = int(m["bp"])
        share = bp / float(depth["genome_bp"])
        n_bins = -(-bp // dep.resolution)
        x, y, v = mapgen.make_map(
            n_bins, dep.d_px, seed=int(seed) + int(m.get("seed_offset", 0)),
            device=device, contacts=float(depth["genome_contacts"]) * share,
            exponent=float(depth["exponent"]),
            n_loops=round(float(depth["genome_loops"]) * share),
            loop_strength=float(depth["loop_strength"]))
        out.append({"chrom": m["chrom"], "n_bins": n_bins,
                    "x": x, "y": y, "v": v})
    return out


def blocks_of(x, y, dep: Deployment) -> int:
    n = int(max(x.max(), y.max())) + 1
    return len(chunk_grid(n, dep.chunk, dep.d_px)[0])


def fused_work(cfg: dict, blocks: int) -> tuple[float, float]:
    """``(FLOP, bytes)`` the fused kernel needs for ``blocks`` blocks of
    the deployment."""
    dep = Deployment(cfg)
    return flops.fused_ladder_work(
        dep.chunk, flops.band_diagonals(dep.chunk, dep.d_px),
        float(cfg["sigma0"]), int(cfg["octaves"]), blocks)


def program_config(cfg: dict):
    """The program's ``DetectionConfig`` for a deployment."""
    from mustache_tpu_torch import DetectionConfig

    return DetectionConfig(
        resolution=int(cfg["resolution"]),
        distance_bp=int(cfg["distance_bp"]), pt=float(cfg["pt"]),
        pt2=float(cfg.get("pt2", 0.1)), st=float(cfg["st"]),
        sigma0=float(cfg["sigma0"]), octaves=int(cfg["octaves"]),
        precision=cfg["precision"])
