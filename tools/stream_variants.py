#!/usr/bin/env python3
"""Variants of the fused kernel's streamed mode, timed on the card beside
the committed one.

The streamed mode (``mustache_tpu_torch/kernels/csrc/fused_ladder.cu``)
computes a sigma's vertical pass once per cluster, each rank a share of
the columns; each CTA's horizontal pass then needs 66 + 2r of those
columns, which the kernel copies after the sigma's cluster barrier from
the ranks that hold them into a local buffer (16-byte loads through
distributed shared memory) and runs the pass from there. Each variant is
made from the committed source by text substitution (it asserts the exact
text it replaces, so an edit of the kernel that moves it fails here
loudly) and built beside it:

* ``dsmem``: the other way to feed the horizontal pass, reading the
  ranks' shares in the pass itself (``map_shared_rank`` pointers: a
  4-column group never straddles two 64-column pieces, and a pass
  segment spans at most two): no local copy, but every input of the pass
  crosses the SM-to-SM network (the pass reads each column 10 + 2r times
  over its rows' taps, the copy once). Checked bit-identical to the
  committed kernel on every shape;
* ``cluster-C`` (C = 2, 3, 5, 6, 8): clusters of C CTAs instead of the
  kernel's ``CLUSTER`` (the wrapper's ``fused_ladder.CLUSTER`` set to
  match while the variant runs, so that its shared memory and grid
  follow). Checked bit-identical to the committed kernel on every shape;
  each prints its CTAs per SM and resident clusters (the CUDA occupancy
  API);
* ablations, for timing only (their outputs are wrong): ``no-vpass``
  (the vertical pass's FMAs skipped), ``no-hpass`` (the copy's barrier
  kept, the horizontal pass and NMS skipped), ``no-copy`` and
  ``no-fetch`` (no chunk copied; the mbarriers still complete). What a
  part costs is the committed kernel's time less the variant's. (Skipping
  the chunk waits is no ablation: a CTA could then exit with tensor
  copies still writing its shared memory.)

The committed kernel and each variant run in turns (committed, variants,
variants reversed, committed; CUDA events, ten launches after one) on
``chip_smoke.py`` phase 3's streamed shapes. Needs a CUDA card; imports
nothing of JAX.

    python tools/stream_variants.py [--variants dsmem cluster-2 cluster-3
        cluster-5 cluster-6 cluster-8 no-vpass no-hpass no-copy no-fetch]
        [--shapes 5kb-oct5 5kb-s3oct4 1kb-oct5]

Run one variant a process where they are ablations: a variant whose
launch faults leaves the process's CUDA context unusable.
"""

import argparse
import ctypes
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402

SRC = Path(ROOT) / "mustache_tpu_torch" / "kernels" / "csrc" / "fused_ladder.cu"

# the horizontal pass reading the ranks' shares: union column u of row g
# is rank (u / 64) % C's share column 64 ((u / 64) / C) + u % 64
HPASS_DSMEM = r'''
template <int L>
__device__ __forceinline__ void hpass_d(float (&acc)[HW], const float* w,
                                        const float* row, int u0, int C,
                                        int npieces) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int P0 = u0 / PW;
  const int P1 = P0 + 1 < npieces ? P0 + 1 : P0;
  const float* pa = cluster.map_shared_rank(row, P0 % C) + PW * (P0 / C - P0);
  const float* pb = cluster.map_shared_rank(row, P1 % C) + PW * (P1 / C - P1);
  float wr[16];
  float4 v;
#pragma unroll
  for (int q = 0; q < HW + L - 1; ++q) {
    tap_block<L>(wr, w, q);
    if (q % 4 == 0) {
      const int u = u0 + q;
      v = *reinterpret_cast<const float4*>((u < PW * (P0 + 1) ? pa : pb) + u);
    }
    const float xv = q % 4 == 0 ? v.x : q % 4 == 1 ? v.y : q % 4 == 2 ? v.z
                                                                     : v.w;
#pragma unroll
    for (int o = 0; o < HW; ++o) {
      const int t = q - o;
      if (t >= 0 && t < L) acc[o] = fmaf(wr[t % 16], xv, acc[o]);
    }
  }
}

__device__ __forceinline__ void hpass_dn(int L, float (&acc)[HW],
                                         const float* w, const float* row,
                                         int u0, int C, int npieces) {
  switch (L) {
#define MTT_CASE(n) \
  case n: hpass_d<n>(acc, w, row, u0, C, npieces); break;
    MTT_TAP_COUNTS(MTT_CASE)
#undef MTT_CASE
  }
}

'''


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the kernel source no longer holds, once:\n{old}")
    return text.replace(old, new)


def dsmem_variant(src: str) -> str:
    """The committed source with the horizontal pass reading the shares."""
    anchor = "// The tile's band cells band[b, i - row0, j - i]"
    out = substitute(src, anchor, HPASS_DSMEM + anchor)
    start = out.index("        // this tile's tmp columns: union columns")
    end = out.index("      // blur at row g, blur columns")
    out = out[:start] + "      }\n\n" + out[end:]
    out = substitute(
        out,
        "          hpass_wn(min(SEG, nt - t0), G, w + t0, x + t0);",
        "          hpass_dn(min(SEG, nt - t0), G, w + t0,\n"
        "                   s_share + (sig & 1) * GR * WP + g * WP,\n"
        "                   TC * rank + CELLS * warp + t0, C,\n"
        "                   (TC * m + 2 + 2 * r + PW - 1) / PW);")
    return out


CLUSTERS = (2, 3, 5, 6, 8)
CHECKED = ("dsmem",) + tuple(f"cluster-{c}" for c in CLUSTERS)


def variants(src: str) -> dict:
    """Each variant's source."""
    vpass = "              vpass_wn(min(SEG, nt - t0), acc, w + t0,"
    nohpass = "        __syncthreads();\n      }\n\n      // blur at row g"
    copy = ("        for (int e = tid; e < GR * nq; e += THREADS) {\n"
            "          const int gg")
    tma = ("      mbar_arrive_tx(bar, (mirror ? 2 * CH - 1 : CH) * RP * 4);\n"
           "      tma_load(dst, tm_chunk, g4, row_lo - base, b, bar);\n"
           "      if (mirror) tma_load(mirror, tm_mirror, g4, row_lo - base, "
           "b, bar);")
    cp = ("    const int pr = threadIdx.x >> 3, q0 = threadIdx.x & 7;\n"
          "    if (pr < rows) {")
    nofetch = substitute(src, tma, "      mbar_arrive(bar);")
    nofetch = substitute(nofetch, cp, cp.replace("pr < rows", "false"))
    return {
        "dsmem": dsmem_variant(src),
        "no-vpass": substitute(src, vpass, vpass.replace("vpass_wn",
                                                         "if (0) vpass_wn")),
        "no-hpass": substitute(src, nohpass, nohpass.replace(
            "__syncthreads();\n", "__syncthreads();\n        continue;\n")),
        "no-copy": substitute(src, copy, copy.replace("e < GR * nq",
                                                      "0 && e < GR * nq")),
        "no-fetch": nofetch,
        **{f"cluster-{c}": substitute(src, "constexpr int CLUSTER = 4;",
                                      f"constexpr int CLUSTER = {c};")
           for c in CLUSTERS},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["dsmem"],
                    choices=list(CHECKED) + ["no-vpass", "no-hpass",
                                             "no-copy", "no-fetch"])
    ap.add_argument("--shapes", nargs="+",
                    default=["5kb-oct5", "5kb-s3oct4", "1kb-oct5"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    import chip_smoke as C
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.kernels import build
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.scalespace import (
        build_ladder, ladder_tensor, radii_tensor,
    )

    sources = variants(SRC.read_text())
    report = {"device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(args.variants) + 1) as pool:
        # one nvcc a source, all started together
        builds = {"committed": ("fused_ladder", None)}
        for name in args.variants:
            path = Path(tmp) / f"fused_ladder_{name.replace('-', '_')}.cu"
            path.write_text(sources[name])
            builds[name] = (f"fused_ladder_{name.replace('-', '_')}", path)
        futures = {name: pool.submit(build.build, *nb)
                   for name, nb in builds.items()}
        libs = {name: f.result() for name, f in futures.items()}
        for name, nb in builds.items():
            report[f"ptxas_{name}"] = spills(build.build_log(*nb))
    cluster = fl.CLUSTER
    order = ["committed"] + args.variants + args.variants[::-1] + ["committed"]
    dev = torch.device("cuda")
    for label, N, d_px, res, n_bins, starts, octaves in C.SHAPES:
        if label not in args.shapes:
            continue
        spec = build_ladder(octaves)
        taps = ladder_tensor(spec.kernels, dev)
        radii = radii_tensor(spec.blur_sigmas, dev)
        cs, nzf, _ = C.synthetic_blocks(dev, N, d_px, res, n_bins, starts,
                                        seed=7)
        kw = dict(R=spec.radius, n_octaves=len(octaves), planes_per_octave=9,
                  DB=band_width(N, d_px),
                  valid=torch.tensor(C.VALID, dtype=torch.int32, device=dev))
        outs, times, occ = {}, {}, {}
        for name in order:
            build._LOADED["fused_ladder"] = fl.bind(ctypes.CDLL(
                str(libs[name])))
            fl.CLUSTER = (int(name.split("-")[1])
                          if name.startswith("cluster-") else cluster)
            outs[name] = fl.fused_ladder_nms_batched(cs, nzf, taps,
                                                     radii=radii, **kw)
            times.setdefault(name, []).append(C.cuda_ms(
                lambda: fl.fused_ladder_nms_batched(cs, nzf, taps,
                                                    radii=radii, **kw),
                reps=10))
            occ[name] = fl.occupancy(kw["R"], kw["n_octaves"], dev) + (
                fl.smem_bytes(kw["R"], kw["n_octaves"]),)
        fl.CLUSTER = cluster
        checked = [k for k in CHECKED if k in outs]
        for name in checked:
            if not all(torch.equal(a, b)
                       for a, b in zip(outs["committed"], outs[name])):
                raise SystemExit(f"{label}: the {name} variant differs")
        report[label] = {"ms": times, "ctas_per_sm, max_active_clusters, "
                         "smem_bytes": occ}
        print(f"{label}: " + ", ".join(f"{k} {v}" for k, v in times.items())
              + " ms; CTAs per SM, clusters resident, bytes a CTA: "
              + ", ".join(f"{k} {v}" for k, v in occ.items())
              + (f"; {', '.join(checked)} bit-identical" if checked else ""),
              flush=True)
        del cs, nzf, outs
        torch.cuda.empty_cache()
    build._LOADED.pop("fused_ladder", None)
    print(json.dumps(report))


def spills(log: str) -> str:
    """ptxas's spill line of the streamed mode's kernel (the second)."""
    return [ln.strip() for ln in log.splitlines() if "spill" in ln][-1]


if __name__ == "__main__":
    main()
