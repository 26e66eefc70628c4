"""Multi-device and multi-process execution: mesh construction and the
sharded runners.

Torch port of ``mustache_tpu/sharding.py``. The unit of data parallelism
is the detection block (the reference's multiprocessing fan-out,
mustache.py:913-934): one host process splits each batch of blocks over
a ``block`` axis of devices, launches every device's share, and only then
copies the packed outputs back, so the devices run at the same time.
Nothing crosses devices but the band on the way in: the JAX runners make
no collective in either placement (``mustache_tpu/sharding.py:132-135,
205``), so the port needs no NCCL. A mesh is a grid of ``torch.device``
entries; an entry may repeat a device (``["cpu"] * 4`` in the tests,
``["cuda:0"] * 4`` on one card), so the multi-device code runs where one
device exists.

The mesh's ``row`` axis splits each block of the dense runner
(:meth:`MeshRunner.__call__`, the JAX ``P("block", "row", None)``
sharding) over the ``n_row`` entries of its block group: each entry
uploads only its window of the block's rows (its row tiles of the fused
kernel plus a halo of the ladder radius and the NMS ring, straight from
the host: the torch form of GSPMD's halo exchange) and computes their
band state; the group's first entry, the owner, gathers the parts by
device copies, reduces the per-plane partials and runs the epilogue on
the whole block. The band-resident pipelines run each block group's share
on its owner (the JAX band path replicates over ``row``).

Two band placements, as in the JAX package:

* ``"replicate"``: every entry holds the whole chromosome band (for the
  float32 default, the compact raw band, which each entry normalizes on
  its device) and detects a contiguous share of each batch from its copy;
* ``"rowshard"``: each entry holds only the band rows of its own
  contiguous block range (:class:`RowShardPlan`), normalized on the host
  beforehand, since the windowed z-score needs whole columns.

Multi-process runs (one process per host or per card) exchange nothing
but a barrier before process 0 assembles the part files
(``mustache_tpu/cli.py:553-557``): :func:`initialize_distributed` opens a
``gloo`` process group for it and :func:`barrier` waits on it with a
timeout.
"""

from __future__ import annotations

import contextlib
import datetime
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from mustache_tpu_torch.bandnorm import bucket_rows
from mustache_tpu_torch.device import resolve_device
from mustache_tpu_torch.kernels import fused_ladder

# how long a process waits for its peers at the rendezvous and at the
# parts barrier: the barrier waits for the slowest process's last
# chromosome, so this bounds the skew between processes, not a unit
TIMEOUT = datetime.timedelta(hours=6)


class Mesh:
    """A ``[n_block, n_row]`` grid of ``torch.device`` entries (the JAX
    ``Mesh`` over axes ``("block", "row")``); entry ``(i, r)`` is entry
    ``i * n_row + r`` in grid order."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"block": self.devices.shape[0], "row": self.devices.shape[1]}

    @property
    def block_devices(self) -> list[torch.device]:
        """Each block group's owner: the grid's first column."""
        return list(self.devices[:, 0])

    def row_devices(self, i: int) -> list[torch.device]:
        """The ``n_row`` entries of block group ``i``, owner first."""
        return list(self.devices[i])


def make_mesh(n_block: int | None = None, n_row: int = 1,
              devices=None) -> Mesh:
    """A (block, row) mesh over the first ``n_block * n_row`` of
    ``devices`` (default: every visible CUDA device; an explicit list may
    repeat one), in the JAX order: ``devices.reshape(n_block, n_row)``."""
    if n_row < 1:
        raise ValueError(f"n_row must be >= 1, got {n_row}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass devices= to "
                               "mesh other devices)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    nd = len(devs)
    if n_block is None:
        n_block = nd // n_row
    if n_block < 1 or n_block * n_row > nd:
        raise ValueError(
            f"mesh {n_block}x{n_row} needs {max(n_block, 1) * n_row} "
            f"devices, have {nd}")
    grid = np.empty((n_block, n_row), dtype=object)
    for i in range(n_block):
        for r in range(n_row):
            grid[i, r] = devs[i * n_row + r]
    return Mesh(grid)


class RowShardPlan:
    """Block-to-entry assignment and slab geometry of the row-sharded band
    (``mustache_tpu/sharding.py:49-111``).

    Entry i owns a CONTIGUOUS range of blocks ``[c0[i], c1[i])`` and
    holds only the band rows they read: slab i covers ``[r0[i],
    starts[c1[i] - 1] + chunk)``, padded to ``slab_rows`` rows (one
    bucketed row count for every entry). Adjacent slabs overlap by the
    block overlap; a block's stencil halo lies inside its own ``chunk x
    chunk`` reconstruction, so no other margin is needed."""

    def __init__(self, starts, chunk: int, nd: int):
        starts = np.asarray(starts, np.int64)
        nblocks = len(starts)
        per = -(-nblocks // nd) if nblocks else 0   # most blocks per entry
        self.nd = nd
        self.chunk = chunk
        self.per_chip = per
        self.c0 = [min(i * per, nblocks) for i in range(nd)]
        self.c1 = [min((i + 1) * per, nblocks) for i in range(nd)]
        self.r0 = np.asarray(
            [starts[self.c0[i]] if self.c0[i] < self.c1[i] else 0
             for i in range(nd)], np.int64)
        spans = [
            int(starts[self.c1[i] - 1] + chunk - self.r0[i])
            if self.c0[i] < self.c1[i] else chunk
            for i in range(nd)
        ]
        self.slab_rows = bucket_rows(max(spans + [chunk]))
        self.starts = starts

    def launches(self, Bl: int):
        """Yield ``(idxs, starts_local)`` per launch: ``idxs`` the global
        block index of each slot, entry-major (None for a pad slot), and
        ``starts_local`` the ``[nd, Bl]`` slab-relative starts (-1 for a
        pad slot)."""
        n_launches = -(-self.per_chip // Bl) if self.per_chip else 0
        for k in range(n_launches):
            idxs: list = []
            sl = np.full((self.nd, Bl), -1, np.int32)
            for i in range(self.nd):
                for j in range(Bl):
                    g = self.c0[i] + k * Bl + j
                    if g < self.c1[i]:
                        idxs.append(int(g))
                        sl[i, j] = int(self.starts[g] - self.r0[i])
                    else:
                        idxs.append(None)
            yield idxs, sl

    def slab(self, band: np.ndarray, i: int) -> np.ndarray:
        """Entry i's slab ``[slab_rows, Dl]`` of the host band, zero-padded
        (all slabs together hold the band's rows plus the overlaps, not
        nd bands)."""
        out = np.zeros((self.slab_rows, band.shape[1]), band.dtype)
        seg = band[self.r0[i]: self.r0[i] + self.slab_rows]
        out[: seg.shape[0]] = seg
        return out


def _batch_size(cfg, nblocks: int, device: torch.device, per_block: int,
                reserve: int = 0, share: int = 1) -> int:
    """Blocks per batch. On CUDA, from free device memory: half of it,
    split among the ``share`` mesh entries on the device, less ``reserve``
    bytes of per-batch scratch, over ``per_block`` bytes a block holds at
    its peak; at most 16 blocks. On the CPU, 2 (as the JAX package)."""
    if cfg.block_batch:
        return cfg.block_batch
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cap = max(1, min(16, int((0.5 * free / share - reserve)
                                 // per_block)))
    else:
        cap = 2
    return min(cap, nblocks)


def upload_band(band: np.ndarray, device: torch.device) -> torch.Tensor:
    """One H2D of the host band, staged through pinned memory on CUDA."""
    with torch.profiler.record_function("upload.stage"):
        t = torch.from_numpy(band)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t


def _to_host(out: torch.Tensor):
    """``(host tensor, event or None)``: a CUDA tensor's copy queued into
    pinned host memory with an event recorded after it; a CPU tensor is
    its own host copy."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _on(dev: torch.device):
    """``dev`` as the current CUDA device (nothing on the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class MeshRunner:
    """Band-resident sharded execution over the ``block`` axis of a mesh.

    The pipelines place the chromosome's band on every entry
    (:meth:`place_band`) or one slab on each (:meth:`place_band_rowshard`),
    build one detector per device (:meth:`per_device`), and hand their
    launches' ``(idxs, starts)`` to :meth:`pipelined`, which launches
    every entry's share of a batch before the first device-to-host copy,
    and the next batch before it collects this one, and yields the packed
    rows batch by batch, entry-major; the pipelines restore block order
    with a stable sort. ``launches[e]`` counts the fused-kernel launches
    made on grid entry e (the kernel wrapper's own count, read around each call;
    the pipelines launch on the owners)."""

    def __init__(self, mesh: Mesh, band_placement: str = "replicate",
                 log=None):
        if band_placement not in ("replicate", "rowshard"):
            raise ValueError(f"unknown band_placement {band_placement!r}")
        self.mesh = mesh
        self.devices = mesh.block_devices
        self.nr = mesh.shape["row"]
        self.band_placement = band_placement
        self.log = log                    # RunLog (or None) for events
        self.last_plan: RowShardPlan | None = None
        self.last_band_event: dict | None = None
        self.launches = [0] * (len(self.devices) * self.nr)
        # bytes of dense rows each grid entry held in the last row-split
        # call of the dense runner
        self.last_held: list[int] = []
        self._row_dets: dict = {}

    @property
    def nb(self) -> int:
        return len(self.devices)

    def round_batch(self, b: int) -> int:
        """Smallest multiple of the block axis size >= b."""
        return -(-b // self.nb) * self.nb

    def local_batch(self, cfg, nblocks: int, per_block: int,
                    reserve: int = 0) -> int:
        """Blocks per entry and launch: ``cfg.block_batch`` split over the
        entries when set, else the least that any device's own free
        memory allows, shared among the entries on that device
        (:func:`_batch_size`)."""
        if cfg.block_batch:
            return -(-cfg.block_batch // self.nb)
        local = max(1, -(-nblocks // self.nb))
        share = Counter(self.devices)
        return min(_batch_size(cfg, local, d, per_block, reserve,
                               share=share[d]) for d in share)

    def per_device(self, make) -> list:
        """``[make(device)]`` per entry, made once per distinct device
        (entries on one device share it: the detector's taps and radii
        live on the device)."""
        made: dict = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    def place_band(self, band) -> list[torch.Tensor]:
        """One copy of ``band`` ([rows, Dl], host array or tensor) on
        every entry. A tensor already on the first entry's device serves
        that entry; the others get copies (device to device)."""
        if isinstance(band, np.ndarray):
            return [upload_band(band, d) for d in self.devices]
        return [band if k == 0 and band.device == d
                else band.to(d, non_blocking=True, copy=True)
                for k, d in enumerate(self.devices)]

    # -- row-sharded band placement ------------------------------------
    def plan_rowshard(self, starts, chunk: int) -> RowShardPlan:
        """Block assignment and slab geometry of this chromosome's grid;
        kept for the byte accounting."""
        self.last_plan = RowShardPlan(starts, chunk, self.nb)
        return self.last_plan

    def place_band_rowshard(self, band: np.ndarray,
                            plan: RowShardPlan) -> list[torch.Tensor]:
        """Upload entry i's slab to entry i only (total H2D ~ one band
        plus the overlaps); logs a ``rowshard_band`` event."""
        slabs = [plan.slab(band, i) for i in range(plan.nd)]
        self.last_band_event = dict(
            chips=plan.nd, per_chip_mb=round(slabs[0].nbytes / 1e6, 2),
            total_mb=round(sum(s.nbytes for s in slabs) / 1e6, 2),
            replicated_mb=round(band.nbytes * plan.nd / 1e6, 2))
        if self.log is not None:
            self.log.event("rowshard_band", **self.last_band_event)
        return [upload_band(s, d) for s, d in zip(slabs, self.devices)]

    def replicated_launches(self, starts, Bl: int):
        """The replicate placement's launches in :meth:`RowShardPlan.
        launches`' format: batches of ``nb * Bl`` blocks in order, entry
        k taking the k-th contiguous ``Bl`` of each (pad slots -1)."""
        nblocks = len(starts)
        for b0 in range(0, nblocks, self.nb * Bl):
            idxs: list = []
            sl = np.full((self.nb, Bl), -1, np.int32)
            for k in range(self.nb):
                for j in range(Bl):
                    g = b0 + k * Bl + j
                    if g < nblocks:
                        idxs.append(g)
                        sl[k, j] = int(starts[g])
                    else:
                        idxs.append(None)
            yield idxs, sl

    def launch(self, detectors, bands, idxs, starts_local):
        """Launch one batch over the mesh: entry k runs ``detectors[k].
        fn_band_packed(*bands[k], starts)`` (``bands[k]``: a tuple of the
        entry's band or slab of each map, one for the single-map detector
        and two for the differential one) on its real slots of ``starts_local[k]``
        (pad slots are dropped, an entry without real slots is skipped),
        then queues the packed buffer's copy to pinned host memory and
        records an event after it (on the CPU the buffer is the host
        copy). Nothing waits for the device; :meth:`collect` does. One
        ``mesh.launch`` profiler range."""
        Bl = starts_local.shape[1]
        pending = []
        with torch.profiler.record_function("mesh.launch"):
            for k, dev in enumerate(self.devices):
                slots = [j for j in range(Bl) if starts_local[k, j] >= 0]
                if not slots:
                    continue
                local = [int(starts_local[k, j]) for j in slots]
                before = fused_ladder.LAUNCHES
                with _on(dev):
                    out = detectors[k].fn_band_packed(*bands[k], local)
                    host, done = _to_host(out)
                self.launches[k * self.nr] += fused_ladder.LAUNCHES - before
                pending.append((k, slots, local, host, done))
        return idxs, Bl, pending

    @staticmethod
    def collect(launched):
        """Wait for a :meth:`launch`'s copies; returns ``[(global index,
        entry, local start, packed row)]``, entry-major. One
        ``mesh.collect`` profiler range."""
        idxs, Bl, pending = launched
        rows = []
        with torch.profiler.record_function("mesh.collect"):
            for k, slots, local, host, done in pending:
                if done is not None:
                    done.synchronize()
                host = host.numpy()
                for pos, (j, s) in enumerate(zip(slots, local)):
                    rows.append((idxs[k * Bl + j], k, s, host[pos]))
        return rows

    def pipelined(self, detectors, bands, launches):
        """The rows of every batch of ``launches`` (``(idxs,
        starts_local)`` pairs from :meth:`replicated_launches` or
        :meth:`RowShardPlan.launches`), batch by batch in order, as
        :meth:`collect` returns them. Batch k+1 is launched before batch
        k is collected, so the device runs it while the caller finishes
        batch k's rows on the host (``mustache_tpu/pipeline.py:502-510``);
        batch k's copy is queued before batch k+1's kernels, so
        collecting it does not wait for them."""
        pending = None
        for idxs, sl in launches:
            launched = self.launch(detectors, bands, idxs, sl)
            if pending is not None:
                yield from self.collect(pending)
            pending = launched
        if pending is not None:
            yield from self.collect(pending)

    def __call__(self, detectors, blocks):
        """The dense entry (``mustache_tpu/sharding.py:262-277``):
        ``blocks`` ``[B, N, N]`` (host array or tensor) padded with zero
        blocks to a multiple of ``nb``, split into contiguous shares, each
        detected by ``detectors[k]`` on block group k (all launched before
        the first copy back); the outputs of the real blocks, as host
        arrays in block order. With ``n_row > 1`` each share's rows are
        split over its group (:meth:`_row_split`)."""
        blocks = torch.as_tensor(blocks)
        B = blocks.shape[0]
        pad = (-B) % self.nb
        if pad:
            blocks = torch.cat([blocks, blocks.new_zeros(
                (pad,) + tuple(blocks.shape[1:]))])
        per = blocks.shape[0] // self.nb
        shares = [blocks[k * per:(k + 1) * per] for k in range(self.nb)]
        if self.nr > 1:
            outs = self._row_split(detectors, shares)
        else:
            outs = []
            for k, dev in enumerate(self.devices):
                before = fused_ladder.LAUNCHES
                with _on(dev):
                    outs.append(detectors[k].fn(shares[k].to(dev)))
                self.launches[k] += fused_ladder.LAUNCHES - before
        host = {key: np.concatenate([o[key].cpu().numpy() for o in outs])
                for key in outs[0]}
        return {key: a[:B] for key, a in host.items()}

    def _row_detector(self, det, dev: torch.device):
        """``det`` for a row entry on ``dev``: itself where its taps live
        there, else one detector of the same configuration per device."""
        if det.taps.device == dev:
            return det
        key = (id(det), dev)
        if key not in self._row_dets:
            from mustache_tpu_torch.detect import build_detector

            self._row_dets[key] = (det, build_detector(
                det.cfg, det.n, device=dev, max_candidates=det.K))
        return self._row_dets[key][1]

    def _row_split(self, detectors, shares) -> list[dict]:
        """Each group's share with its rows split over the group's row
        entries: entry r uploads its window of every block
        (``fused_ladder.window_rows`` of its row tiles ``row_cuts[r]``)
        and computes its part (``BlockDetector.row_state``); once every
        entry has launched, each owner gathers its group's parts by
        device copies and finishes the blocks (``join_rows``)."""
        N = shares[0].shape[-1]
        R = detectors[0].spec.radius
        cuts = fused_ladder.row_cuts(N, self.nr)
        held = [0] * len(self.launches)
        parts: list[list] = []
        for k, share in enumerate(shares):
            group = []
            for r, dev in enumerate(self.mesh.row_devices(k)):
                t_lo, t_hi = cuts[r], cuts[r + 1]
                if t_lo == t_hi:
                    continue                    # more entries than tiles
                e = k * self.nr + r
                det = self._row_detector(detectors[k], dev)
                w0, w1 = fused_ladder.window_rows(N, t_lo, t_hi, R)
                before = fused_ladder.LAUNCHES
                with _on(dev):
                    win = share[:, w0:w1].to(dev, non_blocking=True)
                    group.append(det.row_state(win, w0, t_lo, t_hi))
                self.launches[e] += fused_ladder.LAUNCHES - before
                held[e] = win.numel() * win.element_size()
            parts.append(group)
        self.last_held = held
        outs = []
        for k, group in enumerate(parts):
            owner = self.devices[k]
            with _on(owner):
                moved = [tuple(t.to(owner, non_blocking=True) for t in p)
                         for p in group]
                outs.append(detectors[k].join_rows(moved))
        return outs


def make_runner(mesh: Mesh, band_placement: str = "replicate",
                log=None) -> MeshRunner:
    """The sharded runner over ``mesh``: ``"replicate"`` (every entry
    holds the band) or ``"rowshard"`` (each entry holds its block range's
    rows); ``log``: a ``RunLog`` for the ``rowshard_band`` event."""
    return MeshRunner(mesh, band_placement, log=log)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join a ``gloo`` process group of ``num_processes`` over
    ``tcp://<coordinator>`` (``host:port`` of process 0) as rank
    ``process_id``, waiting at most :data:`TIMEOUT` for the peers. A no-op
    for one process. The group carries only :func:`barrier`."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return
    if not coordinator:
        raise ValueError("a multi-process run needs --engine-coordinator "
                         "host:port (env MTPU_COORDINATOR)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def barrier(name: str) -> None:
    """Every process of the group reaches ``name`` before any goes on
    (``multihost_utils.sync_global_devices``); a peer that died or stays
    away raises after :data:`TIMEOUT` instead of hanging the others. A
    no-op without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        try:
            dist.monitored_barrier(timeout=TIMEOUT, wait_all_ranks=True)
        except RuntimeError as exc:
            raise RuntimeError(f"barrier {name!r}: {exc}") from exc


def finalize_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_chromosomes(chromosomes: Sequence, process_id: int,
                      num_processes: int) -> list:
    """Static round-robin partition of the run's units over processes."""
    return [c for i, c in enumerate(chromosomes)
            if i % num_processes == process_id]
