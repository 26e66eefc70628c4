#!/usr/bin/env python3
"""Write ``.cool`` / ``.mcool`` files without h5py: a minimal HDF5 writer
in numpy, for test and smoke-run tooling (the machine with the card has
no h5py).

The files follow cooler's schema as ``tests/test_cool.py::build_cool``
lays it out: ``chroms/{name,length}``, ``bins/{chrom,start,end,weight}``,
``pixels/{bin1_id,bin2_id,count}`` (sorted by ``(bin1, bin2)``) and
``indexes/{chrom_offset,bin1_offset}``, the ``bin-size`` attribute on the
cooler group, and for ``.mcool`` one cooler group per resolution under
``resolutions/<res>``. The HDF5 subset: superblock version 0, groups as
symbol tables (one v1 B-tree node, one SNOD and one local heap each),
version 1 object headers, contiguous datasets, fixed-length string and
numeric columns, scalar attributes (integers, floats and fixed-length
strings). h5py reads the files, and so does ``mustache_tpu_torch/io/h5.py``.

    python tools/write_cool.py OUT.mcool [--n-bins 9629 --d-px 400
        --seed 2021 --res 5000 --chrom chr21]

writes ``tests/synthetic.py``'s map (as ``bench.py``'s chr21 5 kb
workload by default) and prints the seconds it took.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b"\x89HDF\r\n\x1a\n"
INTERNAL_K = 16            # group B-tree: children per node up to 2K


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * ((-len(b)) % 8)


def _datatype(dt: np.dtype) -> bytes:
    """A datatype message body for a numpy dtype (little endian)."""
    dt = np.dtype(dt)
    if dt.kind == "S":
        return struct.pack("<B3sI", 0x13, bytes([0x01, 0, 0]), dt.itemsize)
    if dt.kind in "iu":
        sign = 0x08 if dt.kind == "i" else 0
        return struct.pack("<B3sIHH", 0x10, bytes([sign, 0, 0]), dt.itemsize,
                           0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (4, 8):
        e, m, bias = (8, 23, 127) if dt.itemsize == 4 else (11, 52, 1023)
        return struct.pack("<B3sIHHBBBBI", 0x11,
                           bytes([0x20, 8 * dt.itemsize - 1, 0]),
                           dt.itemsize, 0, 8 * dt.itemsize, m, e, 0, m, bias)
    raise ValueError(f"write_cool: no HDF5 type for {dt}")


def _dataspace(shape: tuple) -> bytes:
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


def _message(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _attribute(name: str, value) -> bytes:
    if isinstance(value, str):
        arr = np.array(value.encode(), dtype=f"S{len(value.encode()) + 1}")
    elif isinstance(value, (bool, int, np.integer)):
        arr = np.array(value, np.int64)
    else:
        arr = np.array(value, np.float64)
    nm = name.encode() + b"\0"
    dt, sp = _datatype(arr.dtype), _dataspace(())
    body = (struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(sp))
            + _pad8(nm) + _pad8(dt) + _pad8(sp) + arr.tobytes())
    return _message(0x0C, body)


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    """Lays the file out in address order: metadata blocks and dataset
    bytes, each at the address :meth:`alloc` hands out."""

    def __init__(self, leaf_k: int):
        self.leaf_k = leaf_k
        self.eof = 96                       # after the superblock
        self.blocks: list[tuple[int, object]] = []

    def alloc(self, data) -> int:
        """Place ``data`` (bytes or a numpy array) at the end; its
        address."""
        addr = self.eof
        self.blocks.append((addr, data))
        n = len(data) if isinstance(data, bytes) else data.nbytes
        self.eof += n + (-n) % 8
        return addr

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype.kind != "S":
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        addr = self.alloc(arr) if arr.nbytes else UNDEF
        layout = struct.pack("<BBQQ", 3, 1, addr, arr.nbytes)
        return self.alloc(_object_header([
            _message(0x01, _dataspace(arr.shape)),
            _message(0x03, _datatype(arr.dtype)),
            _message(0x08, layout)]))

    def group(self, node: dict) -> tuple[int, int, int]:
        """Write a group's members, then its local heap, SNOD, B-tree node
        and object header: ``(header, B-tree, heap)`` addresses."""
        names = sorted((k for k in node if k != "@attrs"),
                       key=lambda k: k.encode())
        if len(names) > 2 * self.leaf_k:
            raise ValueError("write_cool: group too large for one SNOD")
        targets = [self.group(node[k])[0] if isinstance(node[k], dict)
                   else self.dataset(node[k]) for k in names]
        seg, offs = bytearray(b"\0" * 8), []
        for k in names:
            offs.append(len(seg))
            seg += _pad8(k.encode() + b"\0")
        seg_addr = self.alloc(bytes(seg))
        # free-list offset 1: no free block (libhdf5's H5HL_FREE_NULL)
        heap = self.alloc(b"HEAP" + struct.pack("<B3xQQQ", 0, len(seg), 1,
                                                 seg_addr))
        entries = b"".join(struct.pack("<QQI4x16x", o, t, 0)
                           for o, t in zip(offs, targets))
        snod = (b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries
                + b"\0" * (40 * (2 * self.leaf_k - len(names))))
        snod_addr = self.alloc(snod)
        tree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF)
                + struct.pack("<QQQ", 0, snod_addr, offs[-1] if offs else 0))
        tree += b"\0" * (8 + 16 + (2 * INTERNAL_K + 1) * 8
                         + 2 * INTERNAL_K * 8 - len(tree))
        tree_addr = self.alloc(tree)
        msgs = [_message(0x11, struct.pack("<QQ", tree_addr, heap))]
        msgs += [_attribute(k, v) for k, v in node.get("@attrs", {}).items()]
        return self.alloc(_object_header(msgs)), tree_addr, heap


def _largest_group(node: dict) -> int:
    subs = [v for k, v in node.items()
            if isinstance(v, dict) and k != "@attrs"]
    return max([len([k for k in node if k != "@attrs"])]
               + [_largest_group(s) for s in subs])


def write_h5(path: str, tree: dict) -> None:
    """Write ``tree`` as an HDF5 file: a dict is a group (its ``"@attrs"``
    entry a dict of scalar attributes), a numpy array a 1-D dataset."""
    w = _Writer(leaf_k=max(4, -(-_largest_group(tree) // 2)))
    root, tree_addr, heap = w.group(tree)
    sb = (SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                  w.leaf_k, INTERNAL_K, 0)
          + struct.pack("<QQQQ", 0, UNDEF, w.eof, UNDEF)
          + struct.pack("<QQII", 0, root, 1, 0)
          + struct.pack("<QQ", tree_addr, heap))
    assert len(sb) == 96
    with open(path, "wb") as fh:
        fh.write(sb)
        for addr, data in w.blocks:
            fh.seek(addr)
            fh.write(data if isinstance(data, bytes) else data.tobytes())
        fh.truncate(w.eof)


def cooler_tree(chroms, res: int, pixels: dict, weights=None,
                count_dtype=np.int32) -> dict:
    """One cooler group: ``chroms`` ``[(name, length_bp)]``, ``pixels``
    ``{chrom: (x, y, count)}`` in local bins (a key ``(c1, c2)`` in
    chromosome order for an inter rectangle), ``weights`` the balance
    column (ones by default)."""
    names = [c[0] for c in chroms]
    lengths = np.array([c[1] for c in chroms], np.int64)
    nbins_per = [int(np.ceil(n / res)) for n in lengths]
    chrom_offset = np.concatenate([[0], np.cumsum(nbins_per)]).astype(np.int64)
    nbins = int(chrom_offset[-1])
    bin_chrom = np.repeat(np.arange(len(names), dtype=np.int32), nbins_per)
    bin_start = np.concatenate([np.arange(n, dtype=np.int64) * res
                                for n in nbins_per])
    b1s, b2s, vs = [], [], []
    for key, (x, y, v) in pixels.items():
        i1, i2 = ((names.index(key[0]), names.index(key[1]))
                  if isinstance(key, tuple) else (names.index(key),) * 2)
        if i1 > i2:
            raise ValueError("write inter pairs in chromosome order")
        b1s.append(np.asarray(x, np.int64) + chrom_offset[i1])
        b2s.append(np.asarray(y, np.int64) + chrom_offset[i2])
        vs.append(np.asarray(v))
    b1 = np.concatenate(b1s) if b1s else np.zeros(0, np.int64)
    b2 = np.concatenate(b2s) if b2s else np.zeros(0, np.int64)
    v = np.concatenate(vs) if vs else np.zeros(0)
    order = np.lexsort((b2, b1))
    b1, b2, v = b1[order], b2[order], v[order]
    width = max([len(n.encode()) for n in names] + [1])
    return {
        "@attrs": {"format": "HDF5::Cooler", "format-version": 3,
                   "bin-type": "fixed", "bin-size": int(res),
                   "storage-mode": "symmetric-upper", "nbins": nbins,
                   "nchroms": len(names), "nnz": len(b1),
                   "generated-by": "tools/write_cool.py"},
        "chroms": {"name": np.array([n.encode() for n in names],
                                    f"S{width}"),
                   "length": lengths},
        "bins": {"chrom": bin_chrom, "start": bin_start,
                 "end": bin_start + res,
                 "weight": (np.ones(nbins) if weights is None
                            else np.asarray(weights, np.float64))},
        "pixels": {"bin1_id": b1, "bin2_id": b2,
                   "count": v.astype(count_dtype)},
        "indexes": {"chrom_offset": chrom_offset,
                    "bin1_offset": np.searchsorted(
                        b1, np.arange(nbins + 1)).astype(np.int64)},
    }


def write_cool(path: str, chroms, res: int, pixels: dict, weights=None,
               count_dtype=np.int32) -> None:
    """A ``.cool`` file of one resolution (see :func:`cooler_tree`)."""
    write_h5(path, cooler_tree(chroms, res, pixels, weights, count_dtype))


def write_mcool(path: str, layers: dict, count_dtype=np.int32) -> None:
    """A ``.mcool`` file: ``layers`` ``{res: (chroms, pixels, weights)}``,
    each a cooler group under ``resolutions/<res>``."""
    write_h5(path, {
        "@attrs": {"format": "HDF5::MCOOL", "format-version": 2},
        "resolutions": {str(int(r)): cooler_tree(c, r, p, w, count_dtype)
                        for r, (c, p, w) in layers.items()}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help=".cool or .mcool path")
    ap.add_argument("--n-bins", type=int, default=9629)
    ap.add_argument("--d-px", type=int, default=400)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--loops", type=int, default=300)
    ap.add_argument("--res", type=int, default=5000)
    ap.add_argument("--chrom", default="chr21")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    from synthetic import synthetic_hic

    x, y, v, _ = synthetic_hic(args.n_bins, args.d_px, seed=args.seed,
                               n_loops=args.loops, loop_strength=3.0)
    t0 = time.perf_counter()
    chroms = [(args.chrom, args.n_bins * args.res)]
    pixels = {args.chrom: (x, y, v)}
    if args.out.endswith(".mcool"):
        write_mcool(args.out, {args.res: (chroms, pixels, None)},
                    count_dtype=np.float64)
    else:
        write_cool(args.out, chroms, args.res, pixels,
                   count_dtype=np.float64)
    print(f"{len(v)} contacts -> {args.out} in "
          f"{time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
