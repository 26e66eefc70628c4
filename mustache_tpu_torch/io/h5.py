"""Read-only HDF5, for the subset that h5py and cooler write, in numpy and
a native chunk decoder linked against zlib (no h5py, no libhdf5).

``.cool`` / ``.mcool`` files are HDF5; the card machine has no h5py, so
``io/cool.py`` reads them through this module. What it reads:

* superblock versions 0 and 1 (h5py's default) and 2 and 3
  (``libver="latest"``);
* object headers v1 and v2, with their continuation blocks;
* groups as symbol tables (a v1 B-tree of type 0, a local heap and SNOD
  nodes: every group h5py writes by default, ``.mcool``'s
  ``resolutions/<res>`` too) and as compact link messages (new-style
  groups whose links fit in the header);
* datatypes: fixed-point (8-64 bits, either byte order), IEEE float
  (16/32/64 bits), fixed-length strings, enums over an integer base (read
  as their integer values, as h5py does) and variable-length strings in
  the global heap (h5py's ``str`` attributes);
* scalar and 1-D attributes and datasets;
* dataset layouts: compact, contiguous, and chunked with a v1 B-tree
  chunk index of any depth; the filters deflate (1) and shuffle (2)
  (cooler's default ``h5opts``: gzip level 6 with shuffle).

:meth:`H5File.read` decompresses only the chunks that overlap the rows
asked for and widens them to the caller's dtype. A chunked dataset of
fixed-size elements (numbers, fixed-length strings) is read by one call
of the native decoder (``io/native/h5_chunks.cpp``): on up to
``native.N_THREADS`` threads, each chunk is read, inflated, unshuffled
and widened in one pass straight into the output; the Python loop it
replaced is kept as :meth:`H5File._read_chunked_plain`, the twin the
tests hold it to, and reads only chunked variable-length strings (whose
heap references are resolved in Python). Every read adds to the file's
:attr:`H5File.counters`: the chunks inflated, their inflated bytes, the
seconds spent in ``zlib`` and in undoing the shuffle (summed over the
decoder's threads: CPU time, not wall time) and the chunks the native
decoder took (a chromosome of a cooler file at 5 kb has thousands of
chunks, too many for a profiler range each). Anything outside the
subset (fletcher32, szip or another filter, dense link or attribute
storage in a fractal heap, a chunk index other than the v1 B-tree,
shared or committed messages, soft or external links, datasets of rank
above 1, compound, array, reference or opaque types, ...) raises a
``ValueError`` that names the feature: a file is read right or not at
all. A read past the end of the file or of a dataset raises too.

File format: the HDF5 File Format Specification, version 3.0 (sections
II-IV); the layouts below follow its field order.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

from mustache_tpu_torch.io import native

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE = 0x01, 0x02, 0x03
_FILL_OLD, _FILL = 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x06, 0x07, 0x08, 0x0B, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 10: "array"}
_CHUNK_INDEX_NAMES = {1: "single chunk", 2: "implicit", 3: "fixed array",
                      4: "extensible array", 5: "version 2 B-tree"}


def _unsupported(what: str):
    return ValueError(f"HDF5 feature not supported by this reader: {what}")


class _Cursor:
    """Little-endian field reader over a bytes object."""

    def __init__(self, data: bytes, pos: int = 0, so: int = 8, sl: int = 8):
        self.data, self.pos, self.so, self.sl = data, pos, so, sl

    def u(self, n: int) -> int:
        if self.pos + n > len(self.data):
            raise ValueError("HDF5 structure ends early (truncated or "
                             "corrupt file)")
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def off(self) -> int:
        return self.u(self.so)

    def length(self) -> int:
        return self.u(self.sl)

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("HDF5 structure ends early (truncated or "
                             "corrupt file)")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def skip(self, n: int) -> None:
        self.pos += n


class _Type:
    """A parsed datatype: ``kind`` is ``"num"`` (numpy ``dtype``: fixed
    point, float, enum base, fixed-length string) or ``"vlen_str"``
    (``size`` bytes per element in the file: length, heap address,
    index)."""

    def __init__(self, kind: str, dtype, size: int):
        self.kind, self.dtype, self.size = kind, dtype, size


class _Dataset:
    """A dataset's parsed header: shape, type, layout, filters, fill."""

    def __init__(self, shape, dtype: _Type, layout: dict, filters: list,
                 fill: bytes | None):
        self.shape, self.dtype, self.layout = shape, dtype, layout
        self.filters, self.fill = filters, fill
        self._chunks = None          # cached chunk index
        self._chunk_arrays = None    # the same as int64 arrays


class H5File:
    """One HDF5 file opened for reading. Paths are ``/``-separated from
    the root group (``"resolutions/5000/pixels/count"``)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._size = self._fh.seek(0, 2)
            self._superblock()
        except BaseException:
            self._fh.close()
            raise
        self._objects: dict[str, int] = {"": self._root}
        self._headers: dict[int, list] = {}
        self._datasets: dict[str, _Dataset] = {}
        # inflate_s and unshuffle_s: seconds summed over the native
        # decoder's threads (CPU time, not wall time); chunks_native: the
        # chunks that decoder took
        self.counters = {"chunks_inflated": 0, "bytes_inflated": 0,
                         "inflate_s": 0.0, "unshuffle_s": 0.0,
                         "chunks_native": 0}

    # -- file access -------------------------------------------------------
    def _read(self, addr: int, n: int) -> bytes:
        if addr == self._undef:
            raise ValueError("HDF5: read at an undefined address")
        at = self._base + addr
        if at < 0 or at + n > self._size:
            raise ValueError(f"HDF5: {n} bytes at {at} lie beyond the end of "
                             f"{self.path} ({self._size} bytes): truncated "
                             f"file")
        self._fh.seek(at)
        return self._fh.read(n)

    def _cursor(self, addr: int, n: int) -> _Cursor:
        return _Cursor(self._read(addr, n), 0, self._so, self._sl)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- superblock --------------------------------------------------------
    def _superblock(self) -> None:
        at = 0
        while True:
            if at + 8 > self._size:
                raise ValueError(f"{self.path} is not an HDF5 file "
                                 f"(no superblock signature)")
            self._fh.seek(at)
            if self._fh.read(8) == SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        self._fh.seek(at)
        c = _Cursor(self._fh.read(256))
        c.skip(8)
        ver = c.u(1)
        if ver in (0, 1):
            c.skip(3)                          # free space, root, reserved
            if c.u(1) != 0:
                raise _unsupported("shared header message format version")
            so, sl = c.u(1), c.u(1)
            c.skip(1 + 2 + 2 + 4)              # reserved, K's, flags
            if ver == 1:
                c.skip(4)                      # indexed storage K, reserved
            c.so, c.sl = so, sl
            base = c.off()
            c.skip(3 * so)                     # free space, EOF, VFD info
            c.skip(so)                         # root entry: link name
            root = c.off()
        elif ver in (2, 3):
            so, sl = c.u(1), c.u(1)
            c.skip(1)                          # flags
            c.so, c.sl = so, sl
            base = c.off()
            c.skip(2 * so)                     # extension, EOF
            root = c.off()
        else:
            raise _unsupported(f"superblock version {ver}")
        if so not in (2, 4, 8) or sl not in (2, 4, 8):
            raise _unsupported(f"offset size {so} / length size {sl}")
        self._so, self._sl = so, sl
        self._undef = (1 << (8 * so)) - 1
        self._base = base if base != self._undef else at
        self._root = root

    # -- object headers ----------------------------------------------------
    def _messages(self, addr: int) -> list:
        """``[(type, data)]`` of the object header at ``addr``, with its
        continuation blocks, NIL messages dropped; a shared message
        raises."""
        got = self._headers.get(addr)
        if got is not None:
            return got
        head = self._read(addr, 4)
        out: list = []
        if head == b"OHDR":
            # the prefix is at most 34 bytes (the file may end sooner)
            c = self._cursor(addr, min(34, self._size - self._base - addr))
            c.skip(4)
            if c.u(1) != 2:
                raise _unsupported("object header version (OHDR)")
            flags = c.u(1)
            if flags & 0x20:
                c.skip(16)                     # times
            if flags & 0x10:
                c.skip(4)                      # attribute phase change
            size0 = c.u(1 << (flags & 3))
            blocks = [(addr + c.pos, size0, True)]
            order = bool(flags & 0x04)
            while blocks:
                baddr, bsize, first = blocks.pop(0)
                data = self._read(baddr, bsize)
                if first:
                    c = _Cursor(data, 0, self._so, self._sl)
                else:
                    if data[:4] != b"OCHK":
                        raise ValueError("HDF5: bad object header "
                                         "continuation signature")
                    c = _Cursor(data[:-4], 4, self._so, self._sl)
                hdr = 6 if order else 4
                while len(c.data) - c.pos >= hdr:
                    mtype, msize, mflags = c.u(1), c.u(2), c.u(1)
                    if order:
                        c.skip(2)
                    body = c.raw(msize)
                    self._take(mtype, mflags, body, out, blocks, v2=True)
        else:
            c = self._cursor(addr, 16)
            if c.u(1) != 1:
                raise _unsupported(f"object header version {head[0]}")
            c.skip(1 + 2 + 4)
            size0 = c.u(4)
            blocks = [(addr + 16, size0)]
            while blocks:
                baddr, bsize = blocks.pop(0)[:2]
                c = self._cursor(baddr, bsize)
                while len(c.data) - c.pos >= 8:
                    mtype, msize, mflags = c.u(2), c.u(2), c.u(1)
                    c.skip(3)
                    body = c.raw(msize)
                    self._take(mtype, mflags, body, out, blocks, v2=False)
        self._headers[addr] = out
        return out

    def _take(self, mtype, mflags, body, out, blocks, *, v2: bool) -> None:
        if mtype == 0:
            return
        if mflags & 0x02:
            raise _unsupported(f"shared object header message (type "
                               f"{mtype}: a committed datatype or a shared "
                               f"message table)")
        if mtype == _CONTINUATION:
            c = _Cursor(body, 0, self._so, self._sl)
            a, n = c.off(), c.length()
            blocks.append((a, n, False) if v2 else (a, n))
            return
        out.append((mtype, body))

    # -- groups ------------------------------------------------------------
    def _links(self, addr: int) -> dict[str, int]:
        """Name -> object header address of the group at ``addr``."""
        msgs = self._messages(addr)
        links: dict[str, int] = {}
        for mtype, body in msgs:
            if mtype == _SYMBOL_TABLE:
                c = _Cursor(body, 0, self._so, self._sl)
                btree, heap = c.off(), c.off()
                self._symbol_table(btree, self._heap_data(heap), links)
            elif mtype == _LINK_INFO:
                c = _Cursor(body, 0, self._so, self._sl)
                c.skip(1)
                flags = c.u(1)
                if flags & 1:
                    c.skip(8)
                if c.off() != self._undef:
                    raise _unsupported("dense link storage (fractal heap)")
            elif mtype == _LINK:
                name, target = self._link(body)
                links[name] = target
        return links

    def _link(self, body: bytes):
        c = _Cursor(body, 0, self._so, self._sl)
        if c.u(1) != 1:
            raise _unsupported("link message version")
        flags = c.u(1)
        ltype = c.u(1) if flags & 0x08 else 0
        if flags & 0x04:
            c.skip(8)
        if flags & 0x10:
            c.skip(1)
        name = c.raw(c.u(1 << (flags & 3))).decode("utf-8")
        if ltype != 0:
            raise _unsupported({1: "soft link", 64: "external link"}.get(
                ltype, f"link type {ltype}") + f" ({name!r})")
        return name, c.off()

    def _heap_data(self, addr: int) -> bytes:
        c = self._cursor(addr, 8 + 2 * self._sl + self._so)
        if c.raw(4) != b"HEAP":
            raise ValueError("HDF5: bad local heap signature")
        c.skip(4)
        size = c.length()
        c.length()                              # free list
        return self._read(c.off(), size)

    def _symbol_table(self, addr: int, heap: bytes, links: dict) -> None:
        """Walk a group's v1 B-tree (type 0) into ``links``."""
        node = self._btree_node(addr, 0)
        for child in node["children"]:
            if node["level"] > 0:
                self._symbol_table(child, heap, links)
                continue
            c = self._cursor(child, 8)
            if c.raw(4) != b"SNOD":
                raise ValueError("HDF5: bad symbol table node signature")
            c.skip(2)
            n = c.u(2)
            entry = 2 * self._so + 24
            c = self._cursor(child + 8, n * entry)
            for _ in range(n):
                name_off, obj, cache = c.off(), c.off(), c.u(4)
                c.skip(20)
                end = heap.index(b"\0", name_off)
                name = heap[name_off:end].decode("utf-8")
                if cache == 2:
                    raise _unsupported(f"soft link ({name!r})")
                links[name] = obj

    def _btree_node(self, addr: int, want_type: int, rank: int = 0) -> dict:
        """One v1 B-tree node: its level, children and keys (type 0: heap
        offsets; type 1: ``(size, filter mask, offsets)`` per chunk)."""
        c = self._cursor(addr, 8 + 2 * self._so)
        if c.raw(4) != b"TREE":
            raise ValueError("HDF5: bad B-tree node signature")
        ntype, level, used = c.u(1), c.u(1), c.u(2)
        if ntype != want_type:
            raise ValueError(f"HDF5: B-tree node type {ntype}, expected "
                             f"{want_type}")
        key = self._sl if ntype == 0 else 8 + 8 * (rank + 1)
        c = self._cursor(addr + 8 + 2 * self._so,
                         (used + 1) * key + used * self._so)
        keys, children = [], []
        for i in range(used + 1):
            if ntype == 0:
                keys.append(c.length())
            else:
                size, mask = c.u(4), c.u(4)
                keys.append((size, mask, [c.u(8) for _ in range(rank + 1)]))
            if i < used:
                children.append(c.off())
        return {"level": level, "keys": keys, "children": children}

    def _resolve(self, path: str) -> int:
        """Object header address of ``path``; KeyError when absent."""
        path = path.strip("/")
        addr = self._objects.get(path)
        if addr is not None:
            return addr
        parent, _, name = path.rpartition("/")
        links = self._links(self._resolve(parent))
        if name not in links:
            raise KeyError(f"{path!r} not in {self.path}")
        self._objects[path] = links[name]
        return links[name]

    # -- public: structure -------------------------------------------------
    def __contains__(self, path: str) -> bool:
        try:
            self._resolve(path)
        except KeyError:
            return False
        return True

    def keys(self, path: str = "") -> list[str]:
        """Member names of the group at ``path``, sorted."""
        return sorted(self._links(self._resolve(path)))

    def attrs(self, path: str = "") -> dict:
        """Every attribute of the object at ``path``: scalars as numpy
        scalars (strings as ``str``), 1-D ones as arrays."""
        out = {}
        for mtype, body in self._messages(self._resolve(path)):
            if mtype == _ATTRIBUTE:
                name, value = self._attribute(body)
                out[name] = value
            elif mtype == _ATTRIBUTE_INFO:
                c = _Cursor(body, 0, self._so, self._sl)
                c.skip(1)
                if c.u(1) & 1:
                    c.skip(2)
                if c.off() != self._undef:
                    raise _unsupported("dense attribute storage "
                                       "(fractal heap)")
        return out

    # -- types, spaces -----------------------------------------------------
    def _datatype(self, c: _Cursor) -> _Type:
        cv = c.u(1)
        cls, ver = cv & 0x0F, cv >> 4
        bits = c.u(3)
        size = c.u(4)
        if cls == 0:                                    # fixed point
            c.skip(4)
            order = ">" if bits & 1 else "<"
            kind = "i" if bits & 0x08 else "u"
            if size not in (1, 2, 4, 8):
                raise _unsupported(f"{8 * size}-bit integers")
            return _Type("num", np.dtype(f"{order}{kind}{size}"), size)
        if cls == 1:                                    # float
            offset, prec = c.u(2), c.u(2)
            eloc, esize, mloc, msize = c.u(1), c.u(1), c.u(1), c.u(1)
            c.skip(4)
            ieee = {2: (10, 5, 10), 4: (23, 8, 23), 8: (52, 11, 52)}
            if (bits & 0x40 or size not in ieee or offset != 0
                    or prec != 8 * size or mloc != 0
                    or (eloc, esize, msize) != ieee[size]):
                raise _unsupported(f"non-IEEE {8 * size}-bit float")
            order = ">" if bits & 1 else "<"
            return _Type("num", np.dtype(f"{order}f{size}"), size)
        if cls == 3:                                    # fixed string
            return _Type("num", np.dtype(f"S{size}"), size)
        if cls == 8:                                    # enum
            base = self._datatype(c)
            if base.kind != "num" or base.dtype.kind not in "iu":
                raise _unsupported("enum over a non-integer base")
            n = bits & 0xFFFF
            for _ in range(n):                          # member names
                end = c.data.index(b"\0", c.pos)
                nlen = end - c.pos + 1
                c.skip(nlen + ((-nlen) % 8 if ver < 3 else 0))
            c.skip(n * base.size)                       # member values
            return base
        if cls == 9:                                    # variable length
            if bits & 0x0F != 1:
                raise _unsupported("variable-length sequence")
            return _Type("vlen_str", None, 4 + self._so + 4)
        raise _unsupported(f"{_CLASS_NAMES.get(cls, f'class {cls}')} "
                           f"datatype")

    def _dataspace(self, c: _Cursor):
        """Shape tuple (``()`` for a scalar, ``None`` for a null space)."""
        ver = c.u(1)
        rank = c.u(1)
        flags = c.u(1)
        if ver == 1:
            c.skip(5)
            stype = 1 if rank else 0
        elif ver == 2:
            stype = c.u(1)
        else:
            raise _unsupported(f"dataspace message version {ver}")
        shape = tuple(c.length() for _ in range(rank))
        if flags & 1:
            c.skip(rank * self._sl)
        if stype == 2:
            return None
        return shape if stype == 1 else ()

    def _decode(self, raw: bytes, t: _Type, count: int):
        """``count`` elements of type ``t`` from ``raw``."""
        if t.kind == "num":
            return np.frombuffer(raw, t.dtype, count)
        out = np.empty(count, object)
        c = _Cursor(raw, 0, self._so, self._sl)
        for i in range(count):
            n, heap, idx = c.u(4), c.off(), c.u(4)
            out[i] = self._global_heap(heap, idx)[:n].decode("utf-8")
        return out

    def _global_heap(self, addr: int, index: int) -> bytes:
        c = self._cursor(addr, 8 + self._sl)
        if c.raw(4) != b"GCOL":
            raise ValueError("HDF5: bad global heap signature")
        c.skip(4)
        size = c.length()
        c = self._cursor(addr, size)
        c.skip(8 + self._sl)
        while len(c.data) - c.pos >= 8 + self._sl:
            idx = c.u(2)
            c.skip(6)
            n = c.length()
            if idx == 0:
                break
            if idx == index:
                return c.raw(n)
            c.skip(n + (-n) % 8)
        raise ValueError(f"HDF5: global heap object {index} not found")

    def _attribute(self, body: bytes):
        c = _Cursor(body, 0, self._so, self._sl)
        ver = c.u(1)
        flags = c.u(1)
        if flags & 0x03:
            raise _unsupported("shared attribute datatype or dataspace")
        nlen, tlen, slen = c.u(2), c.u(2), c.u(2)
        if ver == 3:
            c.skip(1)                           # name character set
        elif ver not in (1, 2):
            raise _unsupported(f"attribute message version {ver}")
        pad = (lambda n: n + (-n) % 8) if ver == 1 else (lambda n: n)
        name = c.data[c.pos:c.pos + nlen].split(b"\0")[0].decode("utf-8")
        c.skip(pad(nlen))
        t = self._datatype(_Cursor(c.data, c.pos, self._so, self._sl))
        c.skip(pad(tlen))
        shape = self._dataspace(_Cursor(c.data, c.pos, self._so, self._sl))
        c.skip(pad(slen))
        if shape is None:
            return name, None
        if len(shape) > 1:
            raise _unsupported(f"attribute of rank {len(shape)} ({name!r})")
        count = int(np.prod(shape, dtype=np.int64))
        vals = self._decode(c.raw(count * t.size), t, count)
        if t.kind == "num":
            vals = vals.astype(vals.dtype.newbyteorder("="))
        return name, (vals[0] if shape == () else vals)

    # -- datasets ----------------------------------------------------------
    def _dataset(self, path: str) -> _Dataset:
        ds = self._datasets.get(path)
        if ds is not None:
            return ds
        shape = dtype = layout = None
        filters, fill = [], None
        for mtype, body in self._messages(self._resolve(path)):
            c = _Cursor(body, 0, self._so, self._sl)
            if mtype == _DATASPACE:
                shape = self._dataspace(c)
            elif mtype == _DATATYPE:
                dtype = self._datatype(c)
            elif mtype == _LAYOUT:
                layout = self._layout(c)
            elif mtype == _FILTERS:
                filters = self._filters(c)
            elif mtype == _FILL:
                fill = self._fill(c)
            elif mtype == _FILL_OLD and fill is None:
                fill = c.raw(c.u(4)) or None
            elif mtype == _EXTERNAL:
                raise _unsupported("external data files")
        if layout is None or dtype is None:
            raise ValueError(f"{path!r} is not a dataset")
        if shape is None:
            shape = (0,)
        if len(shape) > 1:
            raise _unsupported(f"dataset of rank {len(shape)} ({path!r})")
        for fid, _, _ in filters:
            if fid not in (1, 2):
                raise _unsupported(
                    f"filter {_FILTER_NAMES.get(fid, f'id {fid}')} "
                    f"({path!r})")
        ds = _Dataset(shape, dtype, layout, filters, fill)
        self._datasets[path] = ds
        return ds

    def _layout(self, c: _Cursor) -> dict:
        ver = c.u(1)
        if ver in (1, 2):
            rank, cls = c.u(1), c.u(1)
            c.skip(5)
            addr = c.off() if cls != 0 else None
            dims = [c.u(4) for _ in range(rank)]
            if cls == 0:
                return {"class": "compact", "data": c.raw(c.u(4))}
            if cls == 1:
                return {"class": "contiguous", "addr": addr}
            return {"class": "chunked", "addr": addr, "dims": dims[:-1]}
        if ver not in (3, 4):
            raise _unsupported(f"data layout message version {ver}")
        cls = c.u(1)
        if cls == 0:
            return {"class": "compact", "data": c.raw(c.u(2))}
        if cls == 1:
            return {"class": "contiguous", "addr": c.off()}
        if cls == 3:
            raise _unsupported("virtual dataset layout")
        if ver == 3:
            rank = c.u(1)
            addr = c.off()
            dims = [c.u(4) for _ in range(rank)]
            return {"class": "chunked", "addr": addr, "dims": dims[:-1]}
        c.skip(1)                                      # flags
        rank, enc = c.u(1), c.u(1)
        c.skip(rank * enc)
        index = c.u(1)
        name = _CHUNK_INDEX_NAMES.get(index, index)
        raise _unsupported(f"chunk index {name} (layout version 4)")

    def _filters(self, c: _Cursor) -> list:
        ver, n = c.u(1), c.u(1)
        if ver == 1:
            c.skip(6)
        elif ver != 2:
            raise _unsupported(f"filter pipeline message version {ver}")
        out = []
        for _ in range(n):
            fid = c.u(2)
            nlen = c.u(2) if ver == 1 or fid >= 256 else 0
            flags, ncd = c.u(2), c.u(2)
            c.skip(nlen + ((-nlen) % 8 if ver == 1 else 0))
            cd = [c.u(4) for _ in range(ncd)]
            if ver == 1 and ncd % 2:
                c.skip(4)
            out.append((fid, flags, cd))
        return out

    def _fill(self, c: _Cursor):
        ver = c.u(1)
        if ver in (1, 2):
            c.skip(2)
            defined = c.u(1)
            if ver == 1 or defined:
                n = c.u(4)
                return c.raw(n) if defined and n else None
            return None
        flags = c.u(1)
        if flags & 0x20:
            n = c.u(4)
            return c.raw(n) or None
        return None

    def read(self, path: str, lo: int | None = None, hi: int | None = None,
             out_dtype=None) -> np.ndarray:
        """Rows ``[lo, hi)`` of the 1-D (or scalar) dataset at ``path``,
        as ``out_dtype`` (default: the stored type, native byte order;
        variable-length strings as ``str`` objects). A chunked dataset
        decompresses only the chunks that meet the rows."""
        ds = self._dataset(path)
        n = int(ds.shape[0]) if ds.shape else 1
        lo = 0 if lo is None else int(lo)
        hi = n if hi is None else int(hi)
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"{path!r}: rows [{lo}, {hi}) outside its {n} "
                             f"rows")
        t = ds.dtype
        if out_dtype is None:
            out_dtype = (object if t.kind == "vlen_str"
                         else t.dtype.newbyteorder("="))
        out = np.empty(hi - lo, out_dtype)
        if hi > lo:
            lay = ds.layout
            if lay["class"] == "chunked" and t.kind == "num":
                self._read_chunked(path, ds, lo, hi, out)
            elif lay["class"] == "chunked":
                self._read_chunked_plain(path, ds, lo, hi, out)
            else:
                if lay["class"] == "compact":
                    raw = lay["data"][lo * t.size:hi * t.size]
                    if len(raw) < (hi - lo) * t.size:
                        raise ValueError(f"{path!r}: compact data too short")
                elif lay["addr"] == self._undef:
                    raw = None
                else:
                    raw = self._read(lay["addr"] + lo * t.size,
                                     (hi - lo) * t.size)
                if raw is None:
                    out[:] = self._fill_values(ds, hi - lo)
                else:
                    out[:] = self._decode(raw, t, hi - lo)
        return out.reshape(()) if ds.shape == () else out

    def _fill_values(self, ds: _Dataset, count: int):
        if ds.fill is None:
            return 0
        return self._decode(ds.fill * count, ds.dtype, count)

    def _chunk_index(self, ds: _Dataset) -> list:
        """``[(first row, stored size, filter mask, address)]`` of every
        chunk, in row order, from the v1 B-tree (type 1) of any depth."""
        if ds._chunks is None:
            out = []
            if ds.layout["addr"] != self._undef:
                stack = [ds.layout["addr"]]
                while stack:
                    node = self._btree_node(stack.pop(), 1, rank=1)
                    if node["level"] > 0:
                        stack.extend(reversed(node["children"]))
                        continue
                    for (size, mask, offs), a in zip(node["keys"],
                                                      node["children"]):
                        out.append((offs[0], size, mask, a))
            out.sort()
            ds._chunks = out
        return ds._chunks

    def _chunk_table(self, ds: _Dataset):
        """:meth:`_chunk_index` as int64 arrays ``(first row, stored size,
        filter mask, file offset)``; an undefined address as -1."""
        if ds._chunk_arrays is None:
            chunks = self._chunk_index(ds)
            ds._chunk_arrays = tuple(
                np.array([c[i] for c in chunks], np.int64) for i in range(3)
            ) + (np.array([-1 if c[3] == self._undef else self._base + c[3]
                           for c in chunks], np.int64),)
        return ds._chunk_arrays

    def _read_chunked(self, path, ds: _Dataset, lo, hi, out) -> None:
        """Rows ``[lo, hi)`` of a chunked dataset of fixed-size elements
        into ``out``: the chunks that meet them are picked here, and one
        native call decodes them (``native.decode_h5_chunks``); rows no
        chunk holds read as the fill value."""
        t = ds.dtype
        cn = ds.layout["dims"][0]
        first, size, mask, addr = self._chunk_table(ds)
        k0 = max(0, int(np.searchsorted(first, lo, "right")) - 1)
        k1 = int(np.searchsorted(first, hi, "left"))
        sel = np.arange(k0, max(k0, k1))
        sel = sel[first[sel] + cn > lo]
        first, size, mask, addr = first[sel], size[sel], mask[sel], addr[sel]
        bad = np.flatnonzero((addr < 0) | (addr + size > self._size))
        if len(bad):
            k = bad[0]
            if addr[k] < 0:
                raise ValueError("HDF5: read at an undefined address")
            raise ValueError(f"HDF5: {size[k]} bytes at {addr[k]} lie beyond "
                             f"the end of {self.path} ({self._size} bytes): "
                             f"truncated file")
        fids = [fid for fid, _, _ in ds.filters]
        fes = [(cd[0] if cd else t.size) if fid == 2 else 0
               for fid, _, cd in ds.filters]
        target = out
        if not native.h5_writes(t.dtype, out.dtype):
            # a cast the decoder does not make: numpy's, from the stored
            # type (zeroed: rows no chunk holds are cast too)
            target = np.zeros(hi - lo, t.dtype.newbyteorder("="))
        rc, stats = native.decode_h5_chunks(
            self._fh.fileno(), addr, size, mask, first, cn, fids, fes,
            t.dtype, target, lo, hi)
        count = self.counters
        count["chunks_inflated"] += int(stats[0])
        count["bytes_inflated"] += int(stats[1])
        count["inflate_s"] += float(stats[2]) * 1e-9
        count["unshuffle_s"] += float(stats[3]) * 1e-9
        count["chunks_native"] += len(sel)
        if rc:
            row = int(first[stats[4]])
            if rc == native.H5_INFLATE:
                raise ValueError(f"{path!r}: chunk at row {row} does not "
                                 f"inflate (zlib error {int(stats[5])})")
            if rc == native.H5_SIZE:
                raise ValueError(f"{path!r}: chunk at row {row} holds "
                                 f"{int(stats[5])} bytes, expected "
                                 f"{cn * t.size}")
            raise ValueError(f"HDF5: the chunk at row {row} of {path!r} "
                             f"read short ({int(stats[5])} of "
                             f"{int(size[stats[4]])} bytes)")
        if target is not out:
            out[:] = target
        held = np.minimum(hi, first + cn) - np.maximum(lo, first)
        if int(held.sum()) != hi - lo:
            self._fill_uncovered(ds, lo, hi, out)

    def _fill_uncovered(self, ds: _Dataset, lo, hi, out) -> None:
        """Rows of ``[lo, hi)`` that no chunk holds read as the fill
        value, as HDF5 does."""
        cn = ds.layout["dims"][0]
        mask = np.ones(hi - lo, bool)
        for first, _, _, _ in self._chunk_index(ds):
            mask[max(0, first - lo):max(0, min(hi, first + cn) - lo)] = False
        out[mask] = self._fill_values(ds, int(mask.sum()))

    def _read_chunked_plain(self, path, ds: _Dataset, lo, hi, out) -> None:
        """:meth:`_read_chunked` one chunk at a time in Python and
        ``zlib`` (the loop the native decoder replaced): the twin the tests
        hold the native call to, and the reader of chunked variable-length
        strings."""
        t = ds.dtype
        cn = ds.layout["dims"][0]
        chunks = self._chunk_index(ds)
        starts = [ch[0] for ch in chunks]
        covered = 0
        k = max(0, int(np.searchsorted(starts, lo, "right")) - 1)
        count = self.counters
        clock = time.perf_counter
        for first, size, mask, addr in chunks[k:]:
            if first >= hi:
                break
            if first + cn <= lo:
                continue
            data = self._read(addr, size)
            for i in reversed(range(len(ds.filters))):
                if mask >> i & 1:
                    continue
                fid, _, cd = ds.filters[i]
                t0 = clock()
                if fid == 1:
                    try:
                        data = zlib.decompress(data)
                    except zlib.error as exc:
                        raise ValueError(f"{path!r}: chunk at row {first} "
                                         f"does not inflate: {exc}") from None
                    count["chunks_inflated"] += 1
                    count["bytes_inflated"] += len(data)
                    count["inflate_s"] += clock() - t0
                else:
                    es = cd[0] if cd else t.size
                    data = (np.frombuffer(data, np.uint8)
                            .reshape(es, -1).T.tobytes())
                    count["unshuffle_s"] += clock() - t0
            if len(data) != cn * t.size:
                raise ValueError(f"{path!r}: chunk at row {first} holds "
                                 f"{len(data)} bytes, expected {cn * t.size}")
            a, b = max(lo, first), min(hi, first + cn)
            vals = self._decode(data[(a - first) * t.size:
                                     (b - first) * t.size], t, b - a)
            out[a - lo:b - lo] = vals
            covered += b - a
        if covered != hi - lo:
            self._fill_uncovered(ds, lo, hi, out)
