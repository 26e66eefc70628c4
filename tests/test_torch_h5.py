"""The port's own HDF5 reader (``mustache_tpu_torch/io/h5.py``) and the
``.cool`` reader on it (``io/cool.py``), against h5py and the JAX
package's reader, on files h5py writes here:

* every schema variant of ``tests/test_cool_fuzz.py::build_cool_variant``
  (int32/uint32 ids, int32 offsets, float counts, chunks of 64, with gzip,
  extra bins columns, an empty chromosome, an empty file);
* cooler's own layout: gzip 6 with shuffle on every column, chunked (a
  chunk B-tree of two levels), ``bins/chrom`` as an enum, variable-length
  string attributes, an inter rectangle, NaN weights; and an ``.mcool``
  of two resolutions;
* files of ``tools/write_cool.py`` (the h5py-free writer), which h5py
  reads back equal to the inputs.

Each file reads equal to h5py dataset by dataset and attribute by
attribute, and ``read_cooler`` / ``read_mcooler`` equal to the JAX
reader's triplets (intra and inter, balanced and not). Unsupported
features raise a ``ValueError`` naming them. A subprocess with h5py
blocked gives the CLI's TSV of this process."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_cases as C
from mustache_tpu.io import cool as jcool
from mustache_tpu_torch.io import cool as tcool
from mustache_tpu_torch.io import h5
from synthetic import synthetic_hic

h5py = pytest.importorskip("h5py")
from test_cool_fuzz import (  # noqa: E402
    D_PX, N_BINS, _pixels, build_cool_variant,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import write_cool  # noqa: E402

RES = 5000


def _same_as_h5py(path):
    """Every group's members and attributes and every dataset of ``path``
    equal between h5py and the port's reader; whole and sliced reads."""
    with h5py.File(path, "r") as f, h5.H5File(path) as g:
        def visit(name, obj):
            got_attrs = g.attrs(name)
            assert set(got_attrs) == set(obj.attrs), name
            for k, v in obj.attrs.items():
                assert np.array_equal(np.asarray(got_attrs[k]),
                                      np.asarray(v)), (name, k)
            if isinstance(obj, h5py.Group):
                assert g.keys(name) == sorted(obj), name
                return
            want = np.asarray(obj[()])
            nan = want.dtype.kind == "f"
            got = g.read(name)
            # the stored type in native byte order
            assert got.dtype == want.dtype.newbyteorder("="), name
            assert np.array_equal(got, want, equal_nan=nan), name
            if want.ndim == 0:
                return
            n = len(want)
            for lo, hi in ((0, n), (n // 3, n // 2), (max(n - 7, 0), n)):
                assert np.array_equal(g.read(name, lo, hi), want[lo:hi],
                                      equal_nan=nan), name
                if want.dtype.kind in "iuf":
                    assert np.array_equal(g.read(name, lo, hi, np.float64),
                                          want[lo:hi].astype(np.float64),
                                          equal_nan=nan), name

        assert g.keys() == sorted(f)
        visit("", f)
        f.visititems(visit)


def _triplets_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_as_jax(path, pairs, res=None, balances=(False, True)):
    for bal in balances:
        for c1, c2 in pairs:
            if res is None:
                got = tcool.read_cooler(path, 300_000, c1, c2, bal)
                want = jcool.read_cooler(path, 300_000, c1, c2, bal)
                assert got[3] == want[3]
                _triplets_equal(got[:3], want[:3])
            else:
                _triplets_equal(
                    tcool.read_mcooler(path, 300_000, c1, c2, res, bal),
                    jcool.read_mcooler(path, 300_000, c1, c2, res, bal))
    assert tcool.cool_chrom_list(path, res) == jcool.cool_chrom_list(path,
                                                                     res)


@pytest.mark.parametrize("variant", [
    dict(id_dtype=np.int32), dict(id_dtype=np.uint32),
    dict(offset_dtype=np.int32), dict(count_dtype=np.float64),
    dict(count_dtype=np.float32), dict(chunks=64),
    dict(chunks=64, compression="gzip"),
    dict(extra_bins_cols=("KR", "VC")), "empty chromosome", "empty file",
])
def test_fuzz_variants_read_like_h5py_and_jax(tmp_path, variant):
    x, y, v = _pixels(N_BINS, D_PX, seed=41)
    path = str(tmp_path / "v.cool")
    chroms, pixels, kw = [("chr1", N_BINS * RES)], {"chr1": (x, y, v)}, {}
    if variant == "empty chromosome":
        chroms = [("chr1", N_BINS * RES), ("chr2", 200 * RES),
                  ("chr3", N_BINS * RES)]
        pixels = {"chr1": (x, y, v), "chr3": (x, y, v)}
    elif variant == "empty file":
        pixels = {}
    else:
        kw = variant
    build_cool_variant(path, chroms, RES, pixels, **kw)
    _same_as_h5py(path)
    _same_as_jax(path, [(c, c) for c, _ in chroms])


PAIRS = [("chr1", "chr1"), ("chr2", "chr2"), ("chr1", "chr2"),
         ("chr2", "chr1")]


def test_cooler_layout_and_mcool(tmp_path):
    path = str(tmp_path / "c.cool")
    npix = C.write_cooler_layout(path)
    with h5.H5File(path) as g:
        ds = g._dataset("pixels/count")
        # shuffle, then deflate
        assert ds.filters[0][0] == 2 and ds.filters[1][0] == 1
        root = g._btree_node(ds.layout["addr"], 1, rank=1)
        assert root["level"] >= 1                       # a two-level tree
        assert len(g._chunk_index(ds)) == -(-npix // 100) > 64
        assert g.attrs("")["generated-by"] == "cooler-0.9.3"
    _same_as_h5py(path)
    _same_as_jax(path, PAIRS, balances=(False, True, "weight"))
    mcool = str(tmp_path / "c.mcool")
    for res, n1 in ((RES, 900), (2 * RES, 450)):
        C.write_cooler_layout(mcool, f"resolutions/{res}", n1=n1, n2=250,
                              res=res)
    with h5py.File(mcool, "a") as f:
        f.attrs["format"] = "HDF5::MCOOL"
    _same_as_h5py(mcool)
    _same_as_jax(mcool, PAIRS[:3], res=RES)
    with pytest.raises(ValueError, match="explicit resolution"):
        tcool.CoolFile(mcool)
    with pytest.raises(ValueError, match=r"available: \['10000', '5000'\]"):
        tcool.CoolFile(mcool, resolution=1000)


def test_slices_inflate_only_their_chunks(tmp_path, monkeypatch):
    path = str(tmp_path / "c.cool")
    C.write_cooler_layout(path)
    calls = []
    real = h5.zlib.decompress
    monkeypatch.setattr(h5.zlib, "decompress",
                        lambda b: calls.append(1) or real(b))
    with h5.H5File(path) as g, h5py.File(path, "r") as f:
        got = g.read("pixels/bin2_id", 1050, 1150, np.int64)
        assert np.array_equal(got, f["pixels/bin2_id"][1050:1150])
    assert len(calls) == 2                  # rows 1000-1199: two chunks


def test_unsupported_features_raise_by_name(tmp_path):
    cases = {
        "fletcher32": lambda f: f.create_dataset(
            "d", data=np.arange(100), chunks=(10,), fletcher32=True),
        "chunk index": lambda f: f.create_dataset(
            "d", data=np.arange(100), chunks=(10,)),
        "dense attribute storage": lambda f: [
            f.attrs.__setitem__(f"a{i}", i) for i in range(20)],
        "soft link": lambda f: f.__setitem__("s", h5py.SoftLink("/x")),
        "compound": lambda f: f.create_dataset(
            "d", data=np.zeros(3, [("a", "i4"), ("b", "f8")])),
    }
    for feature, make in cases.items():
        path = str(tmp_path / f"{feature.replace(' ', '_')}.h5")
        latest = feature in ("chunk index", "dense attribute storage")
        with h5py.File(path, "w", libver="latest" if latest else None) as f:
            make(f)
        with h5.H5File(path) as g, pytest.raises(ValueError, match=feature):
            g.attrs("")
            for name in g.keys():
                g.read(name)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        open(tmp_path / "x.cool", "wb").write(b"\0" * 600)
        h5.H5File(str(tmp_path / "x.cool"))


def test_write_cool_files_read_back(tmp_path):
    x1, y1, v1, _ = synthetic_hic(400, 60, seed=71, n_loops=5)
    x2, y2, v2, _ = synthetic_hic(300, 60, seed=72, n_loops=5)
    chroms = [("chr1", 400 * RES), ("chr2", 300 * RES), ("chrM", 16_000)]
    pixels = {"chr1": (x1, y1, v1), "chr2": (x2, y2, v2),
              ("chr1", "chr2"): (x1[:500] % 400, y1[:500] % 300, v1[:500])}
    w = np.linspace(0.5, 1.5, 704)
    w[::29] = np.nan
    path, mcool = str(tmp_path / "w.cool"), str(tmp_path / "w.mcool")
    write_cool.write_cool(path, chroms, RES, pixels, w, np.float64)
    write_cool.write_mcool(mcool, {RES: (chroms, pixels, w),
                                   2 * RES: (chroms[:1], {"chr1": (
                                       x1 // 2, y1 // 2, v1)}, None)})
    with h5py.File(path, "r") as f:
        assert f.attrs["bin-size"] == RES
        assert list(f["chroms/name"][:]) == [b"chr1", b"chr2", b"chrM"]
        assert np.array_equal(f["bins/weight"][:], w, equal_nan=True)
        b1 = f["pixels/bin1_id"][:]
        assert np.all(np.diff(b1) >= 0) and len(b1) == len(v1) + len(v2) + 500
        assert f["pixels/count"].dtype == np.float64
        assert sorted(f["pixels/count"][:]) == sorted(
            np.concatenate([v1, v2, v1[:500]]))
    with h5py.File(mcool, "r") as f:
        assert sorted(f["resolutions"]) == ["10000", "5000"]
        assert f["resolutions/10000"].attrs["bin-size"] == 2 * RES
    _same_as_h5py(path)
    _same_as_h5py(mcool)
    _same_as_jax(path, PAIRS)
    _same_as_jax(mcool, PAIRS, res=RES)


SCRIPT = r"""
import sys
sys.modules["h5py"] = None            # any import of h5py now fails
sys.path[:0] = [ROOT, ROOT + "/tests"]
from mustache_tpu_torch import cli
rc = cli.main(["-f", COOL, "-ch", "chr1", "-r", "5kb", "-d", "300kb", "-o",
               OUT, "-pt", "0.1", "-st", "0.8", "--engine-platform", "cpu"])
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("jax", "jaxlib", "mustache_tpu", "h5py"))
print("RC", rc, "BAD_MODULES", bad)
"""


def test_cli_on_cool_without_h5py(tmp_path):
    """The CLI on a ``.cool`` in a fresh interpreter where h5py cannot be
    imported: the TSV of this process's run, and no h5py or JAX loaded."""
    from mustache_tpu_torch import cli

    x, y, v, _ = synthetic_hic(400, 60, seed=3, n_loops=6)
    cool = str(tmp_path / "m.cool")
    build_cool_variant(cool, [("chr1", 400 * RES)], RES,
                       {"chr1": (x, y, np.round(v))})
    here, there = str(tmp_path / "here.tsv"), str(tmp_path / "there.tsv")
    assert cli.main(["-f", cool, "-ch", "chr1", "-r", "5kb", "-d", "300kb",
                     "-o", here, "-pt", "0.1", "-st", "0.8",
                     "--engine-platform", "cpu"]) == 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(C.SUBPROCESS_ENV)
    script = (SCRIPT.replace("ROOT", repr(ROOT)).replace("COOL", repr(cool))
              .replace("OUT", repr(there)))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RC 0 BAD_MODULES []" in res.stdout, res.stdout
    rows = open(here).read()
    assert rows.count("\n") > 3 and open(there).read() == rows


def test_committed_card_fixtures():
    """The files ``chip_smoke.py`` phase 11 reads on the card (no h5py
    there): equal to h5py here, and the port's triplets match the
    committed digests of the JAX reader's (``tools/make_torch_golden.py
    --slice cool_card``)."""
    import chip_smoke

    for path in C.COOL_CARD.values():
        _same_as_h5py(path)
        assert os.path.getsize(path) < 150_000
    want = C.load_golden(chip_smoke.COOL_EXPECTED)
    got = chip_smoke.cool_digests(tcool, C.COOL_CARD["cool"],
                                  C.COOL_CARD["mcool"])
    assert got == {k: v for k, v in want.items() if not k.startswith("_")}


def test_compact_and_big_endian_datasets(tmp_path):
    """A compact layout (the data inside the object header), big-endian
    integers and floats, a scalar, and a chunked column with unwritten
    chunks (their rows read as the fill value)."""
    path = str(tmp_path / "misc.h5")
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32LE,
                             h5py.h5s.create_simple((5,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5, dtype=np.int32))
        f.create_dataset("be_i8", data=np.arange(9, dtype=">i8"))
        f.create_dataset("be_f4", data=np.linspace(0, 1, 7).astype(">f4"))
        f.create_dataset("scalar", data=2.5)
        part = f.create_dataset("sparse", shape=(100,), chunks=(10,),
                                dtype=np.int16, fillvalue=7)
        part[20:30] = 3
    with h5.H5File(path) as g:
        assert g._dataset("compact").layout["class"] == "compact"
        assert float(g.read("scalar")) == 2.5
    _same_as_h5py(path)
