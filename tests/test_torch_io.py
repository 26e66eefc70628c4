"""The port's readers (``mustache_tpu_torch.io``) against the JAX
package's on the same files: ``(x, y, v)`` equal exactly, array for
array. Text (5- and 3-column, with and without a bias file, with rows
pandas drops), HiC-Pro, ``.hic`` v6/v8/v9 written by tests/hic_writer.py,
and ``.cool`` / ``.mcool`` where h5py is installed; plus chromosome
discovery and the size maps."""

import argparse

import numpy as np
import pytest

from mustache_tpu.io import bias as jbias
from mustache_tpu.io import chrom as jchrom
from mustache_tpu.io import hic as jhic
from mustache_tpu.io import hicpro as jhicpro
from mustache_tpu.io import text as jtext
from mustache_tpu_torch.io import bias as tbias
from mustache_tpu_torch.io import chrom as tchrom
from mustache_tpu_torch.io import hic as thic
from mustache_tpu_torch.io import hicpro as thicpro
from mustache_tpu_torch.io import text as ttext
from hic_writer import write_hic
from synthetic import synthetic_hic

RES = 5000


def _same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _coo(n=600, d_px=90, seed=5):
    x, y, v, _ = synthetic_hic(n, d_px, seed=seed, n_loops=8)
    return x, y, v


def _cell(c) -> str:
    """A float with at most 15 significant digits: pandas' default parser
    and a correctly rounded one agree on those (see test_text_round_trips_repr
    for 17)."""
    return f"{c:.15g}" if isinstance(c, float) else str(c)


def _text_rows(path, rows, sep="\t"):
    with open(path, "w") as fh:
        for r in rows:
            fh.write(sep.join(_cell(c) for c in r) + "\n")
    return str(path)


@pytest.fixture()
def text5(tmp_path):
    """Two chromosomes (one spelt without 'chr'), values with at most 15
    significant digits, contacts past the distance cut, in mixed order."""
    x, y, v = _coo()
    rng = np.random.default_rng(0)
    v = np.round(v * rng.uniform(0.5, 1.5, len(v)), 6)
    rows = [("chr21", a * RES, "chr21", b * RES, c) for a, b, c in zip(x, y, v)]
    x2, y2, v2 = _coo(300, 40, seed=9)
    rows += [("20", b * RES, "20", a * RES, c) for a, b, c in zip(x2, y2, v2)]
    rows += [("chr21", 10 * RES, "chr21", 500 * RES, 7.0),
             ("chr21", 10 * RES, "chr20", 11 * RES, 3.0)]
    order = rng.permutation(len(rows))
    return _text_rows(tmp_path / "c5.txt", [rows[i] for i in order])


@pytest.mark.parametrize("chrom", ["21", "chr21", "20", "chr20", "22"])
@pytest.mark.parametrize("dist", [200_000, 2_000_000])
def test_text_5col_matches_jax(text5, chrom, dist):
    _same(ttext.read_text_contacts(text5, dist, False, chrom, RES),
          jtext.read_text_contacts(text5, dist, False, chrom, RES))


@pytest.mark.parametrize("sep", ["\t", " ", ","])
def test_text_3col_matches_jax(tmp_path, sep):
    x, y, v = _coo(seed=6)
    path = _text_rows(tmp_path / "c3.txt",
                      [(a * RES + 2500, b * RES + 2500, c)
                       for a, b, c in zip(x, y, v)], sep)
    assert ttext.sniff_separator(path) == jtext.sniff_separator(path)
    _same(ttext.read_text_contacts(path, 300_000, False, "21", RES),
          jtext.read_text_contacts(path, 300_000, False, "21", RES))


def test_text_dropped_rows_match_jax(tmp_path):
    """Rows pandas' ``dropna`` removes (missing fields, NA tokens, short
    rows) are removed here too; blank lines are skipped."""
    rows = [("chr1", 0, "chr1", 5000, 4), ("chr1", 5000, "chr1", 10000, "NA"),
            ("chr1", "", "chr1", 5000, 2), ("chr1", 5000, "chr1", 5000, "nan"),
            ("chr1", 10000, "chr1", 20000), ("chr1", 10000, "chr1", 15000, 6.5)]
    path = _text_rows(tmp_path / "holes.txt", rows)
    with open(path, "a") as fh:
        fh.write("\nchr1\t0\tchr1\t0\t1\n")
    got = ttext.read_text_contacts(path, 2_000_000, False, "1", RES)
    _same(got, jtext.read_text_contacts(path, 2_000_000, False, "1", RES))
    assert list(got[2]) == [4.0, 6.5, 1.0]


def test_text_na_names_and_long_names(tmp_path):
    """A row whose name is an NA token is dropped as pandas drops it; a
    name of 64 bytes or more is refused (the reader keeps 63)."""
    rows = [("chr1", 0, "chr1", 5000, 4), ("NA", 0, "chr1", 5000, 3),
            ("chr1", 0, "null", 5000, 2), ("chr1", 5000, "chr1", 5000, 1)]
    path = _text_rows(tmp_path / "na.txt", rows)
    got = ttext.read_text_contacts(path, 2_000_000, False, "1", RES)
    _same(got, jtext.read_text_contacts(path, 2_000_000, False, "1", RES))
    assert list(got[2]) == [4.0, 1.0]
    ok = "c" * 63
    path = _text_rows(tmp_path / "long.txt", [(ok, 0, ok, 5000, 4)])
    assert list(ttext.read_text_contacts(path, 2_000_000, False, ok,
                                         RES)[2]) == [4.0]
    path = _text_rows(tmp_path / "long.txt", [(ok + "c", 0, "x", 5000, 4)])
    with pytest.raises(ValueError, match="64"):
        ttext.read_text_contacts(path, 2_000_000, False, "1", RES)


def test_text_round_trips_repr(tmp_path):
    """Values written with repr read back exactly (correctly rounded
    parse); pandas' default parser may land a few ulps off on 17 digits."""
    x, y, v = _coo(seed=7)
    v = v * np.random.default_rng(1).uniform(0.5, 1.5, len(v))
    path = _text_rows(tmp_path / "r.txt", [("chr2", a * RES, "chr2", b * RES,
                                            repr(float(c)))
                                           for a, b, c in zip(x, y, v)])
    got = ttext.read_text_contacts(path, 2_000_000, False, "2", RES)
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[2], v)
    want = jtext.read_text_contacts(path, 2_000_000, False, "2", RES)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-15, atol=0)


def test_read_table_chunks(tmp_path, monkeypatch):
    """Chunked parsing, with a chunk that needs the line-by-line path, gives
    the rows of a one-chunk read."""
    x, y, v = _coo(seed=8)
    rows = [("chr3", a * RES, "chr3", b * RES, c) for a, b, c in zip(x, y, v)]
    rows[700] = ("chr3", 5, "chr3", 5, "")
    path = _text_rows(tmp_path / "k.txt", rows)
    whole = ttext.read_text_contacts(path, 2_000_000, False, "3", RES)
    monkeypatch.setattr(ttext, "CHUNK_LINES", 256)
    _same(ttext.read_text_contacts(path, 2_000_000, False, "3", RES), whole)
    _same(whole, jtext.read_text_contacts(path, 2_000_000, False, "3", RES))


@pytest.fixture()
def bias_files(tmp_path):
    rng = np.random.default_rng(3)
    f3 = tmp_path / "b3.txt"
    with open(f3, "w") as fh:
        for i in range(600):
            val = "nan" if i % 53 == 0 else f"{rng.uniform(0.1, 2.0):.6f}"
            fh.write(f"chr21\t{i * RES + 2500}\t{val}\n")
        fh.write(f"chr5\t{3 * RES}\t9.0\n")
    f1 = tmp_path / "b1.txt"
    f1.write_text("".join(f"{rng.uniform(0.1, 2.0):.6f}\n"
                          for _ in range(700)))
    return str(f3), str(f1)


def test_text_with_bias_matches_jax(text5, bias_files):
    for path in bias_files:
        tb, jb = (tbias.read_bias(path, "chr21", RES),
                  jbias.read_bias(path, "chr21", RES))
        assert tb.by_line == jb.by_line
        np.testing.assert_array_equal(tb.as_array(700), jb.as_array(700))
        _same(ttext.read_text_contacts(text5, 2_000_000, tb, "21", RES),
              jtext.read_text_contacts(text5, 2_000_000, jb, "21", RES))
    assert tbias.read_bias("", "21", RES) is False


@pytest.fixture()
def hicpro_files(tmp_path):
    x, y, v = _coo(seed=11)
    offset = 100
    bed = tmp_path / "abs.bed"
    with open(bed, "w") as fh:
        for i in range(offset):
            fh.write(f"chr20\t{i * RES}\t{(i + 1) * RES}\t{i}\n")
        for i in range(600):
            fh.write(f"chr21\t{i * RES}\t{(i + 1) * RES}\t{offset + i}\n")
    mat = tmp_path / "raw.matrix"
    with open(mat, "w") as fh:
        fh.write("0\t1\t9\n")
        for a, b, c in zip(x, y, v):
            fh.write(f"{offset + a}\t{offset + b}\t{c:.15g}\n")
    return str(mat), str(bed)


@pytest.mark.parametrize("chrom", ["21", "chr20", "22"])
def test_hicpro_matches_jax(hicpro_files, bias_files, chrom):
    mat, bed = hicpro_files
    for bpath in ("",) + bias_files:
        tb, jb = (tbias.read_bias(bpath, chrom, RES),
                  jbias.read_bias(bpath, chrom, RES))
        _same(thicpro.read_hicpro(mat, bed, 1_000_000, tb, chrom, RES),
              jhicpro.read_hicpro(mat, bed, 1_000_000, jb, chrom, RES))


def _hic(tmp_path, version, **kw):
    x, y, v = _coo(seed=13)
    v = np.round(v) if kw.get("use_short_counts") else v
    x2, y2, v2 = _coo(300, 40, seed=14)
    kr = np.ones(600)
    kr[::41] = 2.5
    kr[7] = np.nan
    rng = np.random.default_rng(2)
    ix = rng.integers(0, 600, 200)
    iy = rng.integers(0, 300, 200)
    keep = np.unique(ix * 1000 + iy, return_index=True)[1]
    inter = (ix[keep], iy[keep], rng.poisson(5.0, len(keep)) + 1.0)
    path = str(tmp_path / f"t{version}.hic")
    write_hic(path, [("chr1", 600 * RES), ("chr2", 300 * RES)], RES,
              {"chr1": (x, y, v), "chr2": (x2, y2, v2),
               ("chr1", "chr2"): inter},
              version=version, norms={("KR", "chr1"): kr,
                                      ("KR", "chr2"): np.ones(300)}, **kw)
    return path


@pytest.mark.parametrize("version,kw", [
    (6, {}), (8, {}), (8, {"use_short_counts": True}), (9, {}),
    (9, {"use_short_counts": True}), (9, {"dense_blocks": True}),
    (9, {"dense_blocks": True, "use_short_counts": True}),
    (8, {"block_bins": 64}), (9, {"block_bins": 64})])
def test_hic_matches_jax(tmp_path, version, kw):
    path = _hic(tmp_path, version, **kw)
    for norm in (False, "KR", "NONE"):
        for dist in (100_000, 2_000_000):
            _same(thic.read_hic_file(path, norm, False, dist, "chr1", "chr1",
                                     RES),
                  jhic.read_hic_file(path, norm, False, dist, "chr1", "chr1",
                                     RES))
        _same(thic.read_hic_file(path, norm, False, 0, "chr2", "chr1", RES),
              jhic.read_hic_file(path, norm, False, 0, "chr2", "chr1", RES))
    th, jh = thic.HicFile(path), jhic.HicFile(path)
    try:
        assert th.version == jh.version == version
        assert th.chromosomes == [thic.HicChromosome(c.index, c.name, c.length)
                                  for c in jh.chromosomes]
        assert th.resolutions == jh.resolutions == [RES]
        assert th.genome == jh.genome
        np.testing.assert_array_equal(th.norm_vector("KR", 1, "BP", RES),
                                      jh.norm_vector("KR", 1, "BP", RES))
    finally:
        th.close()
        jh.close()


def test_hic_missing_norm_raises(tmp_path):
    path = _hic(tmp_path, 8)
    with pytest.raises(ValueError, match="VC"):
        thic.read_hic_file(path, "VC", False, 100_000, "chr1", "chr1", RES)


def test_hic_truncated_block_raises(tmp_path):
    """A row-list block whose records stop early raises IOError."""
    import struct
    import zlib

    path = _hic(tmp_path, 8)
    body = struct.pack("<iiibb", 5, 0, 0, 1, 1) + struct.pack("<hhh", 1, 0, 5)
    body += struct.pack("<hf", 1, 2.0)          # 1 of 5 records
    block = tmp_path / "block.bin"
    block.write_bytes(zlib.compress(body))
    hic = thic.HicFile(path)
    try:
        hic.f.close()
        hic.f = open(block, "rb")
        with pytest.raises(IOError, match="truncated"):
            hic._decode_block(thic._BlockEntry(0, 0, block.stat().st_size))
    finally:
        hic.close()


def test_chrom_sizes_and_discovery(tmp_path):
    sizes = tmp_path / "sizes.txt"
    sizes.write_text("chr1\t1000\n2\t500\nbad line\nchrX\t77\n")
    assert tchrom.read_chrom_sizes(str(sizes)) == \
        jchrom.read_chrom_sizes(str(sizes)) == \
        {"chr1": 1000, "chr2": 500, "chrX": 77}
    assert tchrom.chrom_matches("chr7", "7") and not tchrom.chrom_matches(
        "chr7", "17")

    # discovery and size maps of the CLI, on a .hic with no -ch
    from mustache_tpu.cli import _chromosome_lists as jlists
    from mustache_tpu_torch.cli import _chromosome_lists as tlists
    path = _hic(tmp_path, 9)
    args = argparse.Namespace(chromosome="n", chromosome2="n",
                              chrSize_file="")
    assert tlists(args, path, RES) == jlists(args, path, RES)
    assert tlists(args, path, RES)[0] == ["chr1", "chr2"]
    args = argparse.Namespace(chromosome=["21"], chromosome2="n",
                              chrSize_file=str(sizes))
    assert tlists(args, "x.txt", RES) == jlists(args, "x.txt", RES)


def _cool_files(tmp_path):
    pytest.importorskip("h5py")
    from test_cool import build_cool

    x, y, v = _coo(seed=15)
    x2, y2, v2 = _coo(300, 40, seed=16)
    chroms = [("chr1", 600 * RES), ("chr2", 300 * RES), ("chrM", 16_000)]
    pixels = {"chr1": (x, y, v), "chr2": (x2, y2, v2)}
    rng = np.random.default_rng(4)
    w = rng.uniform(0.5, 1.5, 600 + 300 + 4)
    w[::37] = np.nan
    cool = str(tmp_path / "m.cool")
    build_cool(cool, chroms, RES, pixels, weights=w)
    mcool = str(tmp_path / "m.mcool")
    build_cool(mcool, chroms, RES, pixels, weights=w,
               group=f"resolutions/{RES}")
    return cool, mcool


def test_cool_and_mcool_match_jax(tmp_path):
    cool, mcool = _cool_files(tmp_path)
    from mustache_tpu.io import cool as jcool
    from mustache_tpu_torch.io import cool as tcool

    for bal in (False, True, "weight"):
        for c1, c2 in (("chr1", "chr1"), ("chr2", "chr2"), ("chr2", "chr1")):
            got = tcool.read_cooler(cool, 300_000, c1, c2, bal)
            want = jcool.read_cooler(cool, 300_000, c1, c2, bal)
            assert got[3] == want[3] == RES
            _same(got[:3], want[:3])
            _same(tcool.read_mcooler(mcool, 300_000, c1, c2, RES, bal),
                  jcool.read_mcooler(mcool, 300_000, c1, c2, RES, bal))
    assert tcool.cool_chrom_list(cool) == jcool.cool_chrom_list(cool) \
        == ["chr1", "chr2"]
    assert tcool.cool_chrom_list(mcool, RES) == jcool.cool_chrom_list(mcool,
                                                                      RES)
    from mustache_tpu.cli import _chromosome_lists as jlists
    from mustache_tpu_torch.cli import _chromosome_lists as tlists
    args = argparse.Namespace(chromosome="n", chromosome2="n",
                              chrSize_file="")
    for path in (cool, mcool):
        assert tlists(args, path, RES) == jlists(args, path, RES)
    with pytest.raises(NameError):
        tcool.read_cooler(cool, 300_000, "chr9", "chr9", True)


def test_cool_without_h5py_raises(tmp_path, monkeypatch):
    """No h5py: opening a .cool raises the JAX reader's error; importing
    the module never needed h5py."""
    import builtins

    from mustache_tpu_torch.io import cool as tcool

    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(RuntimeError, match="requires h5py"):
        tcool.CoolFile(str(tmp_path / "x.cool"))
