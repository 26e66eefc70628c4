"""The ladder route (``mustache_tpu_torch/ladder.py``, the JAX package's
XLA path in torch ops) on the CPU: the route table; float64 block
detection against the JAX package's float64 ``fn_single`` (rows, their
order, anchors and scales exact, q within rtol 1e-9) and against the
scipy oracle at the JAX test's own tolerance (rtol 1e-5, atol 1e-11), on
tests/test_detect.py's block; float32 with ``use_pallas="off"`` and a
5-octave ladder (radius 110) on both routes against the JAX XLA path
under the f32 rule (rows exact, q within rtol 2e-4); the kernel route
against the JAX fused gate over a grid of ladders; the band blur against the
dense two-pass blur; and the f32 kernel route's q against the float64
route's on a map where the two packages' f32 paths part (PERF.md §6)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import mustache_tpu.detect as jdetect
from mustache_tpu.config import DetectionConfig as JaxConfig
from mustache_tpu.normalize import normalize_sparse as jax_normalize
from mustache_tpu_torch import DetectionConfig, detect_loops_coo
from mustache_tpu_torch import detect as tdetect
from mustache_tpu_torch.diff import band_of
from mustache_tpu_torch.kernels import fused_ladder
from mustache_tpu_torch.ladder import band_blur
from mustache_tpu_torch.scalespace import build_ladder
from oracle import detect_block_oracle
from synthetic import synthetic_hic
import torch_port_cases  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: the suite runs six workers on a
    few cores, where torch's own thread pool only oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw,route", [
    (dict(), "kernel"),
    (dict(precision="float64"), "ladder"),
    (dict(use_pallas="off"), "ladder"),
    (dict(use_pallas="on"), "kernel"),
    (dict(use_pallas="on", precision="float64"), "ladder"),
    (dict(octaves=3), "kernel"),
    (dict(octaves=4), "kernel"),              # slab mode, 174,144 B, R=55
    (dict(octaves=5), "kernel"),              # streamed, 153,136 B, R=110
    (dict(octaves=6), "ladder"),              # R=220 > 127
    (dict(sigma0=3.0, octaves=4), "kernel"),  # streamed, 148,160 B, R=103
    (dict(sigma0=2.0, octaves=5), "ladder"),  # R=138 > 127
])
def test_resolve_route(kw, route):
    cfg = DetectionConfig(**kw)
    assert tdetect.resolve_route(cfg) == route
    spec = build_ladder(cfg.octave_values)
    if cfg.precision == "float32" and cfg.use_pallas != "off":
        assert fused_ladder.kernel_fits(spec.radius, cfg.octaves) == (
            route == "kernel")
    # the route is the configuration's alone (no device enters it)
    det = tdetect.build_detector(cfg, 300, device=CPU)
    assert det.route == route
    assert det.taps.dtype == (torch.float64 if cfg.precision == "float64"
                              else torch.float32)


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("sigma0", [1.0, 1.6, 2.0, 2.5, 3.0, 4.0])
def test_resolve_route_is_the_jax_gate(sigma0, precision):
    """The port's kernel route is exactly the JAX package's fused domain:
    ``resolve_route == "kernel"`` iff ``_resolve_pallas`` fuses the same
    configuration with ``use_pallas="on"``, for octaves 1-7."""
    for octaves in range(1, 8):
        cfg = DetectionConfig(sigma0=sigma0, octaves=octaves,
                              precision=precision)
        jcfg = JaxConfig(**{f: getattr(cfg, f)
                            for f in cfg.__dataclass_fields__})
        fused = jdetect._resolve_pallas(dataclasses.replace(
            jcfg, use_pallas="on"))
        assert (tdetect.resolve_route(cfg) == "kernel") == fused, (
            sigma0, octaves, precision)


def test_resolve_route_rejects_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        tdetect.resolve_route(DetectionConfig(precision="float16"))


def _block(n, d_px, seed, n_loops=25):
    """tests/test_detect.py::make_block: an exact-normalized dense block."""
    x, y, v, _ = synthetic_hic(n, d_px, seed=seed, n_loops=n_loops)
    jax_normalize(x, y, v, 5000, d_px, exact=True)
    c = np.zeros((n, n))
    c[x, y] = v
    return c


def _port_rows(c, cfg):
    """The port's rows for one dense block through its band path."""
    n = c.shape[0]
    Dl = tdetect.band_width(n, cfg.distance_px)
    band = band_of(torch.from_numpy(c), Dl, 0.0)
    det = tdetect.build_detector(cfg, n, device=CPU)
    out = tdetect.unpack_block(det.out_spec,
                               det.fn_band_packed(band, [0]).numpy()[0])
    return tdetect.finish_block(out, block_index=0, start=0, cfg=cfg,
                                spec=det.spec)


def _jax_rows(c, cfg):
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    det = jdetect.build_detector(jcfg, c.shape[0])
    out = jax.tree.map(np.asarray, det.fn_single(c))
    return jdetect.finish_block(out, block_index=0, start=0, cfg=jcfg,
                                spec=det.spec)


def _assert_rows(got, want, rtol, atol=0.0):
    assert len(want) > 3
    assert [(r[0], r[1], r[3]) for r in got] == \
        [(r[0], r[1], r[3]) for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def f64_block():
    """tests/test_detect.py's f64 block (N=700, d_px 120) through the port
    and, once, through the JAX package's float64 fn_single."""
    modes = jdetect._BH_MODE, tdetect._BH_MODE
    jdetect._BH_MODE = tdetect._BH_MODE = "sort"
    try:
        c = _block(700, 120, 11)
        cfg = DetectionConfig(resolution=5000, distance_bp=120 * 5000,
                              pt=0.2, st=0.88, precision="float64")
        return c, cfg, _port_rows(c, cfg), _jax_rows(c, cfg)
    finally:
        jdetect._BH_MODE, tdetect._BH_MODE = modes


def test_f64_block_matches_jax_f64(f64_block):
    _, _, got, want = f64_block
    _assert_rows(got, want, rtol=1e-9)


def test_f64_block_matches_oracle(f64_block):
    c, _, got, _ = f64_block
    ref = detect_block_oracle(c.copy(), [1.6, 3.2], 120, 0.88, 0.2)
    _assert_rows(got, [[int(r[0]), int(r[1]), r[2], r[3]] for r in ref],
                 rtol=1e-5, atol=1e-11)


@pytest.fixture(scope="module")
def jax_xla_rows():
    """The JAX package's f32 XLA rows of a block, computed once per
    (n, d_px, seed, octaves) in this module: both of the port's routes
    are held to the same rows."""
    cache = {}

    def rows(n, d_px, seed, cfg):
        key = (n, d_px, seed, cfg.octaves)
        if key not in cache:
            mode, jdetect._BH_MODE = jdetect._BH_MODE, "sort"
            try:
                c = _block(n, d_px, seed, n_loops=12).astype(np.float32)
                cache[key] = c, _jax_rows(c, cfg.with_(use_pallas="off"))
            finally:
                jdetect._BH_MODE = mode
        return cache[key]
    return rows


@pytest.mark.parametrize("n,d_px,seed,kw", [
    (700, 120, 12, dict(use_pallas="off")),
    # 5 octaves: radius 110, the kernel route in the streamed mode (here
    # its plain version) and the ladder route; the smallest block that
    # holds the pad and enough tested pixels
    (300, 64, 13, dict(octaves=5)),
    (300, 64, 13, dict(octaves=5, use_pallas="off")),
])
def test_f32_ladder_matches_jax_xla(n, d_px, seed, kw, jax_xla_rows,
                                   monkeypatch):
    monkeypatch.setattr(tdetect, "_BH_MODE", "sort")
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000, pt=0.2,
                          st=0.88, min_tested=5000, **kw)
    assert tdetect.resolve_route(cfg) == (
        "ladder" if kw.get("use_pallas") == "off" else "kernel")
    c, want = jax_xla_rows(n, d_px, seed, cfg)
    _assert_rows(_port_rows(c, cfg), want, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_blur_is_the_dense_blur_on_the_band(dtype):
    """The banded-matmul blur against the two conv2d passes of the plain
    version, sheared to the band, on the 3-octave ladder's 12 largest
    sigmas (radius 28) over blocks that are not a multiple of the slab."""
    spec = build_ladder((1.6, 3.2, 6.4))
    taps = torch.as_tensor(spec.kernels[24:], dtype=dtype)
    cs = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 237, 237))).to(dtype)
    cpad = fused_ladder._symmetric_pad(cs, spec.radius)
    for Dl in (128, 200):
        got = band_blur(cpad, taps, 237, Dl)
        want = torch.stack([band_of(fused_ladder._blur_octave(c, taps, 237),
                                    Dl, 0.0) for c in cpad])
        tol = 1e-12 if dtype == torch.float64 else 2e-5
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# PERF.md §6 (f32 tolerance), tools/f32_tolerance.py: on this map the
# port's f32 q and the JAX package's differ by 4.75e-4, more than the f32
# parity rule's 2e-4; against the float64 route the port sits 2.76e-4
# away and the JAX package 7.33e-4. Over 14 maps (2000 and 4000 bins at
# d_px 64) the port's f32 q stayed within 9.3e-4 of float64: the bound.
DRIFT_MAP = dict(n_bins=2000, d_px=64, seed=2)
F32_BOUND = 1e-3


def test_f32_kernel_route_within_bound_of_f64():
    m = DRIFT_MAP
    x, y, v, _ = synthetic_hic(m["n_bins"], m["d_px"], seed=m["seed"],
                               n_loops=40)
    cfg = DetectionConfig(resolution=5000, distance_bp=m["d_px"] * 5000,
                          pt=0.1, st=0.8)
    f32 = detect_loops_coo(x, y, v, cfg, device="cpu")
    f64 = detect_loops_coo(x, y, v, cfg.with_(precision="float64"),
                           device="cpu")
    common = {(lp.bin1, lp.bin2): lp.q for lp in f64}
    q32 = [(lp.q, common[(lp.bin1, lp.bin2)]) for lp in f32
           if (lp.bin1, lp.bin2) in common]
    assert len(q32) >= 0.95 * max(len(f32), len(f64)) and len(q32) > 10
    err = max(abs(a - b) / b for a, b in q32)
    assert err <= F32_BOUND, err
