"""The port's copies of the host config and ladder vs the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import mustache_tpu.config as jcfg
import mustache_tpu.scalespace as jss
import mustache_tpu_torch.config as tcfg
import mustache_tpu_torch.scalespace as tss


def test_detection_config_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.DetectionConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.DetectionConfig)]
    assert tf == jf
    for kw in ({}, {"resolution": 1000, "distance_bp": 2_000_000},
               {"sigma0": 2.0, "octaves": 3}):
        j, t = jcfg.DetectionConfig(**kw), tcfg.DetectionConfig(**kw)
        assert (t.distance_px, t.chunk_size, t.octave_values) == \
            (j.distance_px, j.chunk_size, j.octave_values)


@pytest.mark.parametrize("n,chunk,overlap", [
    (900, 2000, 400), (9629, 2000, 400), (12000, 4000, 2000), (2001, 2000, 1),
])
def test_chunk_grid_and_masks(n, chunk, overlap):
    js, je = jcfg.chunk_grid(n, chunk, overlap)
    ts, te = tcfg.chunk_grid(n, chunk, overlap)
    assert (ts, te) == (js, je)
    assert tcfg.block_mask_sizes(ts, te, overlap) == \
        jcfg.block_mask_sizes(js, je, overlap)


@pytest.mark.parametrize("s", ["5kb", "2Mb", "5000", "x1kb", "", 7000])
def test_parse_bp_and_clamp(s):
    assert tcfg.parse_bp(s) == jcfg.parse_bp(s)
    for res in (1000, 5000, 25000):
        for dist in (False, 1, 500_000, 2_000_000, 10**9):
            assert tcfg.clamp_distance_filter(dist, res) == \
                jcfg.clamp_distance_filter(dist, res)


@pytest.mark.parametrize("octaves", [(1.6, 3.2), (1.6, 3.2, 6.4)])
def test_build_ladder_bit_equal(octaves):
    j, t = jss.build_ladder(octaves), tss.build_ladder(octaves)
    assert t.kernels.dtype == np.float64
    assert np.array_equal(t.kernels, j.kernels)
    assert t.det_sigmas == j.det_sigmas and t.det_ceil == j.det_ceil
    assert t.radius == j.radius and t.blur_sigmas == j.blur_sigmas


def test_ladder_tensor_round_trip():
    spec = tss.build_ladder((1.6, 3.2))
    k = tss.ladder_tensor(spec.kernels, torch.device("cpu"))
    assert k.dtype == torch.float32 and k.is_contiguous()
    assert tuple(k.shape) == spec.kernels.shape
    assert np.array_equal(k.numpy(), spec.kernels.astype(np.float32))
