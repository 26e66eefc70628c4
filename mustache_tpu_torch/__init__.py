"""mustache-tpu, PyTorch/CUDA port.

Multi-scale chromatin loop detection (scale-space difference of
Gaussians on Hi-C / Micro-C maps) for PyTorch, with the fused blur-ladder
/ DoG / NMS stage as a hand-written CUDA kernel for Hopper (sm_90a). It
sits beside the JAX package ``mustache_tpu``, which is its reference, and
never imports JAX.

It covers intra-chromosomal detection at float32 and float64, single-map
and differential, with the device, host or no normalize, and
inter-chromosomal detection (``inter.detect_inter_loops_coo``; the CLI's
``-ch2``): from COO triplets (``detect_loops_coo`` / ``find_loops`` ->
``write_loops``; ``detect_diff_loops_coo`` / ``find_diff_loops`` for two
conditions) or from contact files through the CLIs (``python -m
mustache_tpu_torch``, ``mustache-tpu-torch``; ``python -m
mustache_tpu_torch.diff_cli``, ``diff-mustache-tpu-torch``: text, HiC-Pro,
.hic, .cool and .mcool, the last two through the port's own HDF5 reader,
``io/h5.py``, without h5py), on one device, a mesh of devices (blocks
over its ``block`` axis, each block's rows over its ``row`` axis) or
several processes. ROADMAP.md lists what remains.
"""

from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.diff import detect_diff_loops_coo, find_diff_loops
from mustache_tpu_torch.pipeline import Loop, detect_loops_coo, find_loops, write_loops

__all__ = [
    "DetectionConfig",
    "Loop",
    "detect_diff_loops_coo",
    "detect_loops_coo",
    "find_diff_loops",
    "find_loops",
    "write_loops",
]
