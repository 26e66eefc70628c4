"""mustache-tpu, PyTorch/CUDA port (partial).

Multi-scale chromatin loop detection (scale-space difference of
Gaussians on Hi-C / Micro-C maps) for PyTorch, with the fused blur-ladder
/ DoG / NMS stage as a hand-written CUDA kernel for Hopper (sm_90a). It
sits beside the JAX package ``mustache_tpu``, which is its reference, and
never imports JAX.

It covers single-map intra-chromosomal detection at float32, from COO
triplets (``detect_loops_coo`` / ``find_loops`` -> ``write_loops``) or
from contact files through the CLI (``python -m mustache_tpu_torch``,
``mustache-tpu-torch``: text, HiC-Pro, .hic, and .cool / .mcool where
h5py is installed). What is still to port is listed in ROADMAP.md.
"""

from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.pipeline import Loop, detect_loops_coo, find_loops, write_loops

__all__ = [
    "DetectionConfig",
    "Loop",
    "detect_loops_coo",
    "find_loops",
    "write_loops",
]
