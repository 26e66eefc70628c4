"""Scale-space ladder construction (SIFT-style octaves of Gaussians).

A copy of ``mustache_tpu/scalespace.py`` (framework-free; the port must
not import the JAX package) plus :func:`ladder_tensor`, which carries the
f64 ladder weights over to the port's f32 device tensor.

The reference builds, per octave ``o``, twelve Gaussian blurs with sigmas
``o * 2^(k/10)`` for ``k = 0..11`` (mustache.py:714-752, s hardcoded 10),
takes difference-of-Gaussian planes ``L_k = G_k - G_{k+1}``, and detects on
the nine interior planes ``L_1..L_9`` whose recorded detection scale is
``o * 2^((k+1)/10)``.

Kernel weights replicate ``scipy.ndimage.gaussian_filter`` exactly: the
reference chooses ``truncate`` so the kernel radius is ``ceil(2*sigma)``
(mustache.py:717-719), and scipy's discrete kernel is the normalized
sampled Gaussian. All weights are computed in float64 and zero-padded to
the ladder's maximum radius so the whole ladder runs as one batched
separable convolution (zero taps are exact no-ops, and symmetric padding by
the maximum radius reproduces scipy's per-sigma ``reflect`` boundary).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SUBDIVISIONS = 10  # the reference hardcodes s=10 (mustache.py:711)


def kernel_radius(sigma: float) -> int:
    """The radius scipy actually uses for the reference's blur call.

    The reference picks ``truncate`` so the radius *should* be
    ``ceil(2*sigma)`` (mustache.py:717-719), but scipy computes
    ``int(truncate*sigma + 0.5)`` and the float64 round-trip
    ``(3.5/sigma)*sigma`` can land a hair under the integer, truncating the
    radius to ``ceil(2*sigma) - 1`` for some sigmas. Bit-compatibility
    requires reproducing that exact arithmetic.
    """
    w = 2 * math.ceil(2 * sigma) + 1
    t = ((w - 1) / 2 - 0.5) / sigma
    return int(t * float(sigma) + 0.5)


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """scipy-compatible sampled-Gaussian weights."""
    if radius is None:
        radius = kernel_radius(sigma)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    # parenthesization matters for the bit-for-bit scipy claim: scipy's
    # _gaussian_kernel1d computes (-0.5 / sigma2) * (x ** 2); the
    # left-to-right ((-0.5/s2) * x) * x form differs by 1 ulp for most
    # sigmas
    phi = np.exp(-0.5 / (sigma * sigma) * (x * x))
    return phi / phi.sum()


def octave_sigmas(octave: float, s: int = SUBDIVISIONS) -> list[float]:
    """Twelve blur sigmas of one octave: ``octave * 2^(k/s)``, k=0..11."""
    return [octave * 2.0 ** (k / s) for k in range(s + 2)]


@dataclasses.dataclass(frozen=True)
class LadderSpec:
    """Static description of the full multi-octave blur ladder."""

    octave_values: tuple[float, ...]
    blur_sigmas: tuple[float, ...]          # all blurs, octave-major, 12/octave
    kernels: np.ndarray                      # [n_blurs, 2*R+1] f64, zero-padded
    radius: int                              # common (max) kernel radius
    det_sigmas: tuple[float, ...]            # detection scale per plane (f64)
    det_ceil: tuple[int, ...]                # ceil(det_sigma) per plane

    @property
    def n_blurs(self) -> int:
        return len(self.blur_sigmas)

    @property
    def planes_per_octave(self) -> int:
        return SUBDIVISIONS - 1  # nine detection planes per octave

    @property
    def n_planes(self) -> int:
        return len(self.det_sigmas)


def build_ladder(octave_values) -> LadderSpec:
    blur_sigmas: list[float] = []
    det_sigmas: list[float] = []
    for o in octave_values:
        sig = octave_sigmas(o)
        blur_sigmas.extend(sig)
        # detection plane j (j=1..9) records sigma o*2^((j+1)/10)
        det_sigmas.extend(sig[2:11])
    radius = max(kernel_radius(s) for s in blur_sigmas)
    kernels = np.zeros((len(blur_sigmas), 2 * radius + 1), dtype=np.float64)
    for i, s in enumerate(blur_sigmas):
        k = gaussian_kernel_1d(s)
        r = (len(k) - 1) // 2
        kernels[i, radius - r: radius + r + 1] = k
    return LadderSpec(
        octave_values=tuple(octave_values),
        blur_sigmas=tuple(blur_sigmas),
        kernels=kernels,
        radius=radius,
        det_sigmas=tuple(det_sigmas),
        det_ceil=tuple(int(math.ceil(s)) for s in det_sigmas),
    )


def ladder_tensor(kernels: np.ndarray, device) -> "torch.Tensor":
    """The ladder taps ``LadderSpec.kernels`` ([S, 2R+1] f64, zero-padded)
    as the f32 contiguous device tensor the blur kernels read. Rounding to
    f32 is the one precision step, the same one the JAX f32 path takes
    (``spec.kernels.astype(float32)``)."""
    import torch

    return torch.as_tensor(np.ascontiguousarray(kernels, np.float32),
                           device=device)
