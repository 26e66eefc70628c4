"""Distance normalization of a raw COO map, in plain PyTorch.

The reference's ``normalize_sparse`` (mustache.py:622-686; the frozen
oracle's ``normalize_sparse_oracle``), long-range branch: every diagonal
``d`` in ``[0, d_px + 1]`` is z-scored against a sliding window of
``F = 2 Mb / resolution`` bins (``np.convolve(..., "same")`` with a box
of ones, taken here as differences of float64 prefix sums that restart
every ``F`` bins), falling back to the diagonal's own mean and standard
deviation where the window holds fewer than 30 contacts, then scaled by
``1 + log30(1 + mean)``. Contacts beyond ``d_px + 1`` keep their raw
values.

The diagonals are the columns of a band ``[n, d_px + 2]`` (row ``x``,
column ``y - x``), so all of them are normalized at once. Every sum runs
in float64 whatever ``dtype`` the result takes.
"""

from __future__ import annotations

import math

import torch


def window_bins(resolution: int) -> int:
    """The reference's window: ``int(2_000_000 / resolution)`` bins."""
    return int(2_000_000 / resolution)


def normalize_coo(x: torch.Tensor, y: torch.Tensor, v: torch.Tensor,
                  resolution: int, d_px: int, *,
                  dtype=torch.float64) -> torch.Tensor:
    """Normalized values of the contacts ``(x, y, v)`` (int64, int64,
    float64 tensors on one device, ``x <= y``), in ``dtype``. ``v`` is
    not modified.

    Only the reference's long-range branch is transcribed: it is the one
    taken when ``(n - d_px) * resolution > 2 Mb``, which every map of the
    benchmark's deployments meets; a shorter map raises. The window of
    the shortest normalized diagonal must also hold ``F`` bins (its
    ``"same"`` convolution is then as long as the diagonal)."""
    dev = v.device
    n = int(torch.maximum(x.max(), y.max())) + 1
    if (n - d_px) * resolution <= 2_000_000:
        raise ValueError(f"n={n} bins at d_px={d_px}: the short-map branch "
                         f"of the reference normalize is not transcribed")
    F = window_bins(resolution)
    D = d_px + 2
    if n - (D - 1) < F:
        raise ValueError(f"diagonal {D - 1} of {n} bins is shorter than the "
                         f"window of {F} bins")
    dist = (y - x).abs()
    sel = dist < D
    xs, ds = x[sel], dist[sel]
    vs = v[sel].to(torch.float64)

    # the band of raw values and of presence; the window sums read
    # v + 0.001 at each contact, as the reference's ``vals`` does
    raw = torch.zeros((n, D), dtype=torch.float64, device=dev)
    raw[xs, ds] = vs
    pres = torch.zeros((n, D), dtype=torch.bool, device=dev)
    pres[xs, ds] = True
    presf = pres.to(torch.float64)

    # each diagonal's mean and population standard deviation (np.mean,
    # np.std of its contacts), two passes
    cnt = presf.sum(0)
    mean = raw.sum(0) / cnt
    std = torch.sqrt((((raw - mean) * presf) ** 2).sum(0) / cnt)
    mean_h = [0.0 if math.isnan(m) else m for m in mean.tolist()]
    std_h = [1.0 if math.isnan(s) else s for s in std.tolist()]
    factor_h = [1 + math.log(1 + m, 30) for m in mean_h]
    mean_d = torch.tensor(mean_h, dtype=torch.float64, device=dev)[ds]
    std2_d = torch.tensor(std_h, dtype=torch.float64, device=dev)[ds] ** 2
    factor_d = torch.tensor(factor_h, dtype=torch.float64, device=dev)[ds]

    # window [lo, hi) = [i - F // 2, i + (F - 1) // 2] of each contact's
    # diagonal, clipped to the diagonal (the band is zero beyond its end)
    lo = (xs - F // 2).clamp(min=0)
    hi = (xs + (F - 1) // 2 + 1).clamp(max=n)

    # window sums from prefix sums restarted every F rows, so that each
    # difference is of sums no larger than two windows (a prefix over the
    # whole diagonal would lose the window's low digits)
    rows = -(-n // F) * F
    first = torch.where(lo % F == 0, lo, lo - 1)
    zero = torch.zeros((), dtype=torch.float64, device=dev)

    def window(a):
        c = torch.zeros((rows, D), dtype=torch.float64, device=dev)
        c[:n] = a
        c = c.view(rows // F, F, D).cumsum(1).view(rows, D)
        head = torch.where(lo % F == 0, zero, c[first, ds])
        same = (lo // F) == (hi - 1) // F
        total = c[(lo // F) * F + F - 1, ds]
        return torch.where(same, c[hi - 1, ds] - head,
                           (total - head) + c[hi - 1, ds])

    vals = torch.where(pres, raw + 0.001, zero)
    counts = window(presf)
    s1 = window(vals)
    s2 = window(vals * vals)
    del raw, pres, presf, vals

    local_var = (s2 - s1 ** 2 / counts) / (counts - 1)
    local_var = torch.where(torch.isfinite(local_var), local_var, std2_d)
    local_mean = s1 / counts
    few = counts < 30
    local_mean = torch.where(few, mean_d, local_mean)
    local_var = torch.where(few, std2_d, local_var)
    local_mean = torch.where(torch.isfinite(local_mean), local_mean, mean_d)
    local_std = torch.sqrt(local_var)
    out = (vs + 0.001 - local_mean) / local_std
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    out = out * factor_d

    result = v.to(torch.float64).clone()
    result[sel] = out
    return result.to(dtype)
