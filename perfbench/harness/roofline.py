"""A kernel's share of its roofline over the traced sub-window."""

from __future__ import annotations

from typing import Optional

from harness import counts, measure


def _ops_bytes(kernel: str, shape: tuple) -> tuple:
    if kernel == "k1":
        B, Lq, _Lk, Hq, Hkv, D, window = shape
        return counts.k1_ops_bytes(B, Lq, Hq, Hkv, D, window)
    N, L, C = shape
    return counts.k4_ops_bytes(N, L, C)


def share(run, kernel: str) -> Optional[float]:
    """Summed bound time over summed device time of the launches paired
    with their kernels (%); None when the sub-window holds none or lost
    its kernel records, the calls logged disagree with the port's own
    launch counter, or the card has no peak."""
    t = measure.device_trace(run)
    if not t or counts.peak(run.card) is None:
        return None
    k = t[kernel]
    if t["launches"][kernel] != k["calls"]:
        return None             # the calls logged are not the port's launches
    pairs = k["pairs"]
    spent = sum(s for _shape, s in pairs)
    if not pairs or spent <= 0:
        return None
    bound = sum(counts.bound_s(*_ops_bytes(kernel, shape), run.card)
                for shape, _s in pairs)
    return 100.0 * bound / spent
