"""Dynamic Time Warping, vectorized numpy (no numba dependency).

A copy of `acestep_tpu/scoring/dtw.py`: the port keeps its own, as it
imports nothing of the JAX package.

Same monotonic-path DTW as the reference's numba kernel
(upstream acestep/core/scoring/_dtw.py): cost matrix in, (text_idx,
time_idx) path out. The DP recurrence is evaluated along anti-diagonals so
each wavefront is one vectorized numpy op instead of a scalar loop.
"""

from __future__ import annotations

import numpy as np


def dtw(cost_matrix: np.ndarray):
    """cost_matrix (N, M) -> (text_indices, time_indices) of the optimal
    monotonic path from (0,0) to (N-1, M-1)."""
    x = np.asarray(cost_matrix, np.float32)
    N, M = x.shape
    INF = np.float32(np.inf)
    cost = np.full((N + 1, M + 1), INF, np.float32)
    trace = np.full((N + 1, M + 1), -1, np.int8)
    cost[0, 0] = 0.0

    # anti-diagonal wavefronts: cells (i, j) with i + j = s
    for s in range(2, N + M + 1):
        i_lo = max(1, s - M)
        i_hi = min(N, s - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = s - i
        c0 = cost[i - 1, j - 1]          # diagonal
        c1 = cost[i - 1, j]              # up   (advance text)
        c2 = cost[i, j - 1]              # left (advance time)
        stacked = np.stack([c0, c1, c2])
        t = np.argmin(stacked, axis=0)
        cost[i, j] = x[i - 1, j - 1] + stacked[t, np.arange(len(i))]
        trace[i, j] = t

    # backtrace (boundary rules match the reference)
    trace[0, :] = 2
    trace[:, 0] = 1
    text_idx, time_idx = [], []
    i, j = N, M
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return (np.asarray(text_idx[::-1], np.int32),
            np.asarray(time_idx[::-1], np.int32))


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis (reference uses it to denoise
    attention before DTW). width must be odd; no-op for width <= 1."""
    if width <= 1:
        return x
    if width % 2 == 0:
        width += 1
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1).astype(x.dtype)
