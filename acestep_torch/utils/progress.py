"""Diffusion progress estimation with persisted timing history.

Capability parity with the reference's progress subsystem
(reference acestep/core/generation/handler/progress.py): per-request
step-time records persisted to a JSON cache (last 100, keyed by
device/steps/batch/duration bucket), used to interpolate a smooth progress
fraction while the (opaque, jitted) diffusion call runs; a background thread
drives a callback during generation.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

from acestep_torch.utils.fsio import atomic_write_json

MAX_RECORDS = 100


def _duration_bucket(duration_s: float) -> int:
    """10s buckets below 60s, 30s buckets above (progress.py:45-54 idea)."""
    if duration_s <= 60:
        return int(duration_s // 10) * 10
    return int(duration_s // 30) * 30


class ProgressEstimator:
    def __init__(self, cache_path: Optional[str] = None,
                 device_key: Optional[str] = None):
        """`cache_path` persists the records as JSON; None keeps them in
        memory for the life of the estimator."""
        self.cache_path = cache_path
        self.device_key = device_key or "cpu"
        self._lock = threading.Lock()
        self._records: Dict[str, List[float]] = {}
        self._load()

    def _key(self, steps: int, batch: int, duration_s: float) -> str:
        return f"{self.device_key}|s{steps}|b{batch}|d{_duration_bucket(duration_s)}"

    def _load(self) -> None:
        if self.cache_path is None:
            return
        try:
            with open(self.cache_path, "r", encoding="utf-8") as f:
                raw = json.load(f)
            # a cosmetic cache must never break handler/server startup:
            # valid-JSON-wrong-shape (null, list, {"k": 5}) is as corrupt
            # as bad JSON
            self._records = {
                str(k): [float(x) for x in v][-MAX_RECORDS:]
                for k, v in raw.items() if isinstance(v, (list, tuple))
            } if isinstance(raw, dict) else {}
        except (OSError, ValueError, TypeError, AttributeError):
            self._records = {}

    def _save(self) -> None:
        if self.cache_path is None:
            return
        try:
            atomic_write_json(self.cache_path, self._records)
        except OSError:
            pass

    def record(self, steps: int, batch: int, duration_s: float,
               total_seconds: float) -> None:
        with self._lock:
            key = self._key(steps, batch, duration_s)
            values = self._records.setdefault(key, [])
            values.append(float(total_seconds))
            del values[:-MAX_RECORDS]
            self._save()

    def estimate_seconds(self, steps: int, batch: int,
                         duration_s: float) -> Optional[float]:
        """Median of recorded times for the bucket; neighbor-bucket and
        step-scaled fallbacks before giving up."""
        with self._lock:
            key = self._key(steps, batch, duration_s)
            values = self._records.get(key)
            if values:
                ordered = sorted(values)
                return ordered[len(ordered) // 2]
            # fallback: NEAREST bucket with the same step count (prefer a
            # matching batch), scaled by the duration-bucket ratio; both
            # buckets clamp to >=1 so the sub-10s bucket (0) can neither
            # divide by zero-ish values nor skip scaling entirely
            mine = max(_duration_bucket(duration_s), 1)
            prefix = f"{self.device_key}|s{steps}|"
            best = None     # (batch_mismatch, duration_distance, estimate)
            for other_key, other_vals in self._records.items():
                if not other_key.startswith(prefix) or not other_vals:
                    continue
                try:
                    rest = other_key[len(prefix):]          # "b{N}|d{D}"
                    other_b = int(rest.split("|", 1)[0][1:])
                    other_d = max(int(rest.rsplit("|d", 1)[1]), 1)
                except (ValueError, IndexError):
                    continue
                ordered = sorted(other_vals)
                med = ordered[len(ordered) // 2]
                cand = (int(other_b != batch), abs(other_d - mine),
                        med * mine / other_d)
                if best is None or cand[:2] < best[:2]:
                    best = cand
            if best is not None:
                return best[2]
        return None


class ProgressTicker:
    """Background thread interpolating progress during an opaque call.

    with ProgressTicker(est_seconds, cb) as t: ... long call ...
    cb(fraction) fires every `interval`; fraction saturates at 0.95 until
    finish() is called (then 1.0)."""

    def __init__(self, estimate_seconds: Optional[float],
                 callback: Callable[[float], None],
                 interval: float = 0.5):
        self.estimate = estimate_seconds
        self.callback = callback
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self):
        self._t0 = time.time()
        if self.estimate and self.estimate > 0:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            frac = min((time.time() - self._t0) / self.estimate, 0.95)
            try:
                self.callback(frac)
            except Exception:
                return

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        if exc[0] is None:
            try:
                self.callback(1.0)
            except Exception:
                pass
