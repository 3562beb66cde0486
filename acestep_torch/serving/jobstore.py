"""Job store with atomic JSON + JSONL persistence and a TTL result cache.

Re-designs the reference's `_JobStore` + diskcache "local_redis"
(acestep/api_server.py:781-945,720-751;
acestep/local_cache.py) as thread-safe stdlib-only
components. Jobs persist to disk and reload across restarts; results are
cached with a TTL under the same "acestep_result:{task_id}" key scheme the
reference uses.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional
from uuid import uuid4

RESULT_KEY_PREFIX = "acestep_result:"
JOB_STORE_MAX_AGE_SECONDS = 24 * 3600
RESULT_EXPIRE_SECONDS = 3600
TASK_TIMEOUT_SECONDS = 1800


# canonical implementations live in utils.fsio (core modules use them
# without importing the serving layer); re-exported here for callers that
# historically imported them from jobstore
from acestep_torch.utils.fsio import append_jsonl, atomic_write_json  # noqa: E402,F401


@dataclass
class JobRecord:
    job_id: str
    status: str = "queued"      # queued | running | succeeded | failed
    created_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    progress_text: str = ""
    status_text: str = ""
    env: str = "development"
    progress: float = 0.0
    stage: str = "queued"
    updated_at: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


class JobStore:
    """Thread-safe in-memory job registry with optional disk persistence."""

    def __init__(self, max_age_seconds: int = JOB_STORE_MAX_AGE_SECONDS,
                 persist_dir: Optional[str] = None) -> None:
        self._lock = threading.Lock()
        self._jobs: Dict[str, JobRecord] = {}
        # per-job serialized snapshots, updated incrementally at the
        # persistence points (create/succeed/fail/load) so a snapshot is
        # O(1) serialization under the lock instead of asdict of every
        # retained record; mid-flight field churn (progress, status_text)
        # is deliberately not mirrored — on reload queued/running collapse
        # to failed-by-restart anyway
        self._ser: Dict[str, Dict[str, Any]] = {}
        self._max_age = max_age_seconds
        self._persist_dir = persist_dir
        # snapshot I/O runs OUTSIDE self._lock (serialized by _io_lock with
        # a version counter) so SSE polls never block behind an fsync
        self._io_lock = threading.Lock()
        self._snap_version = 0
        self._written_version = 0
        if persist_dir:
            self._load_persisted()

    # -- persistence --------------------------------------------------------

    @property
    def _snapshot_path(self) -> str:
        assert self._persist_dir is not None
        return os.path.join(self._persist_dir, "jobs.json")

    @property
    def _history_path(self) -> str:
        assert self._persist_dir is not None
        return os.path.join(self._persist_dir, "jobs_history.jsonl")

    def _load_persisted(self) -> None:
        try:
            with open(self._snapshot_path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        for rec in data.get("jobs", []):
            try:
                job = JobRecord(**rec)
            except TypeError:
                continue
            # Anything that was mid-flight when the server died is failed.
            if job.status in ("queued", "running"):
                job.status = "failed"
                job.stage = "failed"
                job.error = "server restarted while job was in flight"
            self._jobs[job.job_id] = job
            self._ser[job.job_id] = job.to_dict()

    def _snapshot_locked(self, rec: Optional[JobRecord] = None):
        """Refresh `rec`'s serialized copy and assemble the payload under
        self._lock; the caller writes it to disk AFTER releasing the lock.
        The per-record copies in self._ser make this O(changed record),
        not O(all retained jobs)."""
        if rec is not None and self._persist_dir:
            self._ser[rec.job_id] = rec.to_dict()
        if not self._persist_dir:
            return None
        self._snap_version += 1
        return ({"jobs": list(self._ser.values())}, self._snap_version)

    def _write_snapshot(self, snap) -> None:
        """Best-effort: a persistence failure (disk full, read-only
        volume) must never fail a finished job or kill a worker — the
        in-memory store stays authoritative."""
        if snap is None:
            return
        try:
            payload, version = snap
            with self._io_lock:
                if version <= self._written_version:
                    return      # a newer snapshot already hit the disk
                self._written_version = version
                atomic_write_json(self._snapshot_path, payload)
        except OSError:
            pass

    def _append_history(self, entry) -> None:
        if entry is None:
            return
        try:        # best-effort, like the snapshot
            append_jsonl(self._history_path, entry)
        except OSError:
            pass

    def _history_entry(self, rec: JobRecord) -> Optional[Dict[str, Any]]:
        if not self._persist_dir:
            return None
        entry = rec.to_dict()
        entry.pop("result", None)  # results can be large; history is metadata
        return entry

    # -- lifecycle ----------------------------------------------------------

    def create(self, env: str = "development") -> JobRecord:
        return self.create_with_id(str(uuid4()), env=env)

    def create_with_id(self, job_id: str, env: str = "development") -> JobRecord:
        now = time.time()
        rec = JobRecord(job_id=job_id, status="queued", created_at=now,
                        env=env, updated_at=now)
        with self._lock:
            self._jobs[job_id] = rec
            snap = self._snapshot_locked(rec)
        self._write_snapshot(snap)
        return rec

    def get(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            return self._jobs.get(job_id)

    def mark_running(self, job_id: str) -> None:
        # No snapshot here: on reload both "queued" and "running" collapse
        # to failed-by-restart (_load_persisted), so persisting the flip
        # buys nothing and would cost a full-store rewrite per job.
        with self._lock:
            rec = self._jobs[job_id]
            rec.status = "running"
            rec.stage = "running"
            rec.started_at = rec.updated_at = time.time()

    def mark_succeeded(self, job_id: str, result: Dict[str, Any]) -> None:
        with self._lock:
            rec = self._jobs[job_id]
            # result/progress land BEFORE the status flip: lock-free readers
            # of the live record (SSE loops) key on status=='succeeded' and
            # must never observe it with result still None
            rec.result = result
            rec.progress = 1.0
            rec.finished_at = rec.updated_at = time.time()
            rec.status = rec.stage = "succeeded"
            snap = self._snapshot_locked(rec)
            entry = self._history_entry(rec)
        self._write_snapshot(snap)
        self._append_history(entry)

    def mark_failed(self, job_id: str, error: str) -> None:
        with self._lock:
            rec = self._jobs[job_id]
            rec.error = error       # error precedes the status flip, as above
            rec.finished_at = rec.updated_at = time.time()
            rec.status = rec.stage = "failed"
            snap = self._snapshot_locked(rec)
            entry = self._history_entry(rec)
        self._write_snapshot(snap)
        self._append_history(entry)

    def update_progress(self, job_id: str, progress: float,
                        stage: Optional[str] = None) -> None:
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                return
            rec.progress = float(progress)
            if stage:
                rec.stage = stage
            rec.updated_at = time.time()

    def update_status_text(self, job_id: str, text: str) -> None:
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id].status_text = text

    def update_progress_text(self, job_id: str, text: str) -> None:
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id].progress_text = text

    # -- maintenance / stats -------------------------------------------------

    def cleanup(self) -> int:
        """Drop finished jobs older than max_age. Returns number removed."""
        cutoff = time.time() - self._max_age
        removed = 0
        with self._lock:
            for job_id in [
                j for j, r in self._jobs.items()
                if r.status in ("succeeded", "failed")
                and (r.finished_at or r.created_at) < cutoff
            ]:
                del self._jobs[job_id]
                self._ser.pop(job_id, None)
                removed += 1
            snap = self._snapshot_locked() if removed else None
        self._write_snapshot(snap)
        return removed

    def get_stats(self) -> Dict[str, int]:
        with self._lock:
            stats = {"total": len(self._jobs), "queued": 0, "running": 0,
                     "succeeded": 0, "failed": 0}
            for rec in self._jobs.values():
                stats[rec.status] = stats.get(rec.status, 0) + 1
            return stats


class LocalResultCache:
    """TTL key-value cache (the reference's diskcache 'local_redis',
    local_cache.py). In-memory dict + optional JSON spill for restart
    survival; values are JSON-serialized strings like the reference's."""

    def __init__(self, persist_path: Optional[str] = None) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, tuple] = {}   # key -> (expires_at, json_str)
        self._persist_path = persist_path
        if persist_path and os.path.exists(persist_path):
            try:
                with open(persist_path, "r", encoding="utf-8") as f:
                    raw = json.load(f)
                now = time.time()
                self._data = {k: tuple(v) for k, v in raw.items()
                              if v[0] > now}
            except (OSError, ValueError):
                pass

    def set(self, key: str, value: Any, ex: int = RESULT_EXPIRE_SECONDS) -> None:
        payload = value if isinstance(value, str) else json.dumps(value)
        with self._lock:
            old = self._data.get(key)
            now = time.time()
            # prune: without this, entries whose TTL lapsed but were never
            # get()-polled again live forever in memory AND get rewritten
            # into the spill file on every set
            for k in [k for k, v in self._data.items() if v[0] < now]:
                del self._data[k]
            self._data[key] = (now + ex, payload)
            if old is not None and old[1] == payload:
                # TTL-only refresh (e.g. a client polling an expired task
                # re-caches the same entry from the job store on every
                # poll): skip the full-file rewrite+fsync — the spill is a
                # warm-start optimization, the job store is the durable
                # record
                return
            self._spill_locked()

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            item = self._data.get(key)
            if item is None:
                return None
            expires_at, payload = item
            if expires_at < time.time():
                del self._data[key]
                return None
            return payload

    def _spill_locked(self) -> None:
        if not self._persist_path:
            return
        try:
            atomic_write_json(self._persist_path,
                              {k: list(v) for k, v in self._data.items()})
        except OSError:
            pass
