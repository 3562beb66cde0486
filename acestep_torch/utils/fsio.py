"""Small filesystem helpers shared across layers.

Lives in utils so core modules (pipeline, utils.progress) don't have to
import from the serving layer for a generic atomic write — serving
imports these, not the reverse.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any


def atomic_write_json(path: str, data: Any) -> None:
    """Write JSON atomically (tmp file + fsync + rename), like the
    reference api_server.py:720-736 — a crash mid-write can never leave
    a truncated file behind."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, ensure_ascii=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def append_jsonl(path: str, record: Any) -> None:
    """Append one JSON line (durable job history, api_server.py:738-751)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(record, ensure_ascii=False) + "\n")
