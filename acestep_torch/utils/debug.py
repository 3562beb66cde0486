"""Named debug timers gated by per-subsystem switches.

Capability parity with acestep/debug_utils.py
(debug_start/debug_end pairs + module-scoped switches from env). Timings go
to stderr; switches: ACESTEP_DEBUG=1 enables all,
ACESTEP_DEBUG_<SUBSYSTEM>=1 enables one (e.g. ACESTEP_DEBUG_DIT)."""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional

_active: Dict[str, float] = {}
_lock = threading.Lock()


def debug_enabled(subsystem: str = "") -> bool:
    if os.environ.get("ACESTEP_DEBUG"):
        return True
    if subsystem:
        return bool(os.environ.get(f"ACESTEP_DEBUG_{subsystem.upper()}"))
    return False


def debug_start(name: str, subsystem: str = "") -> None:
    if not debug_enabled(subsystem):
        return
    with _lock:
        _active[name] = time.time()


def debug_end(name: str, subsystem: str = "") -> Optional[float]:
    if not debug_enabled(subsystem):
        return None
    with _lock:
        t0 = _active.pop(name, None)
    if t0 is None:
        return None
    elapsed = time.time() - t0
    print(f"[debug] {name}: {elapsed * 1000:.1f} ms", file=sys.stderr,
          flush=True)
    return elapsed


class debug_timer:
    """Context-manager form: `with debug_timer('vae_decode', 'vae'): ...`"""

    def __init__(self, name: str, subsystem: str = ""):
        self.name = name
        self.subsystem = subsystem
        self.elapsed: Optional[float] = None

    def __enter__(self):
        debug_start(self.name, self.subsystem)
        return self

    def __exit__(self, *exc):
        self.elapsed = debug_end(self.name, self.subsystem)
