"""Named debug timers gated by per-subsystem switches: the span tracer's
spans (`utils/trace.py`) under its debug switch.

Capability parity with acestep/debug_utils.py (module-scoped switches
from env). Timings go to stderr as `[debug] name: x ms`; switches:
ACESTEP_DEBUG=1 enables all, ACESTEP_DEBUG_<SUBSYSTEM>=1 enables one
(e.g. ACESTEP_DEBUG_DIT). The same switches print the render's own stage
spans as they close."""

from __future__ import annotations

from typing import Optional

from acestep_torch.utils.trace import Span, debug_enabled

__all__ = ["debug_enabled", "debug_timer"]


class debug_timer(Span):
    """Context-manager form: `with debug_timer('vae_decode', 'vae') as t:`;
    `t.elapsed` holds the seconds when the subsystem's switch is on (read
    as the timer opens), else None."""

    def __init__(self, name: str, subsystem: str = ""):
        super().__init__(name)
        self.subsystem = subsystem
        self.elapsed: Optional[float] = None

    def __exit__(self, *exc):
        seconds = self.end()
        if self._print:
            self.elapsed = seconds
        return False
