"""Device-memory exhaustion: detection.

Copy of `acestep_tpu/utils/memory.py`'s matching logic for PyTorch: the
one test behind the handler's out-of-memory ladders. CUDA raises
`torch.cuda.OutOfMemoryError`; other paths phrase it as "out of memory",
"RESOURCE_EXHAUSTED" or "OOM" in their message.
"""

from __future__ import annotations

import torch


def is_oom_error(e: BaseException) -> bool:
    """True when `e` is a device-memory exhaustion."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return ("RESOURCE_EXHAUSTED" in msg or "OOM" in msg
            or "out of memory" in msg.lower())

