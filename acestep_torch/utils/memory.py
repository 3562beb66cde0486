"""Device-memory exhaustion: detection and release.

Copy of `acestep_tpu/utils/memory.py`'s matching logic for PyTorch: the
one test behind the handler's out-of-memory ladders. CUDA raises
`torch.cuda.OutOfMemoryError`; other paths phrase it as "out of memory",
"RESOURCE_EXHAUSTED" or "OOM" in their message.
"""

from __future__ import annotations

import gc

import torch


def is_oom_error(e: BaseException) -> bool:
    """True when `e` is a device-memory exhaustion."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return ("RESOURCE_EXHAUSTED" in msg or "OOM" in msg
            or "out of memory" in msg.lower())



def release_device_memory() -> None:
    """Collect garbage and release the caching allocator's unused blocks,
    so a smaller retry after an out-of-memory error starts from a clean
    pool."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
