"""Path sanitisation for user-supplied filesystem paths.

The reference guards every user-provided training path with a single
``safe_path`` validator under a configurable safe root
(`acestep/training/path_safety.py`) and routes all training-module IO
through it (`training/data_module.py:57-78`). Same contract here: the
training REST service and dataset/manifest loaders accept paths straight
from HTTP bodies, so anything that touches the filesystem must resolve
under the safe root or raise.

The root defaults to the process working directory; operators can widen
it with ``ACESTEP_SAFE_ROOT`` (e.g. a data volume).
"""
from __future__ import annotations

import os
from typing import Optional

_SAFE_ROOT: str = os.path.normpath(
    os.path.abspath(os.environ.get("ACESTEP_SAFE_ROOT", os.getcwd())))


def safe_path(user_path: str, *, base: Optional[str] = None) -> str:
    """Normalise `user_path` and require it to live under `base` (or the
    global safe root). Returns the absolute path; raises ValueError when
    the path escapes — the reference's normpath + prefix pattern
    (path_safety.py:39-71) hardened with realpath so a symlink planted
    inside the root (shared volume, archive extraction) cannot point the
    jail at /etc or another user's data."""
    root = (os.path.normpath(os.path.abspath(base)) if base is not None
            else _SAFE_ROOT)
    if not isinstance(user_path, str) or not user_path:
        raise ValueError("empty path")
    cand = user_path
    if not os.path.isabs(cand):
        cand = os.path.join(root, cand)
    cand = os.path.normpath(os.path.abspath(cand))
    # compare link-resolved forms: both sides through realpath, so a root
    # that itself lives behind a symlink (e.g. /tmp on macOS) still works
    real_root = os.path.realpath(root)
    real_cand = os.path.realpath(cand)
    if ((cand != root and not cand.startswith(root + os.sep)) or
            (real_cand != real_root
             and not real_cand.startswith(real_root + os.sep))):
        raise ValueError(
            f"path {user_path!r} escapes the allowed root {root!r}")
    return cand
