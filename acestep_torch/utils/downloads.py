"""Local checkpoint resolution and integrity manifests.

The local half of `acestep_tpu/utils/downloads.py`: candidate directories
(an explicit root, `ACESTEP_CHECKPOINT_DIR` or `./checkpoints`, then the
per-user cache), the weight-file probe, and the SHA-256 manifest that guards
weight files. The port downloads nothing: a checkpoint is placed in one of
those directories by hand.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

DEFAULT_ROOT = os.environ.get(
    "ACESTEP_CHECKPOINT_DIR",
    os.path.join(os.getcwd(), "checkpoints"))

MANIFEST_NAME = "checksums.json"

_WEIGHT_SUFFIXES = (".safetensors", ".bin", ".npz", ".pt")


def candidate_dirs(name: str, root: Optional[str] = None) -> List[str]:
    roots = [root] if root else []
    roots += [DEFAULT_ROOT,
              os.path.join(os.path.expanduser("~"), ".cache", "acestep_tpu",
                           "checkpoints")]
    return [os.path.join(r, name) for r in roots if r]


def _looks_like_checkpoint(path: str) -> bool:
    """A usable checkpoint has weight files, not just config JSONs — an
    interrupted copy must not satisfy resolution forever."""
    if not os.path.isdir(path):
        return False
    return any(entry.endswith(_WEIGHT_SUFFIXES)
               for entry in os.listdir(path))


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(ckpt_dir: str) -> Dict[str, str]:
    """Hash every weight file into `checksums.json`."""
    hashes = {
        entry: _file_sha256(os.path.join(ckpt_dir, entry))
        for entry in sorted(os.listdir(ckpt_dir))
        if entry.endswith(_WEIGHT_SUFFIXES)
    }
    with open(os.path.join(ckpt_dir, MANIFEST_NAME), "w",
              encoding="utf-8") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
    return hashes


def verify_checkpoint(ckpt_dir: str) -> List[str]:
    """Weight files that are missing or differ from the manifest.

    No manifest -> nothing to verify (checkpoints without one stay valid);
    returns [] in that case."""
    manifest_path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        return []
    try:
        with open(manifest_path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return [MANIFEST_NAME]
    bad = []
    for name, digest in manifest.items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path) or _file_sha256(path) != digest:
            bad.append(name)
    return bad


def resolve_local(name: str, root: Optional[str] = None) -> Optional[str]:
    """The local directory holding `name` if one exists, without hashing;
    None otherwise."""
    for path in candidate_dirs(name, root):
        if _looks_like_checkpoint(path):
            return path
    return None
