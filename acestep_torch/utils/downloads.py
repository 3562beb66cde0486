"""Checkpoint resolution, download and integrity manifests.

Port of `acestep_tpu/utils/downloads.py`:
- resolve locally first: candidate directories (an explicit root,
  `ACESTEP_CHECKPOINT_DIR` or `./checkpoints`, then the per-user cache),
  with a probe for weight files, so an interrupted copy never satisfies it;
- else download with HuggingFace <-> ModelScope fallback (`smart_download`:
  a reachability probe picks the primary hub, the other is tried when it
  fails; `prefer_source` or `ACESTEP_DOWNLOAD_SOURCE` overrides the probe).
  The hub packages are imported only when a download runs;
- a SHA-256 manifest of the weight files, written after every download and
  checked on resolution;
- else raise an actionable error naming the directories searched.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

REPO_IDS: Dict[str, str] = {
    # model name -> hub repo id (the same id on HF and ModelScope)
    "acestep-v15-turbo": "ACE-Step/ACE-Step-v1.5-turbo",
    "acestep-v15-base": "ACE-Step/ACE-Step-v1.5-base",
    "acestep-v15-sft": "ACE-Step/ACE-Step-v1.5-sft",
    "vae": "ACE-Step/ACE-Step-v1.5-vae",
    "Qwen3-Embedding-0.6B": "Qwen/Qwen3-Embedding-0.6B",
    "acestep-5Hz-lm-0.6B": "ACE-Step/acestep-5Hz-lm-0.6B",
    "acestep-5Hz-lm-1.7B": "ACE-Step/acestep-5Hz-lm-1.7B",
    "acestep-5Hz-lm-4B": "ACE-Step/acestep-5Hz-lm-4B",
}

DEFAULT_ROOT = os.environ.get(
    "ACESTEP_CHECKPOINT_DIR",
    os.path.join(os.getcwd(), "checkpoints"))

MANIFEST_NAME = "checksums.json"

_WEIGHT_SUFFIXES = (".safetensors", ".bin", ".npz", ".pt")

# directories whose manifest already verified in this process
_VERIFIED_DIRS: set = set()


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


# ------------------------------------------------------------------
# Source probing + smart download
# ------------------------------------------------------------------


def _probe(host: str, timeout: float = 3.0) -> bool:
    import socket

    try:
        socket.create_connection((host, 443), timeout=timeout).close()
        return True
    except OSError:
        return False


def has_egress(timeout: float = 3.0) -> bool:
    """Any supported hub reachable?"""
    return _probe("huggingface.co", timeout) or _probe("modelscope.cn",
                                                       timeout)


def _download_hf(repo_id: str, target: str) -> None:
    from huggingface_hub import snapshot_download

    snapshot_download(repo_id=repo_id, local_dir=target)


def _download_modelscope(repo_id: str, target: str) -> None:
    try:
        from modelscope import snapshot_download  # noqa: F401 — optional dep
    except ImportError as e:
        raise RuntimeError(
            "modelscope is not installed; pip install modelscope or use "
            "prefer_source='huggingface'") from e
    snapshot_download(model_id=repo_id, local_dir=target)


def smart_download(repo_id: str, target: str,
                   prefer_source: Optional[str] = None) -> Tuple[str, str]:
    """Download with HF <-> ModelScope auto-fallback.

    Returns (source_used, message); raises when both sources fail. An
    explicit preference wins, then the ACESTEP_DOWNLOAD_SOURCE env var
    ('auto'/'' keeps the probe); otherwise a reachability probe picks the
    primary, and the alternative is tried on failure."""
    if prefer_source is None:
        env = os.environ.get("ACESTEP_DOWNLOAD_SOURCE", "").strip().lower()
        if env in ("huggingface", "modelscope"):
            prefer_source = env
    if prefer_source == "huggingface":
        hf_first = True
    elif prefer_source == "modelscope":
        hf_first = False
    else:
        hf_first = _probe("huggingface.co")
    order = (("huggingface", _download_hf),
             ("modelscope", _download_modelscope))
    if not hf_first:
        order = order[::-1]
    errors = []
    for source, fn in order:
        try:
            fn(repo_id, target)
            return source, f"downloaded {repo_id} from {source}"
        except Exception as e:  # noqa: BLE001 — fall back to the other hub
            errors.append(f"{source}: {e}")
    raise RuntimeError(
        f"all download sources failed for {repo_id}:\n  "
        + "\n  ".join(errors))


def ensure_model(name: str, root: Optional[str] = None,
                 allow_download: bool = True,
                 prefer_source: Optional[str] = None,
                 verify: bool = True) -> str:
    """Return a local directory containing the named checkpoint."""
    for path in candidate_dirs(name, root):
        if _looks_like_checkpoint(path):
            # hash multi-GB weight dirs at most once per process: repeat
            # resolutions (per-request LM swaps) must not pay it again
            if verify and path not in _VERIFIED_DIRS:
                bad = verify_checkpoint(path)
                if bad:
                    raise RuntimeError(
                        f"checkpoint '{name}' at {path} failed integrity "
                        f"verification: {bad}. Delete the directory to "
                        f"re-download, or remove {MANIFEST_NAME} to skip "
                        f"verification.")
                _VERIFIED_DIRS.add(path)
            return path

    repo_id = REPO_IDS.get(name)
    if repo_id and allow_download and has_egress():
        target = os.path.join(root or DEFAULT_ROOT, name)
        partial = target + ".partial"       # atomic: download then rename
        os.makedirs(partial, exist_ok=True)
        smart_download(repo_id, partial, prefer_source=prefer_source)
        write_manifest(partial)
        if os.path.isdir(target):
            # a leftover non-checkpoint dir (an interrupted download, a
            # config-only remnant) would make os.replace fail; the probe
            # above already rejected it
            import shutil

            shutil.rmtree(target, ignore_errors=True)
        os.replace(partial, target)
        return target

    searched = "\n  ".join(candidate_dirs(name, root))
    raise FileNotFoundError(
        f"checkpoint '{name}' not found locally and cannot be downloaded "
        f"(no egress or unknown model). Searched:\n  {searched}\n"
        f"Place the HF checkpoint directory there, or set "
        f"ACESTEP_CHECKPOINT_DIR.")


def ensure_main_model(root: Optional[str] = None,
                      variant: str = "turbo") -> str:
    return ensure_model(f"acestep-v15-{variant}", root)


def ensure_vae(root: Optional[str] = None) -> str:
    return ensure_model("vae", root)


def ensure_text_encoder(root: Optional[str] = None) -> str:
    return ensure_model("Qwen3-Embedding-0.6B", root)


def ensure_lm_model(size: str = "0.6B", root: Optional[str] = None) -> str:
    return ensure_model(f"acestep-5Hz-lm-{size}", root)
