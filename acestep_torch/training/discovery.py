"""Checkpoint discovery for training and serving UIs (a copy of
`acestep_tpu/training/discovery.py`; the CLI's `--pick` routes here).

The reference's Side-Step trainer scans a checkpoint root for model
directories, classifies each as official or custom fine-tune, infers the
base variant, and offers a fuzzy-search picker
(`training_v2/model_discovery.py:32-239`). Same surface here, with the
variant defaults sourced from this repo's DiTConfig families instead of
torch fingerprints; LoRA/LoKr adapter dumps are discovered alongside so
one scan can populate both the base-model and adapter dropdowns.
"""
from __future__ import annotations

import difflib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Official directory-name prefixes (reference model_discovery.py:21)
_OFFICIAL_PREFIXES = ("acestep-v15-", "acestep-v1-")

# Per-variant sampler defaults a trainer/UI needs up front (reference
# _BASE_DEFAULTS, model_discovery.py:24-28 — shift/steps match our
# DiTConfig.turbo()/base()/sft() families).
_BASE_DEFAULTS: Dict[str, Dict] = {
    "turbo": {"is_turbo": True, "shift": 3.0, "num_inference_steps": 8},
    "base": {"is_turbo": False, "shift": 1.0, "num_inference_steps": 50},
    "sft": {"is_turbo": False, "shift": 1.0, "num_inference_steps": 50},
}

_WEIGHT_SUFFIXES = (".safetensors", ".npz", ".bin", ".pt", ".msgpack")


@dataclass
class ModelInfo:
    """Metadata about a discovered model directory."""

    name: str
    path: str
    is_official: bool
    base_model: str = "unknown"
    config: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"name": self.name, "path": self.path,
                "is_official": self.is_official,
                "base_model": self.base_model}


def detect_base_model(config: Dict, dir_name: str = "") -> str:
    """Infer the base variant: explicit config wins, then the is_turbo
    flag, then the directory-name heuristic (reference
    model_discovery.py:106-122)."""
    explicit = str(config.get("model_version", "")).lower()
    if explicit in _BASE_DEFAULTS:
        return explicit
    if config.get("is_turbo", False):
        return "turbo"
    name_lower = dir_name.lower()
    for variant in ("turbo", "base", "sft"):
        if variant in name_lower:
            return variant
    return "unknown"


def get_base_defaults(base_model: str) -> Dict:
    """Default sampler params for a variant (unknown -> base family)."""
    return dict(_BASE_DEFAULTS.get(base_model, _BASE_DEFAULTS["base"]))


def _has_weights(path: str) -> bool:
    try:
        return any(f.endswith(_WEIGHT_SUFFIXES) for f in os.listdir(path))
    except OSError:
        return False


def scan_models(checkpoint_dir: str) -> List[ModelInfo]:
    """Model directories = subdirs carrying a config.json (reference
    model_discovery.py:46-103). Sorted official-first, then by name."""
    out: List[ModelInfo] = []
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return out
    for name in sorted(os.listdir(checkpoint_dir)):
        path = os.path.join(checkpoint_dir, name)
        cfg_path = os.path.join(path, "config.json")
        if not os.path.isdir(path) or not os.path.exists(cfg_path):
            continue
        try:
            with open(cfg_path, "r", encoding="utf-8") as f:
                config = json.load(f) or {}
        except (OSError, ValueError):
            config = {}
        # adapter dumps also carry config-ish JSONs; classify separately
        if _looks_like_adapter(path, config):
            continue
        if not _has_weights(path):
            continue    # config-only remnant (interrupted download)
        out.append(ModelInfo(
            name=name, path=path,
            is_official=name.lower().startswith(_OFFICIAL_PREFIXES),
            base_model=detect_base_model(config, name),
            config=config))
    out.sort(key=lambda m: (not m.is_official, m.name))
    return out


def _looks_like_adapter(path: str, config: Dict) -> bool:
    if config.get("peft_type") or config.get("lora_alpha") is not None:
        return True
    return os.path.exists(os.path.join(path, "adapter_config.json")) or \
        os.path.exists(os.path.join(path, "adapter_model.safetensors"))


def scan_adapters(root: str) -> List[Dict]:
    """LoRA/LoKr adapter dumps under `root`: PEFT/LyCORIS directories
    (adapter_config.json / adapter_model.safetensors) and bare
    *.safetensors files (the formats lora/adapters.py imports)."""
    out: List[Dict] = []
    if not root or not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if os.path.isdir(path):
            cfg = os.path.join(path, "adapter_config.json")
            if os.path.exists(os.path.join(path, "config.json")) and \
                    not os.path.exists(cfg):
                continue            # a model dir, not an adapter dump
            if os.path.exists(cfg) or any(
                    f.endswith(".safetensors") for f in
                    (os.listdir(path) if os.path.isdir(path) else [])):
                kind = "dir"
                if os.path.exists(cfg):
                    try:
                        with open(cfg, "r", encoding="utf-8") as f:
                            kind = str((json.load(f) or {}).get(
                                "peft_type", "dir")).lower()
                    except (OSError, ValueError):
                        pass
                out.append({"name": name, "path": path, "kind": kind})
        elif name.endswith(".safetensors"):
            out.append({"name": name, "path": path, "kind": "safetensors"})
    return out


def fuzzy_search(query: str, models: List[ModelInfo]) -> List[ModelInfo]:
    """Substring match first, then difflib close matches (reference
    model_discovery.py:134-158)."""
    if not query:
        return list(models)
    q = query.lower()
    substring_hits = [m for m in models if q in m.name.lower()]
    if substring_hits:
        return substring_hits
    names = [m.name for m in models]
    close = set(difflib.get_close_matches(query, names, n=5, cutoff=0.4))
    return [m for m in models if m.name in close]


def pick_model(checkpoint_dir: str,
               query: Optional[str] = None) -> Optional[ModelInfo]:
    """Non-interactive picker: exact name, else best fuzzy match, else
    the first official model. The CLI's --pick flag routes queries here;
    interactive menus stay out of the library (this runs in servers)."""
    models = scan_models(checkpoint_dir)
    if not models:
        return None
    if query:
        for m in models:
            if m.name == query:
                return m
        hits = fuzzy_search(query, models)
        return hits[0] if hits else None
    return models[0]
