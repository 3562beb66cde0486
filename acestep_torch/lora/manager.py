"""Adapter files: `.npz` in the JAX package's format (`acestep_tpu/lora/
manager.py`), so an adapter saved by either package loads in the other.

Keys are `<target>:<part>` (`self_attn.q_proj:down`) in the JAX layout,
plus `__meta__`, the JSON meta as bytes. Safetensors adapters (PEFT and
LyCORIS dumps) and the `LoraManager` runtime are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_adapter(path: str, adapter: dict) -> None:
    """{meta, weights} (tensors or numpy arrays) -> .npz file."""
    flat: Dict[str, np.ndarray] = {}
    for name, pair in adapter["weights"].items():
        for part, value in pair.items():
            flat[f"{name}:{part}"] = _np(value)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=np.frombuffer(
        json.dumps(adapter["meta"]).encode(), dtype=np.uint8), **flat)


def load_adapter_file(path: str) -> dict:
    """.npz file -> {meta, weights} with CPU tensors."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz adapters are ported yet (safetensors comes "
            f"with the LoRA runtime slice of the PyTorch port; acestep_tpu "
            f"has it)")
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        weights: Dict[str, dict] = {}
        for key in data.files:
            if key == "__meta__":
                continue
            name, part = key.rsplit(":", 1)
            weights.setdefault(name, {})[part] = torch.from_numpy(
                np.array(data[key]))
    return {"meta": meta, "weights": weights}
