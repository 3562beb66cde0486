"""Adapter files and the adapter lifecycle at inference.

Port of `acestep_tpu/lora/manager.py`:

- `.npz` adapters in the JAX package's format, so an adapter saved by
  either package loads in the other: keys `<target>:<part>`
  (`self_attn.q_proj:down`) in the JAX layout, plus `__meta__`, the JSON
  meta as bytes;
- safetensors dumps of other trainers: PEFT LoRA (`lora_A` / `lora_B`,
  DoRA's `lora_magnitude_vector`, the `adapter_config.json` sidecar's
  `lora_alpha` / `r`) and LyCORIS LoKr (`lokr_w1` / `lokr_w2`, optionally
  rank-factored `_a` / `_b`, `alpha`, `dora_scale`). The format is read
  by `utils/checkpoint.read_safetensors` with `json` and numpy, so no
  `safetensors` package is needed;
- `LoraManager`: load / add / unload / toggle / set_scale / status /
  signature, and the effective weights of the active adapter, merged once
  and cached until the active adapter or its scale changes.

Loaded adapters hold CPU tensors: float32 from safetensors, the stored
dtype from `.npz`.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from acestep_torch.lora.adapters import adapter_param_count, merge_weights
from acestep_torch.ops.quant import dequantized_weights
from acestep_torch.utils.checkpoint import read_safetensors


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


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
    """An adapter file, or a directory holding one -> {meta, weights} with
    CPU tensors. A directory resolves to its conventional file
    names first, then to its only adapter file."""
    if os.path.isdir(path):
        for name in ("adapter_model.safetensors", "adapter.npz",
                     "pytorch_lora_weights.safetensors"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return load_adapter_file(cand)
        cands = [n for n in sorted(os.listdir(path))
                 if n.endswith((".safetensors", ".npz"))]
        if len(cands) == 1:
            return load_adapter_file(os.path.join(path, cands[0]))
        raise ValueError(
            f"cannot resolve an adapter file in directory {path}: "
            f"candidates={cands}")
    if path.endswith(".npz"):
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
    if path.endswith(".safetensors"):
        return _load_safetensors_adapter(path)
    raise ValueError(f"unsupported adapter format: {path}")


def _read_sidecar(path: str):
    """(lora_alpha, r) of the PEFT `adapter_config.json` beside `path`, or
    Nones: without it an alpha != rank adapter would merge at the wrong
    strength."""
    sidecar = os.path.join(os.path.dirname(os.path.abspath(path)),
                           "adapter_config.json")
    if os.path.exists(sidecar):
        try:
            with open(sidecar, "r", encoding="utf-8") as f:
                cfg = json.load(f)
            return cfg.get("lora_alpha"), cfg.get("r")
        except (OSError, ValueError):
            pass
    return None, None


def _lokr_target(raw: str) -> str:
    """LyCORIS's underscore-mangled module name -> our target name
    (`self_attn_q_proj` -> `self_attn.q_proj`, `mlp_gate_proj` ->
    `mlp.gate`)."""
    target = (raw.replace("_", ".", 1)
              if raw.startswith(("self_attn_", "cross_attn_", "mlp_"))
              else raw).replace("gate_proj", "gate").replace(
        "up_proj", "up").replace("down_proj", "down").replace("_", ".")
    return target.replace("self.attn", "self_attn").replace(
        "cross.attn", "cross_attn").replace("q.proj", "q_proj").replace(
        "k.proj", "k_proj").replace("v.proj", "v_proj").replace(
        "o.proj", "o_proj")


def _load_safetensors_adapter(path: str) -> dict:
    if not os.path.isfile(path):
        # the message the JAX package's reader (safetensors' safe_open)
        # gives, which the REST routes pass on in their error envelope
        raise FileNotFoundError(f"No such file or directory: {path}")
    sidecar_alpha, sidecar_rank = _read_sidecar(path)
    tensors = read_safetensors(path)
    per_layer: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    lokr_layers: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    rank = None
    for key, arr in tensors.items():
        lm = re.search(r"layers[._](\d+)[._](.+?)\."
                       r"(lokr_w[12](?:_[ab])?|alpha|dora_scale)$", key)
        if lm:
            lokr_layers.setdefault(_lokr_target(lm.group(2)), {}).setdefault(
                int(lm.group(1)), {})[lm.group(3)] = arr
    for key, arr in tensors.items():
        m = re.search(r"layers\.(\d+)\.(.+?)\."
                      r"(lora_[AB]|lora_magnitude_vector)", key)
        if not m:
            continue
        idx, part = int(m.group(1)), m.group(3)
        target = m.group(2).replace(".weight", "").replace(
            "gate_proj", "gate").replace("up_proj", "up").replace(
            "down_proj", "down")
        # PEFT stores (out, in): lora_A (r, in), lora_B (out, r)
        if part == "lora_A":
            arr, slot = arr.T, "down"          # (in, r)
            rank = arr.shape[1]
        elif part == "lora_B":
            arr, slot = arr.T, "up"            # (r, out)
        else:
            arr, slot = arr.reshape(-1), "dora_m"   # DoRA magnitude (out,)
        per_layer.setdefault(target, {}).setdefault(idx, {})[slot] = arr
    weights = {}
    for target, by_layer in per_layer.items():
        idxs = sorted(by_layer)
        weights[target] = {
            "down": _t(np.stack([by_layer[i]["down"] for i in idxs])),
            "up": _t(np.stack([by_layer[i]["up"] for i in idxs])),
        }
        n_dora = sum("dora_m" in by_layer[i] for i in idxs)
        if n_dora == len(idxs):
            weights[target]["dora_m"] = _t(
                np.stack([by_layer[i]["dora_m"] for i in idxs]))
        elif n_dora:
            raise ValueError(
                f"{path}: {target} has lora_magnitude_vector for only "
                f"{n_dora}/{len(idxs)} layers; refusing to silently drop "
                f"DoRA on the rest")
    if lokr_layers and not weights:
        return _assemble_lokr_adapter(lokr_layers)
    if lokr_layers and weights:
        raise ValueError(
            f"{path} mixes PEFT lora_A/lora_B and LyCORIS lokr_w1/lokr_w2 "
            f"keys; split the adapters into separate files")
    if not weights:
        raise ValueError(
            f"no recognizable adapter keys in {path}: expected PEFT "
            f"lora_A/lora_B or LyCORIS lokr_w1/lokr_w2 layer keys")
    rank = sidecar_rank or rank or 16
    alpha = sidecar_alpha if sidecar_alpha is not None else rank
    return {"meta": {"kind": "lora", "rank": rank, "alpha": alpha},
            "weights": weights}


def _assemble_lokr_adapter(lokr_layers) -> dict:
    """LyCORIS lokr_w1/lokr_w2 tensors -> our stacked {a, b} factors.

    LyCORIS factors are (out, in): delta = kron(w1, w2). Ours are (in, out),
    and kron(A, B)^T = kron(A^T, B^T), so each factor is transposed.
    Rank-factored w?_a / w?_b compose by a product first. LyCORIS's scale:
    1 with both factors full (alpha is ignored), alpha / rank with a
    rank-factored pair, baked into `a` (modules may carry different
    alphas), so `meta.alpha` stays 1. `dora_scale` maps to `dora_m`."""
    weights: Dict[str, dict] = {}
    for target, by_layer in lokr_layers.items():
        idxs = sorted(by_layer)
        a_rows, b_rows, dora_rows = [], [], []
        for i in idxs:
            parts = by_layer[i]
            rank = None
            w1 = parts.get("lokr_w1")
            if w1 is None and "lokr_w1_a" in parts:
                w1 = parts["lokr_w1_a"] @ parts["lokr_w1_b"]
                rank = parts["lokr_w1_a"].shape[1]
            w2 = parts.get("lokr_w2")
            if w2 is None and "lokr_w2_a" in parts:
                w2 = parts["lokr_w2_a"] @ parts["lokr_w2_b"]
                rank = parts["lokr_w2_a"].shape[1]
            if w1 is None or w2 is None:
                raise ValueError(
                    f"incomplete LoKr factors for {target} layer {i}")
            scale = 1.0
            if rank is not None and parts.get("alpha") is not None:
                scale = float(parts["alpha"]) / rank
            a_rows.append(w1.T * scale)           # (i1, o1), scaled
            b_rows.append(w2.T)                   # (i2, o2)
            if "dora_scale" in parts:
                dora_rows.append(parts["dora_scale"].reshape(-1))
        if dora_rows and len(dora_rows) != len(idxs):
            raise ValueError(
                f"{target} has dora_scale for only {len(dora_rows)}/"
                f"{len(idxs)} layers; refusing to silently drop DoRA")
        weights[target] = {"a": _t(np.stack(a_rows)),
                           "b": _t(np.stack(b_rows))}
        if dora_rows:
            weights[target]["dora_m"] = _t(np.stack(dora_rows))
    return {"meta": {"kind": "lokr", "alpha": 1.0}, "weights": weights}


class LoraManager:
    """Named adapters over one base model, and the effective weights of the
    active one.

    `effective_weights()` is {} while no adapter is active or the manager is
    toggled off (the base model serves as it is), else the mapping of
    `adapters.merge_weights` (parameter name -> merged tensor on the
    model's device, in its dtype) for `adapters.call_with_weights`. The
    base module is never modified. The merge is cached and rebuilt only
    when the active adapter or its scale changes; the merged copy is
    dropped on `toggle(False)` and when the active adapter is unloaded.
    Over a quantized base every quantized weight, w8a8 included, is
    materialized in bfloat16 first and the effective weights carry them
    all, as the JAX package dequantizes its whole base before merging."""

    def __init__(self, model: torch.nn.Module):
        self._model = model
        self._adapters: Dict[str, dict] = {}
        self._scales: Dict[str, float] = {}
        self._loaded_at: Dict[str, float] = {}
        self._active: Optional[str] = None
        self._enabled = True
        self._merged: Optional[Dict[str, torch.Tensor]] = None
        self._lock = threading.Lock()

    def load(self, path: str, adapter_name: Optional[str] = None,
             scale: float = 1.0) -> Dict[str, Any]:
        adapter = load_adapter_file(path)
        name = adapter_name or os.path.splitext(os.path.basename(path))[0]
        self.add(name, adapter, scale)
        return {"adapter_name": name, "scale": scale,
                "params": adapter_param_count(adapter),
                "kind": adapter["meta"].get("kind", "lora")}

    def add(self, name: str, adapter: dict, scale: float = 1.0) -> None:
        """Register an adapter held in memory (a trainer's hand-off) and
        make it the active one."""
        with self._lock:
            self._adapters[name] = adapter
            self._scales[name] = scale
            self._loaded_at[name] = time.time()
            self._active = name
            self._merged = None

    def unload(self, adapter_name: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            name = adapter_name or self._active
            if name is None or name not in self._adapters:
                return {"unloaded": None}
            del self._adapters[name]
            self._scales.pop(name, None)
            self._loaded_at.pop(name, None)
            if self._active == name:
                self._active = next(iter(self._adapters), None)
                self._merged = None
            # an inactive adapter never shaped the effective weights
            return {"unloaded": name, "active": self._active}

    def toggle(self, use_lora: bool) -> Dict[str, Any]:
        with self._lock:
            self._enabled = bool(use_lora)
            if not self._enabled:
                # the base serves while disabled: do not pin a second copy
                # of the targeted weights
                self._merged = None
            return {"use_lora": self._enabled, "active": self._active}

    def set_scale(self, scale: float,
                  adapter_name: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            name = adapter_name or self._active
            if name is None or name not in self._adapters:
                raise KeyError(f"no such adapter: {name}")
            if name == self._active and \
                    self._scales.get(name, 1.0) != float(scale):
                self._merged = None
            self._scales[name] = float(scale)
            return {"adapter_name": name, "scale": float(scale)}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "use_lora": self._enabled,
                "active_adapter": self._active,
                "adapters": [
                    {"name": n,
                     "scale": self._scales.get(n, 1.0),
                     "kind": a["meta"].get("kind", "lora"),
                     "loaded_at": self._loaded_at.get(n)}
                    for n, a in self._adapters.items()
                ],
            }

    def signature(self) -> str:
        """The active adapter and its scale, for output uuids ('' when
        disabled or nothing is active): the same request under another
        adapter or scale gets another uuid."""
        with self._lock:
            if not self._enabled or self._active not in self._adapters:
                return ""
            return (f"{self._active}"
                    f"@{self._scales.get(self._active, 1.0):g}")

    @torch.no_grad()
    def effective_weights(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            if not self._enabled or self._active is None:
                return {}
            if self._merged is None:
                adapter = self._adapters[self._active]
                dev = next(self._model.parameters()).device
                weights = {n: {p: x.to(dev) for p, x in pair.items()}
                           for n, pair in adapter["weights"].items()}
                base = dequantized_weights(self._model)
                self._merged = {**base, **merge_weights(
                    self._model, weights, self._scales.get(self._active, 1.0),
                    adapter["meta"], base)}
            return self._merged
