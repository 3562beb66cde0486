"""Carry the JAX package's parameter trees across to the port's modules.

`dit_from_jax` / `vae_from_jax` / `lm_from_jax` take a parameter pytree of
the JAX package as numpy arrays (`jax.tree.map(np.asarray,
init_dit_params(...))`, or a tree from `utils/checkpoint.py`'s converters)
and return the port's `state_dict`, or load it into a module when one is
given.
Layout rules of the JAX package:

- linears store w as (in, out); PyTorch's `nn.Linear` is (out, in);
- convs store w as (k, in, out) ("HIO"); `nn.Conv1d` is (out, in, k);
- `conv1d_transpose` flips its kernel and uses input dilation, which is a
  `nn.ConvTranspose1d` with the unflipped kernel laid out (in, out, k);
- the decoder and encoder layers are stacked on a leading axis, one entry
  of `layers.{i}` each; the VAE's blocks are lists.

A tree shaped like the parameters maps the same way, so `dit_from_jax` of a
JAX gradient tree gives the gradient of each of the port's parameters by
name. LoRA/LoKr adapters keep the JAX layout in both packages
(`lora/adapters.py`): `adapter_from_jax` / `adapter_to_jax` only move their
arrays between numpy and tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _is_transpose_conv(path: str) -> bool:
    """The two transposed convs of the models: the DiT's de-patchifier and
    the VAE decoder blocks' upsamplers."""
    return path == "decoder.proj_out" or path.endswith(".up")


def _leaf(path: str, name: str, arr: np.ndarray):
    """(torch key, torch-layout array) of one JAX leaf."""
    key = f"{path}.{name}" if path else name
    if name == "w":
        key = f"{path}.weight"
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 3:
            arr = arr.transpose(1, 2, 0) if _is_transpose_conv(path) \
                else arr.transpose(2, 1, 0)
    elif name == "b":
        key = f"{path}.bias"
    return key, arr


def jax_leaf(key: str, ndim: int) -> Tuple[Tuple[str, ...], int]:
    """The JAX tree keys and ndim of the leaf that the port's state-dict
    `key` (of a tensor of `ndim` dims) carries, the inverse of `_flatten`'s
    naming: `weight` / `bias` are `w` / `b`; `layers.{i}` is entry i of a
    leaf stacked on a leading axis (one more dim in JAX); any other index
    is a list position (the VAE's blocks), not a key."""
    parts = key.split(".")
    keys, stacked = [], 0
    for i, part in enumerate(parts):
        if part.isdigit():
            stacked += i > 0 and parts[i - 1] == "layers"
            continue
        keys.append(part)
    keys[-1] = {"weight": "w", "bias": "b"}.get(keys[-1], keys[-1])
    return tuple(keys), ndim + stacked


def _flatten(tree, path: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for name, sub in tree.items():
            sub_path = f"{path}.{name}".lstrip(".")
            if name == "layers":             # stacked on a leading axis
                for i in range(len(next(_leaves(sub)))):
                    _flatten(_index(sub, i), f"{sub_path}.{i}", out)
            elif isinstance(sub, (dict, list, tuple)):
                _flatten(sub, sub_path, out)
            else:
                key, arr = _leaf(path, name, np.asarray(sub))
                out[key] = arr
    else:                                   # list of blocks
        for i, sub in enumerate(tree):
            _flatten(sub, f"{path}.{i}", out)


def _leaves(tree):
    if isinstance(tree, dict):
        for sub in tree.values():
            yield from _leaves(sub)
    else:
        yield tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _convert(tree) -> Dict[str, torch.Tensor]:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def _load(state: Dict[str, torch.Tensor], module: Optional[nn.Module]):
    if module is None:
        return state
    module.load_state_dict(state, strict=True)
    return module


def dit_from_jax(tree, module: Optional[nn.Module] = None):
    """JAX `init_dit_params` tree -> the AceStepDiT state_dict (fp32), or
    the module with it loaded (cast to the module's dtype and device)."""
    return _load(_convert(tree), module)


def vae_from_jax(tree, module: Optional[nn.Module] = None):
    """JAX `init_vae_params` tree -> the OobleckVAE state_dict (fp32), or
    the module with it loaded."""
    return _load(_convert(tree), module)


def lm_from_jax(tree, module: Optional[nn.Module] = None):
    """JAX `init_lm_params` tree -> the QwenLM state_dict (fp32), or the
    module with it loaded. The bare `embed_tokens` table keeps its (V, H)
    layout; the untied `lm_head` linear transposes like every linear."""
    return _load(_convert(tree), module)


def adapter_from_jax(adapter: dict, device=None,
                     dtype=torch.float32) -> dict:
    """{meta, weights} with numpy (or JAX) leaves -> the same tree with
    tensors on `device`."""
    return {"meta": dict(adapter["meta"]),
            "weights": {name: {part: torch.tensor(np.asarray(x), dtype=dtype,
                                                  device=device)
                               for part, x in pair.items()}
                        for name, pair in adapter["weights"].items()}}


def adapter_to_jax(adapter: dict) -> dict:
    """{meta, weights} with tensor leaves -> numpy leaves (float32)."""
    return {"meta": dict(adapter["meta"]),
            "weights": {name: {part: x.detach().float().cpu().numpy()
                               for part, x in pair.items()}
                        for name, pair in adapter["weights"].items()}}
