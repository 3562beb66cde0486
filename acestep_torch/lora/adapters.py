"""Adapter math: LoRA and LoKr factors over the decoder's stacked layers.

Port of `acestep_tpu/lora/adapters.py`. Targets are the decoder layers'
self/cross-attention q/k/v/o projections and MLP gate/up/down. Adapters
keep the JAX package's layout, stacked over the L decoder layers:
LoRA `down (L, in, r)` and `up (L, r, out)`, LoKr `a (L, a1, a2)` and
`b (L, b1, b2)`, optional DoRA magnitudes `dora_m (L, out)`. So the delta
of a target is (L, in, out); the port's `nn.Linear` weights are (out, in)
per layer, and `merge_weights` transposes each layer's delta onto them.

`merge_weights` returns the merged weights as a name -> tensor mapping, and
`call_with_weights` runs a function of the model with them in place of its
parameters (`torch.func.functional_call`): the model is never copied or
modified. Over a quantized base (`ops/quant.QuantWeight`) the merged weight
takes the empty `weight` slot of the target's storage.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, TypeVar

import torch
from torch import nn
from torch.func import functional_call

R = TypeVar("R")

# path components under model.decoder.layers[i], each ending at an nn.Linear
LORA_TARGETS: Tuple[Tuple[str, ...], ...] = (
    ("self_attn", "q_proj"),
    ("self_attn", "k_proj"),
    ("self_attn", "v_proj"),
    ("self_attn", "o_proj"),
    ("cross_attn", "q_proj"),
    ("cross_attn", "k_proj"),
    ("cross_attn", "v_proj"),
    ("cross_attn", "o_proj"),
    ("mlp", "gate"),
    ("mlp", "up"),
    ("mlp", "down"),
)


def _key(path: Sequence[str]) -> str:
    return ".".join(path)


def target_paths(model, targets: Sequence[Tuple[str, ...]] = LORA_TARGETS,
                 base: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, List[torch.Tensor]]:
    """Map 'self_attn.q_proj' -> the L decoder layers' (out, in) weights;
    a weight named in `base` (parameter name -> tensor) is taken from
    there (a quantized target's materialized weight)."""
    base = base or {}
    out = {}
    for path in targets:
        weights = []
        for i, layer in enumerate(model.decoder.layers):
            node = layer
            for name in path:
                node = getattr(node, name)
            key = f"decoder.layers.{i}.{_key(path)}.weight"
            weights.append(base[key] if key in base else node.weight)
        out[_key(path)] = weights
    return out


# ------------------------------------------------------------------
# LoRA
# ------------------------------------------------------------------


def init_lora(generator: torch.Generator, model, *, rank: int = 16,
              alpha: float = 32.0,
              targets: Sequence[Tuple[str, ...]] = LORA_TARGETS,
              dtype=torch.float32,
              base: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Adapter {meta, weights: {target: {down, up}}} on the generator's
    device: `down` Gaussian / sqrt(in), `up` zeros (the delta starts at 0).
    Targets are drawn in sorted order, as in the JAX package; `base` as in
    `target_paths`."""
    dev = generator.device
    weights = {}
    for name, ws in sorted(target_paths(model, targets, base).items()):
        L, (d_out, d_in) = len(ws), ws[0].shape
        down = torch.randn((L, d_in, rank), generator=generator, device=dev,
                           dtype=dtype) / (d_in ** 0.5)
        weights[name] = {"down": down,
                         "up": torch.zeros((L, rank, d_out), device=dev,
                                           dtype=dtype)}
    return {"meta": {"kind": "lora", "rank": rank, "alpha": alpha},
            "weights": weights}


def lora_delta(adapter_weights: dict, name: str, alpha: float,
               rank: int) -> torch.Tensor:
    """(L, in, out) delta of one target."""
    aw = adapter_weights[name]
    return torch.einsum("lir,lro->lio", aw["down"], aw["up"]) * (alpha / rank)


# ------------------------------------------------------------------
# LoKr (Kronecker product factorization, LyCORIS-style)
# ------------------------------------------------------------------


def _kron_factor(n: int, max_factor: int) -> Tuple[int, int]:
    """Split n = a*b with a <= max_factor, a as large as possible."""
    best = (1, n)
    for a in range(2, min(max_factor, n) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def init_lokr(generator: torch.Generator, model, *, factor: int = 8,
              alpha: float = 1.0,
              targets: Sequence[Tuple[str, ...]] = LORA_TARGETS,
              dtype=torch.float32,
              base: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """delta = kron(a, b): a (L, a1, a2) Gaussian / sqrt(a1), b (L, b1, b2)
    zeros, where in = a1*b1 and out = a2*b2; `base` as in `target_paths`."""
    dev = generator.device
    weights = {}
    for name, ws in sorted(target_paths(model, targets, base).items()):
        L, (d_out, d_in) = len(ws), ws[0].shape
        a1, b1 = _kron_factor(d_in, factor)
        a2, b2 = _kron_factor(d_out, factor)
        a = torch.randn((L, a1, a2), generator=generator, device=dev,
                        dtype=dtype) / (a1 ** 0.5)
        weights[name] = {"a": a, "b": torch.zeros((L, b1, b2), device=dev,
                                                  dtype=dtype)}
    return {"meta": {"kind": "lokr", "factor": factor, "alpha": alpha},
            "weights": weights}


def lokr_delta(adapter_weights: dict, name: str, alpha: float) -> torch.Tensor:
    """(L, in, out) batched Kronecker product of one target's factors."""
    aw = adapter_weights[name]
    a, b = aw["a"], aw["b"]
    L, a1, a2 = a.shape
    _, b1, b2 = b.shape
    kron = torch.einsum("lij,lkm->likjm", a, b).reshape(L, a1 * b1, a2 * b2)
    return kron * alpha


# ------------------------------------------------------------------
# Merge
# ------------------------------------------------------------------


def merge_weights(model, weights: dict, scale, meta: dict,
                  base: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """{parameter name: W + scale * delta} for every layer of every target
    in `weights`, in the base weight's dtype (differentiable in the
    factors); W is `base`'s tensor of that name where it has one. With
    `dora_m` the merged weight's per-output norm is replaced by the
    learned magnitude: W' = m * (W + scale*delta) / ||.||."""
    kind = meta.get("kind", "lora")
    bases = target_paths(model, [tuple(n.split(".")) for n in weights], base)
    merged = {}
    for name, ws in bases.items():
        if kind == "lora":
            delta = lora_delta(weights, name, meta.get("alpha", 32.0),
                               meta.get("rank", 16))
        else:
            delta = lokr_delta(weights, name, meta.get("alpha", 1.0))
        # one cast and one unbind for all layers: unbind's backward stacks
        # the L gradients once, where indexing delta[i] L times would
        # zero-fill and sum L full-size fp32 gradients
        per_layer = (scale * delta).transpose(1, 2).to(ws[0].dtype).unbind(0)
        m = weights[name].get("dora_m")
        for i, w in enumerate(ws):
            new = w + per_layer[i]                            # (out, in)
            if m is not None:
                norm = torch.sqrt((new.float() ** 2).sum(dim=1, keepdim=True))
                new = (new / torch.clamp(norm, min=1e-8).to(new.dtype)
                       * m[i].to(new.dtype)[:, None])
            merged[f"decoder.layers.{i}.{name}.weight"] = new
    return merged


class _Bound(nn.Module):
    """Holds the model so that `functional_call` can swap its weights for
    the length of one call of `fn(model)`."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


def call_with_weights(model: nn.Module, weights: Dict[str, torch.Tensor],
                      fn: Callable[[nn.Module], R]) -> R:
    """`fn(model)` with `weights` (parameter name -> tensor, as
    `merge_weights` gives them) in place of the model's parameters of those
    names; with no weights, `fn(model)` itself. A backward run inside `fn`
    sees the swapped weights too (per-layer recomputation included)."""
    if not weights:
        return fn(model)
    return functional_call(_Bound(model),
                           {f"model.{k}": v for k, v in weights.items()},
                           (fn,))


def adapter_param_count(adapter: dict) -> int:
    return int(sum(x.numel() if isinstance(x, torch.Tensor) else x.size
                   for pair in adapter["weights"].values()
                   for x in pair.values()))
