"""Weight quantization: int8 / fp8 weight-only, w8a8 dynamic, int4 groups.

Port of `acestep_tpu/ops/quant.py`. The JAX package replaces weight leaves
of its parameter tree by {codes, scale} nodes and dequantizes the tree at
the top of each jitted program (XLA fuses the dequantization into each
consumer). Eager PyTorch that did the same would hold a full-precision copy
of the model, so here quantized storage is a module, `QuantWeight`, that
takes the place of an `nn.Linear` / `nn.Conv1d` / `nn.ConvTranspose1d` and
is dequantized per module at use:

- int8 / fp8 / int4 (weight-only): `ops.basic.linear` and `ops.conv`
  materialize the weight in the compute dtype, then run the float product;
- w8a8: `ops.basic.linear` quantizes the activations per token and runs an
  int8 x int8 -> int32 product (`torch._int_mm`, the counterpart of the JAX
  package's `lax.dot_general` with an int32 accumulator); a conv always
  materializes its weight, as in JAX.

Which weights are quantized is the JAX rule applied to the JAX tree path of
each parameter (`utils/weights.jax_leaf`): every `w` leaf of 2 or more
dims whose first key is not excluded. Codes and scales are bit-equal to
the JAX package's: each is stored as the JAX leaf with its output-channel
axis moved to the front, so the in-features axis, over which scales
reduce and int4 groups and packs, is last.

`QuantWeight.weight` is an empty slot: `lora/adapters.call_with_weights`
puts a merged float weight there for the length of a call, and the module
then computes with it instead of its codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# the reference's torchao policy names map onto these modes; int4 is
# group-wise weight-only, two weights a byte
MODE_ALIASES = {
    "int8": "int8",
    "int8_weight_only": "int8",
    "fp8": "fp8",
    "fp8_weight_only": "fp8",
    "w8a8": "w8a8",
    "w8a8_dynamic": "w8a8",
    "int4": "int4",
    "int4_weight_only": "int4",
    "w4a16": "int4",
}

_FP8_MAX = 448.0   # float8_e4m3fn finite max
INT4_GROUP = 128   # in-features per int4 scale group

# the fewest rows `torch._int_mm` takes on a CUDA device (it refuses 16 or
# fewer, and in- and out-features that are not multiples of 8)
_INT_MM_MIN_ROWS = 17


def resolve_mode(mode: str) -> str:
    canon = MODE_ALIASES.get(mode)
    if canon is None:
        raise ValueError(
            f"unsupported quantization mode {mode!r}; supported: "
            f"{sorted(MODE_ALIASES)}")
    return canon


def _is_quantizable(keys: Tuple[str, ...], ndim: int) -> bool:
    """Linear and conv weight matrices only (`w` leaves of 2+ dims in the
    JAX tree); norms, biases, embedding tables and modulation tables stay
    full precision."""
    return bool(keys) and keys[-1] == "w" and ndim >= 2


# ------------------------------------------------------------------
# Codes (on the in-features-last layout)
# ------------------------------------------------------------------


_DIVISORS: dict = {}


def _div(x: torch.Tensor, q: float) -> torch.Tensor:
    """x / q rounded as one IEEE division on every device. PyTorch's CUDA
    kernels multiply by the reciprocal of a host scalar divisor, which can
    move the quotient by an ulp from the CPU's and JAX's; a device tensor
    divisor (made once per device, outside any graph capture: a decode
    step runs eagerly before it is captured) keeps the true quotient."""
    key = (q, x.device)
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS[key] = torch.tensor(q, dtype=torch.float32,
                                          device=x.device)
    return x / d


def _channel_scale(w: torch.Tensor, qmax: float, group=None
                   ) -> torch.Tensor:
    """One scale per row, from the max over the last axis (a weight's
    in-features, an activation's channels); with a tp `group` the row is
    split over its ranks and the max is taken over the whole row."""
    amax = w.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp(_div(amax, qmax), min=1e-12)


def _int4_codes(w: torch.Tensor):
    """Nibble-packed int4 codes and (..., groups) scales, or None when the
    in-features axis does not split into INT4_GROUP groups (the caller then
    stores int8). Even in-features in the low nibble, odd in the high one;
    one scale per (group of INT4_GROUP in-features, output channel)."""
    *lead, fin = w.shape
    if fin % INT4_GROUP or fin % 2:
        return None
    wg = w.reshape(*lead, fin // INT4_GROUP, INT4_GROUP)
    scale = torch.clamp(_div(wg.abs().amax(dim=-1, keepdim=True), 7.0),
                        min=1e-12)
    q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int8)
    q = (q.reshape(*lead, fin) + 8).to(torch.uint8)           # [0, 15]
    packed = q[..., 0::2] | (q[..., 1::2] << 4)
    return packed, scale[..., 0]


def _dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, dtype):
    *lead, half = packed.shape
    u = packed.to(torch.int32)
    q = torch.stack([(u & 0xF) - 8, (u >> 4) - 8], dim=-1).reshape(
        *lead, half * 2)
    ng = scale.shape[-1]
    wg = q.reshape(*lead, ng, -1).float() * scale[..., None]
    return wg.reshape(*lead, half * 2).to(dtype)


# ------------------------------------------------------------------
# The storage module
# ------------------------------------------------------------------

# torch weight layout <-> (out, ..., in): the JAX leaf, output axis first
_TO_CANON = {nn.Linear: None, nn.Conv1d: (0, 2, 1),
             nn.ConvTranspose1d: (1, 2, 0)}
_FROM_CANON = {"linear": None, "conv": (0, 2, 1), "conv_t": (2, 0, 1)}
_KIND = {nn.Linear: "linear", nn.Conv1d: "conv", nn.ConvTranspose1d: "conv_t"}


class QuantWeight(nn.Module):
    """Quantized weight of a linear or 1-D conv, with its float bias.

    Buffers: `codes` (int8, float8_e4m3fn or nibble-packed uint8) and
    float32 `scale`, both laid out output channel first and in-features
    last; `weight` is None unless a merged float weight is swapped in.
    `mode` is int8 / fp8 / w8a8 / int4 (an int4 weight whose in-features
    do not split into groups is stored int8); `dtype` is the dtype the
    weight had, in which weight-only modes materialize it."""

    def __init__(self, kind: str, mode: str, codes: torch.Tensor,
                 scale: torch.Tensor, bias: Optional[nn.Parameter], dtype):
        super().__init__()
        self.kind = kind
        self.mode = mode
        self.dtype = dtype
        self.register_buffer("codes", codes)
        self.register_buffer("scale", scale)
        self.register_buffer("weight", None)
        self.bias = bias

    def extra_repr(self) -> str:
        return (f"kind={self.kind}, mode={self.mode}, "
                f"codes={tuple(self.codes.shape)}")

    def dequantize(self, dtype=None) -> torch.Tensor:
        """The float weight in PyTorch's layout for its kind, in `dtype`
        (default: the dtype the weight had)."""
        dtype = dtype or self.dtype
        if self.codes.dtype == torch.uint8:
            w = _dequantize_int4(self.codes, self.scale, dtype)
        else:
            w = (self.codes.float() * self.scale).to(dtype)
        perm = _FROM_CANON[self.kind]
        return w if perm is None else w.permute(*perm)


@torch.no_grad()
def quantize_weight(module: nn.Module, mode: str) -> QuantWeight:
    """The QuantWeight of an nn.Linear / nn.Conv1d / nn.ConvTranspose1d."""
    mode = resolve_mode(mode)
    cls = type(module)
    if cls not in _KIND:
        raise TypeError(f"cannot quantize a {cls.__name__}")
    perm = _TO_CANON[cls]
    w = module.weight.detach().float()
    w = (w if perm is None else w.permute(*perm)).contiguous()
    stored = mode
    if mode == "fp8":
        scale = _channel_scale(w, _FP8_MAX)
        codes = (w / scale).to(torch.float8_e4m3fn)
    elif mode == "int4":
        packed = _int4_codes(w)
        if packed is None:
            stored = "int8"
            codes, scale = quantize_rows(w)
        else:
            codes, scale = packed
    else:
        codes, scale = quantize_rows(w)
    return QuantWeight(_KIND[cls], stored, codes, scale, module.bias,
                       module.weight.dtype)


@torch.no_grad()
def quantize_module_(root: nn.Module, mode: str, *, prefix: str = "",
                     exclude_prefixes: Tuple[str, ...] = (
                         "tokenizer", "detokenizer")) -> nn.Module:
    """Replace, in place, every quantizable weight under `root` by its
    QuantWeight, one module at a time (each float weight is freed as its
    codes form). `prefix` is root's name in the whole model, so the JAX
    rule sees full paths; `exclude_prefixes` are first keys of the JAX tree
    left in full precision (the DiT's FSQ tokenizer and detokenizer, as in
    the reference; the planner's `lm_head`)."""
    from acestep_torch.utils.weights import jax_leaf

    mode = resolve_mode(mode)
    for name, module in list(root.named_modules()):
        w = module._parameters.get("weight")
        if w is None or not name:
            continue
        full = ".".join(p for p in (prefix, name) if p)
        keys, ndim = jax_leaf(f"{full}.weight", w.ndim)
        if keys[0] in exclude_prefixes or not _is_quantizable(keys, ndim):
            continue
        parent = root.get_submodule(name.rpartition(".")[0])
        setattr(parent, name.rpartition(".")[2],
                quantize_weight(module, mode))
    return root


def dequantized_weights(model: nn.Module, dtype=torch.bfloat16
                        ) -> dict:
    """{'<module>.weight': float weight} of every QuantWeight, w8a8
    included: the JAX package's `dequantize_params(materialize_w8a8=True)`
    (LoRA merging needs real weight tensors)."""
    return {f"{name}.weight": m.dequantize(dtype)
            for name, m in model.named_modules()
            if isinstance(m, QuantWeight)}


# ------------------------------------------------------------------
# Use
# ------------------------------------------------------------------


def int8_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b_t (K, N) int8 -> (M, N) int32, exact, through
    `torch._int_mm`. `b_t` is the transpose of a contiguous (N, K) table
    (column-major, the layout cuBLASLt's int8 product takes). On a CUDA
    device fewer than 17 rows are padded with zero rows, which is exact;
    any other shape the product rejects raises."""
    M = a.shape[0]
    if a.is_cuda and M < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - M))
        return torch._int_mm(a, b_t)[:M]
    return torch._int_mm(a, b_t)


def quantize_rows(x: torch.Tensor, group=None):
    """Symmetric int8 over the last axis, one scale per row: (codes,
    float32 scales (..., 1)). A weight's rows are its output channels; an
    activation's are its tokens (split over a tp `group`'s ranks when one
    is given)."""
    xf = x.float()
    scale = _channel_scale(xf, 127.0, group)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), \
        scale


def w8a8_matmul(x: torch.Tensor, codes: torch.Tensor,
                scale: torch.Tensor, group=None) -> torch.Tensor:
    """Dynamic-activation int8 product: x (..., in) @ codes (out, in).T.

    Per-token symmetric activation codes, the int8 x int8 -> int32
    product, then the int32 sums scaled by (token scale x channel scale)
    in float32 and cast to x's dtype, in the JAX package's order. A
    row-parallel shard (tp `group`) takes each token's scale over the
    whole row and sums the int32 products over the group, so its result
    is the unsplit product's bit for bit."""
    xq, xs = quantize_rows(x, group)
    lead = x.shape[:-1]
    y = int8_mm(xq.reshape(-1, x.shape[-1]), codes.t())
    if group is not None:
        dist.all_reduce(y, group=group)
    y = y.reshape(*lead, codes.shape[0])
    return (y.float() * (xs * scale.reshape(-1))).to(x.dtype)


def quantized_linear(p: QuantWeight, x: torch.Tensor,
                     group=None) -> torch.Tensor:
    """x @ W.T of a QuantWeight with no swapped-in weight (no bias),
    summed over a row-parallel shard's tp `group` when one is given."""
    if p.mode == "w8a8":
        return w8a8_matmul(x, p.codes, p.scale, group)
    y = F.linear(x, p.dequantize().to(x.dtype))
    if group is not None:
        dist.all_reduce(y, group=group)
    return y


def conv_weight(p: nn.Module, dtype) -> torch.Tensor:
    """A conv's weight in `dtype`; a QuantWeight materializes its own (the
    int8 activation path is for linears only, as in JAX)."""
    if p.weight is not None:
        return p.weight.to(dtype)
    if p.mode == "w8a8":
        return p.dequantize(dtype)
    return p.dequantize().to(dtype)


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of a (possibly quantized)
    model."""
    return int(sum(t.numel() * t.element_size()
                   for t in list(model.parameters()) + list(model.buffers())))
