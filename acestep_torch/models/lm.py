"""Qwen3-family causal LM: the 5 Hz planner and the Qwen3-Embedding trunk.

Port of `acestep_tpu/models/lm.py`. `QwenLM` holds the parameters under the
JAX package's tree names (`embed_tokens` is a bare (V, H) table, `layers.i`
carry `input_layernorm` / `self_attn` / `post_attention_layernorm` / `mlp`,
then `norm` and, when the head is not tied, `lm_head`), so
`utils/weights.lm_from_jax` carries a JAX tree across by name.

The cache is a fixed-shape per-layer buffer (n_layers, B, Hkv, max_len, D):
the JAX cache's slot and head axes swapped, so each layer's keys and values
enter the attention's batched products as they lie. `lm_forward` writes
each row's new K/V at that row's own offset with an index scatter of
static shape, and builds the causal mask and the RoPE tables once per call
from the per-row start positions on the device, so one decode step has the
same shapes at every token and a CUDA graph can hold it
(llm/generator.py). Attention is plain PyTorch, as it is plain XLA in the
JAX package: logits and softmax in float32, the P.V product in the cache
dtype. The int8 cache mode stores per head-vector scales and attends
straight over the int8 values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from acestep_torch.config import LMConfig
from acestep_torch.ops.basic import (
    MLP, Attention, RMSNorm, apply_rope, linear, mlp, rms_norm, rope_cos_sin,
    seeded_init_,
)
from acestep_torch.ops.quant import int8_mm, quantize_module_, quantize_rows

# ------------------------------------------------------------------
# Params
# ------------------------------------------------------------------


class LMLayer(nn.Module):
    def __init__(self, cfg: LMConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, **kw)
        self.self_attn = Attention(cfg.hidden_size, cfg.num_attention_heads,
                                   cfg.num_key_value_heads, cfg.head_dim,
                                   **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, **kw)
        self.mlp = MLP(cfg.hidden_size, cfg.intermediate_size, **kw)


class QwenLM(nn.Module):
    def __init__(self, cfg: LMConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **kw))
        self.layers = nn.ModuleList(
            LMLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False, **kw)

    @torch.no_grad()
    def init_own_(self, generator):
        self.embed_tokens.normal_(0.0, 1.0, generator=generator).mul_(0.02)


def build_lm(cfg: LMConfig, device, dtype=torch.float32) -> QwenLM:
    """Uninitialised module on `device` (no init pass over the weights)."""
    return QwenLM(cfg, device="meta", dtype=dtype).to_empty(
        device=device).requires_grad_(False)


def init_lm_params(cfg: LMConfig, generator: torch.Generator, *,
                   dtype=torch.float32,
                   quantization: Optional[str] = None) -> QwenLM:
    """Seeded LM on `generator`'s device, drawn in `dtype` leaf by leaf (a
    4B planner never exists in float32): embed N(0, 0.02^2), linears
    N(0, 0.02^2), unit norm scales — the JAX init's distributions.

    The model is materialized one top-level block at a time, in the order
    `seeded_init_` draws them; with `quantization` each decoder layer is
    quantized (ops/quant, `lm_head` excluded) as soon as it is drawn, so
    the float trunk and its codes are never resident together."""
    dev = generator.device
    model = QwenLM(cfg, device="meta", dtype=dtype).requires_grad_(False)
    model.embed_tokens = nn.Parameter(
        torch.empty_like(model.embed_tokens, device=dev),
        requires_grad=False)
    model.init_own_(generator)
    blocks = [(f"layers.{i}", lp) for i, lp in enumerate(model.layers)]
    blocks += [(name, m) for name, m in model.named_children()
               if name != "layers"]
    for name, block in blocks:
        block.to_empty(device=dev)
        seeded_init_(block, generator)
        if quantization and name.startswith("layers."):
            quantize_module_(block, quantization, prefix=name,
                             exclude_prefixes=("lm_head",))
    return model


# ------------------------------------------------------------------
# KV cache
# ------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class KVCache:
    """Fixed-shape per-layer cache: k/v (n_layers, B, Hkv, max_len, D).

    With `quantized=True` at create time, k/v store int8 with per
    head-vector float32 scales (k_scale/v_scale, (..., max_len, 1)), quantized
    once at write time. `epoch` counts how often the engine has handed the
    buffer out (llm/generator.py): a prefix state made at another epoch no
    longer describes the contents."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    epoch: int = 0
    uid: int = 0          # the name a mesh's ranks know the buffer by

    @classmethod
    def create(cls, cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quantized: bool = False, device=None):
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                 max_len, cfg.head_dim)
        if quantized:
            sshape = shape[:-1] + (1,)
            return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def slots(self) -> int:
        return self.k.shape[3]

    def view(self, ceil: int) -> "KVCache":
        """The first `ceil` slots, sharing storage (the codes phase's
        per-chunk cache ceiling)."""
        def f(a):
            return None if a is None else a[:, :, :, :ceil]
        return KVCache(f(self.k), f(self.v), f(self.k_scale), f(self.v_scale),
                       self.epoch, self.uid)

    @torch.no_grad()
    def graft_prefix(self, src: "KVCache", copy: int) -> "KVCache":
        """Copy the first `copy` cache slots from `src` in place (prefix
        reuse; stale K/V at or after a row's length is never attended, so
        copying extra slots is safe)."""
        for d, s in ((self.k, src.k), (self.v, src.v),
                     (self.k_scale, src.k_scale), (self.v_scale, src.v_scale)):
            if d is not None:
                d[:, :, :, :copy].copy_(s[:, :, :, :copy])
        return self


# ------------------------------------------------------------------
# Forward
# ------------------------------------------------------------------


def _group(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """q (B, Lq, Hq, D) -> (B, Hkv, groups * Lq, D), the query heads of
    each KV head together (a view when Lq == 1)."""
    B, Lq, Hq, D = q.shape
    return q.reshape(B, Lq, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, Hq // Hkv * Lq, D)


def _ungroup(out: torch.Tensor, Lq: int) -> torch.Tensor:
    """(B, Hkv, groups * Lq, D) -> (B, Lq, Hq * D)."""
    B, Hkv, GL, D = out.shape
    return out.reshape(B, Hkv, GL // Lq, Lq, D).permute(0, 3, 1, 2, 4).reshape(
        B, Lq, Hkv * (GL // Lq) * D)


def _masked_softmax(logits: torch.Tensor, masked: torch.Tensor, Lq: int):
    """Softmax over keys of (B, Hkv, groups * Lq, S) float32 logits, with
    `masked` (B, 1, 1, Lq, S) True where a key is hidden (finfo.min, as
    in JAX, so a row with no visible key stays finite)."""
    B, Hkv, GL, S = logits.shape
    logits = logits.reshape(B, Hkv, GL // Lq, Lq, S).masked_fill(
        masked, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1).reshape(B, Hkv, GL, S)


def _attend(q, k, v, masked):
    """GQA attention, float32 logits and softmax. q (B, Lq, Hq, D); k/v
    (B, Hkv, S, D); masked (B, 1, 1, Lq, S) -> (B, Lq, Hq * D)."""
    Lq, D = q.shape[1], q.shape[3]
    logits = torch.matmul(_group(q, k.shape[1]).float(),
                          k.float().transpose(-1, -2)) * D ** -0.5
    probs = _masked_softmax(logits, masked, Lq).to(v.dtype)
    return _ungroup(torch.matmul(probs, v), Lq)


def _attend_quant(q, kq, ks, vq, vs, masked, dtype):
    """GQA attention straight over the int8 cache: the per-slot scales fold
    into the small tensors, (q . (kq*ks)) == (q . kq) * ks and
    probs @ (vq*vs) == (probs*vs) @ vq.

    q (B, Lq, Hq, D); kq/vq (B, Hkv, S, D) int8; ks/vs (B, Hkv, S, 1) f32;
    masked (B, 1, 1, Lq, S) -> (B, Lq, Hq * D)."""
    Lq, D = q.shape[1], q.shape[3]
    logits = torch.matmul(_group(q, kq.shape[1]).float(),
                          kq.float().transpose(-1, -2))
    logits = logits * (ks.transpose(-1, -2) * (D ** -0.5))
    probs = _masked_softmax(logits, masked, Lq)
    pv = (probs * vs.transpose(-1, -2)).to(dtype)
    return _ungroup(torch.matmul(pv, vq.to(dtype)), Lq)


def _write(c: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
           positions: torch.Tensor) -> None:
    """c (B, Hkv, S, X) <- new (B, L, Hkv, X) at slots positions (B, L)."""
    c[rows, :, positions] = new.to(c.dtype)


def lm_forward(model: QwenLM, cfg: LMConfig, input_ids: torch.Tensor,
               cache: KVCache, *, start_pos,
               attention_mask: Optional[torch.Tensor] = None):
    """Run the trunk over `input_ids` (B, L), writing K/V at
    [start_pos, start_pos + L) per row, in place. Returns the final-norm
    hidden states (B, L, H).

    `start_pos` is an int or a (B,) tensor: each row's K/V land at its own
    offset, RoPE follows the row offset, and queries see keys at or below
    their own position over the whole cache. `attention_mask` (B, max_len)
    optionally masks cache slots (1 = valid) and is authoritative when given
    (it must cover the write window too, as `lm_encode`'s does)."""
    B, L = input_ids.shape
    dev = input_ids.device
    max_len = cache.slots
    quantized = cache.quantized
    # int8 caches don't define the compute dtype; the embed table does
    cdtype = model.embed_tokens.dtype if quantized else cache.k.dtype
    x = embed(model, input_ids).to(cdtype)

    start = torch.as_tensor(start_pos, device=dev).long().reshape(-1)
    start = start.expand(B)
    positions = start[:, None] + torch.arange(L, device=dev)[None, :]
    cos, sin = rope_cos_sin(None, cfg.head_dim, cfg.rope_theta,
                            positions=positions)

    cos, sin = cos.to(cdtype), sin.to(cdtype)

    kpos = torch.arange(max_len, device=dev)
    mask = kpos[None, None, :] <= positions[:, :, None]        # (B, L, S)
    if attention_mask is not None:
        mask = mask & attention_mask.bool()[:, None, :]
    masked = ~mask[:, None, None]                              # (B,1,1,L,S)
    rows = torch.arange(B, device=dev)[:, None].expand(B, L)

    eps = cfg.rms_norm_eps
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    for i, lp in enumerate(model.layers):
        a_in = rms_norm(lp.input_layernorm, x, eps)
        at = lp.self_attn
        q = linear(at.q_proj, a_in).reshape(B, L, H, D)
        k = linear(at.k_proj, a_in).reshape(B, L, Hkv, D)
        v = linear(at.v_proj, a_in).reshape(B, L, Hkv, D)
        q = apply_rope(rms_norm(at.q_norm, q, eps), cos, sin)
        k = apply_rope(rms_norm(at.k_norm, k, eps), cos, sin)
        ck, cv = cache.k[i], cache.v[i]
        if quantized:
            kq, ks = quantize_rows(k)       # per head-vector int8
            vq, vs = quantize_rows(v)
            cks, cvs = cache.k_scale[i], cache.v_scale[i]
            _write(ck, kq, rows, positions)
            _write(cks, ks, rows, positions)
            _write(cv, vq, rows, positions)
            _write(cvs, vs, rows, positions)
            att = _attend_quant(q, ck, cks, cv, cvs, masked, cdtype)
        else:
            _write(ck, k, rows, positions)
            _write(cv, v, rows, positions)
            att = _attend(q, ck, cv, masked)
        x = x + linear(at.o_proj, att)
        x = x + mlp(lp.mlp, rms_norm(lp.post_attention_layernorm, x, eps))
    return rms_norm(model.norm, x, eps)


def embed(model: QwenLM, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of `ids`. A shard whose table is split along the
    vocabulary (`tp_vocab`, set by parallel/mesh) looks up the ids among
    its rows, zeros the others, and sums over its tp group."""
    split = model.__dict__.get("tp_vocab")
    if split is None:
        return model.embed_tokens[ids]
    lo, hi, group = split
    x = model.embed_tokens[(ids - lo).clamp(0, hi - lo - 1)]
    x = torch.where(((ids >= lo) & (ids < hi))[..., None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    dist.all_reduce(x, group=group)
    return x


def _head_split(model: QwenLM, cfg: LMConfig):
    """(lo, hi, group) of a shard's output-head rows when the head is
    split along the vocabulary (the tied table or `head_q`), else None
    (an untied float `lm_head` stays whole)."""
    split = model.__dict__.get("tp_vocab")
    if split is None or not (cfg.tie_word_embeddings
                             or hasattr(model, "head_q")):
        return None
    return split


def _gather_vocab(part: Optional[torch.Tensor], split, start: int,
                  end: int, hidden: torch.Tensor) -> torch.Tensor:
    """The logits over [start, end) from each rank's part over its rows'
    share of the window (None when it has none), summed over the group
    as zero-padded blocks: each value comes from one rank unchanged."""
    lo, hi, group = split
    out = torch.zeros(*hidden.shape[:-1], end - start, dtype=torch.float32,
                      device=hidden.device)
    a, b = max(start, lo), min(end, hi)
    if part is not None:
        out[..., a - start:b - start] = part
    dist.all_reduce(out, group=group)
    return out


class HeadQ(nn.Module):
    """Int8 copy of the output head for w8a8 decoding: `q` (V, H) int8,
    rows along the vocab, and per-row float32 `scale` (V, 1)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)


@torch.no_grad()
def build_head_q(model: QwenLM, cfg: LMConfig) -> HeadQ:
    """Int8 copy of the output head (the tied embedding table or the
    untied `lm_head`), per-row scales: once the trunk is int8 the head is
    the largest single read of a decode step. The embedding table stays
    for gathers, encoding and scoring."""
    w = (model.embed_tokens if cfg.tie_word_embeddings
         else model.lm_head.weight).float()                     # (V, H)
    q, scale = quantize_rows(w)
    return HeadQ(q, scale)


def lm_logits(model: QwenLM, cfg: LMConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """(B, L, H) -> (B, L, V) float32; a vocab-split shard computes its
    rows and gathers the rest over its tp group."""
    if cfg.tie_word_embeddings:
        w = model.embed_tokens.to(hidden.dtype)
        out = (hidden @ w.T).float()
    elif not hasattr(model, "lm_head"):
        # untied w8a8 drops the float head (`head_q` holds the int8 copy);
        # this full-vocab path dequantizes it
        hq = model.head_q
        w = (hq.q.float() * hq.scale).to(hidden.dtype)
        out = (hidden @ w.T).float()
    else:
        return linear(model.lm_head, hidden).float()
    split = _head_split(model, cfg)
    if split is None:
        return out
    return _gather_vocab(out, split, 0, cfg.vocab_size, hidden)


def lm_logits_slice(model: QwenLM, cfg: LMConfig, hidden: torch.Tensor,
                    start: int, end: int) -> torch.Tensor:
    """Logits restricted to the token-id window [start, end): a contiguous
    row slice of the head, so a decode step reads only the window's head
    rows (the codes phase samples only the 64k audio-code block).

    With `head_q` (a w8a8 LM, `build_head_q`) the window multiplies as
    int8 x int8 -> int32 with per-token activation scales. A vocab-split
    shard multiplies its rows' share of the window and gathers the rest
    over its tp group."""
    split = _head_split(model, cfg)
    if split is None:
        return _head_rows(model, cfg, hidden, start, end)
    lo, hi, _ = split
    a, b = max(start, lo), min(end, hi)
    part = _head_rows(model, cfg, hidden, a - lo, b - lo) if a < b else None
    return _gather_vocab(part, split, start, end, hidden)


def _head_rows(model: QwenLM, cfg: LMConfig, hidden: torch.Tensor,
               start: int, end: int) -> torch.Tensor:
    """Logits over the head rows [start, end) this module holds."""
    hq = getattr(model, "head_q", None)
    if hq is not None:
        q, sc = hq.q[start:end], hq.scale[start:end]             # (Vw, H)
        xq, xs = quantize_rows(hidden)
        y = int8_mm(xq.reshape(-1, hidden.shape[-1]), q.t())
        y = y.reshape(*hidden.shape[:-1], q.shape[0])
        return y.float() * xs * sc[:, 0]
    w = (model.embed_tokens if cfg.tie_word_embeddings
         else model.lm_head.weight)[start:end]
    return (hidden @ w.to(hidden.dtype).T).float()


def lm_encode(model: QwenLM, cfg: LMConfig, input_ids: torch.Tensor,
              attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Text-encoder mode (Qwen3-Embedding): one causal pass under the
    tokenizer mask, returns the last hidden states (B, L, H). No cache is
    kept."""
    B, L = input_ids.shape
    cache = KVCache.create(cfg, B, L, dtype=dtype, device=input_ids.device)
    return lm_forward(model, cfg, input_ids, cache, start_pos=0,
                      attention_mask=attention_mask)


# ------------------------------------------------------------------
# Sampling (reference: nano-vllm layers/sampler.py + SamplingParams)
# ------------------------------------------------------------------


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    cutoff = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < cutoff, float("-inf"))


def apply_top_p(logits: torch.Tensor, p: float, iters: int = 24) -> torch.Tensor:
    """Nucleus filter without a vocab sort, by the JAX package's bisection:
    the kept set {i : p_i >= tau} for the tau that `iters` halvings of
    [0, max_p] find while keeping mass(lo) >= p (so the kept set always
    covers the target mass, ties included)."""
    probs = torch.softmax(logits, dim=-1)
    hi = probs.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        mass = torch.where(probs >= mid, probs, 0.0).sum(dim=-1, keepdim=True)
        ok = mass >= p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return logits.masked_fill(probs < lo, float("-inf"))


def sample_tokens(generator: Optional[torch.Generator], logits: torch.Tensor,
                  *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0,
                  allow_mask: Optional[torch.Tensor] = None,
                  greedy_if_zero_temp: bool = True) -> torch.Tensor:
    """logits (B, V) float32 -> token ids (B,) int64.

    allow_mask: optional bool (B, V), the FSM constraint; masked logits go
    to -inf before temperature/top-k/top-p. Sampling is Gumbel-max over
    uniforms from `generator` (the role of `jax.random.categorical`), all
    on the logits' device with no host sync."""
    if allow_mask is not None:
        logits = logits.masked_fill(~allow_mask, float("-inf"))
    if temperature <= 0.0 and greedy_if_zero_temp:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        logits = apply_top_k(logits, top_k)
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1)


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Transformers-style repetition penalty on (B, V) logits: tokens of
    the completion (`seen_mask`) score*penalty when negative, else
    score/penalty; applied to the conditional logits before the CFG mix."""
    pen = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen_mask, pen, logits)


def cfg_mix_logits(logits: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """Paired-CFG logit mix: rows [cond; uncond] (2B, V) -> (B, V)
    u + s*(c - u)."""
    c, u = logits.chunk(2, dim=0)
    return u + guidance_scale * (c - u)
