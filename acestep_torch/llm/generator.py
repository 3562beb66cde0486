"""Batched autoregressive generation engine for the 5 Hz LM.

Port of `acestep_tpu/llm/generator.py`. The engine prefills right-padded
prompts at per-row offsets (the prompt ladder bounds their shapes), keeps
the KV cache at a bucketed slot count (the KV ladder), and decodes one
token per step:

- the decode step (trunk + head slice) has one shape per (rows, cache
  ceiling, head window); on a CUDA device each such step is captured once
  as a `torch.cuda.CUDAGraph` and replayed for every token (the role XLA's
  cached executable plays in the JAX engine). Its static inputs are the
  fed tokens, the per-row lengths and the cache; the mask and the RoPE
  tables are built inside the graph from the lengths. On the CPU the step
  runs eagerly, and the eager step is the graph's oracle on the card. A
  capture or replay that fails raises; nothing falls back to eager;
- sampling, the repetition penalty, the CFG mix and the device FSM step run
  outside the graph, on device tensors, with no host sync per token: the
  CoT phase reads its done state back once every 16 tokens and the codes
  phase runs its fixed count with no read-back at all;
- caches come from a small arena of buffers per (rows, slots), so a
  graph's cache pointer stays valid across requests. A prefix state names
  the arena epoch it was made at and is ignored once its buffer has been
  handed out again.

CFG pairing is a batch-axis concat [cond; uncond]; both halves share the
sampled token. Sampling draws from a `torch.Generator` seeded with the
request seed, so the token streams are reproducible per device but are not
JAX's (greedy decoding, temperature 0, matches JAX token for token).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from acestep_torch.config import LMConfig
from acestep_torch.models.lm import (
    KVCache, QwenLM, apply_repetition_penalty, cfg_mix_logits, lm_forward,
    lm_logits_slice, sample_tokens,
)

CHUNK = 16          # tokens between host reads in the chunked loops


def _pen_mix_fn(do_cfg: bool, cfg_scale: float, penalty: float):
    """Penalize-then-mix: repetition penalty on the CONDITIONAL logits
    before the CFG mix. Returns f(logits (2B|B, V), seen (B, V) bool) ->
    mixed (B, V)."""
    def mix(lg):
        return cfg_mix_logits(lg, cfg_scale) if do_cfg else lg

    if penalty == 1.0:
        return lambda lg, seen: mix(lg)

    def f(lg, seen):
        B = seen.shape[0]
        cond = apply_repetition_penalty(lg[:B], seen, penalty)
        lg = torch.cat([cond, lg[B:]], dim=0) if do_cfg else cond
        return mix(lg)

    return f


def _mark_seen(seen: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """seen (B, V) bool, toks (B,) -> seen with toks marked."""
    out = seen.clone()
    out[torch.arange(seen.shape[0], device=seen.device), toks] = True
    return out


PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


# KV-cache slot-count ladder: the cache length is bucketed so the decode
# shapes (and their graphs) are bounded, and the codes phase decodes in
# chunks whose cache view grows along this ladder, so a step's attention
# scales with the active context instead of the final bucket.
KV_BUCKETS = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def _kv_bucket(n: int) -> int:
    for b in KV_BUCKETS:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def _codes_schedule(prompt_high: int, n_codes: int, S: int) -> tuple:
    """Static (ceiling, steps) chunks for the codes phase: chunk i runs with
    the cache sliced to `ceiling` slots and fills it before growing to the
    next ladder rung. `prompt_high` must be >= every row's real length so
    writes stay inside each ceiling."""
    sched = []
    done = 0
    while done < n_codes:
        ceil = _kv_bucket(prompt_high + done + 1)
        if ceil >= S:
            sched.append((S, n_codes - done))
            break
        steps = min(n_codes - done, ceil - prompt_high - done)
        sched.append((ceil, steps))
        done += steps
    return tuple(sched)


@dataclasses.dataclass
class GenOutput:
    token_ids: List[List[int]]     # generated ids per (conditional) sequence
    texts: List[str]
    stop_reasons: List[str]


@dataclasses.dataclass
class PrefixState:
    """KV cache + the token streams it holds, for phase-1 -> phase-2 prefix
    reuse: the phase-2 prompt extends phase 1's, so its prefill starts from
    the cached K/V and forwards only the delta tokens. Valid while the
    cache buffer is at `epoch`."""
    cache: KVCache
    tokens: List[List[int]]        # per ROW (cond + uncond): prompt + fed ids
    row_lens: np.ndarray           # per-row valid K/V length
    epoch: int = 0

    @property
    def valid(self) -> bool:
        return self.epoch == self.cache.epoch


def _common_prefix_len(a: List[int], b: List[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _GraphStep:
    """One decode step captured as a CUDA graph over a fixed cache view:
    static token / length inputs, static logits output."""

    def __init__(self, step: Callable, cache: KVCache, row_lens: torch.Tensor,
                 lo: int, hi: int):
        rows = row_lens.shape[0]
        dev = row_lens.device
        self.toks = torch.zeros(rows, dtype=torch.long, device=dev)
        # warm-up writes land at each row's current frontier, which the
        # first real step overwrites (stale slots are never attended)
        self.row_lens = row_lens.clone()
        self.cache = cache
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(self.toks, cache, self.row_lens, lo, hi)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread-local: in the REST server other threads (HTTP handlers, a
        # training run) may call CUDA while a worker captures; the
        # default global mode would invalidate the capture then
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = step(self.toks, cache, self.row_lens, lo, hi)

    def __call__(self, toks: torch.Tensor, row_lens: torch.Tensor):
        self.toks.copy_(toks)
        self.row_lens.copy_(row_lens)
        self.graph.replay()
        return self.out


def _logits_at(model: QwenLM, cfg: LMConfig, cache: KVCache,
               ids: torch.Tensor, start, lo: int, hi: int,
               last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Feed `ids` (rows, L) at `start`, writing the cache; logits over
    [lo, hi) at each row's position `last` (default: the only one)."""
    hidden = lm_forward(model, cfg, ids, cache, start_pos=start)
    if last is not None:
        hidden = hidden[torch.arange(ids.shape[0], device=ids.device),
                        last][:, None, :]
    return lm_logits_slice(model, cfg, hidden, lo, hi)[:, 0]


# ---- mesh commands (parallel/mesh): every rank of a tensor-parallel
# engine runs them on its shard and its own caches, which rank 0's engine
# names by uid


def _mesh_new_cache(ctx, root, key: str, cfg: LMConfig, uid: int,
                    rows: int, slots: int, dtype, quantized: bool):
    cache = KVCache.create(cfg, rows, slots, dtype=dtype,
                           quantized=quantized, device=ctx.device)
    cache.uid = uid
    ctx.objects.setdefault(key + "/caches", {})[uid] = cache
    return cache


def _mesh_free_caches(ctx, root, key: str, uids: List[int]):
    caches = ctx.objects.get(key + "/caches", {})
    for uid in uids:
        caches.pop(uid, None)


def _mesh_graft(ctx, root, key: str, dst: int, src: int, copy: int):
    caches = ctx.objects[key + "/caches"]
    caches[dst].graft_prefix(caches[src], copy)


def _mesh_logits(ctx, root, key: str, cfg: LMConfig, uid: int, ceil: int,
                 ids: torch.Tensor, start: torch.Tensor, lo: int, hi: int,
                 last: Optional[torch.Tensor]):
    cache = ctx.objects[key + "/caches"][uid]
    if ceil < cache.slots:
        cache = cache.view(ceil)
    dev = ctx.device
    return _logits_at(ctx.objects[key], cfg, cache, ids.to(dev),
                      start.to(dev), lo, hi,
                      None if last is None else last.to(dev))


def _mesh_logprob(ctx, root, key: str, cfg: LMConfig, ids, target_start,
                  dtype):
    from acestep_torch.scoring.lm_score import sequence_logprob

    return sequence_logprob(ctx.objects[key], cfg, ids, target_start,
                            dtype=dtype)


_ENGINE_KEYS = itertools.count()


class LMEngine:
    """Holds the model, the cache arena and the captured decode steps.

    With a `mesh` (parallel/mesh.Mesh) the model runs tensor-parallel: the
    engine installs each rank's shard (heads, intermediate features and
    the vocabulary split over tp) and keeps the loop here, on rank 0: FSM
    tables, sampling, penalties, the CFG mix and the prefix cache. Each
    prefill and decode forward is a mesh command that carries the fed
    tokens and positions; each rank writes its KV heads into its own copy
    of the cache buffer rank 0 names. The decode step then runs eagerly
    (a CUDA graph does not span processes)."""

    _CROSS_PREFIX_MAX_SLOTS = 1024
    _ARENA_MAX = 6

    def __init__(self, model: QwenLM, cfg: LMConfig, tokenizer,
                 dtype=torch.bfloat16, max_len: int = 4096, mesh=None,
                 kv_quant: bool = False):
        self.mesh = mesh
        self.cfg = cfg
        # the config of the modules this process runs (one rank's heads
        # and features under a mesh)
        self.local_cfg = cfg
        if mesh is not None:
            from acestep_torch.parallel.mesh import make_plan

            plan = make_plan(model, cfg, mesh.tp, vocab=cfg.vocab_size)
            self.local_cfg = plan.local_config(cfg)
            self._key = f"lm-{next(_ENGINE_KEYS)}"
            model = mesh.install(self._key, model, plan)
        self.model = model
        self.tok = tokenizer
        self.dtype = dtype
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.device = model.embed_tokens.device
        self._uids = itertools.count(1)
        # decode steps as graph replays on a CUDA device; False runs the
        # eager step there, the graphs' oracle
        self.cuda_graphs = self.device.type == "cuda" and mesh is None
        # Decode steps emit logits over [0, vocab_use) only: ids beyond the
        # tokenizer are undecodable padding. The bound is the max ASSIGNED
        # token id + 1 rounded up to 128 (the FSM tables' mask size agrees).
        from acestep_torch.llm.fsm import max_assigned_token_bound
        hi = max_assigned_token_bound(tokenizer, fallback=cfg.vocab_size)
        self.vocab_use = min(cfg.vocab_size, -(-hi // 128) * 128)
        self._dev_tbl_cache: Dict[int, tuple] = {}
        self._arena: List[KVCache] = []
        self._graphs: Dict[tuple, _GraphStep] = {}
        self.graph_captures = 0
        self.last_prefill_stats: Dict[str, int] = {}
        self.prefill_stats: Dict[str, int] = {
            "calls": 0, "prompt_tokens": 0, "reused_tokens": 0,
            "delta_tokens": 0}
        # Cross-request prefix cache: back-to-back jobs share the chat
        # template / system prefix, so the engine retains the last CoT
        # phase's state and serves any longest common prefix from it. Off
        # via ACESTEP_LM_PREFIX_CACHE=0; caches above
        # _CROSS_PREFIX_MAX_SLOTS are not retained.
        self.cross_prefix_enabled = (
            os.environ.get("ACESTEP_LM_PREFIX_CACHE", "1") != "0")
        self._cross_prefix: Optional[PrefixState] = None

    # --------------------------------------------------------------
    # Cache arena and the decode step
    # --------------------------------------------------------------

    def _take_cache(self, rows: int, slots: int,
                    keep: Sequence[Optional[PrefixState]]) -> KVCache:
        """A cache buffer of (rows, slots) that no state in `keep` holds,
        moved to a new epoch. Its old contents stay: every slot at or past
        a row's length is overwritten before any query can see it. The
        arena keeps at most _ARENA_MAX buffers, least recently used first;
        an evicted buffer's graphs go with it."""
        held = {s.cache.k.data_ptr() for s in keep if s is not None}
        shape = (rows, slots)
        buf = next((b for b in self._arena
                    if (b.k.shape[1], b.slots) == shape
                    and b.k.data_ptr() not in held), None)
        if buf is None:
            buf = self._new_cache(rows, slots)
        else:
            self._arena.remove(buf)
        evicted = []
        for old in [b for b in self._arena if b.k.data_ptr() not in held]:
            if len(self._arena) < self._ARENA_MAX:
                break
            self._arena.remove(old)
            evicted.append(old.uid)
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[0] != old.k.data_ptr()}
        if evicted and self.mesh is not None:
            self.mesh.call(_mesh_free_caches, self._key, evicted)
        self._arena.append(buf)
        buf.epoch += 1
        return buf

    def _new_cache(self, rows: int, slots: int) -> KVCache:
        """A (rows, slots) cache of this process's KV heads; under a mesh,
        one on every rank under a new uid."""
        if self.mesh is None:
            return KVCache.create(self.cfg, rows, slots, dtype=self.dtype,
                                  quantized=self.kv_quant,
                                  device=self.device)
        return self.mesh.call(_mesh_new_cache, self._key, self.local_cfg,
                              next(self._uids), rows, slots, self.dtype,
                              self.kv_quant)

    def _graft(self, cache: KVCache, src: KVCache, copy: int) -> None:
        if self.mesh is None:
            cache.graft_prefix(src, copy)
        else:
            self.mesh.call(_mesh_graft, self._key, cache.uid, src.uid, copy)

    def _logits(self, cache: KVCache, ids: torch.Tensor, start, lo: int,
                hi: int, last: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """`_logits_at` on this engine's model, or as a mesh command on
        every rank's shard (the fed tokens and positions sent from the
        host)."""
        if self.mesh is None:
            return _logits_at(self.model, self.cfg, cache, ids, start, lo,
                              hi, last)
        start = torch.as_tensor(start).reshape(-1)
        return self.mesh.call(
            _mesh_logits, self._key, self.local_cfg, cache.uid, cache.slots,
            ids.cpu(), start.cpu(), lo, hi,
            None if last is None else last.cpu())

    def sequence_logprob(self, input_ids, target_start: int) -> float:
        """`scoring.lm_score.sequence_logprob` on this engine's model (on
        every rank's shard under a mesh)."""
        from acestep_torch.scoring.lm_score import sequence_logprob

        if self.mesh is None:
            return sequence_logprob(self.model, self.cfg, input_ids,
                                    target_start, dtype=self.dtype)
        return self.mesh.call(_mesh_logprob, self._key, self.local_cfg,
                              input_ids, target_start, self.dtype)

    def _step_eager(self, toks: torch.Tensor, cache: KVCache,
                    row_lens: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        return self._logits(cache, toks[:, None], row_lens, lo, hi)

    def decode_step(self, cache: KVCache, row_lens: torch.Tensor, lo: int,
                    hi: int) -> Callable:
        """f(toks (rows,), row_lens (rows,)) -> logits over [lo, hi) after
        feeding `toks` at `row_lens`: a graph replay on a CUDA device with
        graphs on, else the eager step."""
        if not self.cuda_graphs:
            return lambda toks, rl: self._step_eager(toks, cache, rl, lo, hi)
        key = (cache.k.data_ptr(), tuple(cache.k.shape), lo, hi)
        g = self._graphs.get(key)
        if g is None:
            g = _GraphStep(self._step_eager, cache, row_lens, lo, hi)
            self._graphs[key] = g
            self.graph_captures += 1
        return g

    # --------------------------------------------------------------
    # Cross-request prefix
    # --------------------------------------------------------------

    def _retain_cross_prefix(self, state: PrefixState) -> None:
        if (self.cross_prefix_enabled
                and state.cache.slots <= self._CROSS_PREFIX_MAX_SLOTS):
            self._cross_prefix = state

    def _cross_prefix_for(self, rows) -> Optional[PrefixState]:
        """The retained state, iff it is row-compatible with this call."""
        st = self._cross_prefix
        if st is None or len(st.tokens) != len(rows):
            return None
        if st.cache.k.shape[1] != len(rows) or not st.valid:
            return None
        return st

    # --------------------------------------------------------------
    # Prefill
    # --------------------------------------------------------------

    @torch.no_grad()
    def _prefill_prompts(self, all_prompts: Sequence[str],
                         new_tokens_budget: int,
                         prefix: Optional[PrefixState] = None,
                         rows: Optional[List[List[int]]] = None):
        """Tokenize + bucket-pad + prefill. Returns (logits, cache, lens,
        clamped_budget). The KV cache is sized for prompt + budget; the
        budget is clamped so decode never writes past the cache.

        With `prefix` (phase-1 state whose prompts this call extends), the
        per-row longest common token prefix is served from the cached K/V,
        grafted into the new cache, and only the delta tokens run through
        the model."""
        if rows is None:
            memo: Dict[str, List[int]] = {}
            rows = []
            for p in all_prompts:
                if p not in memo:
                    memo[p] = self.tok.encode(p)[: self.max_len]
                rows.append(memo[p])
        lens = np.asarray([len(r) for r in rows], np.int64)

        budget = min(new_tokens_budget, self.max_len - int(lens.max()))
        if budget <= 0:
            raise ValueError(
                f"prompt length {int(lens.max())} leaves no room for "
                f"generation within max_len {self.max_len}; raise "
                f"LMEngine(max_len=...)")

        pad_id = getattr(self.tok, "pad_token_id", 0) or 0
        cross = self._cross_prefix_for(rows)
        if prefix is not None and not prefix.valid:
            prefix = None
        if prefix is None:
            # the in-request phase-1 state, when given, always wins
            prefix = cross
        if prefix is not None and len(prefix.tokens) == len(rows):
            P = np.asarray(
                [max(0, min(_common_prefix_len(rows[i], prefix.tokens[i]),
                            int(prefix.row_lens[i]), len(rows[i]) - 1))
                 for i in range(len(rows))], np.int64)
        else:
            P = np.zeros(len(rows), np.int64)

        dlens = lens - P
        D = _bucket(int(dlens.max()))
        ids = np.full((len(rows), D), pad_id, np.int64)
        for i, r in enumerate(rows):
            d = r[P[i]:][:D]
            ids[i, : len(d)] = d
        dlens = np.minimum(dlens, D)
        lens = P + dlens

        # cover the furthest PADDED write (P_i + D can pass lens.max() +
        # budget when rows are ragged and the budget small)
        cache_len = _kv_bucket(max(int(lens.max()) + budget, int(P.max()) + D))
        cache = self._take_cache(len(rows), cache_len,
                                 keep=(prefix, self._cross_prefix))
        if prefix is not None and int(P.max()) > 0:
            copy = min(_kv_bucket(int(P.max())), prefix.cache.slots,
                       cache_len)
            self._graft(cache, prefix.cache, copy)
        self.last_prefill_stats = {
            "rows": len(rows),
            "prompt_tokens": int(np.sum(lens)),
            "reused_tokens": int(np.sum(P)),
            "delta_tokens": int(np.sum(dlens)),
        }
        self.prefill_stats["calls"] += 1
        for k in ("prompt_tokens", "reused_tokens", "delta_tokens"):
            self.prefill_stats[k] += self.last_prefill_stats[k]

        dev = self.device
        logits = self._logits(
            cache, torch.as_tensor(ids, device=dev),
            torch.as_tensor(P, device=dev), 0, self.vocab_use,
            last=torch.as_tensor(np.clip(dlens - 1, 0, D - 1), device=dev))
        return logits, cache, lens, budget

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(int(seed))

    # --------------------------------------------------------------
    # Host-driven decoding (unconstrained chunks, host-FSM masks)
    # --------------------------------------------------------------

    @torch.no_grad()
    def generate(
        self,
        prompts: Sequence[str],
        *,
        unconditional_prompts: Optional[Sequence[str]] = None,
        cfg_scale: float = 1.0,
        temperature: float = 0.85,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        max_new_tokens: int = 512,
        stop_strings: Sequence[str] = (),
        fsms: Optional[Sequence] = None,
        seed: int = 0,
        on_token: Optional[Callable[[int, List[int]], None]] = None,
        prefix: Optional[PrefixState] = None,
        seen_tokens: Optional[Sequence[Sequence[int]]] = None,
    ) -> GenOutput:
        """Generate for a batch of prompts (optionally CFG-paired).

        `prefix` enables KV prefix reuse when the prompts extend a prior
        phase's streams. `seen_tokens` seeds the repetition-penalty
        completion set per conditional row."""
        B = len(prompts)
        do_cfg = cfg_scale != 1.0 and unconditional_prompts is not None
        all_prompts = list(prompts) + (list(unconditional_prompts) if do_cfg else [])
        logits, cache, lens, max_new_tokens = self._prefill_prompts(
            all_prompts, max_new_tokens, prefix=prefix)

        gen = self._generator(seed)
        generated: List[List[int]] = [[] for _ in range(B)]
        texts = [""] * B
        done = np.zeros(B, bool)
        stop_reasons = ["length"] * B
        eos_id = getattr(self.tok, "eos_token_id", None)
        # stop strings are short literals: decode a fixed tail window per
        # token (one CHARACTER per token is the worst case)
        tail_w = 4 + max((max(len(self.tok.encode(s)), len(s))
                          for s in stop_strings), default=0)

        def check_row(i: int, t: int) -> bool:
            """Append token t to row i; True when the row just finished."""
            generated[i].append(t)
            if fsms is not None and fsms[i] is not None:
                fsms[i].advance(t)
            if eos_id is not None and t == eos_id:
                done[i] = True
                stop_reasons[i] = "eos"
                return True
            if stop_strings:
                tail = self.tok.decode(generated[i][-tail_w:])
                for s in stop_strings:
                    if s in tail:
                        done[i] = True
                        stop_reasons[i] = f"stop:{s}"
                        return True
            if on_token is not None:
                on_token(i, generated[i])
            return False

        vocab = self.vocab_use
        dev = self.device
        row_lens = torch.as_tensor(lens, device=dev)
        # a disabled MetadataFSM (next_mask() always None) must not route
        # decode onto the per-token host round-trip path
        have_fsm = fsms is not None and any(
            f is not None and getattr(f, "enabled", True) for f in fsms)
        seen0 = np.zeros((B, vocab), bool)
        if seen_tokens is not None:
            for i, ts in enumerate(seen_tokens[:B]):
                for t in ts:
                    if 0 <= t < vocab:
                        seen0[i, t] = True
        seen = torch.as_tensor(seen0, device=dev)
        mix = _pen_mix_fn(do_cfg, cfg_scale, repetition_penalty)
        step = self.decode_step(cache, row_lens, 0, vocab)

        def advance(toks):
            nonlocal logits, seen, row_lens
            seen = _mark_seen(seen, toks)
            feed = torch.cat([toks, toks]) if do_cfg else toks
            logits = step(feed, row_lens)
            row_lens = row_lens + 1

        if not have_fsm:
            # Unconstrained path: CHUNK tokens between host reads; overshoot
            # past a stop string within a chunk is dropped on the host.
            steps_left = max_new_tokens
            while steps_left > 0 and not done.all():
                size = min(CHUNK, steps_left)
                chunk = []
                for _ in range(size):
                    toks = sample_tokens(gen, mix(logits, seen),
                                         temperature=temperature,
                                         top_k=top_k, top_p=top_p)
                    chunk.append(toks)
                    advance(toks)
                toks_host = torch.stack(chunk, dim=1).cpu().numpy()
                for i in range(B):
                    if done[i]:
                        continue
                    for j in range(size):
                        if check_row(i, int(toks_host[i, j])):
                            break
                steps_left -= size
        else:
            # Constrained path: one host FSM mask per token.
            for _ in range(max_new_tokens):
                allow = np.ones((B, vocab), bool)
                for i, fsm in enumerate(fsms):
                    if fsm is None or done[i]:
                        continue
                    m = fsm.next_mask()
                    if m is not None:
                        # default-deny the whole vocab: ids beyond the
                        # tokenizer's mask length must not escape
                        allow[i, :] = False
                        n = min(len(m), vocab)
                        allow[i, :n] = m[:n]
                toks = sample_tokens(gen, mix(logits, seen),
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p,
                                     allow_mask=torch.as_tensor(allow,
                                                                device=dev))
                advance(toks)
                toks_host = toks.cpu().numpy()
                for i in range(B):
                    if not done[i]:
                        check_row(i, int(toks_host[i]))
                if done.all():
                    break

        for i in range(B):
            text = self.tok.decode(generated[i])
            if stop_reasons[i].startswith("stop:"):
                s = stop_reasons[i][5:]
                cut = text.find(s)
                if cut >= 0:
                    text = text[: cut + len(s)]
            elif eos_id is not None and eos_id in generated[i]:
                generated[i] = generated[i][: generated[i].index(eos_id) + 1]
                text = self.tok.decode(generated[i])
            texts[i] = text
        return GenOutput(token_ids=generated, texts=texts,
                         stop_reasons=stop_reasons)

    # --------------------------------------------------------------
    # Constrained CoT against the device FSM tables
    # --------------------------------------------------------------

    def _device_tables(self, fsm_tables) -> dict:
        """DeviceFSMTables -> device tensors, sized to vocab_use: padding
        ids are denied (False) and outside the alphabet (-1), so they can
        never be sampled or transition. Cached per tables object."""
        cached = self._dev_tbl_cache.get(id(fsm_tables))
        if cached is not None and cached[0] is fsm_tables:
            return cached[1]
        V = self.vocab_use
        t2a = fsm_tables.token_to_alpha
        cap = fsm_tables.caption_mask
        if len(t2a) < V:
            t2a = np.concatenate([t2a, np.full(V - len(t2a), -1, np.int32)])
            cap = np.concatenate([cap, np.zeros(V - len(cap), bool)])
        dev = self.device

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

        tbl = {
            "alphabet": t(fsm_tables.alphabet, torch.long),
            "token_to_alpha": t(t2a[:V], torch.long),
            "mask": t(fsm_tables.mask),
            "use_caption": t(fsm_tables.use_caption),
            "trans": t(fsm_tables.trans, torch.long),
            "other_next": t(fsm_tables.other_next, torch.long),
            "caption_mask": t(cap[:V]),
            "start": int(fsm_tables.start),
        }
        if len(self._dev_tbl_cache) >= 8:      # bound device residency
            self._dev_tbl_cache.pop(next(iter(self._dev_tbl_cache)))
        self._dev_tbl_cache[id(fsm_tables)] = (fsm_tables, tbl)
        return tbl

    @torch.no_grad()
    def _cot_decode(self, prompts, unconditional_prompts, *, cfg_scale,
                    temperature, top_k, top_p, repetition_penalty,
                    fsm_tables, max_tokens, seed, pad_id):
        """B constrained sequences against shared FSM tables with per-row
        states. A row that reaches the done state decodes a fixed pad token
        until every row finishes; its count freezes at the transition step.
        Returns (token lists, PrefixState)."""
        B = len(prompts)
        do_cfg = cfg_scale != 1.0 and unconditional_prompts is not None
        all_prompts = list(prompts) + (list(unconditional_prompts)
                                       if do_cfg else [])
        prompt_rows = [self.tok.encode(p)[: self.max_len] for p in all_prompts]
        logits, cache, lens, max_tokens = self._prefill_prompts(
            all_prompts, max_tokens, rows=prompt_rows)
        tbl = self._device_tables(fsm_tables)
        done_state = int(fsm_tables.done)
        dev = self.device
        V = logits.shape[-1]
        gen = self._generator(seed)
        mix = _pen_mix_fn(do_cfg, cfg_scale, repetition_penalty)
        row_lens = torch.as_tensor(lens, device=dev)
        step = self.decode_step(cache, row_lens, 0, self.vocab_use)

        states = torch.full((B,), tbl["start"], dtype=torch.long, device=dev)
        counts = torch.zeros(B, dtype=torch.long, device=dev)
        toks = torch.full((B, max_tokens), -1, dtype=torch.long, device=dev)
        seen = torch.zeros((B, V), dtype=torch.bool, device=dev)
        pad_only = torch.zeros(V, dtype=torch.bool, device=dev)
        pad_only[pad_id] = True
        i = 0
        while i < max_tokens:
            for _ in range(min(CHUNK, max_tokens - i)):
                alive = states != done_state
                allowed = torch.zeros((B, V), dtype=torch.bool, device=dev)
                allowed[:, tbl["alphabet"]] = tbl["mask"][states]
                allowed |= (tbl["use_caption"][states][:, None]
                            & tbl["caption_mask"][None])
                allowed = torch.where(alive[:, None], allowed, pad_only[None])
                tok = sample_tokens(gen, mix(logits, seen),
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p, allow_mask=allowed)
                # pad feeds of finished rows never count as completions
                seen = torch.where(alive[:, None], _mark_seen(seen, tok), seen)
                a = tbl["token_to_alpha"][tok]
                nxt = torch.where(a >= 0,
                                  tbl["trans"][states, a.clamp(min=0)],
                                  tbl["other_next"][states])
                states = torch.where(alive, nxt, states)
                counts = torch.where(alive, i + 1, counts)
                toks[:, i] = torch.where(alive, tok, -1)
                feed = torch.cat([tok, tok]) if do_cfg else tok
                logits = step(feed, row_lens)
                row_lens = row_lens + 1
                i += 1
            if not bool((states != done_state).any()):     # one read a chunk
                break
        toks = toks.cpu().numpy()
        counts = counts.cpu().numpy()
        outs = [toks[r, : counts[r]].tolist() for r in range(B)]
        # steps past the last row's done transition are dropped: the state
        # holds what the JAX loop holds when it stops there
        iters = int(counts.max())
        gen_cond = [outs[r] + [pad_id] * (iters - int(counts[r]))
                    for r in range(B)]
        gen_all = gen_cond + gen_cond if do_cfg else gen_cond
        streams = [p + g for p, g in zip(prompt_rows, gen_all)]
        state = PrefixState(cache=cache, tokens=streams,
                            row_lens=np.asarray(lens) + iters,
                            epoch=cache.epoch)
        self._retain_cross_prefix(state)
        return outs, state

    def generate_cot_device(self, prompt: str, *,
                            unconditional_prompt: Optional[str] = None,
                            cfg_scale: float = 1.0, temperature: float = 0.85,
                            top_k: int = 0, top_p: float = 1.0,
                            repetition_penalty: float = 1.0,
                            fsm_tables=None, max_tokens: int = 256,
                            seed: int = 0, return_state: bool = False):
        """Decode one CoT sequence on the device. Returns token ids, or
        (token ids, PrefixState) when return_state."""
        pad_id = getattr(self.tok, "eos_token_id", None)
        outs, state = self._cot_decode(
            [prompt],
            None if unconditional_prompt is None else [unconditional_prompt],
            cfg_scale=cfg_scale, temperature=temperature, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty,
            fsm_tables=fsm_tables, max_tokens=max_tokens, seed=seed,
            pad_id=int(pad_id) if pad_id is not None else 0)
        return (outs[0], state) if return_state else outs[0]

    def generate_cot_device_batch(
        self, prompts: Sequence[str], *,
        unconditional_prompts: Optional[Sequence[str]] = None,
        cfg_scale: float = 1.0, temperature: float = 0.85,
        top_k: int = 0, top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        fsm_tables=None, max_tokens: int = 256,
        seed: int = 0, return_state: bool = False,
    ):
        """Decode B CoT sequences on the device (shared FSM tables; rows
        draw independent samples). With `return_state`, returns (lists,
        PrefixState) for phase-2 reuse."""
        pad_id = getattr(self.tok, "eos_token_id", None)
        outs, state = self._cot_decode(
            prompts, unconditional_prompts, cfg_scale=cfg_scale,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, fsm_tables=fsm_tables,
            max_tokens=max_tokens, seed=seed,
            pad_id=int(pad_id) if pad_id is not None else 0)
        return (outs, state) if return_state else outs

    # --------------------------------------------------------------
    # Codes phase
    # --------------------------------------------------------------

    def _audio_code_range(self):
        """(start_id, end_id) of the contiguous <|audio_code_N|> block."""
        tok = self.tok
        if hasattr(tok, "audio_code_id"):
            start = tok.audio_code_id(0)
            return start, start + tok.num_audio_codes
        vocab = tok.get_vocab()
        code_re = re.compile(r"^<\|audio_code_(\d+)\|>$")
        ids = sorted(tid for text, tid in vocab.items()
                     if code_re.match(text))
        if not ids:
            raise ValueError("tokenizer has no <|audio_code_N|> tokens")
        start, end = ids[0], ids[-1] + 1
        if end - start != len(ids):
            raise ValueError("audio code token ids are not contiguous")
        return start, end

    @torch.no_grad()
    def generate_codes(
        self,
        prompts: Sequence[str],
        *,
        unconditional_prompts: Optional[Sequence[str]] = None,
        cfg_scale: float = 1.0,
        temperature: float = 0.85,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        n_codes: int = 150,
        seed: int = 0,
        prefix: Optional[PrefixState] = None,
    ) -> List[List[int]]:
        """Decode exactly n_codes audio codes per prompt on the device,
        sampling only the audio-code window (the codes-phase FSM is 'codes
        only, EOS blocked until the count'). Returns 0-based code indices
        (B, n_codes). Each chunk of the ladder schedule decodes on the
        cache sliced to its ceiling; the chunks share one carry, so the
        tokens equal one full-bucket decode's."""
        B = len(prompts)
        do_cfg = cfg_scale != 1.0 and unconditional_prompts is not None
        all_prompts = list(prompts) + (list(unconditional_prompts)
                                       if do_cfg else [])
        logits, cache, lens, budget = self._prefill_prompts(
            all_prompts, n_codes, prefix=prefix)
        if budget < n_codes:
            raise ValueError(
                f"{n_codes} codes need more context than max_len "
                f"{self.max_len} allows after the prompt; raise max_len")
        S = cache.slots
        ph = min(_kv_bucket(int(lens.max())), S)
        schedule = _codes_schedule(ph, n_codes, S)
        code_start, code_end = self._audio_code_range()
        dev = self.device
        gen = self._generator(seed)
        mix = _pen_mix_fn(do_cfg, cfg_scale, repetition_penalty)
        logits = logits[:, code_start:code_end]
        seen = torch.zeros((B, code_end - code_start), dtype=torch.bool,
                           device=dev)
        row_lens = torch.as_tensor(lens, device=dev)
        codes = []
        for ceil, steps in schedule:
            step = self.decode_step(cache.view(ceil), row_lens, code_start,
                                    code_end)
            for _ in range(steps):
                rel = sample_tokens(gen, mix(logits, seen),
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p)
                seen = _mark_seen(seen, rel)
                toks = rel + code_start
                feed = torch.cat([toks, toks]) if do_cfg else toks
                logits = step(feed, row_lens)
                row_lens = row_lens + 1
                codes.append(rel)
        if not codes:
            return [[] for _ in range(B)]
        return torch.stack(codes, dim=1).cpu().numpy()[:B].tolist()
