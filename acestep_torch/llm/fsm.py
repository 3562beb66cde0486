"""Constrained-decoding FSM for the 5 Hz LM planner (numpy only; a copy of
`acestep_tpu/llm/fsm.py`).

Behavior parity: reference acestep/constrained_logits_processor.py
(2339 LoC): enforce the CoT schema

    <think>
    bpm: [30-300]
    caption: [free text]
    duration: [10-600]
    genres: [vocab]            (skipped by default, as in the reference)
    keyscale: [A-G][#b] major|minor
    language: [51 codes]
    timesignature: [2|3|4|6]
    </think>
    <|audio_code_N|>...        (EOS blocked until duration*5 codes)

Redesign notes (not a port):
- The reference subclasses a torch LogitsProcessor and mutates logits
  in-place per token. Here the FSM is a pure host-side object producing a
  boolean allow-mask per step (`next_mask()`), consumed by the
  sampler (`models/lm.py sample_tokens(allow_mask=...)`), and advanced with
  `advance(token_id)`. This keeps the device step fixed-shape.
- Literal runs ("bpm: ", "</think>") are token queues from the tokenizer;
  value sets (keyscale/language/numbers) are token-level prefix tries.
- User-provided metadata is injected by pre-encoding the value into the
  literal queue (the reference's direct-injection path).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from acestep_torch.constants import (
    BPM_MAX, BPM_MIN, DURATION_MAX, DURATION_MIN, KEYSCALE_ACCIDENTALS,
    KEYSCALE_MODES, KEYSCALE_NOTES, VALID_LANGUAGES, VALID_TIME_SIGNATURES,
)

FIELD_ORDER = ["bpm", "caption", "duration", "genres", "keyscale", "language",
               "timesignature"]


def max_assigned_token_bound(tokenizer, fallback: Optional[int] = None) -> int:
    """Exclusive upper bound over ASSIGNED token ids.

    HF vocabs can have holes: added <|audio_code_N|> ids may start at a
    padded boundary above the entry count, so len(tokenizer) alone would
    leave relocated ids invisible to masks and unsampleable by the
    logits-slice. The single source of truth for both TokenTables mask
    sizing and LMEngine.vocab_use — the two bounds MUST agree or some ids
    become maskable-but-unsampleable (or vice versa)."""
    try:
        hi = len(tokenizer)
    except TypeError:
        hi = fallback if fallback is not None else tokenizer.vocab_size
    if hasattr(tokenizer, "get_vocab"):
        try:
            hi = max(hi, max(tokenizer.get_vocab().values()) + 1)
        except (ValueError, TypeError):
            pass
    return hi


class Trie:
    __slots__ = ("children", "terminal")

    def __init__(self):
        self.children: Dict[int, "Trie"] = {}
        self.terminal = False

    def insert(self, ids: Sequence[int]):
        node = self
        for t in ids:
            node = node.children.setdefault(t, Trie())
        node.terminal = True


class TokenTables:
    """Per-tokenizer precomputed token classifications (built once)."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        # len(tokenizer), NOT tokenizer.vocab_size: HF vocab_size excludes
        # added tokens, and the ids that matter most here (<think>,
        # <|audio_code_N|>, <|im_end|>) ARE added tokens on the real
        # checkpoints (Qwen3 base vocab + ACE-Step additions above it).
        # The bound must also cover the MAX ASSIGNED id (shared with
        # LMEngine.vocab_use — see max_assigned_token_bound).
        V = max_assigned_token_bound(tokenizer)
        self.vocab_size = V
        # one batch_decode call instead of V decode() calls (HF fast
        # tokenizers: ~150k singleton decodes cost tens of seconds at init)
        batch_decode = getattr(tokenizer, "batch_decode", None)
        if batch_decode is not None:
            texts = batch_decode([[i] for i in range(V)])
        else:
            texts = [tokenizer.decode([i]) for i in range(V)]
        self.texts = texts
        self.newline_ids = np.asarray(
            [i for i, t in enumerate(texts) if t.strip() == "" and "\n" in t],
            np.int32)
        code_re = re.compile(r"^<\|audio_code_(\d+)\|>$")
        self.code_ids = np.asarray(
            [i for i, t in enumerate(texts) if code_re.match(t)], np.int32)
        # caption: anything printable without newline and not a special tag
        bad = re.compile(r"[\n\r]|</?think>|<\|")
        self.caption_mask = np.zeros(V, bool)
        for i, t in enumerate(texts):
            if t and not bad.search(t):
                self.caption_mask[i] = True
        self.eos_id = getattr(tokenizer, "eos_token_id", None)
        # frozen sets for O(1) per-token membership in advance()
        self.newline_set = frozenset(int(i) for i in self.newline_ids)
        self.code_set = frozenset(int(i) for i in self.code_ids)

    def encode(self, text: str) -> List[int]:
        return list(self.tok.encode(text))


def _cached_trie(tables: TokenTables, key, make) -> "Trie":
    """Memoize value tries on the TokenTables instance (they depend only
    on the tokenizer + the key); tries are read-only after construction,
    so sharing across concurrent FSMs is safe."""
    cache = getattr(tables, "_trie_cache", None)
    if cache is None:
        cache = tables._trie_cache = {}
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _number_trie(tables: TokenTables, lo: int, hi: int) -> Trie:
    trie = Trie()
    for n in range(lo, hi + 1):
        trie.insert(tables.encode(str(n)))
    return trie


def _set_trie(tables: TokenTables, values: Sequence[str]) -> Trie:
    trie = Trie()
    for v in values:
        ids = tables.encode(v)
        # skip values the tokenizer cannot represent: a lossy encode would
        # put unk/special ids on trie edges (observed: '♭' -> a special
        # token on the fallback tokenizer -> '<|endoftext|>' inside a
        # generated keyscale)
        if ids and tables.tok.decode(ids) == v:
            trie.insert(ids)
    return trie


def default_keyscales() -> List[str]:
    return [f"{n}{a} {m}" for n in KEYSCALE_NOTES for a in KEYSCALE_ACCIDENTALS
            for m in KEYSCALE_MODES]


def format_user_value(field: str, value, max_duration: int = DURATION_MAX) -> str:
    """Literal-injection formatting for user metadata. Durations clamp into
    [DURATION_MIN, max_duration] — a 0.8 s request must not inject
    'duration: 0' (outside the schema the trie enforces)."""
    if field == "duration":
        dur = int(round(float(value)))
        return str(min(max(dur, DURATION_MIN), int(max_duration)))
    return str(value)


class GenresVocab:
    """Hot-reloaded genres list (reference: genres trie reloaded from
    genres_vocab.txt on change, constrained_logits_processor.py)."""

    def __init__(self, path: str):
        self.path = path
        self._mtime = 0.0
        self._values: List[str] = []

    def get(self) -> List[str]:
        import os

        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return self._values
        if mtime != self._mtime:
            try:
                with open(self.path, "r", encoding="utf-8") as f:
                    self._values = [line.strip() for line in f
                                    if line.strip()
                                    and not line.startswith("#")]
                self._mtime = mtime
            except OSError:
                pass
        return self._values


def match_caption_genres(caption: Optional[str],
                         genres_vocab: Sequence[str]) -> List[str]:
    """Genres from the vocab matched by the user's caption.

    Reference semantics (constrained_logits_processor.py:1003-1056
    _extract_caption_genres): split the caption on delimiters, collect every
    vocab genre that STARTS WITH a caption word (plus exact members), and
    constrain genre generation to that subset when non-empty (the
    caption-priority trie; validation keeps the prefix inside it,
    :1196-1238)."""
    if not caption or not genres_vocab:
        return []
    # the >=2-char word filter (and thus stopword prefix hits like
    # "an"->"anime") deliberately mirrors the reference's behavior
    words = [w.strip() for w in re.split(r"[,\s\-_/\\|]+", caption.lower())
             if len(w.strip()) >= 2]
    if not words:
        return []
    matched: List[str] = []
    seen = set()
    vocab_lower = [(g, g.lower()) for g in genres_vocab]
    for g, gl in vocab_lower:
        if g in seen:
            continue
        for w in words:
            if gl.startswith(w) or gl == w:
                matched.append(g)
                seen.add(g)
                break
    return matched


class MetadataFSM:
    """Single-sequence FSM. One per generated (conditional) sequence; the
    unconditional CFG twin shares the sampled tokens so it needs no FSM."""

    def __init__(self, tables: TokenTables, *,
                 user_metadata: Optional[dict] = None,
                 skip_genres: bool = True,
                 skip_caption: bool = False,
                 skip_language: bool = False,
                 genres_vocab: Optional[Sequence[str]] = None,
                 caption: Optional[str] = None,
                 max_duration: int = DURATION_MAX,
                 codes_per_second: int = 5,
                 caption_max_tokens: int = 64,
                 phase: str = "cot",
                 enabled: bool = True):
        self.t = tables
        self.enabled = enabled
        self.user = {k: v for k, v in (user_metadata or {}).items()
                     if v not in (None, "", "N/A")}
        self.skip_genres = skip_genres and "genres" not in self.user
        # use_cot_caption/use_cot_language=False in the reference set these
        # (llm_inference.py:1231-1232): the field is dropped from the CoT
        # schema entirely, not generated-then-discarded
        self.skip_caption = skip_caption and "caption" not in self.user
        self.skip_language = skip_language and "language" not in self.user
        self.max_duration = int(max_duration)
        self.codes_per_second = codes_per_second
        self.caption_max_tokens = caption_max_tokens
        self.metadata_text: Dict[str, str] = {}
        self.target_codes: Optional[int] = None
        self.n_codes = 0
        self.finished = False

        # value tries depend only on (tokenizer, max_duration, vocab) —
        # memoized on the TokenTables so per-request/per-batch-row FSM
        # construction doesn't redo ~1000 tokenizer.encode calls
        self._tries = {
            "bpm": _cached_trie(tables, ("bpm",),
                                lambda: _number_trie(tables, BPM_MIN,
                                                     BPM_MAX)),
            "duration": _cached_trie(
                tables, ("duration", self.max_duration),
                lambda: _number_trie(tables, DURATION_MIN,
                                     self.max_duration)),
            "keyscale": _cached_trie(
                tables, ("keyscale",),
                lambda: _set_trie(tables, default_keyscales())),
            "language": _cached_trie(
                tables, ("language",),
                lambda: _set_trie(tables, list(VALID_LANGUAGES))),
            "timesignature": _cached_trie(
                tables, ("timesignature",),
                lambda: _set_trie(
                    tables, [str(v) for v in VALID_TIME_SIGNATURES])),
        }
        if genres_vocab:
            # caption-priority: when the caption names genres from the
            # vocab, restrict the genres field to the matched subset.
            # Only the full-vocab trie is memoized (stable key); a
            # caption-matched subset is small and cheap to build fresh
            matched = match_caption_genres(caption, genres_vocab)
            self.caption_matched_genres = matched
            if matched:
                self._tries["genres"] = _set_trie(tables, matched)
            else:
                # key on the full tuple: hot-reloaded vocab must miss
                self._tries["genres"] = _cached_trie(
                    tables, ("genres", tuple(genres_vocab)),
                    lambda: _set_trie(tables, genres_vocab))

        self._queue: List[int] = []
        self._trie_node: Optional[Trie] = None
        self._value_tokens: List[int] = []
        self._field_idx = -1
        self._field: Optional[str] = None
        self._mode = "literal"     # literal | trie | caption | codes | done
        if phase == "codes":
            self._enter_codes()
        else:
            self._queue = tables.encode("<think>\n")
            self._advance_queue_if_empty()

    # ------------------------------------------------------------------

    def _fields(self) -> List[str]:
        fs = list(FIELD_ORDER)
        if self.skip_genres:
            fs.remove("genres")
        if self.skip_caption:
            fs.remove("caption")
        if self.skip_language:
            fs.remove("language")
        return fs

    def _next_field(self):
        fs = self._fields()
        self._field_idx += 1
        if self._field_idx >= len(fs):
            self._queue = self.t.encode("</think>")
            self._field = None
            self._mode = "literal_end"
            return
        f = fs[self._field_idx]
        self._field = f
        self._value_tokens = []
        if f in self.user:
            val = format_user_value(f, self.user[f], self.max_duration)
            self.metadata_text[f] = val
            self._queue = self.t.encode(f"{f}: {val}\n")
            self._mode = "literal"
        else:
            self._queue = self.t.encode(f"{f}: ")
            self._mode = "literal"

    def _advance_queue_if_empty(self):
        while not self._queue and self._mode in ("literal", "literal_end"):
            if self._mode == "literal_end":
                self._finish_think()
                return
            if self._field is None or self._field in self.user:
                self._next_field()
            elif self._field == "caption":
                self._mode = "caption"
            elif self._field in self._tries:
                self._mode = "trie"
                self._trie_node = self._tries[self._field]
            else:  # genres without vocab: free text like caption
                self._mode = "caption"

    def _finish_think(self):
        self.finished = True
        self._mode = "done"
        dur = self.metadata_text.get("duration")
        try:
            # int(dur * 5), matching the device fast path (handler.py
            # n_codes) — int(dur)*5 would shorten fractional durations
            self.target_codes = int(float(dur) * self.codes_per_second) \
                if dur else None
        except ValueError:
            self.target_codes = None

    def _enter_codes(self):
        self._mode = "codes"
        self.finished = False

    def begin_codes(self, target_duration: Optional[float] = None):
        """Switch to codes phase (phase-2 prompts reuse the same FSM class)."""
        if target_duration:
            self.target_codes = int(target_duration * self.codes_per_second)
        self._enter_codes()

    # ------------------------------------------------------------------

    def next_mask(self) -> Optional[np.ndarray]:
        """Boolean (V,) allow-mask for the next token, or None = no constraint."""
        if not self.enabled:
            return None
        V = self.t.vocab_size
        if self._mode == "done":
            return None
        if self._queue:
            m = np.zeros(V, bool)
            m[self._queue[0]] = True
            return m
        if self._mode == "trie":
            m = np.zeros(V, bool)
            for tid in self._trie_node.children:
                m[tid] = True
            if self._trie_node.terminal:
                m[self.t.newline_ids] = True
            return m
        if self._mode == "caption":
            if len(self._value_tokens) >= self.caption_max_tokens:
                m = np.zeros(V, bool)   # budget exhausted: newline only
                m[self.t.newline_ids] = True
                return m
            m = self.t.caption_mask.copy()
            if self._value_tokens:   # newline ends the field, but not first
                m[self.t.newline_ids] = True
            return m
        if self._mode == "codes":
            m = np.zeros(V, bool)
            m[self.t.code_ids] = True
            if self.t.eos_id is not None and (
                    self.target_codes is None or
                    self.n_codes >= self.target_codes):
                m[self.t.eos_id] = True
            return m
        return None

    def advance(self, token_id: int) -> None:
        """Consume the sampled token and update state."""
        if not self.enabled or self._mode == "done":
            return
        t = self.t
        if self._queue:
            # literal: tolerate mismatch (unconstrained backends)
            if self._queue and token_id == self._queue[0]:
                self._queue.pop(0)
            else:
                self._queue = []
            self._advance_queue_if_empty()
            return
        if self._mode == "trie":
            if token_id in self._trie_node.children:
                self._trie_node = self._trie_node.children[token_id]
                self._value_tokens.append(token_id)
                return
            # newline (or anything else) ends the value
            self.metadata_text[self._field] = self.t.tok.decode(
                self._value_tokens).strip()
            self._next_field()
            self._advance_queue_if_empty()
            return
        if self._mode == "caption":
            if token_id in t.newline_set:
                self.metadata_text[self._field] = self.t.tok.decode(
                    self._value_tokens).strip()
                self._next_field()
                self._advance_queue_if_empty()
            else:
                self._value_tokens.append(token_id)
            return
        if self._mode == "codes":
            if token_id in t.code_set:
                self.n_codes += 1
            elif t.eos_id is not None and token_id == t.eos_id:
                self.finished = True
                self._mode = "done"
            return

    # convenience -------------------------------------------------------

    def metadata(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for k, v in self.metadata_text.items():
            if k in ("bpm", "duration", "timesignature"):
                try:
                    out[k] = int(v)
                except (TypeError, ValueError):
                    out[k] = v
            else:
                out[k] = v
        return out
