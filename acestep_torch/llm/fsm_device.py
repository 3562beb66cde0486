"""Device-resident constrained decoding: the CoT FSM compiled to tables
(numpy only; a copy of `acestep_tpu/llm/fsm_device.py`).

A per-token host-device sync stalls decode, so the masks stay resident on
the device and the state machine becomes a transition table. The host FSM
(llm/fsm.py) walks literals, prefix tries, and free-text segments — all
statically known per request — so it compiles into:

- an ALPHABET: the (small) set of token ids that appear on any structured
  edge (literal runs, trie edges, newline terminators). Free-text (caption)
  tokens are handled by a per-state flag + a precomputed vocab mask instead
  of alphabet entries, keeping tables (S x A), not (S x V).
- mask[S, A] bool            allowed alphabet tokens per state
- use_caption[S] bool        additionally allow the caption token set
- trans[S, A] int32          next state per alphabet token
- other_next[S] int32        next state for any non-alphabet token
- done state                 absorbing; the decode loop exits on it

The whole CoT phase then runs on the device (sample -> transition -> KV
decode, llm/generator.py), reading the done state back once per chunk of
tokens; the host replays the sampled tokens through the reference-faithful
host FSM once at the end to extract metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from acestep_torch.llm.fsm import MetadataFSM, TokenTables, Trie


@dataclasses.dataclass
class DeviceFSMTables:
    alphabet: np.ndarray        # (A,) int32 token ids
    token_to_alpha: np.ndarray  # (V,) int32; -1 = not in alphabet
    mask: np.ndarray            # (S, A) bool
    use_caption: np.ndarray     # (S,) bool
    trans: np.ndarray           # (S, A) int32
    other_next: np.ndarray      # (S,) int32
    caption_mask: np.ndarray    # (V,) bool
    start: int
    done: int

    @property
    def num_states(self) -> int:
        return self.mask.shape[0]


class _StateGraph:
    def __init__(self):
        # per-state: {token_id: next_state}, use_caption flag, other_next
        self.edges: List[Dict[int, int]] = []
        self.caption_flags: List[bool] = []
        self.other: List[int] = []

    def new_state(self, use_caption: bool = False,
                  other_next: Optional[int] = None) -> int:
        self.edges.append({})
        self.caption_flags.append(use_caption)
        self.other.append(-1 if other_next is None else other_next)
        return len(self.edges) - 1

    def literal_chain(self, token_ids: Sequence[int], next_state: int) -> int:
        """States forcing the exact token run; returns the first state."""
        target = next_state
        for tok in reversed(list(token_ids)):
            state = self.new_state()
            self.edges[state][tok] = target
            target = state
        return target

    def trie_chain(self, trie: Trie, newline_ids: Sequence[int],
                   next_state: int) -> int:
        """Clone a prefix trie as states; terminal nodes allow newline ->
        next_state (host FSM trie-mode semantics)."""
        memo: Dict[int, int] = {}

        def build(node: Trie) -> int:
            key = id(node)
            if key in memo:
                return memo[key]
            state = self.new_state()
            memo[key] = state
            for tok, child in node.children.items():
                self.edges[state][tok] = build(child)
            if node.terminal:
                for nl in newline_ids:
                    self.edges[state].setdefault(int(nl), next_state)
            return state

        return build(trie)

    def caption_states(self, newline_ids: Sequence[int], next_state: int,
                       cap: int = 64) -> int:
        """Counted free-text chain: state_i = i tokens consumed.
        state_0 forbids newline (non-empty value), states 1..cap-1 allow
        caption tokens + newline, state_cap allows ONLY newline (budget
        exhausted) — matching MetadataFSM.caption_max_tokens."""
        final = self.new_state()                 # newline only
        for nl in newline_ids:
            self.edges[final][int(nl)] = next_state
        nxt = final
        for i in range(cap - 1, -1, -1):
            state = self.new_state(use_caption=True, other_next=nxt)
            if i > 0:
                for nl in newline_ids:
                    self.edges[state][int(nl)] = next_state
            nxt = state
        return nxt

    def finalize(self, tables: TokenTables, start: int,
                 done: int) -> DeviceFSMTables:
        alphabet = sorted({tok for edges in self.edges for tok in edges})
        alpha_index = {tok: i for i, tok in enumerate(alphabet)}
        S, A = len(self.edges), len(alphabet)
        V = tables.vocab_size

        token_to_alpha = np.full(V, -1, np.int32)
        for tok, i in alpha_index.items():
            token_to_alpha[tok] = i

        mask = np.zeros((S, A), bool)
        trans = np.full((S, A), -1, np.int32)
        other_next = np.asarray(self.other, np.int32)
        use_caption = np.asarray(self.caption_flags, bool)

        for s, edges in enumerate(self.edges):
            fallback = other_next[s] if other_next[s] >= 0 else s
            trans[s, :] = fallback
            for tok, nxt in edges.items():
                a = alpha_index[tok]
                mask[s, a] = True
                trans[s, a] = nxt
        # caption states: alphabet tokens allowed iff they are caption
        # tokens; they flow to the fallback unless an explicit edge exists
        for s in range(S):
            if use_caption[s]:
                for tok, a in alpha_index.items():
                    if tables.caption_mask[tok] and not mask[s, a]:
                        mask[s, a] = True

        return DeviceFSMTables(
            alphabet=np.asarray(alphabet, np.int32),
            token_to_alpha=token_to_alpha,
            mask=mask,
            use_caption=use_caption,
            trans=trans,
            other_next=np.where(other_next >= 0, other_next,
                                np.arange(S, dtype=np.int32)),
            caption_mask=tables.caption_mask.copy(),
            start=start,
            done=done,
        )


def build_cot_tables(tables: TokenTables, *,
                     user_metadata: Optional[dict] = None,
                     skip_genres: bool = True,
                     skip_caption: bool = False,
                     skip_language: bool = False,
                     genres_vocab: Optional[Sequence[str]] = None,
                     caption: Optional[str] = None,
                     max_duration: int = 600) -> DeviceFSMTables:
    """Compile the phase-1 CoT schema into device tables.

    Mirrors MetadataFSM's construction exactly (same tries, same field
    order, same user-metadata literal injection, same caption-priority
    genre restriction) — the host FSM remains the behavioral source of
    truth; tests replay device trajectories through it.
    """
    host = MetadataFSM(tables, user_metadata=user_metadata,
                       skip_genres=skip_genres, skip_caption=skip_caption,
                       skip_language=skip_language,
                       genres_vocab=genres_vocab,
                       caption=caption, max_duration=max_duration)
    fields = host._fields()
    tries = host._tries
    user = host.user
    newline_ids = [int(x) for x in tables.newline_ids]

    b = _StateGraph()
    done = b.new_state()
    b.other[done] = done                      # absorbing

    # build backwards: </think> -> fields (reversed) -> <think>\n
    nxt = b.literal_chain(tables.encode("</think>"), done)
    for field in reversed(fields):
        if field in user:
            from acestep_torch.llm.fsm import format_user_value
            val = format_user_value(field, user[field], max_duration)
            nxt = b.literal_chain(tables.encode(f"{field}: {val}\n"), nxt)
            continue
        if field == "caption" or (field == "genres" and field not in tries):
            value_entry = b.caption_states(newline_ids, nxt)
        else:
            value_entry = b.trie_chain(tries[field], newline_ids, nxt)
        nxt = b.literal_chain(tables.encode(f"{field}: "), value_entry)
    start = b.literal_chain(tables.encode("<think>\n"), nxt)
    return b.finalize(tables, start, done)
