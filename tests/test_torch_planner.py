"""The port's 5 Hz LM planner (llm/) against the JAX package's, on the CPU.

Both handlers hold the same tiny LM (the JAX seeded init carried across by
`lm_from_jax`), float32, with the char-level SimpleTokenizer (32 audio
codes). Sampling draws differ between `jax.random` and `torch.Generator`,
so every comparison decodes greedily (temperature 0): the token ids, the
prefix states and the plan dicts must then be EQUAL (float32 on both sides,
JAX at "highest" precision; over two layers the logits agree to ~1e-6,
far inside the gaps between the top tokens). The FSM tables are numpy on
both sides and must be equal array by array.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.llm import fsm as jfsm
from acestep_tpu.llm import fsm_device as jfsmd
from acestep_tpu.llm.handler import LLMHandler as JaxLLM
from acestep_torch.llm import fsm as tfsm
from acestep_torch.llm import fsm_device as tfsmd
from acestep_torch.llm import generator as tgen
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.llm.tokenizer import SimpleTokenizer
from micro_bpe import build_micro_bpe
from torch_parity import capped, highest, np_tree, one_torch_thread, port_cfg

GREEDY = dict(metadata_temperature=0.0, codes_temperature=0.0)


_one_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


@pytest.fixture(scope="module")
def pair():
    jh = JaxLLM(dtype=jnp.float32)
    jh.initialize(num_fallback_codes=32, max_duration=600, seed=0)
    th = LLMHandler(dtype=torch.float32, device="cpu")
    th.initialize(cfg=port_cfg(jh.cfg), num_fallback_codes=32,
                  max_duration=600, params=np_tree(jh.engine.params))
    return jh, th


def _both(pair, fn):
    jh, th = pair
    with highest():
        want = fn(jh)
    return fn(th), want


# ------------------------------------------------------------------
# FSM tables
# ------------------------------------------------------------------


@pytest.mark.parametrize("tokenizer", ["simple", "bpe"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(user_metadata={"bpm": 120, "keyscale": "C major"}),
    dict(skip_caption=True, skip_language=True),
    dict(skip_genres=False, genres_vocab=["rock", "pop", "jazz fusion"],
         caption="a jazz tune"),
], ids=["default", "user", "skips", "genres"])
def test_cot_tables_equal_jax(tokenizer, kw):
    tok = (SimpleTokenizer(num_audio_codes=32) if tokenizer == "simple"
           else build_micro_bpe(num_audio_codes=32))
    got = tfsmd.build_cot_tables(tfsm.TokenTables(tok), max_duration=240,
                                 **kw)
    want = jfsmd.build_cot_tables(jfsm.TokenTables(tok), max_duration=240,
                                  **kw)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


def test_host_fsm_masks_equal_jax(pair):
    """The host FSM (the constrained generate path, and the replay that
    extracts metadata) allows the same tokens at every step of a CoT."""
    jh, th = pair
    ids = th.engine.generate_cot_device(
        th.build_formatted_prompt("metal", ""), temperature=0.0,
        fsm_tables=th._cot_tables(None, None, None), max_tokens=256)
    a = tfsm.MetadataFSM(th.tables, max_duration=600)
    b = jfsm.MetadataFSM(jh.tables, max_duration=600)
    for t in ids:
        ma, mb = a.next_mask(), b.next_mask()
        assert (ma is None) == (mb is None)
        if ma is not None:
            np.testing.assert_array_equal(ma, mb)
        a.advance(t)
        b.advance(t)
    assert a.finished == b.finished and a.metadata() == b.metadata()


# ------------------------------------------------------------------
# Engine: CoT, codes, prefix reuse
# ------------------------------------------------------------------


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_greedy_cot_device_equals_jax(pair, cfg_scale):
    def run(h):
        p = h.build_formatted_prompt("dreamy shoegaze", "la")
        neg = h.build_formatted_prompt("dreamy shoegaze", "la",
                                       is_negative_prompt=True)
        ids, st = h.engine.generate_cot_device(
            p, unconditional_prompt=neg, cfg_scale=cfg_scale,
            temperature=0.0, repetition_penalty=1.1,
            fsm_tables=h._cot_tables(None, None, None), max_tokens=200,
            return_state=True)
        return ids, st.tokens, np.asarray(st.row_lens).tolist()

    got, want = _both(pair, run)
    assert len(got[0]) > 10
    assert got == want


def test_greedy_cot_batch_equals_jax(pair):
    """Batched rows with different prompts finish at different steps: the
    finished rows' pad feeds and the state's streams match JAX's."""
    def run(h):
        ps = [h.build_formatted_prompt(c, "") for c in ("techno", "a folk song")]
        negs = [h.build_formatted_prompt(c, "", is_negative_prompt=True)
                for c in ("techno", "a folk song")]
        outs, st = h.engine.generate_cot_device_batch(
            ps, unconditional_prompts=negs, cfg_scale=1.5, temperature=0.0,
            fsm_tables=h._cot_tables(None, None, None), max_tokens=200,
            return_state=True)
        return outs, st.tokens, np.asarray(st.row_lens).tolist()

    got, want = _both(pair, run)
    assert got == want


@pytest.mark.parametrize("reuse", [False, True])
def test_greedy_codes_equal_jax(pair, reuse):
    def run(h):
        eng = h.engine
        eng._cross_prefix = None
        p1 = h.build_formatted_prompt("midnight jazz", "")
        out, st = eng.generate_cot_device(
            p1, fsm_tables=h._cot_tables(None, None, None), max_tokens=64,
            seed=2, return_state=True, temperature=0.0)
        eng._cross_prefix = None
        p2 = h.build_formatted_prompt_with_cot(
            "midnight jazz", "", h.tokenizer.decode(out))
        codes = eng.generate_codes([p2], n_codes=12,
                                   temperature=0.0, repetition_penalty=1.2,
                                   prefix=st if reuse else None)
        return codes, eng.last_prefill_stats

    got, want = _both(pair, run)
    assert got == want
    assert (got[1]["reused_tokens"] > 0) == reuse


def test_codes_chunk_schedule_equals_one_bucket(pair, monkeypatch):
    """Each chunk decodes on the cache sliced to its ceiling; the tokens
    equal one decode over the full bucket."""
    _, th = pair
    eng = th.engine
    p2 = th.build_formatted_prompt_with_cot("x", "", "<think>\n</think>")
    lens = len(th.tokenizer.encode(p2))
    assert lens <= 256
    # prompt bucket 256, cache 512: chunks at ceilings 384 and 512
    kw = dict(n_codes=388 - lens, temperature=0.0)
    calls = []
    orig = tgen._codes_schedule
    monkeypatch.setattr(tgen, "_codes_schedule",
                        lambda ph, n, S: calls.append(orig(ph, n, S))
                        or orig(ph, n, S))
    chunked = eng.generate_codes([p2], **kw)
    assert len(calls[0]) > 1
    monkeypatch.setattr(tgen, "_codes_schedule", lambda ph, n, S: ((S, n),))
    assert eng.generate_codes([p2], **kw) == chunked


def test_two_phase_plan_equals_jax(pair):
    """generate_with_stop_condition (CFG-paired, device FSM, prefix reuse)
    gives the same plan dict and the same prefill accounting."""
    def run(h):
        h.engine._cross_prefix = None
        r = h.plan("lofi beats", "[verse]\nhello", target_duration=3,
                   seed=0, cfg_scale=2.0, **GREEDY)
        return r, dict(h.engine.last_prefill_stats)

    got, want = _both(pair, run)
    assert got == want
    assert got[0]["audio_codes"].count("<|audio_code_") == 15
    assert got[1]["rows"] == 2 and got[1]["reused_tokens"] > 0


def test_plan_batch_equals_jax(pair):
    def run(h):
        h.engine._cross_prefix = None
        return h.plan_batch("synthwave", n=2, target_duration=2, seed=1,
                            cfg_scale=2.0, **GREEDY)

    got, want = _both(pair, run)
    assert got == want and len(got) == 2


def test_cross_request_reuse_equals_jax(pair):
    """The second request's phase-1 prefill serves the shared prefix from
    the retained state; the counters and the plans match JAX's, and reuse
    changes no output."""
    def run(h):
        eng = h.engine
        eng._cross_prefix = None
        before = dict(eng.prefill_stats)
        a = h.plan("crisp electro house", target_duration=2, seed=3,
                   cfg_scale=2.0, **GREEDY)
        b = h.plan("crisp electro swing", target_duration=2, seed=4,
                   cfg_scale=2.0, **GREEDY)
        delta = {k: eng.prefill_stats[k] - before[k] for k in before}
        return a, b, delta

    got, want = _both(pair, run)
    assert got == want
    assert 0 < got[2]["reused_tokens"] < got[2]["prompt_tokens"]
    _, th = pair
    th.engine.cross_prefix_enabled = False
    try:
        th.engine._cross_prefix = None
        cold = th.plan("crisp electro swing", target_duration=2, seed=4,
                       cfg_scale=2.0, **GREEDY)
    finally:
        th.engine.cross_prefix_enabled = True
    assert cold == got[1]


def test_stale_prefix_state_is_ignored(pair):
    """A state whose arena buffer has been handed out again no longer
    describes it: the prefill ignores it (full prefill), and the codes do
    not change."""
    _, th = pair
    eng = th.engine
    eng._cross_prefix = None
    p1 = th.build_formatted_prompt("a", "")
    _, st = eng.generate_cot_device(p1, fsm_tables=th._cot_tables(
        None, None, None), max_tokens=32, temperature=0.0, return_state=True)
    p2 = p1 + "tail"
    fresh = eng.generate_codes([p2], n_codes=6, temperature=0.0)
    assert st.valid
    eng.cross_prefix_enabled = False
    eng._cross_prefix = None
    try:
        # churn the arena until st's buffer is reused: a CoT buffer goes
        # only to another CoT
        for _ in range(8):
            eng.generate_cot_device(p1, fsm_tables=th._cot_tables(
                None, None, None), max_tokens=32, temperature=0.0)
        assert not st.valid
        assert eng.generate_codes([p2], n_codes=6, temperature=0.0,
                                  prefix=st) == fresh
        assert eng.last_prefill_stats["reused_tokens"] == 0
    finally:
        eng.cross_prefix_enabled = True


def test_mismatched_rows_fall_back_to_full_prefill(pair):
    _, th = pair
    eng = th.engine
    _, st = eng.generate_cot_device(
        th.build_formatted_prompt("a", ""), max_tokens=32, return_state=True,
        fsm_tables=th._cot_tables(None, None, None))
    codes = eng.generate_codes(["x", "y"], unconditional_prompts=["u", "v"],
                               cfg_scale=2.0, n_codes=4, seed=0, prefix=st)
    assert len(codes) == 2 and all(len(c) == 4 for c in codes)
    assert eng.last_prefill_stats["reused_tokens"] == 0


# ------------------------------------------------------------------
# Host-driven paths and the other modes
# ------------------------------------------------------------------


def test_unconstrained_and_host_fsm_paths_equal_jax(pair):
    """constrained=False: CoT through the chunked unconstrained loop with a
    stop string; max_code_tokens: codes through the host-FSM masked loop."""
    def run(h):
        h.engine._cross_prefix = None
        a = h.plan("ambient", target_duration=2, seed=5, cfg_scale=2.0,
                   constrained=False, max_cot_tokens=40, **GREEDY)
        b = h.plan("ambient", target_duration=2, seed=5, cfg_scale=2.0,
                   max_code_tokens=14, user_metadata={
                       "bpm": 90, "keyscale": "A minor", "timesignature": 4,
                       "duration": 2}, **GREEDY)
        return a, b

    got, want = _both(pair, run)
    assert got == want
    assert 0 < got[1]["audio_codes"].count("<|audio_code_") <= 14


def test_understand_create_format_equal_jax(pair):
    def run(h):
        codes = "".join(f"<|audio_code_{i % 32}|>" for i in range(20))
        with capped(h):
            return (h.understand(codes, temperature=0.0),
                    h.create_sample("a calm song", temperature=0.0),
                    h.format_sample("rock", "la la", temperature=0.0))

    got, want = _both(pair, run)
    assert got == want


def test_vocab_padding_denied_on_device():
    """vocab_use rounds the assigned-id bound up to 128; the device tables
    pad to it with deny / -1, so padding ids (here 135..255 of a 512-row
    head) can never be sampled or transition."""
    from acestep_torch.config import LMConfig

    h = LLMHandler(dtype=torch.float32, device="cpu")
    h.initialize(cfg=LMConfig.tiny(vocab_size=512), num_fallback_codes=32)
    n = h.tokenizer.vocab_size
    assert (n, h.engine.vocab_use) == (135, 256)
    tables = h._cot_tables(None, None, None)
    dev = h.engine._device_tables(tables)
    assert dev["token_to_alpha"].shape[0] == 256
    assert (dev["token_to_alpha"][n:] == -1).all()
    assert not dev["caption_mask"][n:].any()
    assert h.engine._device_tables(tables) is dev      # cached upload
    ids = h.engine.generate_cot_device("x", fsm_tables=tables,
                                       max_tokens=256, seed=1)
    assert ids and max(ids) < n
