"""The planner's plain float32 reference (`reference/lm.py`) against the
port's `LMEngine`, on the CPU at a tiny `LMConfig` with seeded weights
and the char-level tokenizer of 64,000 codes: in each case the engine
prefills, then decodes through its cache, and the reference runs one
full forward pass over the same token stream. Compared are the logits
the sampler is handed (CFG-mixed where paired), never sampled tokens.

The test may import both; the reference itself imports nothing of the
port (`test_perfbench_harness.py` checks that).
"""

import dataclasses
import json
import os

import pytest
import torch
from conftest import PERFBENCH

from harness import correct, weights
from reference import lm as ref_lm
from systems import dit_vae_lm

CONF = json.load(open(os.path.join(PERFBENCH, "configs",
                                   "acestep-v15-turbo-lm4b.json")))
CODES = CONF["planner"]["audio_codes"]
FP32 = 1e-5             # float32 on both sides: rounding only


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_lm() -> dict:
    """A two-layer planner, untied head like the 4B's, its vocabulary
    past the tokenizer's ids like the 4B's."""
    from acestep_torch.config import LMConfig

    return dataclasses.asdict(LMConfig.tiny(vocab_size=64256,
                                            tie_word_embeddings=False))


@pytest.fixture(scope="module")
def conf():
    return dict(CONF, lm=tiny_lm(), dtype="float32")


@pytest.fixture(scope="module")
def llm(conf):
    return dit_vae_lm.build_planner(conf, 2**31 + 5, torch.device("cpu"))


@pytest.fixture(scope="module")
def W(conf):
    return weights.widen(dit_vae_lm.planner_weights(conf, 2**31 + 5,
                                                    torch.device("cpu")))


@pytest.fixture(scope="module")
def tok():
    return ref_lm.Tokenizer(CODES)


@pytest.mark.parametrize("size", ["4B", "tiny"])
def test_param_shapes_are_the_planners(size):
    from acestep_torch.config import LMConfig
    from acestep_torch.models.lm import QwenLM

    lm = CONF["lm"] if size == "4B" else tiny_lm()
    model = QwenLM(LMConfig(**lm), device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        ref_lm.param_shapes(lm)
    assert dataclasses.asdict(LMConfig.for_size("4B")) == CONF["lm"]


def test_tokenizer_is_the_programs(tok):
    from acestep_torch.llm.tokenizer import SimpleTokenizer

    prog = SimpleTokenizer(num_audio_codes=CODES)
    text = ("<|im_start|>user\n# Caption\nF♯ minor, jazz é\n<think>\n"
            "</think><|audio_code_17|><|audio_code_63999|><|im_end|>\n")
    assert tok.encode(text) == prog.encode(text)
    assert tok.decode(tok.encode(text)) == prog.decode(prog.encode(text))
    assert (tok.eos, tok.pad) == (prog.eos_token_id, prog.pad_token_id)
    assert ref_lm.code_window(tok) == (prog.audio_code_id(0),
                                       prog.audio_code_id(0) + CODES)
    assert len(tok.texts) == prog.vocab_size


def test_prompts_are_the_handlers(llm):
    from acestep_torch.llm.handler import format_metadata_as_cot

    caption, lyrics = "synthwave, neon river", "[verse]\nla la"
    assert ref_lm.cot_prompt(caption, lyrics) == \
        llm.build_formatted_prompt(caption, lyrics)
    assert ref_lm.cot_prompt(caption, lyrics, negative=True) == \
        llm.build_formatted_prompt(caption, lyrics, is_negative_prompt=True)
    meta = {"bpm": 120, "caption": "a b: c", "duration": 60,
            "keyscale": "F♯ minor", "language": "en", "timesignature": 4}
    cot = format_metadata_as_cot(meta)
    assert ref_lm.format_cot(ref_lm.cot_fields(cot)) == cot
    for negative in (False, True):
        assert ref_lm.codes_prompt(caption, lyrics, cot, negative) == \
            llm.build_formatted_prompt_with_cot(
                caption, lyrics, cot, is_negative_prompt=negative)


def _force(monkeypatch, steps):
    """The engine's sampler replaced by one that records the logits it is
    handed and returns `steps` in turn."""
    from acestep_torch.llm import generator as gen

    got = []
    monkeypatch.setattr(gen, "sample_tokens",
                        dit_vae_lm._forced([torch.tensor(s) for s in steps],
                                           got))
    return got


@pytest.mark.parametrize("cfg", [False, True], ids=["plain", "cfg_pair"])
def test_prefill_then_cached_decode_is_the_full_forward(llm, W, tok, conf,
                                                        monkeypatch, cfg):
    """A plain stream, and a CFG pair (conditional and unconditional
    prompts, both fed the sampled tokens, mixed u + 2 (c - u))."""
    eng = llm.engine
    eng._cross_prefix = None
    p = ref_lm.cot_prompt("lofi, amber tide", "[verse]\nhollow glass")
    n = ref_lm.cot_prompt("lofi, amber tide", "[verse]\nhollow glass",
                          negative=True)
    fed = tok.encode("<think>\nbpm: 93\ncaption: warm drift")
    got = _force(monkeypatch, [[t] for t in fed])
    eng.generate([p], unconditional_prompts=[n] if cfg else None,
                 cfg_scale=2.0 if cfg else 1.0, max_new_tokens=len(fed),
                 temperature=0.85)
    have = torch.cat(got)[:, :len(tok.texts)].numpy()
    V = (0, len(tok.texts))
    c = ref_lm.logits(W, conf["lm"], tok.encode(p) + fed,
                      range(len(tok.encode(p)) - 1,
                            len(tok.encode(p)) - 1 + len(fed)), *V)
    want = c
    if cfg:
        u = ref_lm.logits(W, conf["lm"], tok.encode(n) + fed,
                          range(len(tok.encode(n)) - 1,
                                len(tok.encode(n)) - 1 + len(fed)), *V)
        want = ref_lm.cfg_mix(c, u, 2.0)
    assert have.shape == tuple(want.shape)
    assert correct.rel(have, want.numpy()) < FP32


def _plan(llm, monkeypatch, seed, caption, lyrics, n=2):
    """One batched plan (`n` songs, the facade's knobs) recorded as the
    benchmark's wrappers record it."""
    from acestep_torch.llm.generator import LMEngine

    for name, wrap in (("_cot_decode", dit_vae_lm._record_cot),
                       ("generate_codes", dit_vae_lm._record_codes)):
        monkeypatch.setattr(LMEngine, name, wrap(getattr(LMEngine, name)))
    llm.engine._cross_prefix = None
    out = llm.plan_batch(caption, lyrics, n=n, seed=seed, cfg_scale=2.0,
                         temperature=0.85, top_p=0.9,
                         user_metadata={"duration": 10.0, "language": "en"})
    plan = dit_vae_lm._open.pop()
    plan["seeds"] = list(range(n))
    monkeypatch.undo()
    return plan, out


def test_batched_cot_with_pads_and_codes_on_its_prefix(llm, W, tok, conf,
                                                       monkeypatch):
    """Two songs' CoTs decoded as one batch, rows finishing at different
    steps and feeding pads after; then phase 2 on phase 1's cached prefix.
    The engine's mixed logits at every sampled position equal the full
    forward's; every CoT token lies in the host FSM's allowed set; each
    song gets duration x 5 codes."""
    rec = {"caption": "jazz, velvet harbor", "duration_s": 10.0,
           "lyrics": "[verse]\nsilver drift comet\npulse valley",
           "language": "en"}
    plan, out = _plan(llm, monkeypatch, 31, rec["caption"], rec["lyrics"])
    lens = [len(o) for o in plan["cot"]["outs"]]
    assert lens[0] != lens[1], lens     # one row feeds pads
    cot_logits, code_logits = dit_vae_lm.teacher_force(llm.engine, plan)
    assert llm.engine.last_prefill_stats["reused_tokens"] > 0
    scale = plan["cot"]["kw"]["cfg_scale"]
    windows = {"cot": (0, len(tok.texts)), "codes": ref_lm.code_window(tok)}
    for r, song in enumerate(dit_vae_lm._songs(rec, plan, tok)):
        for i, phase in enumerate(("cot", "codes")):
            want = dit_vae_lm._reference_logits(W, conf["lm"], song, phase,
                                                windows[phase], scale)
            have = (cot_logits, code_logits)[i][:want.shape[0], r,
                                                :want.shape[1]].numpy()
            assert correct.rel(have, want) < FP32, (r, phase)
        fsm = dit_vae_lm._host_fsm(llm, rec["duration_s"], "en")
        allowed = ref_lm.allowed_sets(fsm, song["cot"])
        assert all(a is None or t in a for t, a in zip(song["cot"], allowed))
        assert fsm.finished
        assert len(song["codes"]) == 50
        assert out[r]["audio_codes"].count("<|audio_code_") == 50
        assert llm.engine.tok.encode(plan["codes"]["prompts"][r]) == \
            song["p2"]


def test_fp8_planner_fails_the_limit(llm, conf, monkeypatch):
    """The reference with every matrix rounded to fp8 e4m3 in the
    program's place fails the limit the port's float32 run holds at this
    size by orders of magnitude (the cell's own limit is set on the card
    at full width, where the control is measured against it)."""
    rec = {"caption": "folk, garden tide", "duration_s": 10.0, "seed": 0,
           "lyrics": "[verse]\nmarble comet\nglass ember", "language": "en"}
    plan, _out = _plan(llm, monkeypatch, 7, rec["caption"], rec["lyrics"])
    dev = torch.device("cpu")
    port = dit_vae_lm.planner_numbers(conf, 2**31 + 5, [rec], [plan], llm,
                                      dev)
    ctl = dit_vae_lm.planner_numbers(conf, 2**31 + 5, [rec], [plan], llm,
                                     dev, fp8=True)
    assert port["lm_logit_err"] < FP32
    assert ctl["lm_logit_err"] > 100 * FP32
    for key in ("stream_bad", "fsm_violations", "code_count_bad"):
        assert port[key] == ctl[key] == 0


def test_the_planner_holds_the_drawn_weights(llm, W):
    """The program's planner holds the weights the reference draws again,
    its norm scales among them drawn off 1, so a norm the port dropped or
    misapplied would move the logits."""
    have = llm.engine.model.state_dict()
    assert set(have) == set(W)
    assert all(torch.equal(have[k].float(), W[k]) for k in W)
    norms = [k for k in W if k.endswith(".scale")]
    assert norms and all((W[k] - 1).abs().max() > 0.05 for k in norms)


def test_the_readout_is_drawn_narrow(W):
    """The head is drawn `READOUT` times as wide as the trunk's matrices,
    so an untrained planner's logits are near flat."""
    trunk = W["layers.0.mlp.up.weight"].std().item()
    head = W["lm_head.weight"].std().item()
    assert head == pytest.approx(trunk * dit_vae_lm.READOUT, rel=0.05)
    assert dit_vae_lm.READOUT < 0.1


@pytest.mark.parametrize("fault", ["q_norm", "final_norm"])
def test_a_fault_in_the_judged_planner_fails_the_limit(llm, conf,
                                                       monkeypatch, fault):
    """The judge teacher-forces through the planner it is given, the one
    that was timed: a norm scale of that planner put back to 1 after its
    plan (the port's own init) shows in `lm_logit_err` far past the limit
    its sound logits hold."""
    rec = {"caption": "soul, copper dawn", "duration_s": 10.0, "seed": 0,
           "lyrics": "[verse]\nember tide\nvelvet comet", "language": "en"}
    plan, _out = _plan(llm, monkeypatch, 11, rec["caption"], rec["lyrics"])
    model = llm.engine.model
    scale = (model.layers[0].self_attn.q_norm.scale if fault == "q_norm"
             else model.norm.scale)
    kept = scale.detach().clone()
    try:
        with torch.no_grad():
            scale.fill_(1.0)
        got = dit_vae_lm.planner_numbers(conf, 2**31 + 5, [rec], [plan], llm,
                                         torch.device("cpu"))
    finally:
        with torch.no_grad():
            scale.copy_(kept)
    assert got["lm_logit_err"] > 100 * FP32
