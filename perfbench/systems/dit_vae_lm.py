"""The turbo text2music system with the 5 Hz planner: `dit_vae`'s DiT and
Oobleck VAE behind one `AceStepHandler`, and the `LLMHandler` the card's
memory tier gives (`initialize_auto`: on a card of 32 GB or more the 4B
planner in bf16, its decode step replayed as CUDA graphs), both driven
through the facade with thinking on.

- `build`: the DiT and VAE as `dit_vae` builds them, and the planner the
  tier picks, its own init replaced by weights drawn as the DiT's and
  the VAE's are (`harness/weights.py`, the run's `lm` stream: norm
  scales 1 + N(0, 0.1), so a norm the port dropped would show), the
  readout scaled by `READOUT` so the CoT's length does not hang on the
  draw; the
  configuration's planner size, precision and widths are checked against
  what the tier built. On the CPU, which has no planner tier, the
  configuration's widths are built directly.
- `install`: wrappers that record, for each facade call, what the
  planner's two loops fed and sampled (the CoT loop's prompts, tokens
  and FSM tables, the codes loop's prompts and codes) and the seeds of
  the render they fed, and the planner that serves them (`TIMED`), which
  the judge reuses; `drivers.Facade`'s `GenerationConfig` gets the
  request's `batch_size` and `allow_lm_batch` (`Facade.params` itself
  asks for one song a call); and one lock keeps the card's graph launches apart
  from the traced stretch's profiler start and stop: CUPTI's teardown in
  `profile.stop()` deadlocked against a CUDA graph launched at the same
  moment from the window's thread, which the planner does ~110 times a
  second.
- `warm`: facade calls until every cache and graph the mix reaches is
  made: the shortest and the longest prompts the mix draws twice each
  (the last CoT's cache is held for the next call's prefix, so two
  buffers of each shape take turns), then the mix's own draws, until
  `warm_quiet` calls in a row capture no graph or `warm_calls` have run.
- `judge`: a sample of the window's requests (`harness/correct.sample`),
  each with both its songs:
  - `lm_logit_err`: the largest, over the sampled songs and the two
    phases, relative L2 gap between the program's CFG-mixed logits and
    the plain float32 reference's (`reference/lm.py`) at every sampled
    position (CoT: the ids the tokenizer has; codes: the audio-code
    window). The program's are got by teacher-forcing the recorded
    streams through the engine that was timed, as the window left it
    (its weights, cache arena, captured graphs and the last call's
    prefix held for reuse): its own CoT and codes loops run, prefill
    then the decode step through the cache as CUDA graphs in bf16, with
    their sampler replaced by one that hands back the recorded tokens.
    The reference draws the planner's weights again and widens them;
  - `stream_bad`: prompts the program fed that differ from the ones the
    reference rebuilds from the caption, the lyrics and the CoT;
  - `fsm_violations`: CoT tokens outside the set the host MetadataFSM
    (`llm/fsm.py`, the device tables' source) allows, walked over the
    emitted tokens, and codes outside the audio-code window;
  - `code_count_bad`: songs whose code count is not duration x 5;
  - `latent_err`, `audio_err`: `dit_vae`'s judge of each song's render,
    as a cover render of its codes (`reference/hints.py` turns them into
    the context latents), with the caption, metadata and language of the
    call's first CoT, as the facade hands them to the handler;
  - `missing`, `saved_bad`: as `dit_vae`'s, over both songs of a call.
- `control`: the planner's and the DiT's references with every matrix
  rounded to fp8 e4m3 (`harness/correct.fp8_rounded`) in the program's
  place, on the streams and codes the program produced for the requests
  a run of the seed would judge.
- `request_flops`: both songs' planner work (`harness/lm_counts.py`:
  each phase of both CFG streams, at the lengths the reference's prompts
  and the recorded CoT give) and their DiT, detokenizer and VAE work
  (`harness/counts.py`).
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import counts, drivers, lm_counts, program, traffic, weights
from harness.correct import fp8_rounded, rel, sample, saved_ok
from reference import dit as ref_dit
from reference import hints as ref_hints
from reference import lm as ref_lm
from reference import text as ref_text
from systems import dit_vae

COVER = "Generate audio semantic tokens based on the given conditions:"
COT_KW = ("cfg_scale", "temperature", "top_k", "top_p", "repetition_penalty",
          "max_tokens", "seed", "pad_id")
CODES_KW = ("cfg_scale", "temperature", "top_k", "top_p",
            "repetition_penalty", "n_codes", "seed")

# the plans of the calls made since `install`, by the seed of each call's
# first song, and the one the facade's thread is making
PLANS: Dict[int, dict] = {}
_open: List[dict] = []
# the planner `install` was given: the judge teacher-forces through it
TIMED: List = []
# held by each CUDA graph launch and by the profiler's start and stop
_CUPTI = threading.Lock()
# The planner's readout is drawn this much smaller than its other
# matrices (a power of two: the rounded draw stays exact). At N(0, 0.02)
# an untrained head spreads the CFG-mixed logits by about 1, so the draw
# fixed how likely a newline was inside the caption, and a run's mean CoT
# length with it (109-140 tokens a song between three seeds, a call's
# mean latency 4.52-4.83 s on an H100). Near-flat logits leave the
# caption's end to the sampler, the same for every seed.
READOUT = 2.0 ** -5


# --------------------------------------------------------------- build

def planner_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The planner's weights of run `seed` in the configuration's dtype,
    drawn as `harness/weights.py` draws every model's (the `lm` stream),
    the readout then scaled by `READOUT`."""
    w = weights.draw(ref_lm.param_shapes(conf["lm"]), seed, "lm", device,
                     getattr(torch, conf["dtype"]))
    w["lm_head.weight"].mul_(READOUT)
    return w


def build_planner(conf: dict, seed: int, device):
    """The planner of run `seed` as the card's tier makes it, holding the
    weights `planner_weights` draws."""
    from acestep_torch.config import LMConfig
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.llm.tokenizer import SimpleTokenizer

    plan = conf["planner"]
    llm = LLMHandler(dtype=getattr(torch, conf["dtype"]), device=device)
    if torch.device(device).type == "cuda":
        got = llm.initialize_auto()
        if (got["size"], got["quantization"]) != (plan["size"],
                                                  plan["quantization"]):
            raise RuntimeError(f"the card's tier built the {got} planner, "
                               f"not the configuration's {plan}")
        if not llm.engine.cuda_graphs:
            raise RuntimeError("the planner's decode step is not graphed")
    else:
        llm.initialize(cfg=LMConfig(**conf["lm"]), tokenizer=SimpleTokenizer(
            num_audio_codes=plan["audio_codes"]))
    have = dataclasses.asdict(llm.cfg)
    bad = {k: (v, have.get(k)) for k, v in conf["lm"].items()
           if have.get(k) != v}
    if bad:
        raise ValueError(f"the planner's geometry differs from the "
                         f"configuration's (want, have): {bad}")
    # the tier's own init sets every norm scale to 1; the drawn weights
    # take its place before any graph or cache holds a pointer to it
    program.load_module(llm.engine.model, planner_weights(conf, seed, device))
    return llm


def build(conf: dict, seed: int, device) -> program.Handlers:
    return program.Handlers(dit=dit_vae.build(conf, seed, device).dit,
                            llm=build_planner(conf, seed, device))


# ------------------------------------------------------------- install

def _batched(orig):
    def params(self, req):
        p, c = orig(self, req)
        c.batch_size = int(req.get("batch_size", 1))
        c.allow_lm_batch = bool(req.get("allow_lm_batch", False))
        return p, c
    return params


def _record_cot(orig):
    def cot_decode(self, prompts, unconditional_prompts, **kw):
        outs, state = orig(self, prompts, unconditional_prompts, **kw)
        _open[:] = [{"cot": {
            "prompts": list(prompts),
            "uncond": list(unconditional_prompts or []),
            "outs": [list(map(int, o)) for o in outs],
            "tables": kw["fsm_tables"],
            "kw": {k: kw[k] for k in COT_KW}}}]
        return outs, state
    return cot_decode


def _record_codes(orig):
    def generate_codes(self, prompts, **kw):
        codes = orig(self, prompts, **kw)
        if _open:
            _open[0]["codes"] = {
                "prompts": list(prompts),
                "uncond": list(kw.get("unconditional_prompts") or []),
                "codes": [list(map(int, c)) for c in codes],
                "kw": {k: kw[k] for k in CODES_KW if k in kw}}
        return codes
    return generate_codes


def _record_render(orig):
    def generate_music(self_, *a, **kw):
        res = orig(self_, *a, **kw)
        if _open and "codes" in _open[0]:
            plan = _open.pop()
            plan["seeds"] = [int(s) for s in res.seeds]
            PLANS[plan["seeds"][0]] = plan
        return res
    return generate_music


class _GuardedProfile:
    """A torch.profiler.profile whose start and stop hold `_CUPTI`."""

    def __init__(self, prof):
        self.prof = prof

    def start(self):
        with _CUPTI:
            self.prof.start()

    def stop(self):
        with _CUPTI:
            self.prof.stop()

    def __getattr__(self, name):
        return getattr(self.prof, name)


def _guarded_replay(orig):
    def replay(self, *a, **kw):
        with _CUPTI:
            return orig(self, *a, **kw)
    return replay


def install(rec: program.Recorder, handlers: program.Handlers) -> None:
    from acestep_torch.llm.generator import LMEngine
    from acestep_torch.pipeline.handler import AceStepHandler
    from harness.trace import Tracer

    PLANS.clear()
    del _open[:]
    TIMED[:] = [handlers.llm]
    rec._patch(drivers.Facade, "params", _batched)
    rec._patch(LMEngine, "_cot_decode", _record_cot)
    rec._patch(LMEngine, "generate_codes", _record_codes)
    rec._patch(AceStepHandler, "generate_music", _record_render)
    rec._patch(torch.cuda.CUDAGraph, "replay", _guarded_replay)
    profile = Tracer.__dict__["_profile"]
    rec._undo.append((Tracer, "_profile", profile))
    Tracer._profile = staticmethod(
        lambda: _GuardedProfile(profile.__func__()))


# ---------------------------------------------------------------- warm

def warm(handlers: program.Handlers, mix: dict, seed: int,
         out_dir: str) -> None:
    """Facade calls until the planner's caches and graphs are made (the
    module's docstring says which)."""
    facade = drivers.Facade(handlers, mix, out_dir)
    pool = traffic.requests(dict(mix, loop="closed"), seed ^ 0x5A5A5A5A, 0,
                            count=64)
    by_len = sorted(pool, key=lambda r: len(r["caption"]) + len(r["lyrics"]))
    order = by_len[:2] + by_len[-2:] + pool
    quiet = calls = 0
    for req in order[:mix["warm_calls"]]:
        before = handlers.llm.engine.graph_captures
        res = facade.one(req)
        if not res.success:
            raise RuntimeError(f"warm-up call failed: {res.error}")
        calls += 1
        quiet = quiet + 1 if handlers.llm.engine.graph_captures == before \
            else 0
        if calls >= 4 and quiet >= mix["warm_quiet"]:
            break
    print(f"perfbench: warm-up {calls} calls, the planner's graphs "
          f"{handlers.llm.engine.graph_captures}, caches "
          f"{sorted(c.slots for c in handlers.llm.engine._arena)}",
          file=sys.stderr)


# --------------------------------------------------------------- judge

def _forced(feed: list, got: list):
    """A sampler that records the logits it is given and hands back the
    next recorded tokens."""
    it = iter(feed)

    def sample_tokens(generator, logits, **kw):
        got.append(logits.float().clone())
        return next(it).to(logits.device)
    return sample_tokens


def teacher_force(engine, plan: dict) -> tuple:
    """(CoT logits (steps, songs, V), codes logits (n, songs, Vc)): the
    CFG-mixed logits the program's own loops compute on the plan's
    recorded streams."""
    from acestep_torch.llm import generator as gen

    cot, codes = plan["cot"], plan["codes"]
    pad = cot["kw"]["pad_id"]
    outs = cot["outs"]
    longest = max(len(o) for o in outs)
    steps = [torch.tensor([o[i] if i < len(o) else pad for o in outs])
             for i in range(longest)]
    steps += [torch.full((len(outs),), pad)] * cot["kw"]["max_tokens"]
    got_cot: List[torch.Tensor] = []
    got_codes: List[torch.Tensor] = []
    real = gen.sample_tokens
    try:
        gen.sample_tokens = _forced(steps, got_cot)
        again, state = engine._cot_decode(
            cot["prompts"], cot["uncond"] or None, fsm_tables=cot["tables"],
            **cot["kw"])
        gen.sample_tokens = _forced(
            [torch.tensor(c) for c in zip(*codes["codes"])], got_codes)
        engine.generate_codes(codes["prompts"],
                              unconditional_prompts=codes["uncond"] or None,
                              prefix=state, **codes["kw"])
    finally:
        gen.sample_tokens = real
    if [list(map(int, o)) for o in again] != outs:
        raise RuntimeError("teacher-forcing the CoT sampled other tokens")
    return (torch.stack(got_cot).cpu(), torch.stack(got_codes).cpu())


def _host_fsm(llm, duration_s: float, language: str):
    """The host MetadataFSM of one CoT row, as the facade's plan makes it
    (duration and language pinned by the request, no genres vocabulary)."""
    from acestep_torch.llm.fsm import MetadataFSM

    return MetadataFSM(llm.tables, user_metadata={
        "duration": duration_s, "language": language},
        max_duration=llm.max_duration, skip_genres=True)


def _songs(rec: dict, plan: dict, tok) -> List[dict]:
    """What the reference rebuilds of each song of one call: its prompts,
    CoT, codes and the CoT's fields."""
    cap, lyr = rec["caption"], rec["lyrics"]
    p1 = tok.encode(ref_lm.cot_prompt(cap, lyr))
    n1 = tok.encode(ref_lm.cot_prompt(cap, lyr, negative=True))
    out = []
    for seed, t, codes in zip(plan["seeds"], plan["cot"]["outs"],
                              plan["codes"]["codes"]):
        fields = ref_lm.cot_fields(tok.decode(t))
        cot = ref_lm.format_cot(fields)
        out.append({"seed": seed, "cot": t, "codes": codes, "fields": fields,
                    "p1": p1, "n1": n1,
                    "p2": tok.encode(ref_lm.codes_prompt(cap, lyr, cot)),
                    "n2": tok.encode(ref_lm.codes_prompt(cap, lyr, cot,
                                                         negative=True))})
    return out


def _mixed(W, lm, cond, uncond, n_prompt_c, n_prompt_u, n, lo, hi, scale):
    c = ref_lm.logits(W, lm, cond, range(n_prompt_c - 1, n_prompt_c - 1 + n),
                      lo, hi)
    u = ref_lm.logits(W, lm, uncond,
                      range(n_prompt_u - 1, n_prompt_u - 1 + n), lo, hi)
    return ref_lm.cfg_mix(c, u, scale).cpu().numpy()


def _reference_logits(W, lm, song: dict, phase: str, window: tuple,
                      scale: float) -> np.ndarray:
    lo, hi = window
    if phase == "cot":
        t = song["cot"]
        return _mixed(W, lm, song["p1"] + t, song["n1"] + t,
                      len(song["p1"]), len(song["n1"]), len(t), lo, hi, scale)
    ids = [lo + c for c in song["codes"]]
    return _mixed(W, lm, song["p2"] + ids, song["n2"] + ids, len(song["p2"]),
                  len(song["n2"]), len(ids), lo, hi, scale)


def planner_numbers(conf: dict, seed: int, picked: List[dict],
                    plans: List[Optional[dict]], llm, device,
                    fp8: bool = False) -> dict:
    """The planner's checks over the sampled calls, the program's logits
    teacher-forced through `llm`, the planner that was timed, in the state
    the window left it in; with `fp8` the reference with fp8 weights
    stands in for the program."""
    lm = conf["lm"]
    tok = ref_lm.Tokenizer(conf["planner"]["audio_codes"])
    if llm is None or not picked or any(p is None for p in plans):
        return {"lm_logit_err": float("inf"), "stream_bad": len(picked),
                "fsm_violations": 0, "code_count_bad": 0}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog_tok = llm.engine.tok
    forced = None if fp8 else [teacher_force(llm.engine, p) for p in plans]
    fsms = [[_host_fsm(llm, rec["duration_s"], rec["language"])
             for _ in p["cot"]["outs"]] for rec, p in zip(picked, plans)]
    del llm
    W = weights.widen(planner_weights(conf, seed, device))
    program.release()
    W8 = fp8_rounded(W) if fp8 else None
    V = len(tok.texts)
    windows = {"cot": (0, V), "codes": ref_lm.code_window(tok)}
    err, stream_bad, violations, count_bad = 0.0, 0, 0, 0
    for j, (rec, plan) in enumerate(zip(picked, plans)):
        scale = plan["cot"]["kw"]["cfg_scale"]
        fed = {"p1": plan["cot"]["prompts"], "n1": plan["cot"]["uncond"],
               "p2": plan["codes"]["prompts"], "n2": plan["codes"]["uncond"]}
        for r, song in enumerate(_songs(rec, plan, tok)):
            for key, prompts in fed.items():
                stream_bad += prog_tok.encode(prompts[r]) != song[key]
            allowed = ref_lm.allowed_sets(fsms[j][r], song["cot"])
            violations += sum(1 for t, a in zip(song["cot"], allowed)
                              if a is not None and t not in a)
            violations += sum(1 for c in song["codes"]
                              if not 0 <= c < tok.num_audio_codes)
            count_bad += len(song["codes"]) != int(rec["duration_s"] * 5)
            for i, phase in enumerate(("cot", "codes")):
                want = _reference_logits(W, lm, song, phase, windows[phase],
                                         scale)
                if fp8:
                    have = _reference_logits(W8, lm, song, phase,
                                             windows[phase], scale)
                else:
                    n = want.shape[0]
                    have = forced[j][i][:n, r, :want.shape[1]].numpy()
                err = max(err, rel(have, want))
    del W, W8
    program.release()
    return {"lm_logit_err": err, "stream_bad": stream_bad,
            "fsm_violations": violations, "code_count_bad": count_bad}


def song_inputs(conf: dict, rec: dict, song: dict, first: dict, W,
                device) -> dict:
    """The DiT reference's inputs of one song of a thinking call: a cover
    render of its codes, with the caption, bpm, key, time signature and
    language of the call's first CoT."""
    dit = conf["dit"]
    f = first["fields"]
    caption = f.get("caption") or rec["caption"]
    language = f.get("language") or rec["language"]
    meta = ref_text.meta_string(rec["duration_s"], f.get("bpm"),
                                f.get("keyscale", ""),
                                f.get("timesignature", ""))
    table = ref_text.hash_table(dit["text_hidden_dim"])
    text, text_m = ref_text.embed(
        table, [ref_text.PROMPT.format(COVER, caption, meta)],
        ref_text.TEXT_MAX_LEN)
    lyric, lyric_m = ref_text.embed(
        table, [ref_text.lyric_prompt(rec["lyrics"], language)],
        ref_text.LYRIC_MAX_LEN)
    inputs = dit_vae.request_inputs(conf, dict(rec, seed=song["seed"]), device)
    T = inputs["src"].shape[1]

    def dev(a):
        return torch.as_tensor(a, device=device)

    inputs.update(text=dev(text), text_mask=dev(text_m), lyric=dev(lyric),
                  lyric_mask=dev(lyric_m),
                  src=ref_hints.lm_hints(W, dit, song["codes"], T, device))
    return inputs


def dit_numbers(conf: dict, seed: int, picked: List[dict],
                plans: List[Optional[dict]], songs: Dict[int, tuple], device,
                fp8: bool = False) -> dict:
    """`latent_err` and `audio_err` of every song of the sampled calls;
    with `fp8` the fp8 reference produces them."""
    if not picked or any(p is None for p in plans):
        return {"latent_err": float("inf"), "audio_err": float("inf")}
    tok = ref_lm.Tokenizer(conf["planner"]["audio_codes"])
    ref = dit_vae.Reference(conf, seed, device)
    ctl = dit_vae.Reference(conf, seed, device, fp8=True) if fp8 else None

    @torch.no_grad()
    def latents(r, rec, song, first):
        n = int(rec["duration_s"] * 25)
        x = ref_dit.latents(r.W, conf["dit"], **song_inputs(
            conf, rec, song, first, r.W, device))
        return x[0, :n].cpu().numpy()

    latent_err = audio_err = 0.0
    for rec, plan in zip(picked, plans):
        rebuilt = _songs(rec, plan, tok)
        for song in rebuilt:
            want = latents(ref, rec, song, rebuilt[0])
            if fp8:
                lat = latents(ctl, rec, song, rebuilt[0])
                audio = ctl.song(lat, rec["duration_s"])
            elif song["seed"] in songs:
                audio, lat, _path = songs[song["seed"]]
            else:
                latent_err = audio_err = float("inf")
                continue
            latent_err = max(latent_err, rel(lat, want))
            audio_err = max(audio_err,
                            rel(audio, ref.song(want, rec["duration_s"])))
    del ref, ctl
    program.release()
    return {"latent_err": latent_err, "audio_err": audio_err}


def judge(conf: dict, seed: int, records: List[dict], songs: Dict[int, tuple],
          device, k: int, renders: List[tuple] = (), fp8: bool = False
          ) -> dict:
    picked = sample(records, seed, k, renders)
    plans = [PLANS.get(r["seed"]) for r in picked]
    llm = TIMED.pop() if TIMED else None
    out = planner_numbers(conf, seed, picked, plans, llm, device, fp8)
    del llm
    out.update(dit_numbers(conf, seed, picked, plans, songs, device, fp8))
    saved_bad = 0
    for r in records:
        if not r["ok"] or fp8:
            continue
        plan = PLANS.get(r["seed"])
        seeds = plan["seeds"] if plan else [r["seed"], None]
        saved_bad += sum(1 for s in seeds if s not in songs or not saved_ok(
            songs[s][2], songs[s][0]))
    out.update(missing=sum(1 for r in records if not r["ok"]),
               saved_bad=saved_bad, sampled=len(picked))
    return out


def control(conf: dict, mix: dict, seed: int, seconds: float, device) -> dict:
    """The control's numbers on the calls a run of `seed` would judge: the
    program makes their plans, then the fp8 references stand in for it."""
    reqs = traffic.requests(mix, seed, seconds, count=mix["correct_sample"])
    handlers = build(conf, seed, device)
    rec = program.Recorder()
    rec.install()
    records = []
    with tempfile.TemporaryDirectory(prefix="perfbench-control-") as out:
        try:
            install(rec, handlers)
            facade = drivers.Facade(handlers, mix, out)
            for req in reqs:
                res = facade.one(req)
                records.append(drivers._record(req, ok=bool(res.success),
                                               error=res.error))
        finally:
            rec.uninstall()
        del handlers, facade
        program.release()
        return judge(conf, seed, records, {}, device, k=len(records),
                     fp8=True)


# ------------------------------------------------------------ counting

def request_flops(conf: dict, rec: dict) -> float:
    """The analytic FLOPs of one completed call: both songs' planner work
    (each phase of both CFG streams) and their cover renders (condition
    encoder, detokenizer, cross K/V, DiT trajectory, VAE decode)."""
    plan = PLANS.get(rec["seed"])
    if plan is None:
        return 0.0
    lm, dit = conf["lm"], conf["dit"]
    tok = ref_lm.Tokenizer(conf["planner"]["audio_codes"])
    lo, hi = ref_lm.code_window(tok)
    rebuilt = _songs(rec, plan, tok)
    f0 = rebuilt[0]["fields"]
    caption = f0.get("caption") or rec["caption"]
    meta = ref_text.meta_string(rec["duration_s"], f0.get("bpm"),
                                f0.get("keyscale", ""),
                                f0.get("timesignature", ""))
    text = ref_text.PROMPT.format(COVER, caption, meta)
    lyric = ref_text.lyric_prompt(rec["lyrics"],
                                  f0.get("language") or rec["language"])
    frames = int(rec["duration_s"] * 25)
    total = 0.0
    for song in rebuilt:
        t = song["cot"]
        shared = [_common(song["p2"], song["p1"] + t),
                  _common(song["n2"], song["n1"] + t)]
        total += lm_counts.plan_flops(
            lm, prompts1=[len(song["p1"]), len(song["n1"])], cot=len(t),
            prompts2=[len(song["p2"]), len(song["n2"])], shared=shared,
            codes=len(song["codes"]), cot_window=len(tok.texts),
            code_window=hi - lo)
        total += counts.request_flops(
            dit, conf["vae"], frames=frames, steps=rec["steps"],
            text_len=ref_text.padded_len(len(text.encode()),
                                         ref_text.TEXT_MAX_LEN),
            lyric_len=ref_text.padded_len(len(lyric.encode()),
                                          ref_text.LYRIC_MAX_LEN),
            refer_frames=dit["timbre_fix_frame"])
        total += detokenizer_flops(dit, len(song["codes"]))
    return total


def detokenizer_flops(dit: dict, codes: int) -> float:
    """The quantizer's output projection and the detokenizer over `codes`
    5 Hz vectors: its input projection once a vector, its stack over the
    `pool_window_size` frames of each, its output projection a frame."""
    h, P = dit["hidden_size"], dit["pool_window_size"]
    stack = counts.encoder_flops(dit, P, 0,
                                 dit["num_attention_pooler_hidden_layers"])
    return codes * (2 * len(dit["fsq_levels"]) * dit["fsq_dim"] + 2 * h * h
                    + stack + 2 * P * h * dit["audio_acoustic_hidden_dim"])


def _common(a: List[int], b: List[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n
