"""The turbo text2music system: the port's DiT and Oobleck VAE behind one
`AceStepHandler`, with no planner.

- `build`: the handler from the configuration's `dit` and `vae` sizes,
  each model built on the meta device and given views of one seeded
  buffer drawn on the card (`harness/weights.py`).
- `warm`: one render at each batch size the mix can form.
- `judge`: a sample of the completed requests, drawn from the run's
  seed, worked out again by the plain float32 reference in
  `perfbench/reference/` from what the client sent (caption, lyrics,
  duration, seed) and the seeded weights, with TF32 off:
  - `latent_err`: the largest, over the sample, relative L2 gap between
    the program's latents and the reference's (condition encoder, cross
    K/V, 8-step DiT trajectory: K1's path);
  - `audio_err`: the largest relative L2 gap between the program's song
    and the reference's, decoded by the reference VAE from the
    reference's own latents through the same decode plan, int16 transfer
    and peak normalisation (K4's path, on top of the DiT's);
  - `missing`: requests due in the window that failed or never came
    back;
  - `saved_bad`: songs whose file is missing or does not hold the song
    (`harness/correct.saved_ok`).
  The sample is `harness/correct.sample`'s: every song of one of the
  largest renders, the longest song, songs drawn from the seed.
- `control`: the same reference with every weight rounded to fp8 e4m3
  (a scale per output channel) in the program's place, judged the same
  way (`perfbench/control.py`).
- `request_flops`: condition encoder, cross K/V, DiT trajectory and VAE
  decode of one song (`harness/counts.request_flops`) at the song's own
  prompt buckets and frames.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from harness import counts, drivers, program, traffic, weights
from harness.correct import fp8_rounded, rel, sample, saved_ok
from reference import dit as ref_dit
from reference import text as ref_text
from reference import vae as ref_vae

REFER_FRAMES = 750      # the timbre reference: 30 s of silence latents
FRAME_BUCKET, MIN_FRAMES = 250, 128


def build(conf: dict, seed: int, device) -> program.Handlers:
    """An initialised `AceStepHandler` serving `conf` with the weights of
    run `seed`, drawn on `device`; no planner."""
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.models.dit import AceStepDiT
    from acestep_torch.models.vae import OobleckVAE
    from acestep_torch.pipeline.handler import AceStepHandler

    dtype = getattr(torch, conf["dtype"])
    cfg = DiTConfig(**program.tuples(conf["dit"]))
    vcfg = VAEConfig(**program.tuples(conf["vae"]))
    dit = program.load_module(
        AceStepDiT(cfg, device="meta", dtype=dtype),
        weights.draw(ref_dit.param_shapes(conf["dit"]), seed, "dit", device,
                     dtype))
    vae = program.load_module(
        OobleckVAE(vcfg, device="meta", dtype=dtype),
        weights.draw(ref_vae.param_shapes(conf["vae"]), seed, "vae", device,
                     dtype))
    handler = AceStepHandler(cfg, vcfg, dtype=dtype, device=device)
    handler.initialize_service(params=dit, vae_params=vae)
    return program.Handlers(dit=handler, llm=None)


def install(rec: program.Recorder, handlers: program.Handlers) -> None:
    """Nothing beyond the Recorder's own wrappers."""


def _handler_kwargs(req: dict, out_dir: str) -> dict:
    """`AceStepHandler.generate_music`'s arguments for a warm-up render of
    `req`'s shapes."""
    meta = {"bpm": "N/A", "keyscale": "N/A", "timesignature": "N/A",
            "duration": f"{int(req['duration_s'])} seconds",
            "language": req.get("vocal_language", "en")}
    return dict(metas=meta, vocal_languages=req.get("vocal_language", "en"),
                audio_duration=float(req["duration_s"]),
                infer_steps=int(req["inference_steps"]),
                shift=float(req["shift"]), save_dir=out_dir,
                audio_format=req["audio_format"])


def warm(handlers: program.Handlers, mix: dict, seed: int,
         out_dir: str) -> None:
    """One render at each batch size the mix can form, with its own
    prompts (same length buckets as the window's) and its save format."""
    reqs = traffic.requests(dict(mix, loop="closed"), seed ^ 0x5A5A5A5A, 0,
                            count=max(mix["warm_batches"]))
    for b in mix["warm_batches"]:
        rows = reqs[:b]
        handlers.dit.generate_music([r["caption"] for r in rows],
                                    [r["lyrics"] for r in rows], batch_size=b,
                                    seeds=[r["seed"] for r in rows],
                                    **_handler_kwargs(rows[0], out_dir))


# ------------------------------------------------------------- the judge

def turbo_schedule(shift: float, steps: int) -> tuple:
    """The turbo model's discrete timesteps: t = 1 - i / steps, shifted
    to shift * t / (1 + (shift - 1) * t)."""
    ts = [1.0 - i / steps for i in range(steps)]
    return tuple(shift * t / (1.0 + (shift - 1.0) * t) for t in ts)


def frames_of(duration_s: float) -> int:
    """The padded latent length of a song of `duration_s` seconds."""
    T = max(int(duration_s * 25), MIN_FRAMES)
    return -(-T // FRAME_BUCKET) * FRAME_BUCKET


def request_inputs(conf: dict, rec: dict, device) -> dict:
    """The reference's inputs for one request, from what the client sent."""
    dit = conf["dit"]
    table = ref_text.hash_table(dit["text_hidden_dim"])
    text, text_m = ref_text.embed(
        table, [ref_text.caption_prompt(rec["caption"], rec["duration_s"])],
        ref_text.TEXT_MAX_LEN)
    lyric, lyric_m = ref_text.embed(
        table, [ref_text.lyric_prompt(rec["lyrics"], rec["language"])],
        ref_text.LYRIC_MAX_LEN)
    T = frames_of(rec["duration_s"])
    c = dit["audio_acoustic_hidden_dim"]
    g = torch.Generator(device).manual_seed(int(rec["seed"]))
    noise = torch.randn((T, c), generator=g, device=device,
                        dtype=getattr(torch, conf["dtype"])).float()[None]

    def dev(a):
        return torch.as_tensor(a, device=device)

    return dict(text=dev(text), text_mask=dev(text_m), lyric=dev(lyric),
                lyric_mask=dev(lyric_m),
                refer=torch.zeros((1, REFER_FRAMES, dit["timbre_hidden_dim"]),
                                  device=device),
                src=torch.zeros((1, T, c), device=device), noise=noise,
                schedule=turbo_schedule(rec["shift"], rec["steps"]))


class Reference:
    """The float32 reference (or, with `fp8`, the control) of one run's
    configuration and weights."""

    def __init__(self, conf: dict, seed: int, device, fp8: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.conf, self.device = conf, device
        served = getattr(torch, conf["dtype"])
        self.W = weights.widen(weights.draw(ref_dit.param_shapes(conf["dit"]),
                                            seed, "dit", device, served))
        self.V = weights.widen(weights.draw(ref_vae.param_shapes(conf["vae"]),
                                            seed, "vae", device, served))
        if fp8:
            self.W, self.V = fp8_rounded(self.W), fp8_rounded(self.V)
        gib = (torch.cuda.get_device_properties(device).total_memory / 2**30
               if torch.device(device).type == "cuda" else 0.0)
        self.tier_chunk = ref_vae.tier_decode_chunk(gib)

    @torch.no_grad()
    def latents(self, rec: dict) -> np.ndarray:
        x = ref_dit.latents(self.W, self.conf["dit"],
                            **request_inputs(self.conf, rec, self.device))
        T = int(rec["duration_s"] * 25)
        return x[0, :T].cpu().numpy()

    @torch.no_grad()
    def song(self, lat: np.ndarray, duration_s: float) -> np.ndarray:
        z = torch.as_tensor(np.asarray(lat, np.float32), device=self.device)[None]
        audio = ref_vae.decode_song(self.V, self.conf["vae"], z, self.tier_chunk)
        n = int(duration_s * 25) * ref_vae.hop(self.conf["vae"])
        return ref_vae.peak_normalize(audio[0, :n])


def judge(conf: dict, seed: int, records: List[dict], songs: Dict[int, tuple],
          device, k: int, renders: List[tuple] = (), produced=None) -> dict:
    """The numbers `correct` compares, for the program's songs (`songs`:
    seed -> (audio, latents, path); `renders`: the seeds of each render);
    `produced` replaces the program with another producer (record ->
    (audio, latents, path)) judged the same way."""
    picked = sample(records, seed, k, renders)
    ref = Reference(conf, seed, device)
    latent_err = audio_err = 0.0
    for rec in picked:
        audio, lat, _path = songs[rec["seed"]] if produced is None \
            else produced(rec)
        want = ref.latents(rec)
        latent_err = max(latent_err, rel(lat, want))
        audio_err = max(audio_err,
                        rel(audio, ref.song(want, rec["duration_s"])))
    saved_bad = sum(1 for r in records if r["ok"] and (
        r["seed"] not in songs
        or not saved_ok(r["file"], songs[r["seed"]][0])))
    return {"latent_err": latent_err if picked else float("inf"),
            "audio_err": audio_err if picked else float("inf"),
            "missing": sum(1 for r in records if not r["ok"]),
            "saved_bad": saved_bad if produced is None else 0,
            "sampled": len(picked)}


def control(conf: dict, mix: dict, seed: int, seconds: float, device) -> dict:
    """The control's numbers on the requests a run of `seed` would judge:
    the fp8 reference produces each sampled request's latents and song."""
    reqs = traffic.requests(mix, seed, seconds, count=12)
    records = [drivers._record(r, ok=True) for r in reqs]
    ctl = Reference(conf, seed, device, fp8=True)

    def produced(rec):
        lat = ctl.latents(rec)
        return ctl.song(lat, rec["duration_s"]), lat, None

    return judge(conf, seed, records, {}, device, k=mix["correct_sample"],
                 produced=produced)


# -------------------------------------------------------------- counting

def request_flops(conf: dict, rec: dict) -> float:
    """The analytic FLOPs of one completed song (counts.request_flops at
    the song's own prompt buckets and frames)."""
    dit = conf["dit"]
    text = ref_text.caption_prompt(rec["caption"], rec["duration_s"])
    lyric = ref_text.lyric_prompt(rec["lyrics"], rec["language"])
    return counts.request_flops(
        dit, conf["vae"], frames=int(rec["duration_s"] * 25),
        steps=rec["steps"],
        text_len=ref_text.padded_len(len(text.encode()), ref_text.TEXT_MAX_LEN),
        lyric_len=ref_text.padded_len(len(lyric.encode()),
                                      ref_text.LYRIC_MAX_LEN),
        refer_frames=dit["timbre_fix_frame"])
