"""Whether what the timed path produced is right.

Once the window has closed, the peak memory has been read and the
program's state is freed, a sample of the completed requests, drawn from
the run's seed, is worked out again by the plain float32 reference in
`perfbench/reference/` from what the client sent (caption, lyrics,
duration, seed) and the seeded weights, with TF32 off:

- `latent_err`: the largest, over the sample, relative L2 gap between the
  program's latents and the reference's (condition encoder, cross K/V,
  8-step DiT trajectory: K1's path);
- `audio_err`: the largest relative L2 gap between the program's song and
  the reference's, decoded by the reference VAE from the reference's own
  latents through the same decode plan, int16 transfer and peak
  normalisation (K4's path, on top of the DiT's);
- `missing`: requests due in the window that failed or never came back;
- `saved_bad`: songs whose file is missing or does not hold the song (a
  WAV's samples compared one by one; a FLAC's STREAMINFO: rate, channels,
  samples and the MD5 of the 16-bit samples).

The sample holds every song of one render drawn from the seed among the
largest the program formed (each slot of a fused group), the longest
song, and songs drawn from the seed up to the mix's `correct_sample`.

The control (`control.py`) is the same reference with every weight
rounded to fp8 e4m3 (a scale per output channel), judged the same way.
"""

from __future__ import annotations

import hashlib
import os
import random
import wave
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import weights
from reference import dit as ref_dit
from reference import text as ref_text
from reference import vae as ref_vae


def turbo_schedule(shift: float, steps: int) -> tuple:
    """The turbo model's discrete timesteps: t = 1 - i / steps, shifted
    to shift * t / (1 + (shift - 1) * t)."""
    ts = [1.0 - i / steps for i in range(steps)]
    return tuple(shift * t / (1.0 + (shift - 1.0) * t) for t in ts)


REFER_FRAMES = 750      # the timbre reference: 30 s of silence latents
FRAME_BUCKET, MIN_FRAMES = 250, 128


def frames_of(duration_s: float) -> int:
    """The padded latent length of a song of `duration_s` seconds."""
    T = max(int(duration_s * 25), MIN_FRAMES)
    return -(-T // FRAME_BUCKET) * FRAME_BUCKET


def rel(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b||; infinite when the shapes differ or either side
    is not finite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def sample(records: List[dict], seed: int, k: int,
           renders: List[tuple] = ()) -> List[dict]:
    """Every song of one render drawn from the seed among the largest
    whose songs all completed, the longest song, then songs drawn from
    the seed until `k` are picked."""
    done = {r["seed"]: r for r in records if r["ok"]}
    if not done:
        return []
    rng = random.Random(int(seed) ^ 0xC0FFEE)
    whole = [g for g in renders if all(s in done for s in g)]
    top = max((len(g) for g in whole), default=0)
    picked = [done[s] for s in rng.choice([g for g in whole
                                           if len(g) == top])] if whole else []
    longest = max(done.values(), key=lambda r: (r["duration_s"], r["seed"]))
    if longest not in picked:
        picked.append(longest)
    rest = [r for r in done.values() if r not in picked]
    return picked + rng.sample(rest, max(0, min(k - len(picked), len(rest))))


def saved_ok(path: Optional[str], audio: np.ndarray) -> bool:
    """The song's file exists and holds this song: a WAV's 16-bit samples
    are the song's, clipped and scaled by 32767, sample for sample; a
    FLAC's STREAMINFO names 48 kHz, the song's channels and samples, and
    the MD5 of those 16-bit samples."""
    if not path or not os.path.exists(path):
        return False
    audio = np.asarray(audio, np.float32)
    if path.endswith(".wav"):
        pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
        with wave.open(path, "rb") as f:
            return (f.getframerate() == 48_000 and f.getsampwidth() == 2
                    and f.getnchannels() == pcm.shape[1]
                    and f.readframes(f.getnframes()) == pcm.tobytes())
    with open(path, "rb") as f:
        head = f.read(42)
    if head[:4] != b"fLaC" or len(head) < 42:
        return False
    info = head[8:42]
    packed = int.from_bytes(info[10:18], "big")
    rate = packed >> 44
    channels = ((packed >> 41) & 0x7) + 1
    samples = packed & ((1 << 36) - 1)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
    return (rate == 48_000 and channels == pcm.shape[1]
            and samples == pcm.shape[0]
            and info[18:34] == hashlib.md5(pcm.tobytes()).digest())


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


def fp8_rounded(W: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every matrix and conv weight rounded to float8 e4m3 with one scale
    an output channel (absmax / 448); norms, biases and tables kept."""
    out = {}
    for k, w in W.items():
        if k.endswith(".weight") and w.dim() >= 2:
            flat = w.reshape(w.shape[0], -1)
            s = flat.abs().amax(1, keepdim=True).clamp_min(1e-12) / 448.0
            q = (flat / s).to(torch.float8_e4m3fn).float() * s
            out[k] = q.reshape(w.shape)
        else:
            out[k] = w
    return out


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
