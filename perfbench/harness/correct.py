"""What every system's judge shares (`perfbench/systems/<system>.py`
`judge`, run once the window has closed, the peak memory has been read
and the program's state is freed):

- `sample`: the completed requests a judge works out again, drawn from
  the run's seed: every song of one render drawn among the largest the
  program formed (each slot of a fused group), the longest song, and
  songs drawn from the seed up to the mix's `correct_sample`;
- `rel`: the relative L2 gap of an answer to the reference's, infinite
  for a shape that differs or a value that is not finite;
- `saved_ok`: whether a song's file holds the song (a WAV's samples
  compared one by one; a FLAC's STREAMINFO: rate, channels, samples and
  the MD5 of the 16-bit samples);
- `fp8_rounded`: weights rounded to float8 e4m3, the control's precision
  step below the bf16 the configurations serve in.
"""

from __future__ import annotations

import hashlib
import os
import random
import wave
from typing import Dict, List, Optional

import numpy as np
import torch


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
