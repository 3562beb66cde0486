"""Audio output: peak normalization, WAV save, AudioSaver, params -> UUID.

A copy of the parts of `acestep_tpu/utils/audio.py` that the text2music
path uses. WAV is written with the stdlib `wave` module; flac, mp3, opus,
aac, ogg and m4a go through an external `ffmpeg` binary when one is present
(the native FLAC encoder is not ported yet).
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import wave
from pathlib import Path
from typing import Optional

import numpy as np

from acestep_torch.constants import SAMPLE_RATE


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


# ------------------------------------------------------------------
# Normalize
# ------------------------------------------------------------------


def peak_normalize(audio: np.ndarray, target_dbfs: float = -1.0) -> np.ndarray:
    """Scale so the peak sits at target_dbfs (reference normalize_audio
    default -1 dBFS). Silent audio is returned unchanged."""
    peak = float(np.max(np.abs(audio)))
    if peak <= 1e-8:
        return audio
    target = 10.0 ** (target_dbfs / 20.0)
    return (audio * (target / peak)).astype(np.float32)


# ------------------------------------------------------------------
# Save
# ------------------------------------------------------------------


def save_wav(path: str, audio: np.ndarray, sr: int = SAMPLE_RATE,
             *, subtype: str = "PCM_16") -> str:
    """audio (frames, channels) float in [-1,1] -> WAV file."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if subtype == "FLOAT32":
        # stdlib wave can only write integer PCM — emit a real IEEE
        # float WAV (format tag 3) by hand rather than silently writing
        # quantized int32 under a float-sounding name
        frames, channels = audio.shape
        data = audio.astype("<f4").tobytes()
        byte_rate = sr * channels * 4
        header = (b"RIFF" + (36 + len(data)).to_bytes(4, "little") +
                  b"WAVEfmt " + (16).to_bytes(4, "little") +
                  (3).to_bytes(2, "little") +            # IEEE float
                  channels.to_bytes(2, "little") +
                  sr.to_bytes(4, "little") +
                  byte_rate.to_bytes(4, "little") +
                  (channels * 4).to_bytes(2, "little") +
                  (32).to_bytes(2, "little") +
                  b"data" + len(data).to_bytes(4, "little"))
        with open(path, "wb") as f:
            f.write(header + data)
        return str(path)
    if subtype == "PCM_16":
        pcm = (audio * 32767.0).astype("<i2")
        width = 2
    elif subtype == "PCM_32":
        pcm = (audio * 2147483647.0).astype("<i4")
        width = 4
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(audio.shape[1])
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return str(path)


class AudioSaver:
    """Multi-format saver: wav/wav32 natively; flac/mp3/opus/aac/ogg/m4a
    via ffmpeg when available."""

    NATIVE = {"wav", "wav32"}
    FFMPEG = {"flac", "mp3", "opus", "aac", "ogg", "m4a"}

    def __init__(self, output_dir: str = "outputs",
                 default_format: str = "wav"):
        self.output_dir = Path(output_dir)
        self.default_format = default_format

    def available_formats(self):
        fmts = sorted(self.NATIVE)
        if _ffmpeg():
            fmts += sorted(self.FFMPEG)
        return fmts

    def save_audio(self, audio: np.ndarray, name: str, fmt: str = "wav",
                   sr: int = SAMPLE_RATE) -> str:
        fmt = (fmt or "").lower()
        if fmt not in self.NATIVE and fmt not in self.FFMPEG:
            # unknown formats fall back to the saver default instead of
            # failing the whole job
            fmt = self.default_format
        self.output_dir.mkdir(parents=True, exist_ok=True)
        if fmt == "wav":
            return save_wav(self.output_dir / f"{name}.wav", audio, sr)
        if fmt == "wav32":
            return save_wav(self.output_dir / f"{name}.wav", audio, sr,
                            subtype="PCM_32")
        if fmt in self.FFMPEG:
            if not _ffmpeg():
                raise RuntimeError(f"{fmt} output requires ffmpeg; "
                                   f"available: {self.available_formats()}")
            tmp = self.output_dir / f"{name}.tmp.wav"
            save_wav(tmp, audio, sr)
            out = self.output_dir / f"{name}.{fmt}"
            try:
                subprocess.run([_ffmpeg(), "-v", "error", "-y", "-i",
                                str(tmp), str(out)], check=True)
            finally:
                # a failed encode must not leave the full-length
                # uncompressed temp WAV behind on a long-running server
                tmp.unlink(missing_ok=True)
            return str(out)
        raise ValueError(f"unknown format {fmt}")


# ------------------------------------------------------------------
# Params -> UUID (reference audio_utils.generate_uuid_from_params: md5 of a
# stable serialization, so identical requests reuse cache entries)
# ------------------------------------------------------------------


def generate_uuid_from_params(params: dict) -> str:
    blob = json.dumps(params, sort_keys=True, default=str).encode()
    h = hashlib.md5(blob).hexdigest()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"
