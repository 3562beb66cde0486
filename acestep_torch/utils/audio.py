"""Audio I/O: load (stereo, 48 kHz), peak and loudness normalization, WAV
and FLAC save, AudioSaver, params -> UUID.

A copy of the parts of `acestep_tpu/utils/audio.py` that the port uses.
WAV is read and written with the stdlib `wave` module, FLAC with the
native codec (utils/flac.py), and audio is resampled with scipy's
polyphase filter; other formats (mp3, opus, aac, ogg, m4a) go through an
external `ffmpeg` binary when one is present.
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

from acestep_torch.constants import AUDIO_CHANNELS, SAMPLE_RATE


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


# ------------------------------------------------------------------
# Load
# ------------------------------------------------------------------


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 (frames, channels) in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, ch), sr


def _ffmpeg_decode(path, target_sr: int, target_channels: int) -> np.ndarray:
    """Decode any ffmpeg-readable file straight to clipped f32 PCM at the
    target rate/channels."""
    out = subprocess.run(
        [_ffmpeg(), "-v", "error", "-i", str(path), "-f", "f32le",
         "-ac", str(target_channels), "-ar", str(target_sr), "-"],
        capture_output=True, check=True)
    data = np.frombuffer(out.stdout, dtype="<f4").reshape(-1, target_channels)
    return np.clip(data, -1.0, 1.0)   # ffmpeg resampler overshoots too


def load_audio(path: str, *, target_sr: int = SAMPLE_RATE,
               target_channels: int = AUDIO_CHANNELS) -> np.ndarray:
    """Load audio -> float32 (frames, target_channels) at target_sr: WAV
    and 16-bit FLAC natively, anything else through ffmpeg when present."""
    p = Path(path)
    if p.suffix.lower() == ".wav":
        try:
            data, sr = load_wav(path)
        except (ValueError, wave.Error, EOFError):
            # outside the stdlib reader's surface (24-bit, IEEE-float,
            # malformed headers)
            if not _ffmpeg():
                raise
            return _ffmpeg_decode(p, target_sr, target_channels)
    elif p.suffix.lower() == ".flac":
        from acestep_torch.utils.flac import decode_flac

        try:
            with open(p, "rb") as f:
                pcm, sr = decode_flac(f.read())
            data = pcm.astype(np.float32) / 32768.0
        except ValueError:
            # outside the native decoder's surface (e.g. 24-bit streams):
            # fall through to ffmpeg when available
            if not _ffmpeg():
                raise
            return _ffmpeg_decode(p, target_sr, target_channels)
    elif _ffmpeg():
        return _ffmpeg_decode(p, target_sr, target_channels)
    else:
        raise ValueError(
            f"cannot load {p.suffix} without ffmpeg; provide a .wav file")
    data = to_channels(data, target_channels)
    if sr != target_sr:
        data = resample(data, sr, target_sr)
    # polyphase filters can overshoot +-1, and float wavs may carry
    # out-of-range samples
    return np.clip(data, -1.0, 1.0)


def to_channels(data: np.ndarray, channels: int) -> np.ndarray:
    if data.shape[1] == channels:
        return data
    if channels == 2 and data.shape[1] == 1:
        return np.repeat(data, 2, axis=1)
    if data.shape[1] > channels >= 2:
        return data[:, :channels]   # extra channels are truncated
    if channels == 1:
        return data.mean(axis=1, keepdims=True)
    return np.tile(data.mean(axis=1, keepdims=True), (1, channels))


def resample(data: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling along axis 0."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(data, sr_out // g, sr_in // g, axis=0).astype(np.float32)


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


def loudness_normalize(audio: np.ndarray, target_lufs: float = -14.0,
                       sr: int = SAMPLE_RATE) -> np.ndarray:
    """Approximate LUFS normalization via K-weighted RMS (ITU-R BS.1770's
    K-weighting and per-channel energy sum, without its gating; within
    ~0.5 LU of a gated meter on music)."""
    from scipy.signal import lfilter

    # the K-weighting biquads below are designed for 48 kHz: measure on a
    # 48 kHz copy when the input is at another rate (the gain still
    # applies to the original samples)
    measured = audio if sr == SAMPLE_RATE else resample(audio, sr,
                                                        SAMPLE_RATE)
    # K-weighting: shelving + high-pass (BS.1770 biquads at 48 kHz)
    b1 = [1.53512485958697, -2.69169618940638, 1.19839281085285]
    a1 = [1.0, -1.69065929318241, 0.73248077421585]
    b2 = [1.0, -2.0, 1.0]
    a2 = [1.0, -1.99004745483398, 0.99007225036621]
    x = lfilter(b1, a1, measured, axis=0)
    x = lfilter(b2, a2, x, axis=0)
    # loudness sums the per-channel mean-square energies (unity channel
    # weights for stereo); a cross-channel mean would under-measure stereo
    # by ~3 LU
    if x.ndim > 1:
        ms = float(np.sum(np.mean(np.square(x), axis=0)))
    else:
        ms = float(np.mean(np.square(x)))
    if ms <= 1e-12:
        return audio
    lufs = -0.691 + 10.0 * np.log10(ms)
    gain = 10.0 ** ((target_lufs - lufs) / 20.0)
    out = audio * gain
    peak = np.max(np.abs(out))
    if peak > 1.0:
        out = out / peak * 0.999
    return out.astype(np.float32)


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
    """Multi-format saver: wav/wav32/flac natively (flac through
    utils/flac.py, no ffmpeg needed); mp3/opus/aac/ogg/m4a via ffmpeg when
    available."""

    NATIVE = {"wav", "wav32", "flac"}
    FFMPEG = {"mp3", "opus", "aac", "ogg", "m4a"}

    def __init__(self, output_dir: str = "outputs",
                 default_format: str = "flac"):
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
        if fmt == "flac":
            from acestep_torch.utils.flac import encode_flac

            pcm = np.clip(np.asarray(audio, np.float32) * 32767.0,
                          -32768, 32767).astype(np.int16)
            out = self.output_dir / f"{name}.flac"
            with open(out, "wb") as f:
                f.write(encode_flac(pcm, sr))
            return str(out)
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
