"""Interactive dataset session: scan -> review/edit -> label -> save -> tensors.

Port of `acestep_tpu/training/dataset_session.py` (the reference's
dataset-editing workflow: the routes of its api/train_api_dataset_service.py
over training/dataset_builder_modules/{models,metadata,scan,label_all,
update_sample,preprocess_utils}.py): a user scans a directory into an
in-memory dataset, reviews and edits individual samples over REST/studio,
auto-labels with the in-stack planner LM, persists the dataset as JSON, and
preprocesses it to training tensors.

This complements the batch-oriented `DatasetBuildPipeline`
(dataset_builder.py): the pipeline is one-shot and per-file-resumable; the
session is stateful and editable. Both converge on the same
`training.preprocess.preprocess_samples` tensor writer.

The dataset JSON (`{"metadata": {...}, "samples": [...]}`) keeps the
reference's and the JAX package's field names, so a dataset saved by
either package, or labeled by the reference's Gradio dataset tab, loads in
the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import struct
import wave
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from acestep_torch.constants import SAMPLE_RATE
from acestep_torch.training.dataset_builder import AUDIO_EXTENSIONS
from acestep_torch.utils.audio import load_audio

INSTRUMENTAL_LYRICS = "[Instrumental]"


def audio_duration_s(path: str) -> float:
    """Cheap duration probe: header-only for wav/flac, ffprobe when
    present, full decode as the last resort (matches the reference's
    librosa.get_duration at scan time, dataset_builder_modules/scan.py)."""
    low = path.lower()
    try:
        if low.endswith(".wav"):
            with wave.open(path, "rb") as f:
                return f.getnframes() / float(f.getframerate() or 1)
        if low.endswith(".flac"):
            with open(path, "rb") as f:
                if f.read(4) == b"fLaC":
                    # STREAMINFO is always the first metadata block:
                    # 1-byte header, 3-byte length, then the 34-byte body;
                    # sample rate = 20 bits at byte 10, total samples =
                    # the low 36 bits of bytes 13..21
                    f.read(4)
                    body = f.read(34)
                    sr = (body[10] << 12) | (body[11] << 4) | (body[12] >> 4)
                    total = ((body[13] & 0x0F) << 32) | struct.unpack(
                        ">I", body[14:18])[0]
                    if sr:
                        return total / float(sr)
    except (OSError, wave.Error, struct.error, IndexError):
        pass
    try:
        import shutil
        import subprocess
        ffprobe = shutil.which("ffprobe")
        if ffprobe:
            out = subprocess.run(
                [ffprobe, "-v", "error", "-show_entries", "format=duration",
                 "-of", "csv=p=0", path],
                capture_output=True, text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    try:
        return load_audio(path).shape[0] / float(SAMPLE_RATE)
    except Exception:
        return 0.0


@dataclass
class Sample:
    """One dataset sample (reference AudioSample,
    dataset_builder_modules/models.py:15-98 — same field names so dataset
    JSONs interchange)."""

    id: str = ""
    audio_path: str = ""
    filename: str = ""
    caption: str = ""
    genre: str = ""
    lyrics: str = INSTRUMENTAL_LYRICS
    raw_lyrics: str = ""          # user-provided (sidecar .txt)
    formatted_lyrics: str = ""    # LM-normalized
    bpm: Optional[int] = None
    keyscale: str = ""
    timesignature: str = ""
    duration: int = 0
    language: str = "unknown"
    is_instrumental: bool = True
    custom_tag: str = ""
    labeled: bool = False
    prompt_override: Optional[str] = None   # None | "caption" | "genre"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Sample":
        valid = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in valid})

    # -- training prompt (reference models.py:54-88) -------------------

    def _tagged(self, text: str, tag_position: str) -> str:
        if not self.custom_tag:
            return text
        if tag_position == "prepend":
            return f"{self.custom_tag}, {text}" if text else self.custom_tag
        if tag_position == "append":
            return f"{text}, {self.custom_tag}" if text else self.custom_tag
        if tag_position == "replace":
            return self.custom_tag
        return text

    def get_full_caption(self, tag_position: str = "prepend") -> str:
        return self._tagged(self.caption, tag_position)

    def get_full_genre(self, tag_position: str = "prepend") -> str:
        return self._tagged(self.genre, tag_position)

    def get_training_prompt(self, tag_position: str = "prepend",
                            use_genre: bool = False) -> str:
        if self.prompt_override == "genre":
            return self.get_full_genre(tag_position)
        if self.prompt_override == "caption":
            return self.get_full_caption(tag_position)
        if use_genre:
            return self.get_full_genre(tag_position)
        return self.get_full_caption(tag_position)

    def has_raw_lyrics(self) -> bool:
        return bool(self.raw_lyrics and self.raw_lyrics.strip())


@dataclass
class SessionMetadata:
    """Dataset-level metadata (reference DatasetMetadata,
    models.py:101-116)."""

    name: str = "untitled_dataset"
    custom_tag: str = ""
    tag_position: str = "prepend"
    created_at: str = field(default_factory=lambda: datetime.now().isoformat())
    num_samples: int = 0
    all_instrumental: bool = True
    genre_ratio: int = 0          # % of samples trained on genre prompts

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SessionMetadata":
        valid = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in valid})


def select_genre_indices(n: int, genre_ratio: int) -> set:
    """Deterministic genre/caption split (reference preprocess_utils.py:7-13
    — seeded shuffle so re-preprocessing keeps the same assignment)."""
    num_genre = int(n * genre_ratio / 100)
    order = list(range(n))
    random.Random(42).shuffle(order)
    return set(order[:num_genre])


class DatasetSession:
    """Stateful, editable dataset: the object behind /v1/dataset/{scan,
    load,save,samples,sample,auto_label,preprocess}."""

    def __init__(self) -> None:
        self.metadata = SessionMetadata()
        self.samples: List[Sample] = []
        self.json_path: Optional[str] = None   # last scan/load/save target

    # -- scan / load / save --------------------------------------------

    def scan_directory(self, audio_dir: str) -> int:
        """Find audio files (+ sidecar `<stem>.txt` raw lyrics and
        `<stem>.json` metadata) and reset the session to them."""
        if not os.path.isdir(audio_dir):
            raise FileNotFoundError(f"audio_dir not found: {audio_dir}")
        samples: List[Sample] = []
        for root, _dirs, files in os.walk(audio_dir):
            for name in sorted(files):
                if not name.lower().endswith(AUDIO_EXTENSIONS):
                    continue
                path = os.path.join(root, name)
                s = Sample(audio_path=path, filename=name,
                           duration=int(round(audio_duration_s(path))))
                # content-sensitive id (same scheme as the staged
                # pipeline): replacing the file invalidates its tensors
                try:
                    st = os.stat(path)
                    sig = f"{path}|{st.st_size}|{int(st.st_mtime)}"
                except OSError:
                    sig = path
                s.id = hashlib.sha1(sig.encode("utf-8")).hexdigest()[:12]
                stem = os.path.splitext(path)[0]
                txt = stem + ".txt"
                if os.path.exists(txt):
                    try:
                        with open(txt, "r", encoding="utf-8") as f:
                            s.raw_lyrics = f.read().strip()
                    except OSError:
                        pass
                meta = stem + ".json"
                if os.path.exists(meta):
                    try:
                        with open(meta, "r", encoding="utf-8") as f:
                            side = json.load(f)
                        s.caption = str(side.get("caption", s.caption))
                        s.genre = str(side.get("genre", s.genre))
                        lang = side.get("vocal_language") or side.get(
                            "language")
                        if lang:
                            s.language = str(lang)
                        metas = side.get("metas") or {}
                        if isinstance(metas, dict):
                            if metas.get("bpm"):
                                try:
                                    s.bpm = int(metas["bpm"])
                                except (TypeError, ValueError):
                                    pass
                            s.keyscale = str(
                                metas.get("keyscale", s.keyscale))
                            s.timesignature = str(
                                metas.get("timesignature", s.timesignature))
                        if side.get("lyrics"):
                            s.raw_lyrics = s.raw_lyrics or str(side["lyrics"])
                    except (OSError, ValueError):
                        pass
                if s.has_raw_lyrics():
                    s.is_instrumental = False
                    s.lyrics = s.raw_lyrics
                samples.append(s)
        if not samples:
            raise FileNotFoundError(f"no audio files under {audio_dir}")
        self.samples = samples
        self.metadata.num_samples = len(samples)
        self.json_path = os.path.join(
            audio_dir, f"{self.metadata.name}.json")
        self.set_all_instrumental(self.metadata.all_instrumental)
        if self.metadata.custom_tag:
            self.set_custom_tag(self.metadata.custom_tag,
                                self.metadata.tag_position)
        return len(samples)

    def load(self, dataset_path: str) -> int:
        with open(dataset_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        self.metadata = SessionMetadata.from_dict(data.get("metadata") or {})
        self.samples = [Sample.from_dict(d) for d in data.get("samples", [])]
        self.metadata.num_samples = len(self.samples)
        self.json_path = dataset_path
        return len(self.samples)

    def save(self, save_path: str) -> str:
        self.metadata.num_samples = len(self.samples)
        payload = {"metadata": self.metadata.to_dict(),
                   "samples": [s.to_dict() for s in self.samples]}
        parent = os.path.dirname(os.path.abspath(save_path))
        os.makedirs(parent, exist_ok=True)
        tmp = save_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, ensure_ascii=False)
        os.replace(tmp, save_path)
        self.json_path = save_path
        return save_path

    # -- dataset-wide edits (reference metadata.py) ---------------------

    def set_custom_tag(self, custom_tag: str,
                       tag_position: str = "prepend") -> None:
        self.metadata.custom_tag = custom_tag
        self.metadata.tag_position = tag_position
        for s in self.samples:
            s.custom_tag = custom_tag

    def set_all_instrumental(self, is_instrumental: bool) -> None:
        """Samples with user lyrics stay vocal; the rest follow the flag
        (reference metadata.py:15-29)."""
        self.metadata.all_instrumental = is_instrumental
        for s in self.samples:
            if s.has_raw_lyrics():
                s.is_instrumental = False
                if not s.lyrics or s.lyrics == INSTRUMENTAL_LYRICS:
                    s.lyrics = s.raw_lyrics
            else:
                s.is_instrumental = is_instrumental
                if is_instrumental:
                    s.lyrics = INSTRUMENTAL_LYRICS
                    s.language = "unknown"

    def update_sample(self, idx: int, fields: Dict[str, Any]) -> Sample:
        if not 0 <= idx < len(self.samples):
            raise IndexError(f"sample index {idx} out of range")
        s = self.samples[idx]
        editable = {"caption", "genre", "prompt_override", "lyrics", "bpm",
                    "keyscale", "timesignature", "language",
                    "is_instrumental"}
        for k, v in fields.items():
            if k not in editable:
                continue
            if k == "bpm":
                v = int(v) if v not in (None, "") else None
            setattr(s, k, v)
        return s

    def labeled_count(self) -> int:
        return sum(1 for s in self.samples if s.labeled)

    def serialize_samples(self) -> List[Dict[str, Any]]:
        return [{"index": i, **s.to_dict()}
                for i, s in enumerate(self.samples)]

    # -- labeling --------------------------------------------------------

    def label_all(self, dit_handler, llm_handler=None, *,
                  skip_metas: bool = False,
                  format_lyrics: bool = False,
                  transcribe_lyrics: bool = False,
                  only_unlabeled: bool = False,
                  max_seconds: float = 30.0,
                  external_labelers: Optional[List[Any]] = None,
                  progress_callback: Optional[Callable[[str], None]] = None,
                  sample_labeled_callback: Optional[
                      Callable[[int, Sample, str], None]] = None,
                  ) -> str:
        """Auto-label the session's samples in place.

        Mirrors the reference's label_all_samples surface
        (dataset_builder_modules/label_all.py via
        train_api_dataset_service.py:292-312): caption+genre+metas from
        the in-stack LM (audio -> 5 Hz codes -> understand), lyrics
        transcription from key-gated external services when
        `transcribe_lyrics`, LM lyric normalization when `format_lyrics`.
        Returns a status string; per-sample progress via the callbacks.
        """
        targets = [(i, s) for i, s in enumerate(self.samples)
                   if not (only_unlabeled and s.labeled and s.caption)]
        if not targets:
            return "All samples already labeled"
        if external_labelers is None and transcribe_lyrics:
            from acestep_torch.training.labeling import resolve_labelers
            external_labelers = resolve_labelers()
        external_labelers = external_labelers or []
        n_ok = 0
        for k, (i, s) in enumerate(targets):
            if progress_callback:
                progress_callback(f"Labeling {k + 1}/{len(targets)}: "
                                  f"{s.filename}")
            status = "✅ labeled"
            try:
                meta: Dict[str, Any] = {}
                if llm_handler is not None:
                    audio = load_audio(s.audio_path)
                    audio = audio[: int(max_seconds * SAMPLE_RATE)]
                    codes = dit_handler.audio_to_codes(np.asarray(audio))
                    meta = llm_handler.understand(codes, seed=i) or {}
                if meta.get("caption"):
                    s.caption = str(meta["caption"])
                genres = meta.get("genres") or meta.get("genre")
                if genres:
                    s.genre = (", ".join(genres)
                               if isinstance(genres, (list, tuple))
                               else str(genres))
                if not skip_metas:
                    if meta.get("bpm"):
                        try:
                            s.bpm = int(float(meta["bpm"]))
                        except (TypeError, ValueError):
                            pass
                    if meta.get("keyscale"):
                        s.keyscale = str(meta["keyscale"])
                    if meta.get("timesignature"):
                        s.timesignature = str(meta["timesignature"])
                    if meta.get("language") and not s.has_raw_lyrics():
                        s.language = str(meta["language"])
                if transcribe_lyrics and not s.has_raw_lyrics():
                    for svc in external_labelers:
                        try:
                            ext = svc.label(s.audio_path) or {}
                        except Exception:
                            continue
                        if ext.get("lyrics"):
                            s.raw_lyrics = str(ext["lyrics"])
                            s.is_instrumental = False
                            s.lyrics = s.raw_lyrics
                            if ext.get("vocal_language"):
                                s.language = str(ext["vocal_language"])
                            break
                if format_lyrics and s.has_raw_lyrics() \
                        and llm_handler is not None:
                    try:
                        out = llm_handler.format_sample(
                            caption=s.caption, lyrics=s.raw_lyrics,
                            seed=i) or {}
                        if out.get("lyrics"):
                            s.formatted_lyrics = str(out["lyrics"])
                            s.lyrics = s.formatted_lyrics
                    except Exception:
                        pass    # formatting is best-effort; raw stays
                if not s.caption:
                    s.caption = os.path.splitext(
                        s.filename)[0].replace("_", " ")
                    status = "✅ labeled (filename caption fallback)"
                s.labeled = True
                n_ok += 1
            except Exception as e:   # per-sample fail-soft, like the ref
                status = f"⚠️ failed: {e}"
            if sample_labeled_callback:
                sample_labeled_callback(i, s, status)
        return f"Labeled {n_ok}/{len(targets)} samples"

    # -- tensors ----------------------------------------------------------

    def to_manifest_entries(self) -> List[Dict[str, Any]]:
        """Session -> preprocess_samples entries, applying the custom tag,
        per-sample prompt overrides, and the genre_ratio split."""
        use_genre = select_genre_indices(len(self.samples),
                                         self.metadata.genre_ratio)
        entries = []
        for i, s in enumerate(self.samples):
            metas: Dict[str, Any] = {}
            if s.bpm:
                metas["bpm"] = s.bpm
            if s.keyscale:
                metas["keyscale"] = s.keyscale
            if s.timesignature:
                metas["timesignature"] = s.timesignature
            entries.append({
                "id": s.id or f"sample_{i:05d}",
                "audio_path": s.audio_path,
                "filename": f"{s.id or f'sample_{i:05d}'}.npz",
                "caption": s.get_training_prompt(
                    self.metadata.tag_position, use_genre=i in use_genre),
                "lyrics": (INSTRUMENTAL_LYRICS if s.is_instrumental
                           else (s.lyrics or INSTRUMENTAL_LYRICS)),
                "vocal_language": s.language,
                "metas": metas,
            })
        return entries

    def preprocess(self, dit_handler, output_dir: str, *,
                   skip_existing: bool = False,
                   progress_callback: Optional[
                       Callable[[str], None]] = None) -> int:
        """Write training tensors for every sample; returns count."""
        from acestep_torch.training.preprocess import preprocess_samples

        entries = self.to_manifest_entries()
        n = 0
        it = preprocess_samples(dit_handler, entries, output_dir,
                                skip_existing=skip_existing)
        for n, _path in enumerate(it, start=1):
            if progress_callback:
                progress_callback(f"Encoding {n}/{len(entries)}")
        return n
