"""Dataset labeling services: CSV metadata + external transcription/caption.

A copy of `acestep_tpu/training/labeling.py` (the port imports nothing of
the JAX package), covering the reference's labeling breadth (its
dataset_builder_modules/csv_metadata.py and label_utils.py, and the
whisper/elevenlabs transcription and gemini caption scripts of
scripts/lora_data_prepare/):

- `load_csv_metadata`: per-directory CSV sidecar metadata (file/caption/
  bpm/key/lyrics columns, dialect-sniffed).
- Transcriber/captioner adapters behind one `Labeler` protocol:
  Whisper (OpenAI audio API), ElevenLabs STT, Gemini audio captioning —
  each gated on its API key and a pluggable HTTP transport, so tests run
  them against fakes and nothing reaches the network without a key; the
  in-stack LM labeler (acestep_torch.training.dataset_builder) is the
  no-network default.
- Word-timestamp -> lyric-lines conversion with CJK-aware joining (the
  reference's smart_join/words_to_lyrics behavior).
- `update_sample` / `export_csv`: manifest curation equivalents of the
  reference's UpdateSampleMixin / dataframe export.
"""

from __future__ import annotations

import base64
import csv
import json
import os
import urllib.request
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "load_csv_metadata", "words_to_lyrics", "smart_join",
    "WhisperTranscriber", "ElevenLabsTranscriber", "GeminiCaptioner",
    "resolve_labelers", "update_sample", "export_csv",
]


# ------------------------------------------------------------------
# CSV metadata (reference csv_metadata.load_csv_metadata)
# ------------------------------------------------------------------


_CSV_FIELDS = {
    "caption": "caption",
    "lyrics": "lyrics",
    "bpm": "bpm",
    "key": "keyscale",            # reference CSVs use `key`
    "keyscale": "keyscale",
    "timesignature": "timesignature",
    "language": "vocal_language",
}


def load_csv_metadata(directory: str) -> Dict[str, Dict[str, Any]]:
    """All `*.csv` files in `directory` -> {audio filename: metadata}.

    A CSV must have a `file` column; recognized metadata columns are
    caption / lyrics / bpm / key(scale) / timesignature / language.
    Dialect (comma/semicolon/tab) is sniffed per file."""
    metadata: Dict[str, Dict[str, Any]] = {}
    if not os.path.isdir(directory):
        return metadata
    for name in sorted(os.listdir(directory)):
        if not name.lower().endswith(".csv"):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path, "r", encoding="utf-8", newline="") as f:
                sample = f.read(4096)
                f.seek(0)
                try:
                    dialect = csv.Sniffer().sniff(sample, delimiters=",;\t")
                    reader = csv.DictReader(f, dialect=dialect)
                except csv.Error:
                    reader = csv.DictReader(f)
                if not reader.fieldnames:
                    continue
                headers = {h.lower().strip(): h for h in reader.fieldnames}
                if "file" not in headers:
                    continue
                for row in reader:
                    fname = (row.get(headers["file"]) or "").strip()
                    if not fname:
                        continue
                    entry = metadata.setdefault(os.path.basename(fname), {})
                    for col, field in _CSV_FIELDS.items():
                        h = headers.get(col)
                        if h and (row.get(h) or "").strip():
                            entry[field] = row[h].strip()
        except (OSError, UnicodeDecodeError):
            continue
    return metadata


def apply_csv_metadata(entries: List[Dict[str, Any]],
                       audio_dir: str) -> int:
    """Merge CSV metadata into scanned manifest entries (sidecar JSON/TXT
    values win — they are per-file, CSVs are bulk). Returns rows applied."""
    table = load_csv_metadata(audio_dir)
    applied = 0
    for e in entries:
        row = table.get(os.path.basename(e.get("audio_path", "")))
        if not row:
            continue
        applied += 1
        for k, v in row.items():
            if k in ("bpm", "keyscale", "timesignature"):
                metas = e.setdefault("metas", {})
                metas.setdefault(k, v)
            else:
                e.setdefault(k, v)
    return applied


# ------------------------------------------------------------------
# Word timestamps -> lyrics (reference whisper_transcription behavior)
# ------------------------------------------------------------------


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x3000 <= cp <= 0x30FF or 0x3400 <= cp <= 0x4DBF
            or 0x4E00 <= cp <= 0x9FFF or 0xF900 <= cp <= 0xFAFF
            or 0xFF00 <= cp <= 0xFFEF or 0x20000 <= cp <= 0x2FA1F)


def smart_join(words: List[str]) -> str:
    """Join words with spaces except across CJK boundaries (CJK scripts
    carry no inter-word spaces)."""
    out = ""
    for w in words:
        if not w:
            continue
        if not out:
            out = w
            continue
        if _is_cjk(out[-1]) or _is_cjk(w[0]):
            out += w
        else:
            out += " " + w
    return out.strip()


def words_to_lyrics(words: List[Dict[str, Any]],
                    line_gap: float = 1.5) -> str:
    """Word-level timestamps -> plain lyric lines: a new line starts
    wherever the inter-word silence exceeds `line_gap` seconds."""
    lines: List[List[str]] = []
    cur: List[str] = []
    prev_end: Optional[float] = None
    for w in words:
        text = (w.get("word") or w.get("text") or "").strip()
        if not text:
            continue
        start = float(w.get("start", 0.0) or 0.0)
        if prev_end is not None and start - prev_end > line_gap and cur:
            lines.append(cur)
            cur = []
        cur.append(text)
        prev_end = float(w.get("end", start) or start)
    if cur:
        lines.append(cur)
    return "\n".join(smart_join(line) for line in lines)


# ------------------------------------------------------------------
# HTTP transport (pluggable so air-gapped tests inject fakes)
# ------------------------------------------------------------------


def _default_transport(url: str, data: bytes, headers: Dict[str, str],
                       timeout: float) -> Dict[str, Any]:
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # nosec B310
        return json.loads(resp.read().decode("utf-8"))


Transport = Callable[[str, bytes, Dict[str, str], float], Dict[str, Any]]


class _HTTPLabeler:
    name = "http"
    env_key = ""

    def __init__(self, api_key: Optional[str] = None,
                 transport: Optional[Transport] = None,
                 timeout: float = 120.0):
        self.api_key = api_key or os.environ.get(self.env_key, "")
        self.transport = transport or _default_transport
        self.timeout = timeout

    @property
    def available(self) -> bool:
        return bool(self.api_key)

    @staticmethod
    def _read(audio_path: str) -> bytes:
        with open(audio_path, "rb") as f:
            return f.read()


class WhisperTranscriber(_HTTPLabeler):
    """OpenAI Whisper API transcription -> {"lyrics": ...} (the reference's
    whisper_transcription.py flow: word timestamps, gap-based lines)."""

    name = "whisper"
    env_key = "OPENAI_API_KEY"
    url = "https://api.openai.com/v1/audio/transcriptions"

    def label(self, audio_path: str) -> Dict[str, Any]:
        boundary = "acestepform"
        body = b""
        fields = {"model": "whisper-1",
                  "response_format": "verbose_json",
                  "timestamp_granularities[]": "word"}
        for k, v in fields.items():
            body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="{k}"\r\n\r\n{v}\r\n').encode()
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="file"; filename="{os.path.basename(audio_path)}"'
                 "\r\nContent-Type: application/octet-stream\r\n\r\n"
                 ).encode() + self._read(audio_path) + b"\r\n"
        body += f"--{boundary}--\r\n".encode()
        out = self.transport(
            self.url, body,
            {"Authorization": f"Bearer {self.api_key}",
             "Content-Type": f"multipart/form-data; boundary={boundary}"},
            self.timeout)
        words = out.get("words") or []
        lyrics = words_to_lyrics(words) if words else (out.get("text") or "")
        label: Dict[str, Any] = {"lyrics": lyrics}
        if out.get("language"):
            label["vocal_language"] = out["language"]
        return label


class ElevenLabsTranscriber(_HTTPLabeler):
    """ElevenLabs speech-to-text -> {"lyrics": ...}."""

    name = "elevenlabs"
    env_key = "ELEVENLABS_API_KEY"
    url = "https://api.elevenlabs.io/v1/speech-to-text"

    def label(self, audio_path: str) -> Dict[str, Any]:
        boundary = "acestepform"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                'name="model_id"\r\n\r\nscribe_v1\r\n').encode()
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="file"; filename="{os.path.basename(audio_path)}"'
                 "\r\nContent-Type: application/octet-stream\r\n\r\n"
                 ).encode() + self._read(audio_path) + b"\r\n"
        body += f"--{boundary}--\r\n".encode()
        out = self.transport(
            self.url, body,
            {"xi-api-key": self.api_key,
             "Content-Type": f"multipart/form-data; boundary={boundary}"},
            self.timeout)
        words = out.get("words") or []
        lyrics = words_to_lyrics(words) if words else (out.get("text") or "")
        label: Dict[str, Any] = {"lyrics": lyrics}
        if out.get("language_code"):
            label["vocal_language"] = out["language_code"]
        return label


class GeminiCaptioner(_HTTPLabeler):
    """Gemini audio analysis -> {"caption", "lyrics"} (the reference's
    gemini_caption.py structured-JSON prompt)."""

    name = "gemini"
    env_key = "GEMINI_API_KEY"
    url = ("https://generativelanguage.googleapis.com/v1beta/models/"
           "gemini-2.0-flash:generateContent")
    prompt = ("Analyze the input audio to generate a detailed caption and "
              "lyrics. Lyrics need structured tags for chorus, verse, "
              "bridge, etc. Output JSON: {\"caption\": <str>, "
              "\"lyrics\": \"[Verse] ...\"}")

    def label(self, audio_path: str) -> Dict[str, Any]:
        mime = {"wav": "audio/wav", "mp3": "audio/mp3", "flac": "audio/flac",
                "ogg": "audio/ogg", "aac": "audio/aac"}.get(
            audio_path.rsplit(".", 1)[-1].lower(), "audio/wav")
        payload = json.dumps({
            "contents": [{"parts": [
                {"text": self.prompt},
                {"inline_data": {
                    "mime_type": mime,
                    "data": base64.b64encode(
                        self._read(audio_path)).decode()}},
            ]}],
            "generationConfig": {"response_mime_type": "application/json"},
        }).encode()
        out = self.transport(
            f"{self.url}?key={self.api_key}", payload,
            {"Content-Type": "application/json"}, self.timeout)
        try:
            text = out["candidates"][0]["content"]["parts"][0]["text"]
            parsed = json.loads(text)
        except (KeyError, IndexError, ValueError, TypeError):
            return {}
        label = {}
        if parsed.get("caption"):
            label["caption"] = str(parsed["caption"])
        if parsed.get("lyrics"):
            label["lyrics"] = str(parsed["lyrics"])
        return label


def resolve_labelers(transport: Optional[Transport] = None) -> List[Any]:
    """Every external labeler whose API key is configured, in the
    reference's priority order (transcription first, caption second).
    Empty in air-gapped environments — the in-stack LM labeler
    (dataset_builder.auto_label) remains the default."""
    out = []
    for cls in (WhisperTranscriber, ElevenLabsTranscriber, GeminiCaptioner):
        svc = cls(transport=transport)
        if svc.available:
            out.append(svc)
    return out


# ------------------------------------------------------------------
# Manifest curation (reference UpdateSampleMixin / dataframe export)
# ------------------------------------------------------------------

_EDITABLE = ("caption", "lyrics", "metas", "vocal_language")


def update_sample(manifest_path: str, index: int, **fields) -> Dict[str, Any]:
    """Edit one manifest entry in place (atomic rewrite). Only labeling
    fields are editable; unknown fields raise so a typo cannot silently
    produce an ignored edit."""
    with open(manifest_path, "r", encoding="utf-8") as f:
        manifest = json.load(f)
    samples = manifest["samples"] if isinstance(manifest, dict) else manifest
    if not 0 <= index < len(samples):
        raise IndexError(f"sample index {index} out of range "
                         f"(have {len(samples)})")
    bad = [k for k in fields if k not in _EDITABLE]
    if bad:
        raise ValueError(f"not editable: {bad}; editable: {_EDITABLE}")
    samples[index].update(fields)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, ensure_ascii=False, indent=1)
    os.replace(tmp, manifest_path)
    return samples[index]


def export_csv(manifest_path: str, csv_path: str) -> int:
    """Manifest -> review CSV (file/caption/lyrics/bpm/keyscale/
    timesignature/language columns). Returns rows written."""
    with open(manifest_path, "r", encoding="utf-8") as f:
        manifest = json.load(f)
    samples = manifest["samples"] if isinstance(manifest, dict) else manifest
    with open(csv_path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "caption", "lyrics", "bpm", "keyscale",
                    "timesignature", "language"])
        for s in samples:
            metas = s.get("metas") or {}
            w.writerow([
                os.path.basename(s.get("audio_path", "")),
                s.get("caption", ""), s.get("lyrics", ""),
                metas.get("bpm", ""), metas.get("keyscale", ""),
                metas.get("timesignature", ""),
                s.get("vocal_language", ""),
            ])
    return len(samples)
