"""Dataset builder: raw audio directory -> training manifest + tensors.

Port of `acestep_tpu/training/dataset_builder.py` (the reference's builder
pipeline: its training/dataset_builder.py and the scan, label, caption,
manifest and tensor stages of dataset_builder_modules/). Stages:

1. scan_audio_dir: find audio files, read durations, pair sidecar metadata
   (`<name>.json` / `<name>.txt` lyrics) when present.
2. auto_label: optional LM captioning — encode audio to 5 Hz codes via the
   DiT tokenizer and ask the planner LM to 'understand' them (the reference
   shells out to whisper/gemini scripts; here the in-stack LM fills the
   same role, air-gap friendly).
3. write_manifest: dataset.json consumable by training.preprocess.
4. build: manifest -> tensor dir (training.preprocess.preprocess_samples).

On a CUDA device the encode runs the VAE encoder's C <= 256 stacks on K4
(`ops/snake_conv`, three launches an encoder pass) and the label stage the
planner's `understand`, which reaches no kernel of the port.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from acestep_torch.constants import SAMPLE_RATE
from acestep_torch.utils.audio import load_audio

AUDIO_EXTENSIONS = (".wav", ".flac", ".mp3", ".ogg", ".m4a", ".aac", ".opus")


def scan_audio_dir(audio_dir: str) -> List[Dict[str, Any]]:
    """Find audio files + sidecar metadata. Returns manifest entries."""
    entries: List[Dict[str, Any]] = []
    for root, _dirs, files in os.walk(audio_dir):
        for name in sorted(files):
            if not name.lower().endswith(AUDIO_EXTENSIONS):
                continue
            path = os.path.join(root, name)
            stem = os.path.splitext(path)[0]
            entry: Dict[str, Any] = {"audio_path": path}
            meta_path = stem + ".json"
            if os.path.exists(meta_path):
                try:
                    with open(meta_path, "r", encoding="utf-8") as f:
                        sidecar = json.load(f)
                    entry.update({k: v for k, v in sidecar.items()
                                  if k in ("caption", "lyrics", "metas",
                                           "vocal_language")})
                except (OSError, ValueError):
                    pass
            lyrics_path = stem + ".txt"
            if "lyrics" not in entry and os.path.exists(lyrics_path):
                try:
                    with open(lyrics_path, "r", encoding="utf-8") as f:
                        entry["lyrics"] = f.read().strip()
                except OSError:
                    pass
            entries.append(entry)
    # bulk CSV sidecars (reference csv_metadata.py): per-file JSON/TXT wins
    from acestep_torch.training.labeling import apply_csv_metadata
    apply_csv_metadata(entries, audio_dir)
    return entries


def _fallback_caption(audio_path: str) -> str:
    """Filename-derived caption used whenever no LM/sidecar caption exists."""
    return os.path.splitext(
        os.path.basename(audio_path))[0].replace("_", " ")


def _understand_label(llm_handler, codes) -> Dict[str, Any]:
    """LM understand() -> {caption?, metas?}; shared by auto_label and
    the staged pipeline's stage_label so the two paths cannot diverge."""
    out = llm_handler.understand(codes)
    label: Dict[str, Any] = {}
    if out.get("caption"):
        label["caption"] = out["caption"]
    metas = {k: out[k] for k in ("bpm", "keyscale", "timesignature")
             if out.get(k)}
    if metas:
        label["metas"] = metas
    return label


def auto_label(entries: List[Dict[str, Any]], dit_handler,
               llm_handler=None, *, max_seconds: float = 30.0,
               external_labelers: Optional[List[Any]] = None,
               ) -> List[Dict[str, Any]]:
    """Fill missing captions/lyrics; defaults otherwise.

    Label sources, in order (mirrors the reference's labeling breadth —
    dataset_builder_modules/label_*.py + scripts/lora_data_prepare/):
    1. `external_labelers` (labeling.resolve_labelers(): Whisper/
       ElevenLabs transcription, Gemini captioning — each gated on its
       API key, so air-gapped runs skip them),
    2. the in-stack LM (tokenize -> understand) for caption + metas,
    3. filename-derived caption fallback.

    One-shot convenience over raw audio; the staged DatasetBuildPipeline
    does the same labeling via its latents cache (stage_label) with
    per-file retry semantics."""
    if external_labelers is None:
        from acestep_torch.training.labeling import resolve_labelers
        external_labelers = resolve_labelers()
    for entry in entries:
        for svc in external_labelers:
            if entry.get("caption") and entry.get("lyrics"):
                break
            try:
                ext = svc.label(entry["audio_path"])
            except Exception:
                continue
            for k, v in ext.items():
                if v:
                    entry.setdefault(k, v)
        if entry.get("caption"):
            entry.setdefault("lyrics", "[inst]")
            continue
        label: Dict[str, Any] = {}
        if llm_handler is not None:
            try:
                audio = load_audio(entry["audio_path"])
                audio = audio[: int(max_seconds * SAMPLE_RATE)]
                codes = dit_handler.audio_to_codes(np.asarray(audio))
                label = _understand_label(llm_handler, codes)
            except Exception:
                label = {}
        if label.get("metas"):
            entry.setdefault("metas", {}).update(label["metas"])
        entry["caption"] = (label.get("caption")
                            or _fallback_caption(entry["audio_path"]))
        entry.setdefault("lyrics", "[inst]")
    return entries


def write_manifest(entries: List[Dict[str, Any]], path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entries, f, indent=2, ensure_ascii=False)
    return path


class DatasetBuildPipeline:
    """Staged, per-file-resumable builder (reference dataset_builder.py +
    dataset_builder_modules/ scan/label/preprocess stages with resume).

    Stages, each persisting incremental artifacts under out_dir:
      scan     -> scan.json (entries with stable content ids)
      encode   -> latents/<id>.npy (VAE latents, skip existing)
      label    -> labels/<id>.json (LM captioning via cached latents ->
                  codes -> understand; skip existing)
      manifest -> dataset.json + dataset_train.json / dataset_val.json
      tensors  -> tensors/<id>.npz (+ tensors_val/) reusing cached latents

    Re-running `build()` after an interruption resumes: completed per-file
    artifacts are skipped, and `build_state.json` records stage completion.
    """

    def __init__(self, audio_dir: str, out_dir: str, dit_handler,
                 llm_handler=None, *, val_fraction: float = 0.0,
                 max_frames: Optional[int] = None,
                 max_label_seconds: float = 30.0, seed: int = 0,
                 external_labelers: Optional[List[Any]] = None):
        from acestep_torch.training.preprocess import MAX_FRAMES_DEFAULT

        self.audio_dir = audio_dir
        self.out_dir = out_dir
        self.dit = dit_handler
        self.llm = llm_handler
        # None -> resolve from env at stage_label time (key-gated external
        # transcription/caption services); [] disables them explicitly
        self.external_labelers = external_labelers
        self.val_fraction = float(val_fraction)
        self.max_frames = max_frames or MAX_FRAMES_DEFAULT
        self.max_label_seconds = max_label_seconds
        self.seed = seed
        self.state_path = os.path.join(out_dir, "build_state.json")
        os.makedirs(out_dir, exist_ok=True)

    # -- state --------------------------------------------------------

    def _load_state(self) -> Dict[str, Any]:
        try:
            with open(self.state_path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"done": []}

    def _mark_done(self, stage: str) -> None:
        state = self._load_state()
        if stage not in state["done"]:
            state["done"].append(stage)
        with open(self.state_path, "w", encoding="utf-8") as f:
            json.dump(state, f, indent=1)

    @staticmethod
    def _entry_id(entry: Dict[str, Any]) -> str:
        """Content-sensitive id: path + size + mtime, so replacing a file
        at the same path invalidates its cached latents/labels/tensors
        instead of silently resuming from the old audio's artifacts."""
        import hashlib

        try:
            st = os.stat(entry["audio_path"])
            sig = f"{entry['audio_path']}|{st.st_size}|{int(st.st_mtime)}"
        except OSError:
            sig = entry["audio_path"]
        return hashlib.sha1(sig.encode("utf-8")).hexdigest()[:12]

    def status(self) -> Dict[str, Any]:
        """Per-stage progress (drives the studio dataset tab)."""
        state = self._load_state()
        entries = self._entries() if os.path.exists(
            os.path.join(self.out_dir, "scan.json")) else []
        n = len(entries)
        lat_dir = os.path.join(self.out_dir, "latents")
        lab_dir = os.path.join(self.out_dir, "labels")
        tens_dir = os.path.join(self.out_dir, "tensors")
        count = (lambda d, suf: len([f for f in os.listdir(d)
                                     if f.endswith(suf)
                                     and ".tmp" not in f])
                 if os.path.isdir(d) else 0)
        return {
            "stages_done": state["done"],
            "num_files": n,
            "encoded": count(lat_dir, ".npy"),
            "labeled": count(lab_dir, ".json"),
            "tensors": count(tens_dir, ".npz"),
        }

    # -- stages -------------------------------------------------------

    def _entries(self) -> List[Dict[str, Any]]:
        with open(os.path.join(self.out_dir, "scan.json"),
                  "r", encoding="utf-8") as f:
            return json.load(f)

    def stage_scan(self) -> List[Dict[str, Any]]:
        entries = scan_audio_dir(self.audio_dir)
        if not entries:
            raise FileNotFoundError(f"no audio files under {self.audio_dir}")
        for e in entries:
            e["id"] = self._entry_id(e)
        with open(os.path.join(self.out_dir, "scan.json"), "w",
                  encoding="utf-8") as f:
            json.dump(entries, f, indent=1, ensure_ascii=False)
        self._mark_done("scan")
        return entries

    def stage_encode(self) -> int:
        lat_dir = os.path.join(self.out_dir, "latents")
        os.makedirs(lat_dir, exist_ok=True)
        # orphaned temp files from a crashed encode would otherwise live
        # forever (and the legacy '.tmp.npy' suffix inflated status counts)
        for name in os.listdir(lat_dir):
            if name.endswith(".tmp") or name.endswith(".tmp.npy"):
                try:
                    os.remove(os.path.join(lat_dir, name))
                except OSError:
                    pass
        n_new = 0
        for e in self._entries():
            path = os.path.join(lat_dir, f"{e['id']}.npy")
            if os.path.exists(path):
                continue
            audio = load_audio(e["audio_path"])
            latents = self.dit.encode_audio(
                np.asarray(audio))[: self.max_frames]
            tmp = path + ".tmp"     # atomic + resume-safe; np.save to an
            with open(tmp, "wb") as f:   # open handle keeps this suffix
                np.save(f, np.asarray(latents, np.float32))
            os.replace(tmp, path)
            n_new += 1
        self._mark_done("encode")
        return n_new

    def stage_label(self) -> int:
        lab_dir = os.path.join(self.out_dir, "labels")
        lat_dir = os.path.join(self.out_dir, "latents")
        os.makedirs(lab_dir, exist_ok=True)
        n_new = 0
        from acestep_torch.constants import LATENT_RATE
        from acestep_torch.training.labeling import resolve_labelers
        max_label_frames = int(self.max_label_seconds * LATENT_RATE)
        external = resolve_labelers() if self.external_labelers is None \
            else self.external_labelers
        for e in self._entries():
            path = os.path.join(lab_dir, f"{e['id']}.json")
            if os.path.exists(path):
                continue
            needs_caption = not e.get("caption")
            needs_lyrics = not e.get("lyrics")
            if not (needs_caption or needs_lyrics):
                continue
            label: Dict[str, Any] = {}
            # external transcription/caption services first (reference
            # scripts/lora_data_prepare/ quality tier), each key-gated
            for svc in external:
                try:
                    ext = svc.label(e["audio_path"])
                except Exception:
                    continue
                for k, v in ext.items():
                    if v and k not in e:
                        label.setdefault(k, v)
            if needs_caption and not label.get("caption") \
                    and self.llm is not None:
                try:
                    latents = np.load(
                        os.path.join(lat_dir, f"{e['id']}.npy"))
                    codes = self.dit.latents_to_codes(
                        latents[:max_label_frames])
                    label.update({k: v for k, v in _understand_label(
                        self.llm, codes).items() if k not in label})
                except Exception:
                    # transient LM failure: if nothing else labeled this
                    # entry, leave NO label file so the next build()
                    # retries instead of baking an empty label forever
                    pass
            if not label:
                continue    # nothing usable; retry next build
            with open(path, "w", encoding="utf-8") as f:
                json.dump(label, f, ensure_ascii=False)
            n_new += 1
        self._mark_done("label")
        return n_new

    def stage_manifest(self) -> Dict[str, str]:
        lab_dir = os.path.join(self.out_dir, "labels")
        entries = self._entries()
        for e in entries:
            lab_path = os.path.join(lab_dir, f"{e['id']}.json")
            if os.path.exists(lab_path):
                try:
                    with open(lab_path, "r", encoding="utf-8") as f:
                        label = json.load(f)
                    for k, v in label.items():
                        e.setdefault(k, v)
                except (OSError, ValueError):
                    pass
            if not e.get("caption"):
                e["caption"] = _fallback_caption(e["audio_path"])
            e.setdefault("lyrics", "[inst]")
        paths = {"manifest": write_manifest(
            entries, os.path.join(self.out_dir, "dataset.json"))}
        if self.val_fraction > 0 and len(entries) > 1:
            import random as _random

            order = list(entries)
            _random.Random(self.seed).shuffle(order)
            n_val = max(1, int(len(order) * self.val_fraction))
            paths["manifest_val"] = write_manifest(
                order[:n_val], os.path.join(self.out_dir,
                                            "dataset_val.json"))
            paths["manifest_train"] = write_manifest(
                order[n_val:], os.path.join(self.out_dir,
                                            "dataset_train.json"))
        self._mark_done("manifest")
        return paths

    def _cond_sig(self, entry: Dict[str, Any]) -> str:
        """Hash of everything that flows into a tensor file BESIDES the
        audio latents (those are keyed by the content-sensitive entry id).
        stage_tensors compares this against a sidecar to invalidate stale
        .npz files — otherwise skip_existing would bake the first-ever
        caption in forever, defeating stage_label's retry design (a label
        that succeeds on build N+1 must reach the training tensors)."""
        import hashlib

        payload = json.dumps(
            {"caption": entry.get("caption", ""),
             "lyrics": entry.get("lyrics", ""),
             "metas": entry.get("metas") or {},
             "vocal_language": entry.get("vocal_language", ""),
             "max_frames": self.max_frames},
            sort_keys=True, ensure_ascii=False)
        return hashlib.sha1(payload.encode("utf-8")).hexdigest()

    def stage_tensors(self) -> Dict[str, int]:
        from acestep_torch.training.preprocess import (
            load_manifest, preprocess_samples)

        lat_dir = os.path.join(self.out_dir, "latents")
        counts = {}
        # stage_manifest only writes split files when there are >=2
        # entries; a single-file dataset with val_fraction>0 must still
        # build tensors from dataset.json (not silently build nothing)
        train_manifest = "dataset_train.json"
        if not (self.val_fraction > 0 and os.path.exists(
                os.path.join(self.out_dir, train_manifest))):
            train_manifest = "dataset.json"
        splits = [("tensors", train_manifest)]
        if self.val_fraction > 0:
            splits.append(("tensors_val", "dataset_val.json"))
        for sub, manifest_name in splits:
            manifest_path = os.path.join(self.out_dir, manifest_name)
            if not os.path.exists(manifest_path):
                continue
            samples = load_manifest(manifest_path)
            out_sub = os.path.join(self.out_dir, sub)
            sigs = {}
            for s in samples:
                s["latents_path"] = os.path.join(lat_dir, f"{s['id']}.npy")
                s["filename"] = f"{s['id']}.npz"
                # invalidate tensors whose conditioning changed since they
                # were built (late LM label, edited sidecar caption, ...)
                sig = sigs[s["id"]] = self._cond_sig(s)
                npz_path = os.path.join(out_sub, s["filename"])
                sig_path = os.path.join(out_sub, f"{s['id']}.sig")
                if os.path.exists(npz_path):
                    try:
                        with open(sig_path, "r", encoding="utf-8") as f:
                            old_sig = f.read().strip()
                    except OSError:
                        old_sig = None
                    if old_sig != sig:
                        os.remove(npz_path)
            out = list(preprocess_samples(
                self.dit, samples, out_sub,
                max_frames=self.max_frames, skip_existing=True))
            for s in samples:   # record what each .npz was built from
                sig_path = os.path.join(out_sub, f"{s['id']}.sig")
                with open(sig_path, "w", encoding="utf-8") as f:
                    f.write(sigs[s["id"]])
            counts[sub] = len(out)
        self._mark_done("tensors")
        return counts

    def build(self, device_lock=None) -> Dict[str, Any]:
        """Run all stages (resuming per-file work already on disk). The
        stages that call the handler or the planner (encode, label,
        tensors) each run whole under `device_lock` when one is given."""
        lock = device_lock or contextlib.nullcontext()
        self.stage_scan()
        with lock:
            self.stage_encode()
        with lock:
            self.stage_label()
        manifests = self.stage_manifest()
        with lock:
            counts = self.stage_tensors()
        return {
            "manifest": manifests["manifest"],
            "manifest_train": manifests.get("manifest_train"),
            "manifest_val": manifests.get("manifest_val"),
            "tensor_dir": os.path.join(self.out_dir, "tensors"),
            "tensor_dir_val": (os.path.join(self.out_dir, "tensors_val")
                               if "tensors_val" in counts else None),
            "num_samples": counts.get("tensors", 0),
            "num_val": counts.get("tensors_val", 0),
        }


def build_dataset(audio_dir: str, out_dir: str, dit_handler,
                  llm_handler=None, *, val_fraction: float = 0.0,
                  **pipeline_kwargs) -> Dict[str, Any]:
    """One command: raw audio directory -> manifest + training tensors.

    Staged + resumable (DatasetBuildPipeline); re-running after an
    interruption skips completed per-file work."""
    pipe = DatasetBuildPipeline(audio_dir, out_dir, dit_handler, llm_handler,
                                val_fraction=val_fraction, **pipeline_kwargs)
    return pipe.build()
