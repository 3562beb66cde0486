"""Dataset preprocessing: raw audio + text -> training tensor files.

Port of `acestep_tpu/training/preprocess.py`. One pass: the training step
runs the condition encoder itself, so preprocessing stores only the VAE
latents (the handler's tiled encode, on the fused Snake+conv kernel for the
encoder's C <= 256 stacks on a CUDA device) and the text/lyric embeddings
of each sample as .npz.

Sample manifest format (dataset.json):
    [{"audio_path": ..., "caption": ..., "lyrics": ...,
      "metas": {"bpm": ..., "keyscale": ..., ...} (optional),
      "vocal_language": "en" (optional)}, ...]
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List

import numpy as np

from acestep_torch.pipeline import text as textlib
from acestep_torch.utils.audio import load_audio

MAX_FRAMES_DEFAULT = 3000   # 120 s cap per training sample (v1 default window)


def load_manifest(path: str) -> List[Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError("dataset manifest must be a JSON list of samples")
    return data


def preprocess_samples(handler, samples: List[Dict[str, Any]], out_dir: str,
                       *, max_frames: int = MAX_FRAMES_DEFAULT,
                       skip_existing: bool = False) -> Iterator[str]:
    """VAE-encode (at most `max_frames` latent frames kept) and text-embed
    every sample; yields the written file paths.

    `handler` is an initialized AceStepHandler (provides encode_audio and
    text_embedder). A sample carrying precomputed `latents` (or a
    `latents_path` .npy) skips the VAE encode: the staged dataset builder
    reuses its encode stage's latents. `audio` (samples, ch) stands in for
    `audio_path`. `filename` overrides the index-based name
    (`sample_<index>.npz`); with `skip_existing` a file already written is
    yielded again, not rebuilt."""
    os.makedirs(out_dir, exist_ok=True)
    for i, sample in enumerate(samples):
        path = os.path.join(out_dir, sample.get("filename",
                                                f"sample_{i:05d}.npz"))
        if skip_existing and os.path.exists(path):
            yield path
            continue
        latents = sample.get("latents")
        if latents is None and sample.get("latents_path"):
            latents = np.load(sample["latents_path"])
        if latents is None:
            audio = sample.get("audio")
            if audio is None:
                audio = load_audio(sample["audio_path"])
            latents = handler.encode_audio(np.asarray(audio))
        latents = np.asarray(latents)[:max_frames]

        caption = sample.get("caption", "")
        lyrics = sample.get("lyrics", "")
        language = sample.get("vocal_language", "en")
        metas = sample.get("metas") or {}
        meta_str = textlib.parse_metas([metas])[0]
        instruction = textlib.resolve_instruction("text2music")
        text_prompt = textlib.build_text_prompt(instruction, caption, meta_str)
        lyric_prompt = textlib.format_lyrics(lyrics, language)

        text_h, text_m = handler.text_embedder.encode_text([text_prompt])
        lyric_h, lyric_m = handler.text_embedder.encode_lyrics([lyric_prompt])

        np.savez(
            path,
            hidden_states=np.asarray(latents, np.float32),
            text_hidden_states=np.asarray(text_h[0], np.float32),
            text_attention_mask=np.asarray(text_m[0], np.int32),
            lyric_hidden_states=np.asarray(lyric_h[0], np.float32),
            lyric_attention_mask=np.asarray(lyric_m[0], np.int32),
            caption=np.frombuffer(caption.encode("utf-8"), np.uint8),
        )
        yield path


def preprocess_audio_files(handler, manifest_path: str, out_dir: str,
                           **kwargs) -> List[str]:
    """Manifest file -> tensor dir. Returns written paths."""
    return list(preprocess_samples(handler, load_manifest(manifest_path),
                                   out_dir, **kwargs))
