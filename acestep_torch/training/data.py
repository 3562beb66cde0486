"""Preprocessed-tensor dataset + fixed-shape batch iterator (numpy).

A copy of `acestep_tpu/training/data.py`. Batches are padded to one frame
bucket and one text/lyric length over the whole dataset, so every step has
the same shapes; the silence/timbre/src conditioning tensors the
flow-matching loss needs are synthesized here (full-song text2music
training: src = silence, chunk mask = all-ones)."""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

FRAME_BUCKET = 250


def _bucket_len(n: int, bucket: int, cap: Optional[int] = None) -> int:
    out = max(bucket, -(-n // bucket) * bucket)
    return min(out, cap) if cap else out


class PreprocessedDataset:
    """Directory of sample_*.npz files from training.preprocess.

    When the directory carries a ``manifest.json`` (``{"samples": [...]}``),
    the listed paths are used instead of the fallback ``*.npz`` scan. Each
    entry resolves relative to the tensor dir first, then against the
    global safe root for legacy cwd-relative manifests; entries that
    escape both roots or do not exist are skipped with a warning — the
    reference's data_module traversal discipline
    (`training/data_module.py:57-128`, path_safety.safe_path)."""

    def __init__(self, tensor_dir: str, val_fraction: float = 0.0,
                 seed: int = 0):
        if not os.path.isdir(tensor_dir):
            raise FileNotFoundError(
                f"not an existing directory: {tensor_dir}")
        self.tensor_dir = os.path.abspath(tensor_dir)
        manifest = os.path.join(self.tensor_dir, "manifest.json")
        if os.path.exists(manifest):
            import json

            from acestep_torch.utils.path_safety import safe_path
            with open(manifest, "r", encoding="utf-8") as f:
                raw_paths = (json.load(f) or {}).get("samples", [])
            files = []
            for raw in raw_paths:
                resolved = None
                for base in (self.tensor_dir, None):
                    try:
                        cand = safe_path(raw, base=base) if base else \
                            safe_path(raw)
                        if os.path.exists(cand):
                            resolved = cand
                            break
                    except ValueError:
                        continue
                if resolved is None:
                    import warnings
                    warnings.warn(
                        f"skipping unresolvable manifest path: {raw!r}")
                    continue
                files.append(resolved)
            self.files = sorted(files)
        else:
            self.files = sorted(glob.glob(
                os.path.join(self.tensor_dir, "*.npz")))
        if not self.files:
            raise FileNotFoundError(f"no .npz samples in {tensor_dir}")
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.files))
        n_val = int(len(self.files) * val_fraction)
        self.val_files = [self.files[i] for i in order[:n_val]]
        self.train_files = [self.files[i] for i in order[n_val:]]

    def __len__(self) -> int:
        return len(self.train_files)

    @staticmethod
    def load(path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as data:
            return {k: data[k] for k in data.files if k != "caption"}


def _pad_to(x: np.ndarray, length: int) -> np.ndarray:
    if x.shape[0] >= length:
        return x[:length]
    pad = [(0, length - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def _npz_shapes(path: str, names: Sequence[str]) -> Dict[str, tuple]:
    """Array shapes inside an .npz WITHOUT decompressing their data.

    np.load(path)[name] inflates the whole member; over a multi-GB tensor
    dir that turns the bucket-sizing pass into minutes of startup IO. Each
    .npy header is a few hundred bytes at the front of its zip member —
    stream-read just that. Falls back to np.load on any format surprise.
    """
    import zipfile

    from numpy.lib import format as npf

    out: Dict[str, tuple] = {}
    try:
        with zipfile.ZipFile(path) as z:
            for n in names:
                with z.open(n + ".npy") as f:
                    version = npf.read_magic(f)
                    if version == (1, 0):
                        shape, _, _ = npf.read_array_header_1_0(f)
                    elif version == (2, 0):
                        shape, _, _ = npf.read_array_header_2_0(f)
                    else:           # pragma: no cover - future format
                        raise ValueError(f"npy format {version}")
                    out[n] = shape
        return out
    except (KeyError, ValueError, OSError):   # pragma: no cover - fallback
        with np.load(path) as data:
            return {n: data[n].shape for n in names}


def make_batches(files: Sequence[str], batch_size: int, *,
                 latent_dim: int = 64, refer_frames: int = 10,
                 frame_bucket: int = FRAME_BUCKET,
                 max_frames: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0,
                 epochs: Optional[int] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield training_loss-shaped batches forever (or for `epochs`).

    All samples in the stream are padded to ONE global frame bucket (the max
    over the dataset, bucketed) so every step has the same shapes.
    """
    lengths, text_lens, lyric_lens = [], [], []
    for path in files:        # one header-only pass for bucket dimensions
        shapes = _npz_shapes(path, ("hidden_states", "text_hidden_states",
                                    "lyric_hidden_states"))
        lengths.append(shapes["hidden_states"][0])
        text_lens.append(shapes["text_hidden_states"][0])
        lyric_lens.append(shapes["lyric_hidden_states"][0])
    frames = _bucket_len(max(lengths), frame_bucket, max_frames)
    text_len = max(text_lens)
    lyric_len = max(lyric_lens)

    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(files)) if shuffle else np.arange(len(files))
        if len(order) < batch_size:
            # tiny datasets (the reference's 8-song LoRA flow with fewer
            # files than batch_size): cycle so one full batch still forms —
            # otherwise the loop below yields nothing and spins forever
            reps = -(-batch_size // len(order))
            order = np.concatenate([order] * reps)[:batch_size]
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start:start + batch_size]
            rows = [PreprocessedDataset.load(files[i]) for i in idxs]
            B = len(rows)
            hs = np.stack([_pad_to(r["hidden_states"], frames) for r in rows])
            mask = np.zeros((B, frames), np.int32)
            for j, r in enumerate(rows):
                mask[j, : min(r["hidden_states"].shape[0], frames)] = 1
            th = np.stack([_pad_to(r["text_hidden_states"], text_len)
                           for r in rows])
            tm = np.stack([_pad_to(r["text_attention_mask"], text_len)
                           for r in rows])
            lh = np.stack([_pad_to(r["lyric_hidden_states"], lyric_len)
                           for r in rows])
            lm = np.stack([_pad_to(r["lyric_attention_mask"], lyric_len)
                           for r in rows])
            yield dict(
                hidden_states=hs,
                attention_mask=mask,
                text_hidden_states=th,
                text_attention_mask=tm.astype(np.int32),
                lyric_hidden_states=lh,
                lyric_attention_mask=lm.astype(np.int32),
                refer_audio_packed=np.zeros(
                    (B, refer_frames, latent_dim), np.float32),
                refer_order_mask=np.arange(B, dtype=np.int32),
                src_latents=np.zeros_like(hs),
                chunk_masks=np.ones((B, frames, latent_dim), np.float32),
                is_covers=np.zeros((B,), np.int32),
            )
        epoch += 1
