"""The port's copies of the JAX package's jax-free helpers: loudness
normalization (`utils/audio.loudness_normalize`, the same numpy/scipy
code) against JAX's on seeded mono, stereo and 44.1 kHz inputs within
1e-6, and the safe root's setter and getter (`utils/path_safety`)."""

import os

import numpy as np
import pytest

from acestep_tpu.utils import audio as jaudio
from acestep_torch.utils import audio as taudio
from acestep_torch.utils import path_safety


@pytest.mark.parametrize("shape,sr,target", [
    ((48000,), 48000, -14.0),           # mono
    ((48000, 2), 48000, -14.0),         # stereo
    ((44100, 2), 44100, -20.0),         # measured on a 48 kHz copy
    ((9600, 2), 48000, 0.0),            # loud target: the peak clamp
])
def test_loudness_normalize_matches_jax(shape, sr, target):
    rng = np.random.default_rng(sum(shape) + sr)
    t = np.arange(shape[0]) / sr
    tone = np.sin(2 * np.pi * 220.0 * t)
    audio = 0.2 * tone.reshape(-1, *([1] * (len(shape) - 1)))
    audio = (audio + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    got = taudio.loudness_normalize(audio, target, sr=sr)
    want = jaudio.loudness_normalize(audio, target, sr=sr)
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not np.allclose(got, audio)
    assert np.abs(got).max() <= 1.0


def test_loudness_normalize_leaves_silence():
    silent = np.zeros((4800, 2), np.float32)
    assert taudio.loudness_normalize(silent) is silent


def test_set_safe_root_bounds_user_paths(tmp_path):
    old = path_safety.get_safe_root()
    try:
        path_safety.set_safe_root(str(tmp_path / "a" / ".." / "jail"))
        assert path_safety.get_safe_root() == str(tmp_path / "jail")
        assert path_safety.safe_path("x.wav") == str(tmp_path / "jail" /
                                                     "x.wav")
        with pytest.raises(ValueError, match="escapes"):
            path_safety.safe_path(str(tmp_path / "other"))
    finally:
        path_safety.set_safe_root(old)
    assert path_safety.get_safe_root() == old == os.path.normpath(old)
