"""The port's native FLAC codec against the JAX package's: for seeded int16
inputs the encoded bytes are equal, on the C path (native/flacenc.c through
ctypes) and on the pure-Python path, decoding round-trips exactly, and
`AudioSaver` writes the same file. Exact equality throughout (an integer
codec)."""

import contextlib

import numpy as np
import pytest

from acestep_tpu.utils import audio as jaudio
from acestep_tpu.utils import flac as jflac
from acestep_tpu.utils import flac_native as jnative
from acestep_torch.utils import audio as taudio
from acestep_torch.utils import flac as tflac
from acestep_torch.utils import flac_native as tnative

_NATIVE = ("native_rice_encode", "native_rice_decode", "native_crc16",
           "native_lpc_reconstruct")


@contextlib.contextmanager
def python_path():
    """Both packages on their pure-Python paths for the block."""
    saved = {m: {n: getattr(m, n) for n in _NATIVE}
             for m in (jnative, tnative)}
    try:
        for m in saved:
            for n in _NATIVE:
                setattr(m, n, None)
        yield
    finally:
        for m, names in saved.items():
            for n, v in names.items():
                setattr(m, n, v)


def _sine(n, ch=2, amp=0.5, seed=0):
    phase = np.random.default_rng(seed).uniform(0, 6.3, ch)
    t = np.arange(n)[:, None] / 30.0
    return (np.sin(t + phase) * amp * 32767).astype(np.int16)


CASES = {
    "stereo_sine": _sine(10000),
    "mono_sine": _sine(7001, ch=1, seed=1),
    "stereo_odd_noise": np.random.default_rng(2).integers(
        -32768, 32768, (4097, 2)).astype(np.int16),
    "mono_odd_noise_1d": np.random.default_rng(3).integers(
        -2000, 2000, 3333).astype(np.int16),
    "silence": np.zeros((5000, 2), np.int16),
    "full_scale": np.tile(np.array([[32767, -32768], [-32768, 32767]],
                                   np.int16), (2049, 1)),
    "one_sample": np.array([[32767, -32768]], np.int16),
    "one_sample_mono": np.array([[-7]], np.int16),
    "block_plus_one": _sine(tflac.BLOCK_SIZE + 1, seed=4),
}


def test_both_packages_have_the_c_path():
    assert tnative.native_rice_encode is not None, "no compiler here"
    assert jnative.native_rice_encode is not None


@pytest.mark.parametrize("path", ["c", "python"])
@pytest.mark.parametrize("name", list(CASES))
def test_encoded_bytes_equal_jax(name, path):
    x = CASES[name]
    with python_path() if path == "python" else contextlib.nullcontext():
        got = tflac.encode_flac(x, 48000)
        want = jflac.encode_flac(x, 48000)
        dec, sr = tflac.decode_flac(got)
    assert got == want
    expect = x[:, None] if x.ndim == 1 else x
    assert sr == 48000
    np.testing.assert_array_equal(dec, expect)


def test_c_and_python_paths_give_the_same_bytes():
    x = CASES["stereo_sine"]
    native = tflac.encode_flac(x, 44100)
    with python_path():
        python = tflac.encode_flac(x, 44100)
    assert native == python


def test_audio_saver_flac_matches_jax(tmp_path):
    audio = (_sine(9000, seed=5).astype(np.float32) / 32767.0) * 1.2
    got = taudio.AudioSaver(str(tmp_path / "t")).save_audio(audio, "song",
                                                             fmt="flac")
    want = jaudio.AudioSaver(str(tmp_path / "j")).save_audio(audio, "song",
                                                              fmt="flac")
    assert got.endswith(".flac")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    # the default format of both savers is flac, and load_audio reads it
    # natively (the same float samples on both sides)
    assert taudio.AudioSaver().default_format == "flac"
    np.testing.assert_array_equal(taudio.load_audio(got),
                                  jaudio.load_audio(want))


def test_facade_default_format_is_flac():
    from acestep_tpu.inference import GenerationConfig as JConfig
    from acestep_torch.inference import GenerationConfig as TConfig

    assert TConfig().audio_format == JConfig().audio_format == "flac"
