"""The port's training data path against the JAX package, on the CPU: audio
loading, the handler's VAE encode (tiny VAE, weights carried across,
float32), the tensor dataset and its batches, the presets, and the CLI's
preprocess -> vanilla run end to end.

Tolerances: audio loading and batches are exact (the same numpy and scipy
code); the encode is float32 on both sides through the tiled encoder,
summation order only, 1e-4 absolute on O(1) latents.
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import DiTConfig, VAEConfig
from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_tpu.training import data as jdata
from acestep_tpu.training import presets as jpresets
from acestep_tpu.utils import audio as jaudio
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.training import cli as tcli
from acestep_torch.training import data as tdata
from acestep_torch.training import presets as tpresets
from acestep_torch.utils import audio as taudio
from torch_parity import assert_close, np_tree, port_cfg, rng


def _write_wav(path, audio: np.ndarray, sr: int) -> None:
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(audio.shape[1])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def test_load_audio_matches_jax(tmp_path):
    a = (0.5 * rng(0).standard_normal((4410, 1))).astype(np.float32)
    _write_wav(tmp_path / "mono.wav", a, 44100)
    got = taudio.load_audio(str(tmp_path / "mono.wav"))
    want = jaudio.load_audio(str(tmp_path / "mono.wav"))
    assert got.shape == want.shape == (4800, 2)
    assert np.array_equal(got, want)
    x = rng(1).standard_normal((10, 3)).astype(np.float32)
    for ch in (1, 2, 3, 4):
        assert np.array_equal(taudio.to_channels(x, ch),
                              jaudio.to_channels(x, ch))


def _tensor_dir(path, lengths, seed=0):
    g = rng(seed)
    path.mkdir()
    for i, T in enumerate(lengths):
        np.savez(path / f"sample_{i:05d}.npz",
                 hidden_states=g.standard_normal((T, 64)).astype(np.float32),
                 text_hidden_states=g.standard_normal((5 + i, 32)).astype(
                     np.float32),
                 text_attention_mask=np.ones(5 + i, np.int32),
                 lyric_hidden_states=g.standard_normal((7 - i, 32)).astype(
                     np.float32),
                 lyric_attention_mask=np.ones(7 - i, np.int32),
                 caption=np.frombuffer(b"x", np.uint8))
    return str(path)


def test_make_batches_matches_jax(tmp_path):
    d = _tensor_dir(tmp_path / "t", [30, 61, 45])
    tds = tdata.PreprocessedDataset(d, val_fraction=0.34, seed=3)
    jds = jdata.PreprocessedDataset(d, val_fraction=0.34, seed=3)
    assert tds.train_files == jds.train_files
    assert tds.val_files == jds.val_files
    kw = dict(frame_bucket=25, seed=4, epochs=2)
    ours = list(tdata.make_batches(tds.files, 2, **kw))
    theirs = list(jdata.make_batches(jds.files, 2, **kw))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert ours[0]["hidden_states"].shape == (2, 75, 64)


def test_presets_match_jax():
    assert tpresets.PRESETS == jpresets.PRESETS
    assert tpresets.get_preset("quick", seed=3).to_dict() == \
        jpresets.get_preset("quick", seed=3).to_dict()
    with pytest.raises(KeyError):
        tpresets.get_preset("nope")


def test_encode_audio_matches_jax():
    geom = dict(frame_bucket=25, min_frames=25, refer_frames=10)
    vcfg = VAEConfig.tiny(decoder_input_channels=64)
    jh = JaxHandler(dit_config=DiTConfig.tiny(), vae_config=vcfg,
                    dtype=jnp.float32, **geom)
    jh.initialize_service(seed=0)
    th = AceStepHandler(port_cfg(DiTConfig.tiny()), port_cfg(vcfg),
                        dtype=torch.float32, device="cpu", **geom)
    th.initialize_service(vae_params=np_tree(jh.vae_params))
    assert jh.tier.encode_chunk == th.tier.encode_chunk
    # 1005 frames of hop 8: padded to a 25-frame bucket, tiled (chunk 512)
    audio = (0.3 * rng(2).standard_normal((8037, 2))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jh.encode_audio(audio)
    got = th.encode_audio(audio)
    assert got.shape == want.shape == (1005, 64)
    assert_close(got, want, atol=1e-4)


def test_cli_preprocess_then_vanilla_runs_end_to_end(tmp_path):
    """preprocess (tiny VAE) -> vanilla (tiny DiT, LoRA) -> fixed on the
    CPU."""
    samples = []
    for i in range(2):
        t_ax = np.arange(4000 + 900 * i) / 48000.0
        tone = 0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t_ax)
        audio = np.stack([tone, 0.5 * tone], axis=1).astype(np.float32)
        _write_wav(tmp_path / f"song{i}.wav", audio, 48000)
        samples.append({"audio_path": str(tmp_path / f"song{i}.wav"),
                        "caption": f"song {i}", "lyrics": "[verse]\nla la",
                        "metas": {"bpm": 120}})
    manifest = tmp_path / "dataset.json"
    manifest.write_text(json.dumps(samples))
    tensors, out = str(tmp_path / "tensors"), str(tmp_path / "lora")
    common = ["--tiny", "--device", "cpu", "--seed", "1"]
    assert tcli.main(["preprocess", *common, "--manifest", str(manifest),
                      "--out-dir", tensors]) == 0
    files = sorted(os.listdir(tensors))
    assert files == ["sample_00000.npz", "sample_00001.npz"]
    with np.load(os.path.join(tensors, files[1])) as z:
        assert z["hidden_states"].shape == (-(-(4900) // 8), 64)
        assert np.isfinite(z["hidden_states"]).all()
    assert tcli.main(["vanilla", *common, "--tensor-dir", tensors,
                      "--output-dir", out, "--max-steps", "3", "--rank", "4",
                      "--checkpoint-every", "2", "--log-every", "1"]) == 0
    assert os.path.exists(os.path.join(out, "adapter.npz"))
    assert os.path.exists(os.path.join(out, "checkpoint_2", "adapter.npz"))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["step"] for e in events][:3] == [1, 2, 2]
    assert all(np.isfinite(e["loss"]) for e in events)
    # `fixed`: continuous timesteps, here resumed from the vanilla run's
    # step-2 checkpoint
    fixed = str(tmp_path / "fixed")
    assert tcli.main(["fixed", *common, "--tensor-dir", tensors,
                      "--output-dir", fixed, "--max-steps", "3", "--rank",
                      "4", "--resume-from",
                      os.path.join(out, "checkpoint_2")]) == 0
    with open(os.path.join(fixed, "checkpoint_3", "trainer_state.json")) as f:
        state = json.load(f)
    assert state["step"] == 3
    assert state["config"]["timestep_mode"] == "continuous"
    # --checkpoint-dir loads an upstream checkpoint: a dir without one fails
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        tcli.main(["vanilla", *common, "--tensor-dir", tensors,
                   "--checkpoint-dir", str(tmp_path / "ckpt")])
