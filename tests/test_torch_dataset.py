"""The port's dataset modules against the JAX package's, on the CPU:
labeling (training/labeling.py), the staged dataset builder
(training/dataset_builder.py) and the interactive dataset session
(training/dataset_session.py), plus the training CLI's `dataset`.

Each test of the JAX package's tests/test_labeling.py,
test_dataset_builder.py and test_dataset_session.py is mirrored here: the
same steps run through both packages on the same files, the JAX test's
assertions hold on the port, and the two outputs (return values, JSON
files, CSV bytes, request bodies sent to the fake transports) must be
equal. Nothing there computes in floating point, except the fake
handlers' deterministic arrays, which must be equal too.

Then the real tiny models: one audio directory through both packages'
`DatasetBuildPipeline` with the tiny handlers (the JAX handler's seeded
VAE carried across, float32) and one stub planner for both, whose
`understand` returns a fixed dict (the planners sample from different
RNGs): scan.json, labels and manifests equal; latents and tensors within
1e-4 absolute (test_torch_preprocess's encode tolerance, on O(1)
latents); the text embeddings (the hash embedder, numpy on both sides)
and masks equal. A greedy tiny planner (temperature 0) labels through
both packages' builders with equal results. Session JSON saved by either
package loads in the other unchanged.
"""

import base64
import json
import os
import wave
import zlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.training import dataset_builder as jbuilder
from acestep_tpu.training import dataset_session as jsession
from acestep_tpu.training import labeling as jlabeling
from acestep_torch.training import dataset_builder as tbuilder
from acestep_torch.training import dataset_session as tsession
from acestep_torch.training import labeling as tlabeling
from torch_parity import (capped, highest, np_tree, port_cfg, tiny_dit_cfg,
                          tiny_vae_cfg)

SIDES = {"torch": (tbuilder, tsession, tlabeling),
         "jax": (jbuilder, jsession, jlabeling)}


def both(fn):
    """(fn(port modules), fn(JAX modules)); each side gets (builder,
    session, labeling)."""
    return fn(*SIDES["torch"]), fn(*SIDES["jax"])


def _write_wav(path, seconds=0.2, sr=48000, data=None):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(sr)
        if data is None:
            f.writeframes(b"\x00\x00" * 2 * int(sr * seconds))
        else:
            f.writeframes((np.clip(data, -1, 1) * 32767).astype(
                "<i2").tobytes())


class FakeEmbedder:
    """Deterministic stand-in for the text embedder (crc32 of the text)."""

    dim = 16

    def encode_text(self, texts, max_len=256):
        h = np.stack([np.full((8, self.dim), zlib.crc32(t.encode()) % 97
                              / 97.0, np.float32) for t in texts])
        return h, np.ones((len(texts), 8), np.int32)

    encode_lyrics = encode_text


class FakeHandler:
    """encode_audio + text_embedder, with an encode counter."""

    def __init__(self):
        self.text_embedder = FakeEmbedder()
        self.encodes = 0

    def encode_audio(self, audio):
        self.encodes += 1
        T = max(4, audio.shape[0] // 1920)
        return np.linspace(0, 1, T * 8, dtype=np.float32).reshape(T, 8)


class CodesHandler(FakeHandler):
    def latents_to_codes(self, latents):
        return "<|audio_code_1|>" * 5

    def audio_to_codes(self, audio):
        return "<|audio_code_1|>" * 5


def _tree(root):
    """{relative path: bytes or array dict} of every file under root, with
    the root itself replaced by a marker inside text files."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k] for k in z.files}
            elif name.endswith(".npy"):
                out[rel] = np.load(path)
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read().replace(str(root).encode(), b"<out>")
    return out


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for rel, w in want.items():
        g = got[rel]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), rel
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=rel + k)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=rel)
        elif rel.endswith(".json"):
            assert json.loads(g) == json.loads(w), rel
        else:
            assert g == w, rel


# ==================================================================
# labeling (mirrors tests/test_labeling.py)
# ==================================================================


def test_load_csv_metadata(tmp_path):
    (tmp_path / "meta.csv").write_text(
        "file,caption,bpm,key\n"
        "a.wav,warm piano,120,C major\n"
        "b.wav,noisy synth,90,\n", encoding="utf-8")
    got, want = both(lambda b, s, lab: lab.load_csv_metadata(str(tmp_path)))
    assert got == want
    assert got["a.wav"] == {"caption": "warm piano", "bpm": "120",
                            "keyscale": "C major"}
    assert got["b.wav"] == {"caption": "noisy synth", "bpm": "90"}


def test_load_csv_metadata_semicolon_dialect(tmp_path):
    (tmp_path / "m.csv").write_text(
        "file;lyrics;language\nx.flac;la la;en\n", encoding="utf-8")
    got, want = both(lambda b, s, lab: lab.load_csv_metadata(str(tmp_path)))
    assert got == want == {"x.flac": {"lyrics": "la la",
                                      "vocal_language": "en"}}


def test_csv_without_file_column_ignored(tmp_path):
    (tmp_path / "m.csv").write_text("name,caption\nx,y\n", encoding="utf-8")
    got, want = both(lambda b, s, lab: lab.load_csv_metadata(str(tmp_path)))
    assert got == want == {}


def test_scan_merges_csv_metadata(tmp_path):
    _write_wav(tmp_path / "song.wav")
    (tmp_path / "bulk.csv").write_text(
        "file,caption,bpm\nsong.wav,csv caption,99\n", encoding="utf-8")
    got, want = both(lambda b, s, lab: b.scan_audio_dir(str(tmp_path)))
    assert got == want
    assert got[0]["caption"] == "csv caption"
    assert got[0]["metas"]["bpm"] == "99"


def test_sidecar_json_wins_over_csv(tmp_path):
    _write_wav(tmp_path / "song.wav")
    (tmp_path / "song.json").write_text(
        json.dumps({"caption": "sidecar caption"}), encoding="utf-8")
    (tmp_path / "bulk.csv").write_text(
        "file,caption\nsong.wav,csv caption\n", encoding="utf-8")
    got, want = both(lambda b, s, lab: b.scan_audio_dir(str(tmp_path)))
    assert got == want and got[0]["caption"] == "sidecar caption"


@pytest.mark.parametrize("words,line_gap", [
    ([{"word": "hello", "start": 0.0, "end": 0.4},
      {"word": "world", "start": 0.6, "end": 1.0},
      {"word": "next", "start": 3.5, "end": 3.9}], 1.5),
    ([{"text": "你好", "start": 0.0, "end": 0.3},
      {"text": "世界", "start": 0.35, "end": 0.6},
      {"word": " ", "start": 0.7},
      {"word": "again", "start": 0.9, "end": None}], 0.2),
])
def test_words_to_lyrics_line_gaps(words, line_gap):
    got, want = both(lambda b, s, lab: lab.words_to_lyrics(words, line_gap))
    assert got == want
    if line_gap == 1.5:
        assert got == "hello world\nnext"


def test_smart_join_cjk():
    for words, joined in ((["你好", "世界"], "你好世界"),
                          (["hello", "world"], "hello world"),
                          (["hello", "世界"], "hello世界"),
                          (["", "a", "", "b"], "a b")):
        got, want = both(lambda b, s, lab: lab.smart_join(words))
        assert got == want == joined


def _wav(tmp_path):
    p = str(tmp_path / "clip.wav")
    _write_wav(p, seconds=0.1)
    return p


def _recording(reply):
    calls = []

    def transport(url, data, headers, timeout):
        calls.append((url, data, headers, timeout))
        return reply(url, data, headers) if callable(reply) else reply
    return transport, calls


def test_whisper_transcriber_fake_transport(tmp_path):
    reply = {"language": "en", "words": [
        {"word": "la", "start": 0.0, "end": 0.2},
        {"word": "la", "start": 0.3, "end": 0.5}]}
    path = _wav(tmp_path)

    def run(b, s, lab):
        transport, calls = _recording(reply)
        return lab.WhisperTranscriber(api_key="k", transport=transport
                                      ).label(path), calls

    (got, got_calls), (want, want_calls) = both(run)
    assert got == want == {"lyrics": "la la", "vocal_language": "en"}
    assert got_calls == want_calls           # the same request, byte for byte
    url, data, headers, _ = got_calls[0]
    assert headers["Authorization"] == "Bearer k" and "openai.com" in url
    assert b"whisper-1" in data


def test_elevenlabs_transcriber_fake_transport(tmp_path):
    path = _wav(tmp_path)

    def run(b, s, lab):
        transport, calls = _recording({"text": "plain text lyrics",
                                       "language_code": "ja"})
        return lab.ElevenLabsTranscriber(api_key="k2", transport=transport
                                         ).label(path), calls

    (got, got_calls), (want, want_calls) = both(run)
    assert got == want == {"lyrics": "plain text lyrics",
                           "vocal_language": "ja"}
    assert got_calls == want_calls
    assert got_calls[0][2]["xi-api-key"] == "k2"


def test_gemini_captioner_fake_transport(tmp_path):
    path = _wav(tmp_path)

    def reply(url, data, headers):
        blob = json.loads(data)["contents"][0]["parts"][1]["inline_data"]
        base64.b64decode(blob["data"])           # valid base64 audio
        return {"candidates": [{"content": {"parts": [{
            "text": json.dumps({"caption": "dreamy pads",
                                "lyrics": "[Verse] la"})}]}}]}

    def run(b, s, lab):
        transport, calls = _recording(reply)
        return lab.GeminiCaptioner(api_key="k3", transport=transport
                                   ).label(path), calls

    (got, got_calls), (want, want_calls) = both(run)
    assert got == want == {"caption": "dreamy pads", "lyrics": "[Verse] la"}
    assert got_calls == want_calls


def test_gemini_malformed_response_is_empty(tmp_path):
    path = _wav(tmp_path)
    got, want = both(lambda b, s, lab: lab.GeminiCaptioner(
        api_key="k3", transport=lambda *a: {"candidates": []}).label(path))
    assert got == want == {}


def test_resolve_labelers_key_gated(monkeypatch):
    for k in ("OPENAI_API_KEY", "ELEVENLABS_API_KEY", "GEMINI_API_KEY"):
        monkeypatch.delenv(k, raising=False)
    got, want = both(lambda b, s, lab: lab.resolve_labelers())
    assert got == want == []
    monkeypatch.setenv("GEMINI_API_KEY", "g")
    monkeypatch.setenv("OPENAI_API_KEY", "o")
    got, want = both(lambda b, s, lab: [type(x).__name__
                                        for x in lab.resolve_labelers()])
    assert got == want == ["WhisperTranscriber", "GeminiCaptioner"]


def test_auto_label_uses_external_labeler(tmp_path):
    class Fake:
        def label(self, path):
            return {"caption": "external cap", "lyrics": "ext lyric"}

    path = _wav(tmp_path)
    got, want = both(lambda b, s, lab: b.auto_label(
        [{"audio_path": path}], dit_handler=None, llm_handler=None,
        external_labelers=[Fake()]))
    assert got == want
    assert got[0]["caption"] == "external cap"
    assert got[0]["lyrics"] == "ext lyric"


def _manifest(path):
    with open(path, "w", encoding="utf-8") as f:
        json.dump([{"audio_path": "/x/a.wav", "caption": "one",
                    "lyrics": "[inst]", "metas": {"bpm": 100}},
                   {"audio_path": "/x/b.wav", "caption": "two",
                    "lyrics": "la"}], f)
    return str(path)


def test_update_sample(tmp_path):
    def run(b, s, lab):
        p = _manifest(tmp_path / f"{lab.__name__}.json")
        out = lab.update_sample(p, 1, caption="two fixed")
        with open(p, "rb") as f:
            return out, f.read()

    got, want = both(run)
    assert got == want
    assert got[0]["caption"] == "two fixed"
    assert json.loads(got[1])[1]["caption"] == "two fixed"


def test_update_sample_rejects_unknown_field(tmp_path):
    for b, s, lab in SIDES.values():
        with pytest.raises(ValueError, match="not editable"):
            lab.update_sample(_manifest(tmp_path / "m.json"), 0,
                              audio_path="/evil")
        with pytest.raises(IndexError, match="out of range"):
            lab.update_sample(_manifest(tmp_path / "m.json"), 5, caption="x")


def test_export_csv_roundtrip(tmp_path):
    def run(b, s, lab):
        d = tmp_path / lab.__name__.split(".")[0]
        d.mkdir()
        p = _manifest(d / "dataset.json")
        n = lab.export_csv(p, str(d / "review.csv"))
        with open(d / "review.csv", "rb") as f:
            return n, f.read(), lab.load_csv_metadata(str(d))

    got, want = both(run)
    assert got == want
    assert got[0] == 2
    assert got[2]["a.wav"]["caption"] == "one"
    assert got[2]["a.wav"]["bpm"] == "100"


# ==================================================================
# the builder (mirrors tests/test_dataset_builder.py)
# ==================================================================


def test_scan_audio_dir_with_sidecars(tmp_path):
    _write_wav(tmp_path / "songA.wav")
    (tmp_path / "songA.json").write_text(json.dumps(
        {"caption": "lofi beat", "metas": {"bpm": 80}, "ignored_field": 1}))
    _write_wav(tmp_path / "songB.wav")
    (tmp_path / "songB.txt").write_text("[Verse]\nhello")
    got, want = both(lambda b, s, lab: b.scan_audio_dir(str(tmp_path)))
    assert got == want and len(got) == 2
    by_name = {os.path.basename(e["audio_path"]): e for e in got}
    assert by_name["songA.wav"]["caption"] == "lofi beat"
    assert by_name["songA.wav"]["metas"] == {"bpm": 80}
    assert "ignored_field" not in by_name["songA.wav"]
    assert by_name["songB.wav"]["lyrics"].startswith("[Verse]")


def test_auto_label_fallback_names(tmp_path):
    _write_wav(tmp_path / "my_cool_track.wav")
    got, want = both(lambda b, s, lab: b.auto_label(
        b.scan_audio_dir(str(tmp_path)), dit_handler=None, llm_handler=None,
        external_labelers=[]))
    assert got == want
    assert got[0]["caption"] == "my cool track"
    assert got[0]["lyrics"] == "[inst]"


def _build_both(audio_dir, tmp_path, handler_cls=FakeHandler, llm=None,
                **kw):
    """Build the same audio dir with each package into its own out dir;
    returns {side: (result, out_dir, handler)}."""
    out = {}
    for side, (b, s, lab) in SIDES.items():
        handler = handler_cls()
        out_dir = str(tmp_path / f"ds_{side}")
        result = b.DatasetBuildPipeline(
            str(audio_dir), out_dir, handler, llm() if llm else None,
            external_labelers=[], **kw).build()
        out[side] = (result, out_dir, handler)
    return out


def _same_build(runs):
    (got, got_dir, _), (want, want_dir, _) = runs["torch"], runs["jax"]
    assert json.loads(json.dumps(got).replace(got_dir, "<out>")) == \
        json.loads(json.dumps(want).replace(want_dir, "<out>"))
    _assert_trees_equal(_tree(got_dir), _tree(want_dir))
    return got


def test_build_dataset_end_to_end(tmp_path):
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    _write_wav(audio_dir / "one.wav")
    _write_wav(audio_dir / "two.wav")
    out = {}
    for side, (b, s, lab) in SIDES.items():
        out_dir = str(tmp_path / f"ds_{side}")
        out[side] = (b.build_dataset(str(audio_dir), out_dir, FakeHandler(),
                                     external_labelers=[]), out_dir, None)
    got = _same_build(out)
    assert got["num_samples"] == 2
    assert os.path.exists(got["manifest"])
    files = os.listdir(got["tensor_dir"])
    assert len([f for f in files if f.endswith(".npz")]) == 2


def test_pipeline_staged_resume(tmp_path):
    """Interrupting after encode and re-running resumes without redoing
    per-file work (per-stage artifacts on disk)."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    for name in ("a.wav", "b.wav", "c.wav"):
        _write_wav(audio_dir / name)
    results = {}
    for side, (b, s, lab) in SIDES.items():
        out_dir = str(tmp_path / f"ds_{side}")
        handler = FakeHandler()
        pipe = b.DatasetBuildPipeline(str(audio_dir), out_dir, handler,
                                      val_fraction=0.34,
                                      external_labelers=[])
        pipe.stage_scan()
        pipe.stage_encode()
        assert handler.encodes == 3
        st = pipe.status()
        assert st["encoded"] == 3 and "encode" in st["stages_done"]
        # "restart": a new pipeline object resumes from disk
        pipe2 = b.DatasetBuildPipeline(str(audio_dir), out_dir, handler,
                                       val_fraction=0.34,
                                       external_labelers=[])
        out = pipe2.build()
        assert handler.encodes == 3      # cached latents, tensors reuse them
        assert out["num_samples"] == 2 and out["num_val"] == 1
        assert os.path.exists(out["manifest_train"])
        assert os.path.exists(out["manifest_val"])
        files = os.listdir(out["tensor_dir"])
        assert len([f for f in files if f.endswith(".npz")]) == 2
        out2 = pipe2.build()             # tensors resumable as well
        assert out2["num_samples"] == 2 and handler.encodes == 3
        results[side] = (out2, out_dir, handler)
    _same_build(results)


def test_no_llm_build_does_not_block_later_labeling(tmp_path):
    """A build without an LM leaves no label files, so a later build with
    one still labels every entry, and the late label reaches the already
    built tensors."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    _write_wav(audio_dir / "first_take.wav")

    class FakeLLM:
        def understand(self, codes):
            return {"caption": "breezy bossa nova", "bpm": 120}

    runs = {}
    for side, (b, s, lab) in SIDES.items():
        out_dir = tmp_path / f"ds_{side}"
        out1 = b.DatasetBuildPipeline(str(audio_dir), str(out_dir),
                                      CodesHandler(), None,
                                      external_labelers=[]).build()
        lab_dir = out_dir / "labels"
        assert not lab_dir.exists() or not any(lab_dir.iterdir())
        assert json.load(open(out1["manifest"]))[0]["caption"] == \
            "first take"
        npz = [f for f in os.listdir(out1["tensor_dir"])
               if f.endswith(".npz")]
        assert len(npz) == 1
        cap1 = np.load(os.path.join(out1["tensor_dir"], npz[0]))["caption"]
        assert bytes(cap1).decode() == "first take"
        out2 = b.DatasetBuildPipeline(str(audio_dir), str(out_dir),
                                      CodesHandler(), FakeLLM(),
                                      external_labelers=[]).build()
        assert json.load(open(out2["manifest"]))[0]["caption"] == \
            "breezy bossa nova"
        cap2 = np.load(os.path.join(out2["tensor_dir"], npz[0]))["caption"]
        assert bytes(cap2).decode() == "breezy bossa nova"
        runs[side] = (out2, str(out_dir), None)
    _same_build(runs)


def test_transient_label_failure_retries_and_tensors_refresh(tmp_path):
    """An LM that throws on build 1 and succeeds on build 2: the retry
    happens and the refreshed caption reaches the tensors."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    _write_wav(audio_dir / "take_two.wav")
    runs = {}
    for side, (b, s, lab) in SIDES.items():
        calls = []

        class FlakyLLM:
            def understand(self, codes):
                calls.append(codes)
                if len(calls) == 1:
                    raise RuntimeError("transient")
                return {"caption": "recovered caption"}

        out_dir = str(tmp_path / f"ds_{side}")
        out1 = b.DatasetBuildPipeline(str(audio_dir), out_dir,
                                      CodesHandler(), FlakyLLM(),
                                      external_labelers=[]).build()
        assert json.load(open(out1["manifest"]))[0]["caption"] == "take two"
        out2 = b.DatasetBuildPipeline(str(audio_dir), out_dir,
                                      CodesHandler(), FlakyLLM(),
                                      external_labelers=[]).build()
        assert len(calls) == 2                    # retried, not skipped
        assert json.load(open(out2["manifest"]))[0]["caption"] == \
            "recovered caption"
        npz = [f for f in os.listdir(out2["tensor_dir"])
               if f.endswith(".npz")]
        cap = np.load(os.path.join(out2["tensor_dir"], npz[0]))["caption"]
        assert bytes(cap).decode() == "recovered caption"
        runs[side] = (out2, out_dir, None)
    _same_build(runs)


def test_orphan_tmp_files_cleaned_and_not_counted(tmp_path):
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    _write_wav(audio_dir / "a.wav")
    statuses = []
    for side, (b, s, lab) in SIDES.items():
        pipe = b.DatasetBuildPipeline(str(audio_dir),
                                      str(tmp_path / f"ds_{side}"),
                                      FakeHandler(), external_labelers=[])
        pipe.stage_scan()
        lat_dir = tmp_path / f"ds_{side}" / "latents"
        lat_dir.mkdir(parents=True)
        # orphans from a crashed encode: current and legacy temp suffixes
        (lat_dir / "dead.npy.tmp").write_bytes(b"x")
        (lat_dir / "dead.npy.tmp.npy").write_bytes(b"x")
        before = pipe.status()
        assert before["encoded"] == 0             # tmp files not counted
        pipe.stage_encode()
        assert not any(".tmp" in n for n in os.listdir(lat_dir))
        statuses.append((before, pipe.status()))
    assert statuses[0] == statuses[1]
    assert statuses[0][1]["encoded"] == 1


def test_pipeline_labels_via_llm(tmp_path):
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    _write_wav(audio_dir / "untitled_take.wav")

    class FakeLLM:
        def understand(self, codes):
            assert codes.startswith("<|audio_code_")
            return {"caption": "a dusty lofi loop", "bpm": 80}

    got = _same_build(_build_both(audio_dir, tmp_path, CodesHandler,
                                  FakeLLM))
    manifest = json.load(open(got["manifest"]))
    assert manifest[0]["caption"] == "a dusty lofi loop"
    assert manifest[0]["metas"]["bpm"] == 80


# ==================================================================
# the session (mirrors tests/test_dataset_session.py)
# ==================================================================


class FakeLLM:
    def understand(self, codes, seed=0):
        assert codes.startswith("<|audio_code_")
        return {"caption": "a dusty lofi loop", "genres": ["lofi", "chill"],
                "bpm": "80", "keyscale": "C major",
                "timesignature": "4", "language": "en"}

    def format_sample(self, caption="", lyrics="", seed=0):
        return {"lyrics": f"[Verse]\n{lyrics.strip()}"}


def _scanned(s, path, **meta):
    session = s.DatasetSession()
    for k, v in meta.items():
        setattr(session.metadata, k, v)
    session.scan_directory(str(path))
    return session


def _samples(session):
    return session.serialize_samples()


def test_scan_reads_sidecars_and_durations(tmp_path):
    _write_wav(tmp_path / "a_song.wav", seconds=1.0)
    (tmp_path / "a_song.txt").write_text("la la la")
    _write_wav(tmp_path / "b_song.wav")
    (tmp_path / "b_song.json").write_text(json.dumps(
        {"caption": "piano etude", "metas": {"bpm": 95, "keyscale": "A minor"},
         "vocal_language": "ja"}))
    got, want = both(lambda b, s, lab: _samples(_scanned(s, tmp_path)))
    assert got == want and len(got) == 2
    by_name = {x["filename"]: x for x in got}
    a, b = by_name["a_song.wav"], by_name["b_song.wav"]
    assert a["raw_lyrics"] == "la la la" and not a["is_instrumental"]
    assert a["lyrics"] == "la la la" and a["duration"] == 1
    assert b["caption"] == "piano etude" and b["bpm"] == 95
    assert b["keyscale"] == "A minor" and b["language"] == "unknown"
    assert b["is_instrumental"]
    assert a["id"] and b["id"] and a["id"] != b["id"]


def test_scan_missing_dir_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    for b, s, lab in SIDES.values():
        for d in ("nope", "empty"):
            with pytest.raises(FileNotFoundError):
                s.DatasetSession().scan_directory(str(tmp_path / d))


def test_audio_duration_header_only(tmp_path):
    from acestep_torch.utils.flac import encode_flac

    _write_wav(tmp_path / "x.wav", seconds=2.5)
    pcm = (np.zeros((48000 * 3 // 2, 2))).astype(np.int16)
    (tmp_path / "y.flac").write_bytes(encode_flac(pcm, 48000))
    (tmp_path / "z.wav").write_bytes(b"not a wav")
    for name, seconds in (("x.wav", 2.5), ("y.flac", 1.5), ("z.wav", 0.0)):
        got, want = both(lambda b, s, lab: s.audio_duration_s(
            str(tmp_path / name)))
        assert got == want and abs(got - seconds) < 0.01, name


def test_custom_tag_positions():
    def run(b, s, lab):
        smp = s.Sample(caption="jazz trio", genre="jazz, bebop",
                       custom_tag="mytag")
        return ([smp.get_full_caption(p) for p in ("prepend", "append",
                                                   "replace", "other")],
                smp.get_full_genre("prepend"),
                s.Sample(custom_tag="t").get_full_caption("prepend"),
                s.Sample(caption="c").get_full_caption("replace"))

    got, want = both(run)
    assert got == want
    assert got[0][:3] == ["mytag, jazz trio", "jazz trio, mytag", "mytag"]
    assert got[1:] == ("mytag, jazz, bebop", "t", "c")


def test_training_prompt_override_and_ratio():
    def run(b, s, lab):
        smp = s.Sample(caption="cap", genre="gen")
        out = [smp.get_training_prompt(use_genre=False),
               smp.get_training_prompt(use_genre=True)]
        for override in ("caption", "genre"):
            smp.prompt_override = override
            out += [smp.get_training_prompt(use_genre=g)
                    for g in (False, True)]
        return out, [sorted(s.select_genre_indices(n, r))
                     for n in (1, 4, 10, 33) for r in (0, 30, 50, 100)]

    got, want = both(run)
    assert got == want
    assert got[0] == ["cap", "gen", "cap", "cap", "gen", "gen"]
    assert len(got[1][2 * 4 + 1]) == 3          # 30% of 10


def test_set_all_instrumental_respects_raw_lyrics(tmp_path):
    _write_wav(tmp_path / "vocal.wav")
    (tmp_path / "vocal.txt").write_text("words here")
    _write_wav(tmp_path / "inst.wav")

    def run(b, s, lab):
        session = _scanned(s, tmp_path)
        session.set_all_instrumental(True)
        first = _samples(session)
        session.set_all_instrumental(False)
        return first, _samples(session)

    got, want = both(run)
    assert got == want
    by_name = {x["filename"]: x for x in got[0]}
    assert not by_name["vocal.wav"]["is_instrumental"]
    assert by_name["vocal.wav"]["lyrics"] == "words here"
    assert by_name["inst.wav"]["is_instrumental"]
    assert by_name["inst.wav"]["lyrics"] == "[Instrumental]"
    assert not {x["filename"]: x for x in got[1]}["inst.wav"][
        "is_instrumental"]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_save_load_round_trip_across_packages(tmp_path, writer, reader):
    """A session saved by one package loads in the other unchanged, and
    re-saves to the same JSON."""
    _write_wav(tmp_path / "a.wav")
    (tmp_path / "a.txt").write_text("words")
    _write_wav(tmp_path / "b.wav")
    s_w, s_r = SIDES[writer][1], SIDES[reader][1]
    session = _scanned(s_w, tmp_path)
    session.metadata.name = "my_set"
    session.set_custom_tag("tagx", "append")
    session.metadata.genre_ratio = 40
    session.samples[0].caption = "hello"
    session.samples[1].bpm = 101
    path = session.save(str(tmp_path / "ds.json"))
    raw = json.load(open(path))
    assert set(raw) == {"metadata", "samples"}    # reference schema shape
    assert raw["metadata"]["custom_tag"] == "tagx"
    assert raw["samples"][0]["labeled"] is False

    loaded = s_r.DatasetSession()
    assert loaded.load(path) == 2
    assert loaded.metadata.name == "my_set"
    assert loaded.metadata.genre_ratio == 40
    assert loaded.samples[0].caption == "hello"
    assert loaded.samples[0].custom_tag == "tagx"
    assert _samples(loaded) == _samples(session)
    again = loaded.save(str(tmp_path / "again.json"))
    assert json.load(open(again)) == raw
    assert loaded.to_manifest_entries() == session.to_manifest_entries()


def test_load_reference_written_dataset(tmp_path):
    """A dataset JSON with the reference's exact field set loads (ids and
    unknown fields tolerated)."""
    payload = {
        "metadata": {"name": "ref_set", "custom_tag": "", "tag_position":
                     "prepend", "created_at": "2025-01-01T00:00:00",
                     "num_samples": 1, "all_instrumental": False,
                     "genre_ratio": 0},
        "samples": [{"id": "abcd1234", "audio_path": "/x/y.wav",
                     "filename": "y.wav", "caption": "c", "genre": "g",
                     "lyrics": "[Verse] hi", "raw_lyrics": "hi",
                     "formatted_lyrics": "", "bpm": 120, "keyscale": "C",
                     "timesignature": "4", "duration": 30,
                     "language": "en", "is_instrumental": False,
                     "custom_tag": "", "labeled": True,
                     "prompt_override": None, "not_a_field": 1}],
    }
    p = tmp_path / "ref.json"
    p.write_text(json.dumps(payload))

    def run(b, s, lab):
        session = s.DatasetSession()
        n = session.load(str(p))
        return n, _samples(session), session.labeled_count(), \
            session.metadata.to_dict()

    got, want = both(run)
    assert got == want
    assert got[0] == 1 and got[1][0]["id"] == "abcd1234"
    assert got[1][0]["bpm"] == 120 and got[2] == 1


def test_update_sample_whitelist():
    def run(b, s, lab):
        session = s.DatasetSession()
        session.samples = [s.Sample(audio_path="/a.wav", filename="a.wav")]
        out = session.update_sample(0, {
            "caption": "new cap", "bpm": "90", "audio_path": "/evil",
            "id": "evil", "is_instrumental": False})
        with pytest.raises(IndexError):
            session.update_sample(5, {})
        return out.to_dict()

    got, want = both(run)
    assert got == want
    assert got["caption"] == "new cap" and got["bpm"] == 90
    assert got["audio_path"] == "/a.wav" and got["id"] != "evil"
    assert not got["is_instrumental"]


def test_label_all_fills_fields_and_callbacks(tmp_path):
    _write_wav(tmp_path / "untitled_take.wav")

    def run(b, s, lab):
        session = _scanned(s, tmp_path)
        events = []
        status = session.label_all(
            CodesHandler(), FakeLLM(),
            progress_callback=lambda m: events.append(("p", m)),
            sample_labeled_callback=lambda i, smp, st: events.append(
                ("s", i, st)))
        again = session.label_all(CodesHandler(), FakeLLM(),
                                  only_unlabeled=True)
        return status, events, _samples(session), again

    got, want = both(run)
    assert got == want
    status, events, samples, again = got
    assert "Labeled" in status
    smp = samples[0]
    assert smp["caption"] == "a dusty lofi loop"
    assert smp["genre"] == "lofi, chill"
    assert smp["bpm"] == 80 and smp["keyscale"] == "C major"
    assert smp["labeled"]
    assert any(e[0] == "p" for e in events)
    assert any(e[0] == "s" and "✅" in e[2] for e in events)
    assert again == "All samples already labeled"


def test_label_all_skip_metas_and_format_lyrics(tmp_path):
    _write_wav(tmp_path / "vocal.wav")
    (tmp_path / "vocal.txt").write_text("raw words")

    def run(b, s, lab):
        session = _scanned(s, tmp_path)
        session.label_all(CodesHandler(), FakeLLM(), skip_metas=True,
                          format_lyrics=True)
        return _samples(session)[0]

    got, want = both(run)
    assert got == want
    assert got["bpm"] is None and got["keyscale"] == ""    # metas skipped
    assert got["formatted_lyrics"].startswith("[Verse]")
    assert got["lyrics"] == got["formatted_lyrics"]
    assert got["raw_lyrics"] == "raw words"               # original kept
    assert got["language"] == "unknown"


def test_label_all_without_llm_falls_back(tmp_path):
    _write_wav(tmp_path / "my_cool_track.wav")

    def run(b, s, lab):
        session = _scanned(s, tmp_path)
        session.label_all(None, None)
        return _samples(session)[0]

    got, want = both(run)
    assert got == want
    assert got["caption"] == "my cool track" and got["labeled"]


def test_label_all_per_sample_failure_is_soft(tmp_path):
    _write_wav(tmp_path / "ok.wav")
    _write_wav(tmp_path / "zz_bad.wav")

    class FlakyHandler(CodesHandler):
        def audio_to_codes(self, audio):
            raise RuntimeError("encode blew up")

    def run(b, s, lab):
        session = _scanned(s, tmp_path)
        seen = []
        session.label_all(FlakyHandler(), FakeLLM(),
                          sample_labeled_callback=lambda i, smp, st:
                          seen.append(st))
        return seen, _samples(session)

    got, want = both(run)
    assert got == want
    assert all("⚠️" in st for st in got[0])     # both failed, none raised
    assert not got[1][0]["labeled"]


def test_label_all_transcribes_through_external_labelers(tmp_path):
    _write_wav(tmp_path / "sung.wav")

    class Transcriber:
        def label(self, path):
            return {"lyrics": "la di da", "vocal_language": "it"}

    def run(b, s, lab):
        session = _scanned(s, tmp_path)
        session.label_all(CodesHandler(), FakeLLM(), transcribe_lyrics=True,
                          external_labelers=[Transcriber()])
        return _samples(session)[0]

    got, want = both(run)
    assert got == want
    assert got["raw_lyrics"] == got["lyrics"] == "la di da"
    assert got["language"] == "it" and not got["is_instrumental"]


def test_manifest_entries_apply_tag_and_ratio(tmp_path):
    for i in range(4):
        _write_wav(tmp_path / f"s{i}.wav")

    def run(b, s, lab):
        session = _scanned(s, tmp_path)
        for i, smp in enumerate(session.samples):
            smp.caption = f"cap{i}"
            smp.genre = f"gen{i}"
        session.samples[2].bpm = 97
        session.set_custom_tag("TAG", "prepend")
        session.metadata.genre_ratio = 50
        return session.to_manifest_entries()

    got, want = both(run)
    assert got == want and len(got) == 4
    assert len([e for e in got if "gen" in e["caption"]]) == 2
    assert all(e["caption"].startswith("TAG, ") for e in got)
    assert all(e["lyrics"] == "[Instrumental]" for e in got)
    assert all(e["filename"].endswith(".npz") for e in got)


def test_preprocess_writes_tensors(tmp_path):
    audio = tmp_path / "audio"
    audio.mkdir()
    _write_wav(audio / "one.wav")
    _write_wav(audio / "two.wav")

    def run(b, s, lab):
        session = _scanned(s, audio)
        out_dir = str(tmp_path / f"tensors_{lab.__name__.split('.')[0]}")
        msgs = []
        handler = FakeHandler()
        n = session.preprocess(handler, out_dir,
                               progress_callback=msgs.append)
        n2 = session.preprocess(handler, out_dir, skip_existing=True)
        return (n, n2, msgs, handler.encodes), _tree(out_dir)

    (got, got_tree), (want, want_tree) = both(run)
    assert got == want
    assert got[0] == got[1] == 2 and got[3] == 2       # skip_existing
    assert got[2][-1].startswith("Encoding 2/2")
    _assert_trees_equal(got_tree, want_tree)


# ==================================================================
# real tiny models through both packages
# ==================================================================


@pytest.fixture(scope="module")
def handlers():
    from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
    from acestep_torch.pipeline.handler import AceStepHandler

    geom = dict(frame_bucket=8, min_frames=8)
    jh = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **geom)
    jh.initialize_service(seed=0)
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **geom)
    th.initialize_service(params=np_tree(jh.params),
                          vae_params=np_tree(jh.vae_params))
    return {"jax": jh, "torch": th}


def _songs(root, n=2):
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        _write_wav(root / f"song_{i}.wav", data=(0.2 * rng.standard_normal(
            (48000 // 5 + 333 * i, 2))))
    (root / "song_1.txt").write_text("[verse]\nla la")
    return root


class StubPlanner:
    def understand(self, codes, seed=0):
        return {"caption": f"stub {len(codes)}", "bpm": 90,
                "keyscale": "D minor"}


def test_builder_stages_match_jax(handlers, tmp_path):
    """scan -> encode -> label -> manifest -> tensors on the tiny handlers
    (JAX's VAE weights carried across) with one stub planner."""
    audio = _songs(tmp_path / "audio")
    runs = {}
    for side, (b, s, lab) in SIDES.items():
        out_dir = str(tmp_path / f"ds_{side}")
        with highest():
            result = b.DatasetBuildPipeline(
                str(audio), out_dir, handlers[side], StubPlanner(),
                val_fraction=0.5, external_labelers=[]).build()
        runs[side] = (result, out_dir)
    (got, got_dir), (want, want_dir) = runs["torch"], runs["jax"]
    assert json.loads(json.dumps(got).replace(got_dir, "<o>")) == \
        json.loads(json.dumps(want).replace(want_dir, "<o>"))
    assert got["num_samples"] == got["num_val"] == 1
    got_tree, want_tree = _tree(got_dir), _tree(want_dir)
    assert sorted(got_tree) == sorted(want_tree)
    for rel, w in want_tree.items():
        g = got_tree[rel]
        if rel.endswith(".json") or rel.endswith(".sig"):
            assert g == w, rel            # scan, labels, manifests, state
        elif rel.endswith(".npy"):        # encode-stage latents
            assert g.shape == w.shape and g.shape[1] == 64
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=rel)
        else:                             # the tensor files
            for k in w:
                if k == "hidden_states":
                    np.testing.assert_allclose(g[k], w[k], atol=1e-4)
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    labels = [json.loads(v) for k, v in got_tree.items()
              if k.startswith("labels")]
    assert len(labels) == 2 and all(x["caption"].startswith("stub ")
                                     for x in labels)


def test_session_preprocess_matches_jax(handlers, tmp_path):
    audio = _songs(tmp_path / "audio")
    trees = {}
    for side, (b, s, lab) in SIDES.items():
        session = _scanned(s, audio, name="tiny_set")
        session.set_custom_tag("tiny", "prepend")
        out_dir = str(tmp_path / f"t_{side}")
        with highest():
            assert session.preprocess(handlers[side], out_dir) == 2
        trees[side] = _tree(out_dir)
    assert sorted(trees["torch"]) == sorted(trees["jax"])
    for rel, w in trees["jax"].items():
        for k in w:
            if k == "hidden_states":
                np.testing.assert_allclose(trees["torch"][rel][k], w[k],
                                           atol=1e-4)
            else:
                np.testing.assert_array_equal(trees["torch"][rel][k], w[k])


def test_greedy_planner_labels_match_jax(tmp_path):
    """The tiny planner (the JAX seeded LM carried across) labels through
    both builders greedily: equal labels and manifests."""
    from acestep_tpu.llm.handler import LLMHandler as JaxLLM
    from acestep_torch.llm.handler import LLMHandler

    jl = JaxLLM(dtype=jnp.float32)
    jl.initialize(num_fallback_codes=32, max_duration=600, seed=0)
    tl = LLMHandler(dtype=torch.float32, device="cpu")
    tl.initialize(cfg=port_cfg(jl.cfg), num_fallback_codes=32,
                  max_duration=600, params=np_tree(jl.engine.params))

    class Greedy:
        def __init__(self, llm):
            self.llm = llm

        def understand(self, codes, seed=0):
            return self.llm.understand(codes, temperature=0.0, seed=seed)

    audio = tmp_path / "audio"
    audio.mkdir()
    _write_wav(audio / "take.wav")
    runs = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for side, llm in (("torch", tl), ("jax", jl)):
            b = SIDES[side][0]
            out_dir = str(tmp_path / f"ds_{side}")
            with highest(), capped(llm):
                result = b.DatasetBuildPipeline(
                    str(audio), out_dir, CodesHandler(), Greedy(llm),
                    external_labelers=[]).build()
            runs[side] = (result, out_dir, None)
    finally:
        torch.set_num_threads(n)
    got = _same_build(runs)
    assert json.load(open(got["manifest"]))[0]["caption"]


# ==================================================================
# the CLI's `dataset`
# ==================================================================


def test_cli_dataset_runs_end_to_end(tmp_path, capsys):
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.training import cli as tcli

    audio = _songs(tmp_path / "audio")
    out = str(tmp_path / "ds")
    common = ["--tiny", "--device", "cpu", "--audio-dir", str(audio),
              "--out-dir", out]
    assert tcli.main(["dataset", *common, "--val-fraction", "0.5"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["num_samples"] == result["num_val"] == 1
    with np.load(os.path.join(result["tensor_dir"], os.listdir(
            result["tensor_dir"])[0].replace(".sig", ".npz"))) as z:
        assert z["hidden_states"].shape[1] == 64
        assert np.isfinite(z["hidden_states"]).all()
    # --label attaches the planner; its understand labels every song
    calls = []

    def understand(self, codes, **kw):
        calls.append((self.device.type, codes))
        return {"caption": "labelled by the planner"}

    with mock.patch.object(LLMHandler, "understand", understand):
        assert tcli.main(["dataset", *common[:-1], out + "_l",
                          "--label"]) == 0
    assert len(calls) == 2 and calls[0][0] == "cpu"
    assert all(c.startswith("<|audio_code_") for _, c in calls)
    with open(os.path.join(out + "_l", "dataset.json")) as f:
        assert [e["caption"] for e in json.load(f)] == [
            "labelled by the planner"] * 2
