"""The port's CLI against the JAX package's: the same flags and defaults
(apart from the port's `--device` and `--tiny`), TOML configs that load in
either package, and the one-shot modes on the CPU at the tiny size: `--once`
writes a flac, `--export-codes` and `--understand` run on a seeded song.
Without a CUDA device and without `--device cpu` the CLI and the server
raise. Exact equality throughout."""

from unittest import mock

import numpy as np
import pytest
import torch

from acestep_tpu import cli as jcli
from acestep_torch import cli as tcli
from acestep_torch.serving import server as tserver
from acestep_torch.utils.audio import save_wav
from acestep_torch.utils.flac import decode_flac

PORT_ONLY = {"device", "tiny"}


def _defaults(parser):
    return vars(parser.parse_args([]))


def test_parser_defaults_equal_jax():
    got, want = _defaults(tcli.build_parser()), _defaults(jcli.build_parser())
    assert set(got) - set(want) == PORT_ONLY
    assert {k: v for k, v in got.items() if k not in PORT_ONLY} == want
    assert got["format"] == "flac"
    assert (got["device"], got["tiny"]) == (None, False)


def test_parser_choices_equal_jax():
    def choices(parser):
        return {a.dest: (tuple(a.option_strings), a.choices)
                for a in parser._actions if a.dest not in PORT_ONLY}

    assert choices(tcli.build_parser()) == choices(jcli.build_parser())


@pytest.mark.parametrize("writer,reader", [(jcli, tcli), (tcli, jcli)])
def test_saved_config_loads_in_the_other_package(tmp_path, writer, reader,
                                                 capsys):
    path = str(tmp_path / "run.toml")
    flags = ["--caption", 'say "hi"\nnow', "--duration", "30", "--seed",
             "7", "--no-think", "--lm-quantization", "w8a8", "--format",
             "wav"]
    assert writer.main(["--save-config", path, *flags]) == 0
    parser = reader.build_parser()
    reader.load_config_defaults(parser, path)
    loaded = vars(parser.parse_args([]))
    direct = vars(reader.build_parser().parse_args(flags))
    assert {k: loaded[k] for k in direct} == direct
    capsys.readouterr()


def _args(tmp_path, *extra):
    return ["--tiny", "--device", "cpu", "--output-dir",
            str(tmp_path / "out"), *extra]


def test_once_writes_flac(tmp_path, capsys):
    rc = tcli.main(_args(tmp_path, "--once", "--no-think", "--duration",
                         "1", "--seed", "1", "--caption", "lofi beat"))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and out[-1].endswith(".flac")
    with open(out[-1], "rb") as f:
        pcm, sr = decode_flac(f.read())
    # the tiny VAE's hop is 8 samples: 25 frames x 8
    assert sr == 48000 and pcm.shape == (25 * 8, 2) and pcm.any()


@pytest.fixture()
def song(tmp_path):
    path = str(tmp_path / "song.wav")
    rng = np.random.default_rng(0)
    t = np.arange(2400) / 48000.0
    audio = 0.3 * np.sin(2 * np.pi * 220 * t)[:, None] + \
        0.02 * rng.standard_normal((2400, 2))
    save_wav(path, audio.astype(np.float32))
    return path


def test_export_codes(tmp_path, song, capsys):
    codes_out = str(tmp_path / "codes.txt")
    assert tcli.main(_args(tmp_path, "--export-codes", song, "--codes-out",
                           codes_out)) == 0
    with open(codes_out) as f:
        codes = f.read()
    assert codes.startswith("<|audio_code_") and codes.count("<|audio_code_")
    # the codes file imports back as generation hints
    assert tcli._read_codes_file(codes_out) == codes
    capsys.readouterr()


def test_understand(tmp_path, song, capsys):
    assert tcli.main(_args(tmp_path, "--understand", song)) == 0
    assert "-- Understanding --" in capsys.readouterr().out


def _serve_once(tmp_path, *extra):
    """`server.main` at the tiny size with a seeded tiny planner behind
    `--lm-size`; in place of serving, one thinking request through the
    facade on the state it built (greedy planner). Returns the result."""
    from acestep_torch import inference as tinf
    from acestep_torch.config import LMConfig
    from acestep_torch.llm.tokenizer import SimpleTokenizer

    def tiny(cls, size, audio_vocab=64_000):
        return cls.tiny(vocab_size=SimpleTokenizer(
            num_audio_codes=audio_vocab).vocab_size)

    out = {}

    def fake_server(state, host, port):
        def serve_forever():
            out["result"] = tinf.generate_music(
                state.dit_handlers[state.default_model], state.llm_handler,
                tinf.GenerationParams(caption="lofi beat", lyrics="la",
                                      duration=1.0, seed=7,
                                      lm_temperature=0.0),
                tinf.GenerationConfig(output_dir=str(tmp_path / "srv")))
            out["mesh"] = state.dit_handlers[state.default_model].mesh
            out["lm_mesh"] = state.llm_handler.mesh
            raise KeyboardInterrupt
        return mock.Mock(serve_forever=serve_forever)

    with mock.patch.object(LMConfig, "for_size", classmethod(tiny)), \
            mock.patch.object(tserver, "create_server", fake_server):
        tserver.main(["--device", "cpu", "--tiny", "--warmup", "",
                      "--lm-size", "0.6B", "--output-dir",
                      str(tmp_path / "out"), *extra])
    # the server's shutdown stopped the meshes it started
    for m in (out["mesh"], out["lm_mesh"]):
        assert m is None or m.closed
    return out


def _flac(path):
    with open(path, "rb") as f:
        return decode_flac(f.read())[0]


def test_mesh_and_lm_tensor_parallel_raise_by_name(tmp_path, capsys):
    """The CLI's `--mesh 2x1` and the server's `--mesh 2x2
    --lm-tensor-parallel 2` (CPU ranks, gloo) render what they render
    without them: the same codes and, the batch padded to the mesh's dp
    and trimmed, the same audio within an int16 step. `--mesh 4x` still
    raises."""
    from torch_mesh_helpers import store_under

    once = ["--once", "--no-think", "--duration", "1", "--seed", "3",
            "--caption", "lofi beat"]
    with store_under(tmp_path):
        assert tcli.main(_args(tmp_path, *once)) == 0
        plain = capsys.readouterr().out.strip().splitlines()[-1]
        assert tcli.main(_args(tmp_path, *once, "--mesh", "2x1")) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert "mesh enabled: dp=2 x tp=1" in lines
        np.testing.assert_allclose(_flac(lines[-1]), _flac(plain), atol=2)

        want = _serve_once(tmp_path)["result"]
        got = _serve_once(tmp_path, "--mesh", "2x2",
                          "--lm-tensor-parallel", "2")
    got = got["result"]
    assert got.success and want.success, (got.error, want.error)
    codes = want.extra_outputs["audio_codes"]
    assert codes.count("<|audio_code_") and \
        got.extra_outputs["audio_codes"] == codes
    np.testing.assert_allclose(got.audios[0]["audio"],
                               want.audios[0]["audio"], atol=2e-4)
    with pytest.raises(ValueError, match="bad mesh spec"):
        tcli.main(_args(tmp_path, "--once", "--mesh", "4x"))


def test_card_unless_cpu_is_asked():
    """Without a CUDA device, the CLI and the server do not fall back to
    the CPU: they raise unless `--device cpu` is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--once", "--no-think", "--duration", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.main(["--no-init", "--port", "0"])


def test_server_main_parser_has_the_jax_flags():
    import argparse

    from acestep_tpu.serving import server as jserver

    flags = set()
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        flags.update(o for act in self._actions for o in act.option_strings)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jserver.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    port = {o for a in tserver.build_parser()._actions
            for o in a.option_strings}
    assert port - flags == {"--device", "--tiny"}
    assert flags - port == set()
