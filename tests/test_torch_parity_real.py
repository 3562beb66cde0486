"""The real-checkpoint parity harness (`scripts/parity_real_torch.py`) on
the CPU: its synthetic checkpoint run exits 0 with every module's relative
error under the default tolerance (2e-2; both sides float32, so the
readings are ~1e-5 and below), a control with one tensor of the port's
loaded DiT perturbed must exceed it and exit 1, a missing checkpoint or
safetensors package is a SKIP with exit 0, and the synthetic checkpoint's
key specs are the JAX package's checkpoint tests' own.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from acestep_tpu.config import DiTConfig, LMConfig, VAEConfig
from acestep_torch.utils import checkpoint as tckpt
from test_checkpoint import _dit_state_spec, _lm_state_spec, _vae_state_spec

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import parity_real_torch as prt  # noqa: E402

pytest.importorskip("safetensors.numpy")

MODULES = {"condition_encoder_states", "condition_context_latents",
           "decoder_step", "vae_decode", "lm_logits", "turbo_2s_latents",
           "turbo_2s_audio"}


def _result(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("perturb", [False, True])
def test_synthetic_checkpoint_parity(capsys, monkeypatch, perturb):
    """Every module of the port within 2e-2 of JAX on the same files; the
    control (the decoder's output projection scaled by 1.1 in the port's
    loaded copy only) must fail the decoder step and the run."""
    if perturb:
        load = tckpt.load_dit_checkpoint

        def perturbed(*a, **k):
            model, silence = load(*a, **k)
            with torch.no_grad():
                model.decoder.proj_out.weight.mul_(1.1)
            return model, silence

        monkeypatch.setattr(tckpt, "load_dit_checkpoint", perturbed)
    rc = prt.main(["--synthetic", "--seconds", "2"])
    res = _result(capsys.readouterr().out)
    assert set(res) == MODULES | {"ok", "tol"}
    assert res["tol"] == 2e-2
    if not perturb:
        assert rc == 0 and res["ok"]
        assert all(res[m] < 1e-4 for m in MODULES), res
        return
    assert rc == 1 and not res["ok"]
    assert res["decoder_step"] > 2e-2, res
    # the request's latents move far past the clean run's ~1e-7
    assert res["turbo_2s_latents"] > 1e-3, res
    # the condition encoder does not read the perturbed tensor
    assert res["condition_encoder_states"] < 1e-4


@pytest.mark.parametrize("missing", ["checkpoint", "safetensors"])
def test_skips_without_weights_or_safetensors(tmp_path, capsys, monkeypatch,
                                              missing):
    if missing == "safetensors":
        monkeypatch.setitem(sys.modules, "safetensors", None)
        argv = ["--synthetic"]
    else:
        argv = ["--checkpoint-dir", str(tmp_path / "absent")]
    assert prt.main(argv) == 0
    assert capsys.readouterr().out.startswith("parity_real_torch: SKIP")


def test_synthetic_specs_are_the_checkpoint_tests():
    assert prt._dit_state_spec(DiTConfig.tiny(fsq_dim=64)) == \
        _dit_state_spec(DiTConfig.tiny(fsq_dim=64))
    vae = VAEConfig.tiny(decoder_input_channels=64)
    assert prt._vae_state_spec(vae) == _vae_state_spec(vae)
    tied = LMConfig.tiny()
    assert prt._lm_state_spec(tied) == _lm_state_spec(tied)
    untied = LMConfig.tiny(tie_word_embeddings=False)
    assert prt._lm_state_spec(untied) == {
        **_lm_state_spec(untied),
        "lm_head.weight": (untied.vocab_size, untied.hidden_size)}
