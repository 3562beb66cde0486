"""The port's gradient-sensitivity estimate (training/presets.py) and the
training CLI's `estimate` against the JAX package, on the CPU
(DiTConfig.tiny, float32, weights carried across).

JAX's `estimate_gradient_sensitivity` draws each batch's keep mask, noise
and timesteps from `jax.random.split` of its key; the port is handed the
same draws (`torch_parity.jax_draws`).

Tolerances: each target's mean ||grad|| / ||w|| to 1e-4 relative (norms of
gradients that test_torch_training holds to 2e-4 of their largest entry,
entry by entry; a norm averages those differences out). The ranking must
be equal, except that targets whose values lie within twice the tolerance
of each other (a tie the tolerance cannot order) may trade places.
"""

from unittest import mock

import jax
import numpy as np
import pytest

from acestep_tpu.models import dit as jdit
from acestep_tpu.training import presets as jpresets
from acestep_torch.models import dit as tdit
from acestep_torch.training import presets as tpresets
from acestep_torch.utils.weights import dit_from_jax
from torch_parity import (B, T, batch_inputs, highest, jax_draws, np_tree,
                          port_cfg, tiny_dit_cfg)

RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(1), cfg))
    return cfg, jparams, port_cfg(cfg)


def _draws(cfg, seed, n):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(jax_draws(cfg, sub, B, (B, T, 64), 0.15, None))
    return out


@pytest.mark.parametrize("num_batches", [1, 2])
def test_estimate_matches_jax(models, num_batches):
    cfg, jparams, tcfg = models
    batches = [batch_inputs(cfg, seed=7 * i + 1) for i in range(3)]
    with highest():
        want = jpresets.estimate_gradient_sensitivity(
            jax.tree.map(jax.numpy.asarray, jparams), cfg, iter(batches),
            num_batches=num_batches, seed=5)
    model = dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu"))
    got = tpresets.estimate_gradient_sensitivity(
        model, tcfg, iter(batches), num_batches=num_batches, seed=5,
        draws=_draws(cfg, 5, num_batches))
    assert len(got) == len(want) == 11
    # the ranking, as runs of tied values: each run holds the same targets
    runs = tpresets.tie_runs(want, RTOL)
    assert len(runs) >= len(want) - 2
    for run in runs:
        assert {n for n, _ in got[run]} == {n for n, _ in want[run]}
    got_d = dict(got)
    np.testing.assert_allclose([got_d[n] for n, _ in want],
                               [v for _, v in want], rtol=RTOL)


def test_estimate_leaves_the_model_as_it_found_it(models):
    """Only the LoRA targets require gradients during the estimate; the
    model's flags come back and no gradient is left behind."""
    cfg, jparams, tcfg = models
    model = dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu"))
    model.encoder.requires_grad_(True)
    flags = {n: p.requires_grad for n, p in model.named_parameters()}
    seen = []
    real = tdit.training_loss

    def loss(m, *a, **kw):
        seen.append({n for n, p in m.named_parameters() if p.requires_grad})
        return real(m, *a, **kw)

    with mock.patch.object(tdit, "training_loss", loss):
        ranked = tpresets.estimate_gradient_sensitivity(
            model, tcfg, [batch_inputs(cfg)], num_batches=1)
    assert len(ranked) == 11 and all(np.isfinite(v) and v > 0
                                     for _, v in ranked)
    from acestep_torch.lora.adapters import LORA_TARGETS
    assert seen == [{f"decoder.layers.{i}.{'.'.join(t)}.weight"
                     for i in range(tcfg.num_hidden_layers)
                     for t in LORA_TARGETS}]
    assert {n: p.requires_grad for n, p in model.named_parameters()} == flags
    assert all(p.grad is None for p in model.parameters())
    assert tpresets.estimate_gradient_sensitivity(model, tcfg, []) == []


def test_cli_estimate(tmp_path, capsys):
    """The JAX package's test_cli_estimate, on the port's CLI."""
    from acestep_torch.pipeline.embedder import HashTextEmbedder
    from acestep_torch.training import cli as tcli
    from acestep_torch.training.preprocess import preprocess_samples

    class Handler:
        text_embedder = HashTextEmbedder(dim=port_cfg(
            tiny_dit_cfg()).text_hidden_dim)

        def encode_audio(self, audio):
            return np.linspace(0, 1, 20 * 64, dtype=np.float32).reshape(20, 64)

    tensors = str(tmp_path / "tensors")
    samples = [{"audio": np.zeros((1920, 2), np.float32),
                "caption": f"s{i}", "lyrics": "[inst]"} for i in range(2)]
    list(preprocess_samples(Handler(), samples, tensors))
    rc = tcli.main(["estimate", "--tensor-dir", tensors, "--tiny",
                    "--device", "cpu", "--num-batches", "1", "--top-k", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "sensitivity" in out and "suggested LoRA targets" in out
    top = out.strip().splitlines()[-1].split(": ")[1].split(", ")
    assert len(top) == 2
