"""The port's full-parameter trainer (training/trainer_full.py) and the
training CLI's `full` subcommand against the JAX package, on the CPU
(DiTConfig.tiny, float32, weights carried across).

The JAX trainer draws each step's keep mask, noise and timesteps from
`jax.random.split` of its key; the port's `train(draws=...)` is handed the
same draws (`torch_parity.jax_draws` of each step's key), so both take the
same four updates. The JAX trainer runs with `checkpoint_every=0` (no
orbax) wherever checkpoints are not compared.

Tolerances. The schedule: 1e-6 of the peak lr (optax evaluates it in
float32, so its cosine's tail is float32 rounding).
Parameters after each step: the first update of Adam is about
lr * sign(gradient) per entry, so an entry whose gradient is near 0 can
take the other sign on a float32 difference; after step k every entry is
held to 2 * (the sum of the lrs of steps 1..k), and all but 1e-3 of the
entries to 5e-2 * the peak lr (the rule of test_torch_training's one-step
test, over four steps). Checkpoints round-trip exactly.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from acestep_tpu.models import dit as jdit
from acestep_tpu.training import cli as jcli
from acestep_tpu.training.trainer_full import FullTrainer as JaxFullTrainer
from acestep_tpu.training.trainer_full import \
    FullTrainingConfig as JaxFullConfig
from acestep_torch.models import dit as tdit
from acestep_torch.training import cli as tcli
from acestep_torch.training.step import tiny_batch
from acestep_torch.training.trainer_full import (FullTrainer,
                                                 FullTrainingConfig,
                                                 warmup_cosine_lr)
from acestep_torch.utils.weights import dit_from_jax
from torch_mesh_helpers import cpu_world
from torch_parity import (B, T, batch_inputs, highest, jax_draws, np_tree,
                          port_cfg, tiny_dit_cfg)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    return cfg, jparams, port_cfg(cfg)


def _port_model(tcfg, jparams):
    return dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu"))


# ------------------------------------------------------------------
# the learning-rate schedule
# ------------------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,max_steps", [
    (1e-4, 100, 10_000),     # the config's defaults
    (1e-3, 1, 4),            # the parity run's
    (3e-4, 5, 5),            # decay_steps = max(max_steps, warmup + 1)
    (2e-4, 0, 7),            # no warmup: the cosine from the first update
])
def test_schedule_matches_optax(lr, warmup, max_steps):
    decay = max(max_steps, warmup + 1)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    counts = range(0, decay + 3)
    want = np.array([float(sched(c)) for c in counts])
    got = np.array([warmup_cosine_lr(c, lr, warmup, decay) for c in counts])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * lr)
    assert got[-1] == 0.0 and got[0] == (0.0 if warmup else lr)
    trainer_lr = FullTrainer(
        tdit.build_dit(port_cfg(tiny_dit_cfg()), "cpu"),
        port_cfg(tiny_dit_cfg()),
        FullTrainingConfig(learning_rate=lr, warmup_steps=warmup,
                           max_steps=max_steps, checkpoint_every=0)).lr
    assert [trainer_lr(c) for c in counts] == list(got)


# ------------------------------------------------------------------
# four updates against JAX's FullTrainer
# ------------------------------------------------------------------


def test_four_steps_match_jax(models):
    cfg, jparams, tcfg = models
    lr, steps = 1e-3, 4
    batches = [batch_inputs(cfg, seed=10 * i) for i in range(steps)]
    jtc = JaxFullConfig(learning_rate=lr, warmup_steps=1, max_steps=steps,
                        checkpoint_every=0, log_every=1, seed=3)
    jt = JaxFullTrainer(jax.tree.map(jax.numpy.asarray, jparams), cfg, jtc)
    key, draws = jax.random.PRNGKey(jtc.seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(jax_draws(cfg, sub, B, (B, T, 64), 0.15, None))
    model = _port_model(tcfg, jparams)
    tt = FullTrainer(model, tcfg, FullTrainingConfig(
        **{**dataclasses.asdict(jtc), "output_dir": "unused"}))
    lrs = [tt.lr(c) for c in range(steps)]
    assert lrs[0] == 0.0 and lrs[1] == lr
    with highest():
        jevents = jt.train(iter(batches))
        tevents = tt.train(iter(batches), draws=draws)
        for k, (je, te) in enumerate(zip(jevents, tevents), start=1):
            assert je[0] == te[0] == k
            np.testing.assert_allclose(te[1], je[1], rtol=1e-5)
            want = dit_from_jax(np_tree(jt.params))
            off, total = 0, 0
            for name, p in model.named_parameters():
                diff = (p.detach() - want[name]).abs()
                assert diff.max() <= 2 * sum(lrs[:k]) + 1e-12, (k, name)
                off += int((diff > 5e-2 * lr).sum())
                total += diff.numel()
            assert off <= 1e-3 * total, (k, off, total)
    assert jt.step == tt.step == steps
    # the update moved the weights (lr 0 at step 1, then the cosine)
    init = dit_from_jax(jparams)
    moved = max(float((p.detach() - init[n]).abs().max())
                for n, p in model.named_parameters())
    assert moved > 0.5 * lr


def test_every_parameter_trains_and_decays(models):
    """Parameters the loss does not reach get zero gradients, as under
    jax.grad, so AdamW's decoupled decay still shrinks them."""
    cfg, jparams, tcfg = models
    model = _port_model(tcfg, jparams)
    t = FullTrainer(model, tcfg, FullTrainingConfig(
        learning_rate=1e-2, warmup_steps=0, weight_decay=0.5, max_steps=1,
        checkpoint_every=0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    list(t.train([batch_inputs(cfg, seed=1)]))
    assert all(p.requires_grad for p in model.parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        changed = not torch.equal(p.detach(), before[name])
        assert changed or not before[name].any(), name


# ------------------------------------------------------------------
# checkpoints
# ------------------------------------------------------------------


def _tiny_batches(tcfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        yield tiny_batch(tcfg, g, batch=2, frames=16)


def _trainer(tcfg, jparams, out, **kw):
    return FullTrainer(_port_model(tcfg, jparams), tcfg, FullTrainingConfig(
        warmup_steps=1, learning_rate=1e-3, log_every=1, output_dir=out,
        **kw))


def test_save_restore_prune_and_skip(models, tmp_path):
    _cfg, jparams, tcfg = models
    out = str(tmp_path / "full")
    t = _trainer(tcfg, jparams, out, max_steps=4, checkpoint_every=1,
                 keep_checkpoints=2)
    events = list(t.train(_tiny_batches(tcfg, 6)))
    assert t.step == 4
    assert [e[2] for e in events if "checkpoint" in e[2]] == [
        f"checkpoint @ {s}" for s in (1, 2, 3, 4)]
    root = os.path.join(out, "checkpoints")
    assert sorted(os.listdir(root)) == ["3", "4"]     # pruned to 2, no tmp
    assert sorted(os.listdir(os.path.join(root, "4"))) == [
        "meta.json", "model.pt", "opt_state.pt"]
    with open(os.path.join(root, "4", "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 4 and meta["config"]["keep_checkpoints"] == 2
    # the end-of-training re-save of step 4 was skipped, and so is another
    stamp = os.stat(os.path.join(root, "4", "model.pt")).st_mtime_ns
    t.save()
    assert os.stat(os.path.join(root, "4", "model.pt")).st_mtime_ns == stamp

    # a fresh trainer restores the latest checkpoint exactly
    t2 = _trainer(tcfg, jparams, out, max_steps=6, checkpoint_every=1,
                  keep_checkpoints=2)
    os.makedirs(os.path.join(root, ".5.tmp"))        # a crashed save
    assert t2.all_steps() == [3, 4]
    assert t2.restore() and t2.step == 4
    for (n, a), (_, b) in zip(t.model.state_dict().items(),
                              t2.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = t.optimizer.state_dict(), t2.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    # and continues to max_steps, saving over the crash's leftover
    events2 = list(t2.train(_tiny_batches(tcfg, 6)))
    assert t2.step == 6 and all(np.isfinite(e[1]) for e in events2)
    assert sorted(os.listdir(root)) == ["5", "6"]
    assert t2.restore(5) and t2.step == 5
    # no checkpoint to restore, or checkpoints switched off
    assert not _trainer(tcfg, jparams, str(tmp_path / "none"), max_steps=1,
                        checkpoint_every=1).restore()
    assert not _trainer(tcfg, jparams, out, max_steps=1,
                        checkpoint_every=0).restore()


def test_resume_continues_like_jax(models, tmp_path):
    """The JAX package's test_full_trainer_with_orbax_resume, on the port."""
    _cfg, jparams, tcfg = models
    out = str(tmp_path / "full")
    t = _trainer(tcfg, jparams, out, max_steps=4, checkpoint_every=2)
    events = list(t.train(_tiny_batches(tcfg, 6)))
    assert t.step == 4 and any("checkpoint" in e[2] for e in events)
    t2 = _trainer(tcfg, jparams, out, max_steps=6, checkpoint_every=2)
    assert t2.restore() and t2.step == 4
    events2 = list(t2.train(_tiny_batches(tcfg, 6)))
    assert t2.step == 6 and all(np.isfinite(e[1]) for e in events2)


@pytest.fixture(scope="module")
def one_rank_world(tmp_path_factory):
    """A world of one CPU rank, open for the module."""
    yield from cpu_world(tmp_path_factory.mktemp("one_rank"), ranks=1)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_mesh_raises_by_name(models, one_rank_world, dp, tp):
    """A mesh larger than the world's devices raises by name (the trainer
    trains over a mesh: `test_torch_trainer_full_mesh.py`), and leaves
    the world as it was."""
    _cfg, jparams, tcfg = models
    with pytest.raises(ValueError, match=f"mesh dp={dp} x tp={tp} needs "
                                         f"{dp * tp} ranks, but this "
                                         "process's world has 1"):
        FullTrainer(_port_model(tcfg, jparams), tcfg,
                    FullTrainingConfig(mesh_dp=dp, mesh_tp=tp))
    assert one_rank_world.world.users == 1 and not one_rank_world.down


# ------------------------------------------------------------------
# the CLI
# ------------------------------------------------------------------

# options only the port has: the device, and --log-every on the trainers
PORT_ONLY = {"--device", "--log-every"}


def _subparsers(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    return sub.choices


def _options(parser):
    return {name: {o for a in p._actions for o in a.option_strings}
            for name, p in _subparsers(parser).items()}


@pytest.mark.parametrize("command", ["vanilla", "fixed", "estimate", "full",
                                     "preprocess", "dataset", "presets"])
def test_cli_arguments_equal_jax(command):
    got, want = _options(tcli.build_parser()), _options(jcli.build_parser())
    assert set(got) == set(want)
    assert got[command] - PORT_ONLY == want[command]
    if "--device" in got[command]:       # every entry point: the card
        sub = _subparsers(tcli.build_parser())[command]
        assert sub.get_default("device") == "cuda"


def test_cli_full_runs_and_resumes(tmp_path, capsys):
    from acestep_torch.training.preprocess import preprocess_samples
    from acestep_torch.pipeline.embedder import HashTextEmbedder

    class Handler:
        text_embedder = HashTextEmbedder(dim=port_cfg(
            tiny_dit_cfg()).text_hidden_dim)

        def encode_audio(self, audio):
            return np.zeros((24, 64), np.float32)

    tensors = str(tmp_path / "tensors")
    samples = [{"audio": np.zeros((1920, 2), np.float32),
                "caption": f"s{i}", "lyrics": "[inst]"} for i in range(2)]
    assert len(list(preprocess_samples(Handler(), samples, tensors))) == 2
    out = str(tmp_path / "full")
    common = ["--tiny", "--device", "cpu", "--tensor-dir", tensors,
              "--output-dir", out, "--checkpoint-every", "2"]
    assert tcli.main(["full", *common, "--max-steps", "2"]) == 0
    assert tcli.main(["full", *common, "--max-steps", "4", "--log-every",
                      "1", "--resume-from", "checkpoint_2"]) == 0
    # JAX's messages on stdout, and no metrics file
    lines = capsys.readouterr().out.splitlines()
    assert [" ".join(line.split(" ")[:2]) for line in lines] == [
        "step 2/2", "checkpoint @", "step 3/4", "step 4/4", "checkpoint @"]
    assert not os.path.exists(os.path.join(out, "metrics.jsonl"))
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2", "4"]
    # the JAX CLI's errors, word for word
    for bad in ("nope", "latest"):
        args = ["full", "--tiny", "--tensor-dir", tensors, "--output-dir",
                str(tmp_path / "empty"), "--resume-from", bad]
        with pytest.raises(SystemExit) as got:
            tcli.main([*args, "--device", "cpu"])
        with pytest.raises(SystemExit) as want:
            jcli.main(args)
        assert got.value.code == want.value.code
        assert str(got.value.code).startswith("full: ")
