"""The port's full-parameter trainer over a dp x tp mesh
(`FullTrainer(mesh_dp=, mesh_tp=)`, `acestep-torch-train full --mesh-dp
--mesh-tp`) on the CPU: a world of 4 CPU ranks (gloo) serves the module,
each trainer's mesh takes ranks of it. DiTConfig.tiny (4 query and 2 KV
heads), float32, weights carried across from JAX.

Four updates at (dp, tp) = (2, 1), (1, 2), (2, 2) and (1, 4) are held to
JAX's unsharded `FullTrainer` on the same draws, with the limits of
`test_torch_trainer_full.test_four_steps_match_jax` (JAX's own mesh test
checks only a finite loss, so the port's mesh is held to JAX's unsharded
run). (1, 4) gives each rank one query head and replicates the KV heads
over pairs of ranks. The batch's rows have 20 and 15 valid frames, so a
mean of the dp ranks' means would differ from the batch's mean.

Gradients as the optimizer takes them (summed over the mesh, clipped by
the global norm over the shards) are held per tensor to the unsharded
trainer's, float32 summation order only: max |mesh - unsharded| <= 1e-5
* max |unsharded| per tensor (readings up to ~1.2e-6), with the clip
scaling (a small `grad_clip`) and without. Fault controls the same
comparison must reject by 100x its limit: the per-head `q_norm` /
`k_norm` gradients not summed over tp, and a dp loss that is the mean of
the ranks' means.
"""

import dataclasses
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from acestep_tpu.models import dit as jdit
from acestep_tpu.training.trainer_full import FullTrainer as JaxFullTrainer
from acestep_tpu.training.trainer_full import \
    FullTrainingConfig as JaxFullConfig
from acestep_torch.models import dit as tdit
from acestep_torch.parallel import mesh as pm
from acestep_torch.training import cli as tcli
from acestep_torch.training.step import tiny_batch
from acestep_torch.training.trainer_full import (FullTrainer,
                                                 FullTrainingConfig)
from acestep_torch.utils.weights import dit_from_jax
from torch_mesh_helpers import cpu_world
from torch_parity import (B, T, batch_inputs, highest, jax_draws, np_tree,
                          one_torch_thread, port_cfg, tiny_dit_cfg)

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
LR, STEPS = 1e-3, 4
TOL_GRAD = 1e-5

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    yield from cpu_world(tmp_path_factory.mktemp("train_mesh"))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's unsharded FullTrainer over STEPS updates: the config, its
    initial params, the batches, each step's draws, and (loss, params in
    the port's layout) after each step."""
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    batches = [batch_inputs(cfg, seed=10 * i) for i in range(STEPS)]
    jtc = JaxFullConfig(learning_rate=LR, warmup_steps=1, max_steps=STEPS,
                        checkpoint_every=0, log_every=1, seed=3)
    jt = JaxFullTrainer(jax.tree.map(jax.numpy.asarray, jparams), cfg, jtc)
    key, draws = jax.random.PRNGKey(jtc.seed), []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        draws.append(jax_draws(cfg, sub, B, (B, T, 64), 0.15, None))
    after = []
    with highest():
        for _step, loss, _ in jt.train(iter(batches)):
            after.append((loss, dit_from_jax(np_tree(jt.params))))
    return dict(cfg=cfg, tcfg=port_cfg(cfg), jparams=jparams, jtc=jtc,
                batches=batches, draws=draws, after=after)


def _model(run):
    return dit_from_jax(run["jparams"], tdit.build_dit(run["tcfg"], "cpu"))


def _trainer(run, dp=1, tp=1, **kw):
    tc = {**dataclasses.asdict(run["jtc"]), "output_dir": "unused",
          "mesh_dp": dp, "mesh_tp": tp, **kw}
    return FullTrainer(_model(run), run["tcfg"], FullTrainingConfig(**tc))


# ------------------------------------------------------------------
# four updates against JAX's unsharded FullTrainer
# ------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp", MESHES)
def test_four_steps_match_jax(world, jax_run, dp, tp):
    tt = _trainer(jax_run, dp, tp)
    try:
        assert (tt.mesh.dp, tt.mesh.tp) == (dp, tp)
        lrs = [tt.lr(c) for c in range(STEPS)]
        events = tt.train(iter(jax_run["batches"]), draws=jax_run["draws"])
        for k, (te, (jloss, want)) in enumerate(
                zip(events, jax_run["after"]), start=1):
            assert te[0] == k
            np.testing.assert_allclose(te[1], jloss, rtol=1e-5)
            tt.sync_model()
            off, total = 0, 0
            for name, p in tt.model.named_parameters():
                diff = (p.detach() - want[name]).abs()
                assert diff.max() <= 2 * sum(lrs[:k]) + 1e-12, (k, name)
                off += int((diff > 5e-2 * LR).sum())
                total += diff.numel()
            assert off <= 1e-3 * total, (k, off, total)
        assert tt.step == STEPS
        init = dit_from_jax(jax_run["jparams"])
        moved = max(float((p.detach() - init[n]).abs().max())
                    for n, p in tt.model.named_parameters())
        assert moved > 0.5 * LR
    finally:
        tt.close()


# ------------------------------------------------------------------
# gradients: the autograd collectives, the tp/dp sums, the sharded clip
# ------------------------------------------------------------------


def _grads(run, dp, tp, grad_clip):
    """Every gradient of one update (the first batch and draws, lr 0), as
    the optimizer took it."""
    tt = _trainer(run, dp, tp, grad_clip=grad_clip, max_steps=1)
    try:
        loss = next(tt.train(iter(run["batches"][:1]),
                             draws=run["draws"][:1]))[1]
        return loss, {n: g.detach().clone()
                      for n, g in tt.gradients().items()}
    finally:
        tt.close()


def _grad_errors(got, want):
    """{name: max |got - want| / max |want|} of every tensor (0 where both
    are 0: a parameter the loss does not reach)."""
    errs = {}
    for n, w in want.items():
        d, top = float((got[n] - w).abs().max()), float(w.abs().max())
        errs[n] = d / top if top else d
    return errs


@pytest.fixture(scope="module")
def unsharded_grads(jax_run):
    return {clip: _grads(jax_run, 1, 1, clip) for clip in (1.0, 1e-3)}


@pytest.mark.parametrize("clip", [1.0, 1e-3])
@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2)])
def test_gradients_equal_unsharded(world, jax_run, unsharded_grads, dp, tp,
                                   clip):
    """Per tensor, the mesh's summed (and, at 1e-3, clipped) gradients are
    the unsharded step's, the per-head q_norm / k_norm scales and (tp=4)
    the KV rows two ranks share included."""
    want_loss, want = unsharded_grads[clip]
    if clip < 1.0:      # the clip scales: the global norm is above it
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in want.values()]))
        assert float(norm) == pytest.approx(clip, rel=1e-4)
    loss, got = _grads(jax_run, dp, tp, clip)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert set(got) == set(want)
    errs = _grad_errors(got, want)
    bad = {n: e for n, e in errs.items() if not e <= TOL_GRAD}
    assert not bad, bad
    assert any("q_norm" in n for n in want) and any("k_norm" in n
                                                    for n in want)


_grad_rules = pm.grad_rules


def _heads_whole(model, plan):
    rules = _grad_rules(model, plan)
    return {n: pm.WHOLE if r == pm.HEADS else r for n, r in rules.items()}


def _mean_of_means(batch, dp):
    m = batch["attention_mask"]
    n = m.shape[0] // dp
    return [dp * float(m[d * n:(d + 1) * n].sum())
            * batch["hidden_states"].shape[-1] for d in range(dp)]


@pytest.mark.parametrize("fault,dp,tp,fails", [
    ("q_norm/k_norm not summed over tp", 1, 2, ("q_norm", "k_norm")),
    ("dp loss as the mean of the ranks' means", 2, 1, ("",)),
])
def test_fault_controls_are_caught(world, jax_run, unsharded_grads, fault,
                                   dp, tp, fails):
    """The gradient comparison rejects each fault: the limit sits between
    the reading and the controls."""
    patch = (mock.patch.object(pm, "grad_rules", _heads_whole) if tp > 1
             else mock.patch.object(FullTrainer, "_counts",
                                    staticmethod(_mean_of_means)))
    with patch:
        _loss, got = _grads(jax_run, dp, tp, 1.0)
    errs = _grad_errors(got, unsharded_grads[1.0][1])
    over = [n for n, e in errs.items() if e > 100 * TOL_GRAD]
    assert over, fault
    assert all(any(f in n for f in fails) for n in over), (fault, over)


def test_rules_name_the_shared_tensors(jax_run):
    model = _model(jax_run)
    for tp, kv in ((2, pm.SPLIT), (4, pm.KV_ROWS)):
        plan = pm.make_plan(model, jax_run["tcfg"], tp)
        rules = pm.grad_rules(model, plan)
        assert list(rules) == [n for n, _ in model.named_parameters()]
        for name, rule in rules.items():
            owner = name.split(".")[-2] if "." in name else ""
            if owner in ("q_norm", "k_norm"):
                assert rule == pm.HEADS, name
            elif owner in ("k_proj", "v_proj"):
                assert rule == kv, name
            elif owner in ("q_proj", "o_proj", "gate", "up", "down"):
                assert rule == pm.SPLIT, name
            else:
                assert rule == pm.WHOLE, name


# ------------------------------------------------------------------
# checkpoints: the unsharded layout both ways
# ------------------------------------------------------------------


def _state_equal(a, b):
    """Two (model state dict, optimizer state dict) pairs, bit for bit."""
    (ma, oa), (mb, ob) = a, b
    assert list(ma) == list(mb)
    for k in ma:
        assert torch.equal(ma[k].cpu(), mb[k].cpu()), k
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"]) == list(range(len(ma)))
    for i, st in oa["state"].items():
        assert sorted(st) == sorted(ob["state"][i])
        for k, v in st.items():
            assert torch.equal(v.cpu(), ob["state"][i][k].cpu()), (i, k)


def _ckpt(run, out, dp=1, tp=1):
    return _trainer(run, dp, tp, output_dir=out, checkpoint_every=2)


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_mesh_checkpoint_resumes_unsharded_and_back(world, jax_run, tmp_path,
                                                    dp, tp):
    """A mesh checkpoint restores into an unsharded trainer bit for bit,
    and that trainer's checkpoint restores onto a mesh bit for bit; each
    pair then takes the same next update."""
    batches, draws = jax_run["batches"], jax_run["draws"]
    out = str(tmp_path / "mesh")
    mt = _ckpt(jax_run, out, dp, tp)
    try:
        list(mt.train(iter(batches[:2]), draws=draws[:2]))
        saved = mt.state_dicts()
    finally:
        mt.close()
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2"]
    ut = _ckpt(jax_run, out)
    assert ut.restore() and ut.step == 2
    _state_equal(ut.state_dicts(), saved)
    list(ut.train(iter(batches[2:3]), draws=draws[2:3]))       # saves 3

    # the unsharded step-3 checkpoint onto a fresh mesh
    mt = _ckpt(jax_run, out, dp, tp)
    try:
        assert mt.restore() and mt.step == 3
        _state_equal(mt.state_dicts(), ut.state_dicts())
        list(ut.train(iter(batches[3:4]), draws=draws[3:4]))
        list(mt.train(iter(batches[3:4]), draws=draws[3:4]))
        mt.sync_model()
        for (n, a), (_, b) in zip(mt.model.named_parameters(),
                                  ut.model.named_parameters()):
            assert float((a - b).detach().abs().max()) <= 2 * LR, n
    finally:
        mt.close()


def test_rows_must_split_over_dp(world, jax_run):
    tt = _trainer(jax_run, 2, 1)
    try:
        g = torch.Generator().manual_seed(0)
        odd = tiny_batch(jax_run["tcfg"], g, batch=3, frames=16)
        with pytest.raises(ValueError, match="3 rows does not split over "
                                             "mesh_dp=2"):
            list(tt.train([odd]))
        assert not tt.mesh.down      # refused before any command
    finally:
        tt.close()


# ------------------------------------------------------------------
# the CLI
# ------------------------------------------------------------------


def test_cli_full_on_a_mesh_runs_and_resumes(world, tmp_path, capsys):
    from acestep_torch.pipeline.embedder import HashTextEmbedder
    from acestep_torch.training.preprocess import preprocess_samples

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
              "--output-dir", out, "--checkpoint-every", "2",
              "--batch-size", "2", "--mesh-dp", "2"]
    assert tcli.main(["full", *common, "--max-steps", "2"]) == 0
    assert tcli.main(["full", *common, "--max-steps", "3", "--log-every",
                      "1", "--resume-from", "latest"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [" ".join(line.split(" ")[:2]) for line in lines] == [
        "step 2/2", "checkpoint @", "step 3/3"]
    assert all(np.isfinite(float(line.split()[3])) for line in lines
               if line.startswith("step"))
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2", "3"]
    # the CLI's trainers let their meshes go; the module's world stays up
    assert not world.down and world.world.users == 1
