"""The port's LoRA/LoKr adapters and trainer against the JAX package,
float32 on the CPU (DiTConfig.tiny), adapters carried across in the JAX
layout they keep in both packages (acestep_torch/utils/weights.py).

Tolerances. Merged weights: 1e-6 absolute (one einsum and one add per
layer, float32). One training step: the loss to 1e-5 relative; the updated
factors as in tests/test_torch_training.py (the first Adam update is about
lr * sign(gradient): 5e-2 * lr on all but 1e-3 of the entries, 2 * lr on
every entry).
"""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acestep_tpu.lora import adapters as jad
from acestep_tpu.lora import manager as jman
from acestep_tpu.models import dit as jdit
from acestep_tpu.models.sampler import build_turbo_schedule
from acestep_tpu.training import lora as jlora
from acestep_torch.lora import adapters as tad
from acestep_torch.lora import manager as tman
from acestep_torch.models import dit as tdit
from acestep_torch.training import lora as tlora
from acestep_torch.utils.weights import (adapter_from_jax, adapter_to_jax,
                                         dit_from_jax)
from torch_parity import (B, T, assert_close, batch_inputs, highest,
                          jax_draws, np_tree, port_cfg, rng, t, tiny_dit_cfg)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    tcfg = port_cfg(cfg)
    tmodel = dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu"))
    return cfg, jparams, tcfg, tmodel


def _adapter(jparams, kind, seed=0, dora=False):
    """A JAX-initialised adapter with every factor non-zero (numpy)."""
    key = jax.random.PRNGKey(seed)
    if kind == "lora":
        ad = jad.init_lora(key, jparams, rank=4, alpha=8.0)
    else:
        ad = jad.init_lokr(key, jparams, factor=4, alpha=0.5)
    ad = {"meta": ad["meta"], "weights": np_tree(ad["weights"])}
    g = rng(seed + 1)
    for name, pair in ad["weights"].items():
        for part in ("up", "b"):
            if part in pair:
                pair[part] = (0.05 * g.standard_normal(pair[part].shape)
                              ).astype(np.float32)
        if dora:
            L, d_out = pair["up"].shape[0], pair["up"].shape[2]
            pair["dora_m"] = (0.5 + g.random((L, d_out))).astype(np.float32)
    return ad


def _check_merged(tmodel, merged, jmerged, meta_targets):
    want = dit_from_jax(np_tree(jmerged))
    assert len(merged) == len(meta_targets) * len(tmodel.decoder.layers)
    for name, w in merged.items():
        assert_close(w, want[name], atol=1e-6, what=name)


@pytest.mark.parametrize("kind,dora", [("lora", False), ("lokr", False),
                                       ("lora", True)])
def test_merge_weights_matches_jax(models, kind, dora):
    _cfg, jparams, _tcfg, tmodel = models
    ad = _adapter(jparams, kind, dora=dora)
    jmerged = jad.merge_weights(jax.tree.map(jnp.asarray, jparams),
                                jax.tree.map(jnp.asarray, ad["weights"]),
                                0.7, ad["meta"])
    tad_ = adapter_from_jax(ad)
    merged = tad.merge_weights(tmodel, tad_["weights"], 0.7, tad_["meta"])
    _check_merged(tmodel, merged, jmerged, ad["weights"])
    assert tad.adapter_param_count(tad_) == jad.adapter_param_count(ad)


def test_init_shapes_match_jax(models):
    _cfg, jparams, _tcfg, tmodel = models
    g = torch.Generator().manual_seed(0)
    for kind in ("lora", "lokr"):
        if kind == "lora":
            ours = tad.init_lora(g, tmodel, rank=4, alpha=8.0)
            theirs = jad.init_lora(jax.random.PRNGKey(0), jparams, rank=4,
                                   alpha=8.0)
        else:
            ours = tad.init_lokr(g, tmodel, factor=4, alpha=0.5)
            theirs = jad.init_lokr(jax.random.PRNGKey(0), jparams, factor=4,
                                   alpha=0.5)
        assert ours["meta"] == theirs["meta"]
        assert list(ours["weights"]) == list(theirs["weights"])
        for name, pair in theirs["weights"].items():
            for part, x in pair.items():
                assert tuple(ours["weights"][name][part].shape) == x.shape
        zero = "up" if kind == "lora" else "b"
        assert all((p[zero] == 0).all() for p in ours["weights"].values())


@pytest.mark.parametrize("kind", ["lora", "lokr"])
def test_one_train_step_matches_jax(models, kind):
    cfg, jparams, tcfg, tmodel = models
    lr, cfg_ratio = 1e-3, 0.5
    discrete = build_turbo_schedule(shift=3.0)
    ad = _adapter(jparams, kind, seed=3)
    key = jax.random.PRNGKey(11)
    batch = batch_inputs(cfg, seed=9)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(lr, weight_decay=0.01))
    jw = jax.tree.map(jnp.asarray, ad["weights"])
    with highest():
        jnew, _, jloss = jlora.make_lora_train_step(
            cfg, ad["meta"], opt, discrete_timesteps=discrete,
            cfg_ratio=cfg_ratio)(jax.tree.map(jnp.asarray, jparams), jw,
                                 opt.init(jw),
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 key)
    weights = adapter_from_jax(ad)["weights"]
    leaves = tlora._leaves(weights)
    for leaf in leaves:
        leaf.requires_grad_(True)
    step = tlora.make_lora_train_step(
        tmodel, tcfg, ad["meta"],
        torch.optim.AdamW(leaves, lr=lr, weight_decay=0.01), grad_clip=1.0,
        discrete_timesteps=discrete, cfg_ratio=cfg_ratio)
    loss = step(weights, {k: t(v) for k, v in batch.items()},
                **jax_draws(cfg, key, B, (B, T, 64), cfg_ratio, discrete))
    assert_close(loss, jloss, atol=0.0, rtol=1e-5, what="loss")
    assert all(p.grad is None for p in tmodel.parameters())
    off, total = 0, 0
    for name, pair in weights.items():
        for part, x in pair.items():
            diff = (x.detach() - t(np.asarray(jnew[name][part]))).abs()
            assert diff.max() <= 2 * lr, (name, part)
            off += int((diff > 5e-2 * lr).sum())
            total += diff.numel()
            # the step moved every factor
            assert not torch.equal(x.detach(), t(ad["weights"][name][part]))
    assert off <= 1e-3 * total, (off, total)


def test_npz_adapters_move_both_ways(models, tmp_path):
    _cfg, jparams, _tcfg, tmodel = models
    jp = jax.tree.map(jnp.asarray, jparams)
    # the port saves, the JAX package loads and merges
    ours = adapter_from_jax(_adapter(jparams, "lora", seed=5, dora=True))
    tman.save_adapter(str(tmp_path / "port.npz"), ours)
    loaded = jman.load_adapter_file(str(tmp_path / "port.npz"))
    assert loaded["meta"] == ours["meta"]
    _check_merged(tmodel, tad.merge_weights(tmodel, ours["weights"], 1.0,
                                            ours["meta"]),
                  jad.merge_adapter(jp, loaded), ours["weights"])
    # the JAX package saves, the port loads and merges
    theirs = _adapter(jparams, "lokr", seed=6)
    jman.save_adapter(str(tmp_path / "jax.npz"), theirs)
    back = tman.load_adapter_file(str(tmp_path / "jax.npz"))
    assert back["meta"] == theirs["meta"]
    for name, pair in theirs["weights"].items():
        for part, x in pair.items():
            assert np.array_equal(back["weights"][name][part].numpy(), x)
    _check_merged(tmodel, tad.merge_weights(tmodel, back["weights"], 1.0,
                                            back["meta"]),
                  jad.merge_adapter(jp, {"meta": theirs["meta"],
                                         "weights": jax.tree.map(
                                             jnp.asarray, theirs["weights"])}),
                  theirs["weights"])
    assert np.array_equal(adapter_to_jax(back)["weights"]["mlp.up"]["a"],
                          theirs["weights"]["mlp.up"]["a"])


def test_trainer_checkpoints_and_resumes(models, tmp_path):
    """JAX's resume semantics (training/lora.py `_resume`): the adapter,
    the optimizer state and the step come back; nothing else does."""
    cfg, _jparams, tcfg, tmodel = models
    batches = itertools.repeat(batch_inputs(cfg, seed=2))
    out = str(tmp_path / "run")
    run = tlora.LoRATrainer(tmodel, tcfg, tlora.LoRATrainingConfig(
        rank=4, alpha=8.0, max_steps=4, checkpoint_every=2, log_every=1,
        output_dir=out, learning_rate=1e-3))
    events = list(run.train(batches))
    assert [e[0] for e in events if e[2].startswith("step")] == [1, 2, 3, 4]
    assert all(np.isfinite(e[1]) for e in events)
    ck = os.path.join(out, "checkpoint_2")
    assert sorted(os.listdir(ck)) == ["adapter.npz", "opt_state.pt",
                                      "trainer_state.json"]
    with open(os.path.join(ck, "trainer_state.json")) as f:
        assert json.load(f)["step"] == 2
    saved = jman.load_adapter_file(os.path.join(ck, "adapter.npz"))
    assert saved["meta"] == {"kind": "lora", "rank": 4, "alpha": 8.0}
    assert os.path.exists(os.path.join(out, "adapter.npz"))
    assert any(np.abs(np.asarray(p["up"])).max() > 0
               for p in saved["weights"].values())

    resumed = tlora.LoRATrainer(tmodel, tcfg, tlora.LoRATrainingConfig(
        rank=4, alpha=8.0, max_steps=4, checkpoint_every=2, log_every=1,
        output_dir=str(tmp_path / "resumed"), learning_rate=1e-3,
        resume_from=ck))
    weights, opt, start = resumed.initial_state()
    assert start == 2
    for name, pair in weights.items():
        for part, x in pair.items():
            assert np.array_equal(x.detach().numpy(),
                                  np.asarray(saved["weights"][name][part]))
    want = torch.load(os.path.join(ck, "opt_state.pt"), weights_only=True)
    got = opt.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    events = list(resumed.train(batches))
    assert [e[0] for e in events if e[2].startswith("step")] == [3, 4]
