"""Named LoRA training presets and the gradient-sensitivity estimate.

Port of `acestep_tpu/training/presets.py`: the preset table (a copy) and
`estimate_gradient_sensitivity`, behind the CLI's `estimate` subcommand,
which ranks the decoder projections by their gradient norm over a few
batches, to guide the choice of LoRA targets; `tie_runs` says which of
its places two estimates within a tolerance may swap."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from acestep_torch.training.lora import LoRATrainingConfig

PRESETS: Dict[str, dict] = {
    # fast sanity pass
    "quick": dict(rank=8, alpha=16.0, learning_rate=3e-4, max_steps=500,
                  checkpoint_every=250, timestep_mode="discrete_shift3"),
    # the reference's default-ish profile (8 songs ~ 1 h class)
    "standard": dict(rank=16, alpha=32.0, learning_rate=1e-4, max_steps=2000,
                     checkpoint_every=500, timestep_mode="discrete_shift3"),
    # v2 'fixed' semantics: continuous timesteps matched to the model config
    "fixed": dict(rank=16, alpha=32.0, learning_rate=1e-4, max_steps=2000,
                  checkpoint_every=500, timestep_mode="continuous"),
    # heavier adapter for style transfer
    "quality": dict(rank=64, alpha=128.0, learning_rate=5e-5, max_steps=6000,
                    checkpoint_every=1000, timestep_mode="continuous"),
    # LoKr variant
    "lokr": dict(kind="lokr", lokr_factor=8, alpha=1.0, learning_rate=1e-4,
                 max_steps=2000, checkpoint_every=500),
}


def get_preset(name: str, **overrides) -> LoRATrainingConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; options: {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return LoRATrainingConfig(**kw)


def estimate_gradient_sensitivity(model, cfg, batches: Iterable[dict],
                                  num_batches: int = 4, seed: int = 0,
                                  draws: Optional[Iterable[dict]] = None
                                  ) -> List[Tuple[str, float]]:
    """Mean over batches of ||grad(target)|| / ||w(target)|| for each LoRA
    target of the decoder (its L layers' weights as one tensor), sorted
    descending. The weight norms are taken once. Only the target weights
    require gradients during the estimate, so the backward computes no
    other weight gradient; the model's own flags are restored after.
    Batches hold `training_loss`'s inputs (numpy or tensors); the draws
    come from a generator seeded `seed`, or per batch from `draws`
    (keep/noise/t)."""
    from acestep_torch.lora.adapters import target_paths
    from acestep_torch.models.dit import training_loss
    from acestep_torch.training.step import to_model

    targets = target_paths(model)
    w_norms = {name: float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(w, dtype=torch.float32) for w in ws])))
        for name, ws in targets.items()}
    flags = {p: p.requires_grad for p in model.parameters()}
    gen = torch.Generator(next(model.parameters()).device).manual_seed(seed)
    draws = iter(draws) if draws is not None else None
    sums: Dict[str, float] = {}
    count = 0
    try:
        model.requires_grad_(False)
        for ws in targets.values():
            for w in ws:
                w.requires_grad_(True)
        for i, batch in enumerate(batches):
            if i >= num_batches:
                break
            fixed = to_model(next(draws), model) if draws is not None else {}
            for ws in targets.values():
                for w in ws:
                    w.grad = None
            training_loss(model, cfg, generator=gen, **fixed,
                          **to_model(batch, model)).backward()
            for name, ws in targets.items():
                g = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(w.grad, dtype=torch.float32)
                     for w in ws]))
                sums[name] = sums.get(name, 0.0) + \
                    float(g) / max(w_norms[name], 1e-9)
            count += 1
    finally:
        for p, flag in flags.items():
            p.grad = None
            p.requires_grad_(flag)
    if count == 0:
        return []
    return sorted(((n, s / count) for n, s in sums.items()),
                  key=lambda kv: -kv[1])


def tie_runs(ranked: List[Tuple[str, float]], rtol: float) -> List[slice]:
    """Slices of `ranked` ((name, value), descending) whose neighbouring
    values lie within 2 * rtol of each other: two estimates each within
    `rtol` of these values may order the targets of a run either way, so
    two rankings agree when each run holds the same targets in both."""
    runs, start = [], 0
    for i in range(1, len(ranked) + 1):
        if i == len(ranked) or \
                ranked[i - 1][1] - ranked[i][1] > 2 * rtol * ranked[i - 1][1]:
            runs.append(slice(start, i))
            start = i
    return runs
