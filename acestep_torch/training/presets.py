"""Named LoRA training presets (a copy of `acestep_tpu/training/presets.py`'s
table). The gradient-sensitivity estimate (`estimate` subcommand) is not
ported yet."""

from __future__ import annotations

from typing import Dict

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
