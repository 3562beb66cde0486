"""Full-parameter flow-matching trainer.

Port of `acestep_tpu/training/trainer_full.py`. Every parameter of the
`AceStepDiT` trains, at the model's own dtype (bf16 on the card, as the JAX
trainer trains the handler's bf16 tree), through `training/step.
make_train_step`: K1 forward and per-layer recompute, K2/K3 backward.

The optimizer is optax's `chain(clip_by_global_norm(grad_clip),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(max_steps,
warmup + 1)), weight_decay))`: `torch.optim.AdamW` (optax's defaults:
betas 0.9/0.999, eps 1e-8, the decay scaled by the scheduled lr) whose lr
is set before each update to `warmup_cosine_lr` of the number of updates
made so far (so the first update has lr 0), after `clip_by_global_norm_`.

Checkpoints take orbax's place: `<output_dir>/checkpoints/<step>/` holds
`model.pt` (the model's state dict), `opt_state.pt` (the optimizer's) and
`meta.json` ({"step", "config"}), written into a temporary directory and
renamed, so a crash leaves no half checkpoint; the newest
`keep_checkpoints` are kept. A dp x tp mesh is ROADMAP item 15 and not
ported: `mesh_dp * mesh_tp > 1` raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from acestep_torch.config import DiTConfig
from acestep_torch.training.step import make_train_step, to_model


@dataclasses.dataclass
class FullTrainingConfig:
    learning_rate: float = 1e-4
    warmup_steps: int = 100
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    max_steps: int = 10_000
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    output_dir: str = "full_train"
    seed: int = 0
    log_every: int = 20
    mesh_dp: int = 1
    mesh_tp: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def warmup_cosine_lr(count: int, peak: float, warmup_steps: int,
                     decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps) at update `count`: linear from 0 over the warmup, then a
    cosine to 0 over the remaining `decay_steps - warmup_steps` (the decay
    counts the warmup)."""
    if count < warmup_steps:
        # optax's linear_schedule, term for term
        return (0.0 - peak) * (1 - count / warmup_steps) + peak
    span = decay_steps - warmup_steps
    c = min(count - warmup_steps, span)
    return peak * (0.5 * (1 + math.cos(math.pi * c / span)))


class FullTrainer:
    """Train every parameter of `model` (an `AceStepDiT`, changed in
    place). `train()` is a generator of (step, loss, message) events, the
    JAX trainer's messages and cadence; `save()` / `restore()` checkpoint
    the model, the optimizer and the step."""

    def __init__(self, model, cfg: DiTConfig,
                 tcfg: Optional[FullTrainingConfig] = None):
        self.cfg = cfg
        self.tcfg = tc = tcfg or FullTrainingConfig()
        if tc.mesh_dp * tc.mesh_tp > 1:
            raise NotImplementedError(
                f"a dp x tp mesh ({tc.mesh_dp} x {tc.mesh_tp}) is not ported "
                "yet: multi-device training is ROADMAP item 15")
        self.model = model.requires_grad_(True)
        self.device = next(model.parameters()).device
        self.decay_steps = max(tc.max_steps, tc.warmup_steps + 1)
        self.optimizer = torch.optim.AdamW(
            model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=tc.weight_decay)
        self.step_fn = make_train_step(model, cfg, self.optimizer,
                                       grad_clip=tc.grad_clip)
        self.step = 0
        self.ckpt_root = (os.path.abspath(os.path.join(tc.output_dir,
                                                       "checkpoints"))
                          if tc.checkpoint_every else None)

    def lr(self, count: int) -> float:
        tc = self.tcfg
        return warmup_cosine_lr(count, tc.learning_rate, tc.warmup_steps,
                                self.decay_steps)

    # -- checkpoint/resume ---------------------------------------------------

    def all_steps(self) -> List[int]:
        if self.ckpt_root is None or not os.path.isdir(self.ckpt_root):
            return []
        return sorted(int(n) for n in os.listdir(self.ckpt_root)
                      if n.isdigit())

    def save(self) -> None:
        if self.ckpt_root is None:
            return
        final = os.path.join(self.ckpt_root, str(self.step))
        # the end-of-training save coincides with a periodic one when
        # max_steps is a checkpoint_every multiple
        if os.path.isdir(final):
            return
        tmp = os.path.join(self.ckpt_root, f".{self.step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)     # a crashed save's leftover
        os.makedirs(tmp)
        torch.save(self.model.state_dict(), os.path.join(tmp, "model.pt"))
        torch.save(self.optimizer.state_dict(),
                   os.path.join(tmp, "opt_state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": self.step, "config": self.tcfg.to_dict()}, f)
        os.rename(tmp, final)
        if self.tcfg.keep_checkpoints > 0:
            for old in self.all_steps()[:-self.tcfg.keep_checkpoints]:
                shutil.rmtree(os.path.join(self.ckpt_root, str(old)))

    def restore(self, step: Optional[int] = None) -> bool:
        """Load checkpoint `step` (the latest when None); False when there
        is none."""
        steps = self.all_steps()
        target = step if step is not None else (steps[-1] if steps else None)
        if target is None:
            return False
        path = os.path.join(self.ckpt_root, str(target))
        self.model.load_state_dict(torch.load(
            os.path.join(path, "model.pt"), map_location=self.device,
            weights_only=True))
        # AdamW moves its moments to the parameters' device and keeps the
        # step counts on the CPU
        self.optimizer.load_state_dict(torch.load(
            os.path.join(path, "opt_state.pt"), map_location="cpu",
            weights_only=True))
        with open(os.path.join(path, "meta.json")) as f:
            self.step = int(json.load(f)["step"])
        return True

    # -- training ------------------------------------------------------------

    def train(self, batches: Iterable[Dict[str, np.ndarray]],
              draws: Optional[Iterable[Dict[str, Any]]] = None
              ) -> Iterator[Tuple[int, float, str]]:
        """One update per batch until `max_steps`. Each step's keep mask,
        noise and timesteps come from a generator seeded `seed` at every
        call (the JAX trainer restarts its key the same way), unless
        `draws` yields them (`training_loss`'s keep/noise/t), one dict a
        step."""
        tc = self.tcfg
        gen = torch.Generator(self.device).manual_seed(tc.seed)
        draws = iter(draws) if draws is not None else None
        t0 = time.time()
        start = self.step
        for batch in batches:
            if self.step >= tc.max_steps:
                break
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr(self.step)
            fixed = (to_model(next(draws), self.model)
                     if draws is not None else {})
            loss = self.step_fn(to_model(batch, self.model), generator=gen,
                                **fixed)
            self.step += 1
            if self.step % tc.log_every == 0 or self.step == tc.max_steps:
                rate = (self.step - start) / max(time.time() - t0, 1e-9)
                yield self.step, float(loss), (
                    f"step {self.step}/{tc.max_steps} loss {float(loss):.4f} "
                    f"({rate:.2f} it/s)")
            if tc.checkpoint_every and self.step % tc.checkpoint_every == 0:
                self.save()
                yield self.step, float(loss), f"checkpoint @ {self.step}"
        self.save()
