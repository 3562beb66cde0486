"""LoRA/LoKr fine-tuning of the DiT decoder.

Port of `acestep_tpu/training/lora.py`, with both timestep modes: discrete
turbo shift-3 timesteps (`vanilla`) and continuous logit-normal ones
matching the model config (`fixed`), CFG condition dropout, flow-matching
MSE, periodic checkpoints, resume, and a generator of (step, loss,
message) progress events.

Only the adapter factors train. Each step merges them into the frozen base
weights (`lora/adapters.merge_weights`, in the base weights' dtype), runs
the loss with the merged weights in place (`call_with_weights`) and
back-propagates into the factors; `torch.optim.AdamW` after
`training/step.clip_by_global_norm_` is the counterpart of optax's
`chain(clip_by_global_norm, adamw)`. Batches are cast to the base weights'
dtype: on the card the base is bf16, the dtype the attention kernels take,
and the adapters and their optimizer state stay fp32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from acestep_torch.config import DiTConfig
from acestep_torch.lora.adapters import (LORA_TARGETS, call_with_weights,
                                         init_lokr, init_lora, merge_weights)
from acestep_torch.lora.manager import load_adapter_file, save_adapter
from acestep_torch.models.dit import training_loss
from acestep_torch.models.sampler import build_turbo_schedule
from acestep_torch.training.step import clip_by_global_norm_, to_model


@dataclasses.dataclass
class LoRATrainingConfig:
    kind: str = "lora"               # "lora" | "lokr"
    rank: int = 16
    alpha: float = 32.0
    lokr_factor: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    max_steps: int = 2000
    batch_size: int = 1
    timestep_mode: str = "discrete_shift3"   # or "continuous"
    cfg_ratio: float = 0.15
    checkpoint_every: int = 500
    output_dir: str = "lora_output"
    adapter_name: str = "adapter"
    # optional target subset ("self_attn.q_proj", ...)
    targets: Optional[tuple] = None
    resume_from: Optional[str] = None
    seed: int = 0
    log_every: int = 10

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _leaves(weights: dict):
    """The adapter's tensors in a fixed order (the optimizer's order)."""
    return [weights[n][p] for n in sorted(weights) for p in sorted(weights[n])]


def make_lora_train_step(model, cfg: DiTConfig, meta: dict,
                         optimizer: torch.optim.Optimizer, *,
                         grad_clip: Optional[float] = 1.0,
                         discrete_timesteps: Optional[tuple] = None,
                         cfg_ratio: float = 0.15,
                         base_weights: Optional[dict] = None):
    """step(weights, batch, generator=None, **draws) -> loss.

    `weights` is the adapter's {target: {part: tensor}} tree, whose leaves
    `optimizer` updates; `batch` holds `training_loss`'s inputs as tensors
    on the model's device; `draws` optionally fixes its keep/noise/t. The
    backward runs inside `call_with_weights`, so the per-layer
    recomputation (remat) sees the merged weights too. `base_weights`
    (parameter name -> tensor) stand in for the model's own: a quantized
    base's dequantized weights (ops/quant.dequantized_weights)."""
    base = base_weights or {}

    def step(weights, batch, generator: Optional[torch.Generator] = None,
             **draws):
        optimizer.zero_grad(set_to_none=True)
        merged = {**base, **merge_weights(model, weights, 1.0, meta, base)}

        def run(m):
            loss = training_loss(m, cfg, generator=generator,
                                 cfg_ratio=cfg_ratio,
                                 discrete_timesteps=discrete_timesteps,
                                 **draws, **batch)
            loss.backward()
            return loss.detach()

        loss = call_with_weights(model, merged, run)
        if grad_clip is not None:
            clip_by_global_norm_([x.grad for x in _leaves(weights)
                                  if x.grad is not None], grad_clip)
        optimizer.step()
        return loss

    return step


class LoRATrainer:
    """Train adapter factors against a frozen base `AceStepDiT`.

    `train()` is a generator yielding (step, loss, message), the JAX
    trainer's contract. Checkpoints go to `<output_dir>/checkpoint_<step>/`
    with the JAX layout's `adapter.npz` and `trainer_state.json`; the
    optimizer state is saved in PyTorch's own format, `opt_state.pt`
    (`torch.save` of the AdamW state dict), where the JAX trainer writes
    `opt_state.npz`. Resuming restores the adapter, the optimizer state and
    the step, and nothing else: the random draws and the batch stream start
    again, as in the JAX trainer."""

    def __init__(self, model, cfg: DiTConfig,
                 tcfg: Optional[LoRATrainingConfig] = None,
                 base_weights: Optional[dict] = None):
        self.model = model
        self.cfg = cfg
        self.tcfg = tcfg or LoRATrainingConfig()
        # a quantized base trains against its dequantized weights
        self.base_weights = base_weights
        self.device = next(model.parameters()).device

    # -- checkpointing ------------------------------------------------------

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.tcfg.output_dir, f"checkpoint_{step}")

    def _meta(self) -> dict:
        if self.tcfg.kind == "lokr":
            return {"kind": "lokr", "factor": self.tcfg.lokr_factor,
                    "alpha": self.tcfg.alpha}
        return {"kind": "lora", "rank": self.tcfg.rank,
                "alpha": self.tcfg.alpha}

    def _save_checkpoint(self, step: int, weights, optimizer) -> str:
        path = self._ckpt_dir(step)
        os.makedirs(path, exist_ok=True)
        save_adapter(os.path.join(path, "adapter.npz"),
                     {"meta": self._meta(), "weights": weights})
        torch.save(optimizer.state_dict(), os.path.join(path, "opt_state.pt"))
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump({"step": step, "config": self.tcfg.to_dict()}, f)
        return path

    def _targets(self):
        tcfg = self.tcfg
        if not tcfg.targets:
            return LORA_TARGETS
        wanted = {t if isinstance(t, str) else ".".join(t)
                  for t in tcfg.targets}
        targets = tuple(t for t in LORA_TARGETS if ".".join(t) in wanted)
        unknown = wanted - {".".join(t) for t in LORA_TARGETS}
        if unknown or not targets:
            raise ValueError(
                f"unknown LoRA targets {sorted(unknown)}; valid: "
                f"{['.'.join(t) for t in LORA_TARGETS]}")
        return targets

    def initial_state(self) -> Tuple[dict, torch.optim.Optimizer, int]:
        """(adapter weights, optimizer, start step): a fresh adapter drawn
        from a generator seeded `seed`, or the one in `resume_from` with
        its optimizer state and step."""
        tcfg = self.tcfg
        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        if tcfg.kind == "lokr":
            adapter = init_lokr(gen, self.model, factor=tcfg.lokr_factor,
                                alpha=tcfg.alpha, targets=self._targets(),
                                base=self.base_weights)
        else:
            adapter = init_lora(gen, self.model, rank=tcfg.rank,
                                alpha=tcfg.alpha, targets=self._targets(),
                                base=self.base_weights)
        weights = adapter["weights"]
        for leaf in _leaves(weights):
            leaf.requires_grad_(True)
        optimizer = torch.optim.AdamW(
            _leaves(weights), lr=tcfg.learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=tcfg.weight_decay)
        if not tcfg.resume_from:
            return weights, optimizer, 0
        path = tcfg.resume_from
        saved = load_adapter_file(os.path.join(path, "adapter.npz"))["weights"]
        with torch.no_grad():
            for name, pair in weights.items():
                for part, leaf in pair.items():
                    leaf.copy_(saved[name][part])
        # AdamW moves its moments to the parameters' device and keeps the
        # step count on the CPU
        optimizer.load_state_dict(torch.load(
            os.path.join(path, "opt_state.pt"), map_location="cpu",
            weights_only=True))
        with open(os.path.join(path, "trainer_state.json")) as f:
            start = json.load(f)["step"]
        return weights, optimizer, start

    # -- training -----------------------------------------------------------

    def train(self, batches: Iterator[Dict[str, np.ndarray]]
              ) -> Iterator[Tuple[int, Optional[float], str]]:
        tcfg = self.tcfg
        weights, optimizer, start_step = self.initial_state()
        # the step draws (CFG keep mask, noise, timesteps)
        gen = torch.Generator(self.device).manual_seed(tcfg.seed + 1)
        discrete = (build_turbo_schedule(shift=3.0)
                    if tcfg.timestep_mode == "discrete_shift3" else None)
        step_fn = make_lora_train_step(
            self.model, self.cfg, self._meta(), optimizer,
            grad_clip=tcfg.grad_clip, discrete_timesteps=discrete,
            cfg_ratio=tcfg.cfg_ratio, base_weights=self.base_weights)

        step = start_step
        loss = None     # stays None when stopped before the first step
        t0 = time.time()
        for batch in batches:
            if step >= tcfg.max_steps:
                break
            loss = step_fn(weights, to_model(batch, self.model), generator=gen)
            step += 1
            if step % tcfg.log_every == 0 or step == tcfg.max_steps:
                loss_f = float(loss)
                rate = (step - start_step) / max(time.time() - t0, 1e-9)
                yield step, loss_f, f"step {step}/{tcfg.max_steps} " \
                    f"loss {loss_f:.4f} ({rate:.2f} it/s)"
            if tcfg.checkpoint_every and step % tcfg.checkpoint_every == 0:
                path = self._save_checkpoint(step, weights, optimizer)
                yield step, float(loss), f"checkpoint saved: {path}"

        final = self._save_checkpoint(step, weights, optimizer)
        save_adapter(os.path.join(tcfg.output_dir,
                                  f"{tcfg.adapter_name}.npz"),
                     {"meta": self._meta(), "weights": weights})
        yield step, (float(loss) if loss is not None else None), \
            f"training complete; final checkpoint: {final}"
