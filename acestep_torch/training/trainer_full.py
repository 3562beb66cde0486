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
`keep_checkpoints` are kept.

`mesh_dp * mesh_tp > 1` trains over a dp x tp mesh (`parallel/mesh.py`,
one process a device, over the process's world when one is open, on
`model`'s device and the other cards otherwise; a CPU model takes gloo
CPU ranks), as JAX's trainer shards its step over `make_mesh(dp, tp)`.
Every rank holds a trainable shard of the DiT under the serving shard
rules and an AdamW over it; rank 0 (this process) sends one train-step
command a batch. Each step:
- the keep/noise/t draws are the whole batch's, taken here from the
  trainer's generator as the unsharded step takes them; each dp block of
  ranks gets its rows of the batch and of the draws, sent to its ranks
  only, its packed timbre references those whose batch id falls in its
  rows, rebased to its first row;
- each rank's loss is its masked sum over the whole batch's count of
  valid entries (`training_loss(count=)`), so the dp ranks' losses sum
  to the unsharded loss and their gradients to its gradient;
- the tp regions sum their outputs and input gradients
  (`ops/basic.enter_region`), gradients are summed by their tensors'
  rules (`parallel.mesh.GradSync`), clipped by the global norm over the
  shards, and AdamW steps each shard.
A checkpoint holds the unsharded layout: `save()` gathers the ranks'
parameters and AdamW state to rank 0 (into `model`, and the optimizer
state on the host), so a mesh checkpoint resumes without a mesh and the
reverse; `restore()` scatters. A rank's failure raises
`parallel.MeshError` (`MeshOutOfMemoryError` when it ran out of device
memory); nothing falls back to the unsharded step.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import shutil
import time
from types import SimpleNamespace
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from acestep_torch.config import DiTConfig
from acestep_torch.models.dit import training_draws
from acestep_torch.training.step import make_train_step, to_model

_KEYS = itertools.count()
# the AdamW moments a checkpoint holds beside each parameter's step
_MOMENTS = ("exp_avg", "exp_avg_sq")


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


def _adamw(params, weight_decay: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


class FullTrainer:
    """Train every parameter of `model` (an `AceStepDiT`, changed in
    place). `train()` is a generator of (step, loss, message) events, the
    JAX trainer's messages and cadence; `save()` / `restore()` checkpoint
    the model, the optimizer and the step.

    Over a mesh (`mesh_dp * mesh_tp > 1`, or a `mesh` the caller made,
    which it closes itself) `optimizer` is rank 0's; under tp the ranks
    train shards of the model, and reading `model` brings it up to date
    from them (`sync_model`). `close()` lets the ranks' shards go."""

    def __init__(self, model, cfg: DiTConfig,
                 tcfg: Optional[FullTrainingConfig] = None, *, mesh=None):
        self.cfg = cfg
        self.tcfg = tc = tcfg or FullTrainingConfig()
        self._model = model.requires_grad_(True)
        self.device = next(model.parameters()).device
        self.decay_steps = max(tc.max_steps, tc.warmup_steps + 1)
        self.step = 0
        self.ckpt_root = (os.path.abspath(os.path.join(tc.output_dir,
                                                       "checkpoints"))
                          if tc.checkpoint_every else None)
        self.mesh, self._own_mesh = mesh, False
        if mesh is None and tc.mesh_dp * tc.mesh_tp > 1:
            from acestep_torch.parallel.mesh import make_mesh, mesh_devices

            self.mesh = make_mesh(tc.mesh_dp, tc.mesh_tp,
                                  devices=mesh_devices(self.device))
            self._own_mesh = True
        if self.mesh is None:
            self.optimizer = _adamw(model.parameters(), tc.weight_decay)
            self.step_fn = make_train_step(model, cfg, self.optimizer,
                                           grad_clip=tc.grad_clip)
            return
        try:
            self._install()
        except BaseException:
            self.close()
            raise

    @property
    def model(self):
        """The DiT being trained; over a tp mesh, first brought up to date
        from the ranks' shards (`sync_model`)."""
        self.sync_model()
        return self._model

    # -- the mesh ------------------------------------------------------------

    def _install(self) -> None:
        from acestep_torch.parallel.mesh import grad_rules, make_plan

        mesh = self.mesh
        self.plan = make_plan(self._model, self.cfg, mesh.tp)
        self._key = f"full-{next(_KEYS)}"
        self._shapes = {n: tuple(p.shape)
                        for n, p in self._model.named_parameters()}
        self._synced = 0
        mesh.install(self._key, self._model, self.plan, trainable=True)
        self.optimizer = mesh.call(
            _setup_rank, self._key, self.plan.local_config(self.cfg),
            self.plan, grad_rules(self._model, self.plan),
            self.tcfg.weight_decay, self.tcfg.grad_clip)

    def close(self) -> None:
        """Bring `model` up to date, drop the ranks' shards and
        optimizers, and close the mesh when the trainer made it."""
        if self.mesh is None:
            return
        try:
            if hasattr(self, "_key") and not self.mesh.down:
                self.sync_model()
                self.mesh.call(_drop_rank, self._key)
        finally:
            mesh, self.mesh = self.mesh, None
            if self._own_mesh:
                mesh.close()

    def _mesh_step(self, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, fixed: Dict[str, Any]
                   ) -> torch.Tensor:
        """One update over the mesh: the whole batch's draws, each dp
        block's rows to its ranks, the step command; the global loss."""
        dp = self.mesh.dp
        x0 = batch["hidden_states"]
        rows = x0.shape[0]
        if rows % dp:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"mesh_dp={dp}")
        keep, noise, t = training_draws(self.cfg, x0, generator=generator,
                                        **fixed)
        batch = dict(batch, keep=keep, noise=noise, t=t)
        n = rows // dp
        blocks = [_block(batch, d * n, n) for d in range(dp)]
        specs = [[(k, tuple(v.shape), v.dtype) for k, v in b.items()]
                 for b in blocks]
        return self.mesh.call(_train_step, self._key, self.lr(self.step),
                              specs, self._counts(batch, dp), root=blocks)

    @staticmethod
    def _counts(batch: Dict[str, torch.Tensor], dp: int
                ) -> List[Optional[float]]:
        """Each dp block's loss denominator: the whole batch's valid
        entries (None under one block: the loss counts its own)."""
        if dp == 1:
            return [None]
        m = batch["attention_mask"]
        return [float(m.sum()) * batch["hidden_states"].shape[-1]] * dp

    def gradients(self) -> Dict[str, torch.Tensor]:
        """{parameter name: the last update's gradient}, as the optimizer
        took it (summed and clipped), in the unsharded layout (over a tp
        mesh joined on the host)."""
        if self.mesh is None or self.mesh.tp == 1:
            return {n: p.grad for n, p in self._model.named_parameters()}
        return self.mesh.call(_gather_rank, self._key, self._shapes,
                              "grads")

    def state_dicts(self):
        """(the model's state dict, the optimizer's state dict) in the
        unsharded trainer's layout, what a checkpoint holds: over a tp
        mesh joined from the ranks (the optimizer's on the host), `model`
        brought up to date on the way."""
        if self.mesh is None or self.mesh.tp == 1:
            return self._model.state_dict(), self.optimizer.state_dict()
        got = self.mesh.call(_gather_rank, self._key, self._shapes, "state")
        self._copy_into_model(got["params"])
        opt = self.optimizer.state_dict()
        names = list(self._shapes)
        state = {}
        if got["step"]:
            state = {i: {"step": got["step"][n],
                         **{k: got[k][n] for k in _MOMENTS}}
                     for i, n in enumerate(names)}
        return self._model.state_dict(), {
            "state": state, "param_groups": opt["param_groups"]}

    def _copy_into_model(self, params: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in self._model.named_parameters():
                p.copy_(params[name])
        self._synced = self.step

    def sync_model(self) -> None:
        """`model` set to the ranks' parameters (a no-op without a mesh,
        under dp alone, or when nothing changed since the last sync)."""
        if self.mesh is None or self.mesh.tp == 1 or \
                self._synced == self.step:
            return
        self._copy_into_model(self.mesh.call(_gather_rank, self._key,
                                             self._shapes, "params"))

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
        model_state, opt_state = self.state_dicts()
        tmp = os.path.join(self.ckpt_root, f".{self.step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)     # a crashed save's leftover
        os.makedirs(tmp)
        torch.save(model_state, os.path.join(tmp, "model.pt"))
        torch.save(opt_state, os.path.join(tmp, "opt_state.pt"))
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
        self._model.load_state_dict(torch.load(
            os.path.join(path, "model.pt"), map_location=self.device,
            weights_only=True))
        # AdamW moves its moments to the parameters' device and keeps the
        # step counts on the CPU
        opt_state = torch.load(os.path.join(path, "opt_state.pt"),
                               map_location="cpu", weights_only=True)
        if self.mesh is None:
            self.optimizer.load_state_dict(opt_state)
        else:
            self._scatter(opt_state)
        with open(os.path.join(path, "meta.json")) as f:
            self.step = int(json.load(f)["step"])
        self._synced = self.step
        return True

    def _scatter(self, opt_state: dict) -> None:
        """`model` and an unsharded optimizer state dict out to the
        ranks."""
        names = list(self._shapes)
        state = opt_state["state"]
        whole = {"params": dict(self._model.named_parameters())}
        steps = {}
        if state:
            steps = {n: state[i]["step"] for i, n in enumerate(names)}
            for k in _MOMENTS:
                whole[k] = {n: state[i][k] for i, n in enumerate(names)}
        self.mesh.call(_scatter_rank, self._key, opt_state["param_groups"],
                       steps, root=whole)

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
            fixed = (to_model(next(draws), self._model)
                     if draws is not None else {})
            if self.mesh is None:
                loss = self.step_fn(to_model(batch, self._model),
                                    generator=gen, **fixed)
            else:
                loss = self._mesh_step(to_model(batch, self._model), gen,
                                       fixed)
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


# ------------------------------------------------------------------
# mesh commands (each runs on every rank of the trainer's mesh)
# ------------------------------------------------------------------


def _block(batch: Dict[str, torch.Tensor], first: int, n: int
           ) -> Dict[str, torch.Tensor]:
    """Rows first..first+n of a batch and its draws; the packed timbre
    references whose batch id falls in them, ids counted from `first`."""
    out = {k: v[first:first + n] for k, v in batch.items()
           if k not in ("refer_audio_packed", "refer_order_mask")}
    order = batch["refer_order_mask"]
    mine = (order >= first) & (order < first + n)
    out["refer_audio_packed"] = batch["refer_audio_packed"][mine]
    out["refer_order_mask"] = order[mine] - first
    return out


def _setup_rank(ctx, root, key: str, cfg: DiTConfig, plan, rules,
                weight_decay, grad_clip):
    """The rank's AdamW and step over its shard; returns the AdamW."""
    from acestep_torch.parallel.mesh import GradSync

    shard = ctx.objects[key]
    opt = _adamw(shard.parameters(), weight_decay)
    ctx.objects[key + "/train"] = SimpleNamespace(
        model=shard, optimizer=opt, plan=plan,
        step=make_train_step(shard, cfg, opt, grad_clip=grad_clip,
                             sync=GradSync(ctx, rules, plan)))
    return opt


def _drop_rank(ctx, root, key: str):
    import gc

    ctx.objects.pop(key, None)
    ctx.objects.pop(key + "/train", None)
    gc.collect()
    if ctx.device.type == "cuda":
        # ranks that share a card get its memory back
        torch.cuda.empty_cache()


def _train_step(ctx, root, key: str, lr: float, specs, counts):
    """One update on the rank: its rows, the step at `lr` with its dp
    block's loss denominator; the loss summed over dp (the batch's
    loss)."""
    import torch.distributed as dist

    from acestep_torch.parallel.mesh import scatter_rows

    rt = ctx.objects[key + "/train"]
    rows = scatter_rows(ctx, root, specs)
    draws = {k: rows.pop(k) for k in ("keep", "noise", "t")}
    for group in rt.optimizer.param_groups:
        group["lr"] = lr
    loss = rt.step(rows, count=counts[ctx.dp_rank], **draws)
    if ctx.dp > 1:
        dist.all_reduce(loss, group=ctx.dp_group)
    return loss


def _gather_rank(ctx, root, key: str, shapes, what: str):
    """On rank 0's host, in the unsharded layout: the parameters
    ('params'), their gradients ('grads'), or the parameters with the
    AdamW state ('state': {'params', 'step' (rank 0's counts), and each of
    _MOMENTS}); None on the other ranks."""
    from acestep_torch.parallel.mesh import gather_state

    rt = ctx.objects[key + "/train"]
    named = [(n, p.grad if what == "grads" else p.detach())
             for n, p in rt.model.named_parameters()]
    got = gather_state(ctx, dict(named), rt.plan, shapes)
    if what != "state":
        return got
    out = {"params": got}
    state = rt.optimizer.state
    held = sum(p in state for p in rt.model.parameters())
    if held not in (0, len(named)):
        raise RuntimeError(f"AdamW holds state for {held} of "
                           f"{len(named)} parameters")
    params = dict(rt.model.named_parameters())
    out["step"] = {n: state[params[n]]["step"] for n, _ in named} \
        if held else {}
    for k in _MOMENTS:
        out[k] = gather_state(ctx, {n: state[params[n]][k] for n, _ in named},
                              rt.plan, shapes) if held else {}
    return out if ctx.rank == 0 else None


def _scatter_rank(ctx, root, key: str, param_groups, steps):
    """Each rank's cut of rank 0's unsharded parameters and AdamW state
    (`root`: {'params', 'exp_avg', 'exp_avg_sq'}: {name: tensor}) into
    its shard and its AdamW."""
    from acestep_torch.parallel.mesh import scatter_state

    rt = ctx.objects[key + "/train"]
    params = dict(rt.model.named_parameters())
    scatter_state(ctx, root and root["params"], params, rt.plan)
    state = {}
    if steps:
        moments = {}
        for k in _MOMENTS:
            moments[k] = {n: torch.empty_like(p) for n, p in params.items()}
            scatter_state(ctx, root and root[k], moments[k], rt.plan)
        state = {i: {"step": steps[n], **{k: moments[k][n]
                                          for k in _MOMENTS}}
                 for i, n in enumerate(params)}
    rt.optimizer.load_state_dict({"state": state,
                                  "param_groups": param_groups})
