"""Flow-matching training step (full-parameter path).

Port of `acestep_tpu/training/step.py`: condition encode, timestep draw,
interpolation, the DiT forward (each layer checkpointed), the MSE, the
backward and the optimizer update. The optimizer is the caller's
`torch.optim` optimizer over the parameters that require gradients;
`grad_clip` clips their global norm first, as optax's
`clip_by_global_norm` does (`clip_by_global_norm_`). A parameter the loss
does not reach gets a zero gradient, as under `jax.grad`, so AdamW decays
it too. `training/trainer_full.py` drives this step.

On a rank of a dp x tp mesh (`sync`, a `parallel.mesh.GradSync`) the
step is the same on its shard and its rows: the gradients are zero-filled
first, so every rank issues the same collectives, then summed over tp and
dp by the tensors' rules, clipped by the global norm over the shards, and
AdamW steps the shard (elementwise, so it equals the unsharded update).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from acestep_torch.config import DiTConfig
from acestep_torch.models.dit import training_loss


def make_train_step(model, cfg: DiTConfig, optimizer: torch.optim.Optimizer,
                    *, grad_clip: Optional[float] = None, sync=None):
    """Returns step(batch, generator=None, count=None, **draws) -> loss
    (detached fp32 scalar); `draws` are `training_loss`'s keep/noise/t and
    `count` its denominator. `sync` (a mesh rank's `GradSync`) reduces
    the gradients over the mesh before the clip."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, generator: Optional[torch.Generator] = None,
             count: Optional[float] = None, **draws):
        optimizer.zero_grad(set_to_none=True)
        loss = training_loss(model, cfg, generator=generator, count=count,
                             **draws, **batch)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if sync is not None:
            sync.reduce_(grads)
        if grad_clip is not None:
            clip_by_global_norm_(grads, grad_clip, sync)
        optimizer.step()
        return loss.detach()

    return step


def clip_by_global_norm_(grads, max_norm: float, sync=None) -> None:
    """optax.clip_by_global_norm, in place: every gradient is scaled by
    max_norm / norm unless the global norm is below max_norm
    (`torch.nn.utils.clip_grad_norm_` scales by max_norm / (norm + 1e-6)
    instead). The norm is summed in fp32; on a mesh rank (`sync`, after
    its `reduce_`) over the shards (`GradSync.global_norm`)."""
    norms = torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])
    norm = (torch.linalg.vector_norm(norms) if sync is None
            else sync.global_norm(norms))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def to_model(arrays: dict, model) -> dict:
    """numpy arrays or tensors -> tensors on `model`'s device, floating
    ones cast to its dtype (on the card bf16, the kernels' dtype)."""
    first = next(model.parameters())
    out = {}
    for k, v in arrays.items():
        x = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.asarray(v), device=first.device)
        out[k] = x.to(first.dtype) if x.is_floating_point() else x
    return out


def tiny_batch(cfg: DiTConfig, generator: torch.Generator, *,
               batch: int = 2, frames: int = 20, text_len: int = 8,
               lyric_len: int = 16, refer_len: Optional[int] = None,
               dtype=torch.float32) -> dict:
    """A self-consistent random batch on the generator's device, for smoke
    tests."""
    refer_len = refer_len or 2 * cfg.pool_window_size
    dev = generator.device
    C = cfg.audio_acoustic_hidden_dim

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype)

    ones = torch.ones((batch,), dtype=torch.int32, device=dev)
    return dict(
        hidden_states=randn(batch, frames, C),
        attention_mask=torch.ones((batch, frames), dtype=torch.int32,
                                  device=dev),
        text_hidden_states=randn(batch, text_len, cfg.text_hidden_dim),
        text_attention_mask=torch.ones((batch, text_len), dtype=torch.int32,
                                       device=dev),
        lyric_hidden_states=randn(batch, lyric_len, cfg.text_hidden_dim),
        lyric_attention_mask=torch.ones((batch, lyric_len),
                                        dtype=torch.int32, device=dev),
        refer_audio_packed=randn(batch, refer_len, cfg.timbre_hidden_dim),
        refer_order_mask=torch.arange(batch, dtype=torch.int32, device=dev),
        src_latents=randn(batch, frames, C),
        chunk_masks=torch.ones((batch, frames, C), dtype=dtype, device=dev),
        is_covers=ones * 0,
    )
