"""Flow-matching training step (full-parameter path).

Port of `acestep_tpu/training/step.py`: condition encode, timestep draw,
interpolation, the DiT forward (each layer checkpointed), the MSE, the
backward and the optimizer update. The optimizer is the caller's
`torch.optim` optimizer over the parameters that require gradients;
`grad_clip` clips their global norm first (optax's
`clip_by_global_norm`). The orbax-checkpointed `FullTrainer` over a dp x tp
mesh is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from acestep_torch.config import DiTConfig
from acestep_torch.models.dit import training_loss


def make_train_step(model, cfg: DiTConfig, optimizer: torch.optim.Optimizer,
                    *, grad_clip: Optional[float] = None):
    """Returns step(batch, generator=None, **draws) -> loss (detached fp32
    scalar); `draws` are `training_loss`'s keep/noise/t."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, generator: Optional[torch.Generator] = None, **draws):
        optimizer.zero_grad(set_to_none=True)
        loss = training_loss(model, cfg, generator=generator, **draws,
                             **batch)
        loss.backward()
        if grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(params, grad_clip)
        optimizer.step()
        return loss.detach()

    return step


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
