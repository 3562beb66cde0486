"""Turbo flow-matching sampler: the discrete 8-step shift schedules, ODE
Euler or SDE renoise updates, and the cover switch.

Port of the turbo half of `acestep_tpu/models/sampler.py`; the trajectory
is a Python loop over the schedule. Cross-attention K/V over the condition
sequence are computed once per trajectory (`ConditionSet.build`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from acestep_torch.config import DiTConfig
from acestep_torch.constants import SHIFT_TIMESTEPS, VALID_SHIFTS, VALID_TIMESTEPS
from acestep_torch.models.dit import decoder_cross_kv, dit_decoder


def build_turbo_schedule(shift: float = 3.0,
                         timesteps: Optional[Sequence[float]] = None):
    """Resolve the discrete turbo schedule: custom timesteps snap to the
    nearest of the 20 valid values; otherwise shift snaps to {1, 2, 3}."""
    if timesteps is not None:
        ts = [float(t) for t in timesteps]
        while ts and ts[-1] == 0:
            ts.pop()
        if len(ts) > 20:
            ts = ts[:20]
        if ts:
            return [min(VALID_TIMESTEPS, key=lambda v: abs(v - t)) for t in ts]
    s = min(VALID_SHIFTS, key=lambda v: abs(v - shift))
    return list(SHIFT_TIMESTEPS[s])


def truncate_for_cover_noise(schedule, cover_noise_strength: float):
    """Start the trajectory from the timestep nearest to
    1 - cover_noise_strength. Returns (schedule', start_t), start_t None
    when nothing is truncated."""
    if cover_noise_strength <= 0.0:
        return list(schedule), None
    effective = 1.0 - cover_noise_strength
    body = list(schedule[:-1]) if schedule[-1] == 0.0 else list(schedule)
    nearest = min(body, key=lambda v: abs(v - effective))
    return list(schedule[body.index(nearest):]), nearest


@dataclasses.dataclass
class ConditionSet:
    """Per-layer cross K/V (stacked (n_layers, B, Lk, Hkv, D) k and v) and
    the context latents of one condition."""
    cross_kv: tuple
    context_latents: torch.Tensor

    @classmethod
    def build(cls, model, cfg: DiTConfig, enc, context_latents):
        return cls(decoder_cross_kv(model, cfg, enc), context_latents)


def _select_condition(a: ConditionSet, b: Optional[ConditionSet],
                      use_a: bool):
    if b is None or use_a:
        return a.cross_kv, a.context_latents
    return b.cross_kv, b.context_latents


def get_x0_from_noise(zt, vt, t):
    return zt - vt * torch.as_tensor(t, device=zt.device).reshape(
        -1, 1, 1).to(zt.dtype)


def renoise(x, t, noise):
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if t.dim() != x.dim():
        t = t.reshape((-1,) + (1,) * (x.dim() - 1))
    return t * noise + (1 - t) * x


def sample_turbo(model, cfg: DiTConfig, *, x_init: torch.Tensor,
                 schedule: Sequence[float], cond: ConditionSet,
                 cond_non_cover: Optional[ConditionSet] = None,
                 cover_steps: Optional[int] = None,
                 infer_method: str = "ode",
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Discrete-schedule sampler. `schedule` lists the visited timesteps
    (no trailing 0); the last step lands on x0 (both updates reduce to it
    when t_next == 0). `generator` draws the SDE renoise noise."""
    n = len(schedule)
    ts = torch.tensor(list(schedule) + [0.0], dtype=x_init.dtype,
                      device=x_init.device)
    bsz = x_init.shape[0]
    cover_cut = n if cover_steps is None else cover_steps
    xt = x_init
    for i in range(n):
        t, t_next = ts[i], ts[i + 1]
        t_vec = t.expand(bsz)
        kv, ctx = _select_condition(cond, cond_non_cover, i < cover_cut)
        vt = dit_decoder(model, cfg, xt, t_vec, t_vec, ctx, cross_kv_cache=kv)
        if infer_method == "sde":
            noise = torch.randn(xt.shape, generator=generator,
                                device=xt.device, dtype=xt.dtype)
            xt = renoise(get_x0_from_noise(xt, vt, t_vec), t_next, noise)
        else:
            xt = xt - vt * (t - t_next)
    return xt
