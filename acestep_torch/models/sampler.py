"""Flow-matching samplers: the turbo model's discrete 8-step shift
schedules, and the base/sft models' continuous schedule with classifier-
free guidance (CFG) by batch doubling, guided by APG or ADG; ODE Euler or
SDE renoise updates, and the cover switch.

Port of `acestep_tpu/models/sampler.py`; each trajectory is a Python loop
over the schedule. Cross-attention K/V over the condition sequence are
computed once per trajectory (`ConditionSet.build`), and the doubled
[cond; null] condition once per side of the cover switch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from acestep_torch.config import DiTConfig
from acestep_torch.constants import SHIFT_TIMESTEPS, VALID_SHIFTS, VALID_TIMESTEPS
from acestep_torch.models.dit import decoder_cross_kv, dit_decoder
from acestep_torch.utils import trace


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


def build_continuous_schedule(infer_steps: int, shift: float = 1.0):
    """linspace(1, 0, steps + 1) in float32 with the shift warp
    t <- s t / (1 + (s - 1) t): steps + 1 values ending at 0, on the host."""
    t = np.linspace(1.0, 0.0, infer_steps + 1, dtype=np.float32)
    if shift != 1.0:
        t = np.float32(shift) * t / (1 + (np.float32(shift) - 1) * t)
    return [float(v) for v in t]


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


# ------------------------------------------------------------------
# Guidance (APG / ADG)
# ------------------------------------------------------------------


def apg_step(pred_cond, pred_uncond, running_avg, *, guidance_scale: float,
             momentum: float = -0.75, eta: float = 0.0,
             norm_threshold: float = 2.5):
    """One APG update in float32 over the time axis (dim 1) of (B, T, C).
    Returns (guided, new_running_avg)."""
    cond = pred_cond.float()
    running = cond - pred_uncond.float() + momentum * running_avg
    d = running
    if norm_threshold > 0:
        n = torch.linalg.vector_norm(d, dim=1, keepdim=True)
        d = d * torch.clamp(norm_threshold / n, max=1.0)
    # the 1e-12 floor keeps an all-zero column of pred_cond from giving NaN
    v1 = cond / torch.clamp(torch.linalg.vector_norm(cond, dim=1,
                                                     keepdim=True), min=1e-12)
    parallel = (d * v1).sum(dim=1, keepdim=True) * v1
    update = d - parallel + eta * parallel
    guided = cond + (guidance_scale - 1) * update
    return guided.to(pred_cond.dtype), running


def adg_step(latents, pred_cond, pred_uncond, sigma, *, guidance_scale: float,
             angle_clip: float = 3.14 / 6, apply_norm: bool = False,
             apply_clip: bool = True):
    """Angle-based Dynamic Guidance, in float32: the conditional x0
    estimate is rotated away from the unconditional one by `weight` times
    their angle (clipped), per frame over the channels."""
    x, vc, vu = latents.float(), pred_cond.float(), pred_uncond.float()
    n, t, c = vc.shape
    sigma = torch.as_tensor(sigma, device=x.device).reshape(-1, 1, 1).float()
    sigma = sigma.expand(n, 1, 1)

    weight = guidance_scale - 1
    weight = weight * (weight > 0) + 1e-3

    hat_c = x - sigma * vc
    hat_u = x - sigma * vu
    diff = hat_c - hat_u

    def _unit(v):
        return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)

    flat_c, flat_u = hat_c.reshape(-1, c), hat_u.reshape(-1, c)
    cos = (_unit(flat_c) * _unit(flat_u)).sum(dim=1, keepdim=True)
    theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    theta_new = (torch.clamp(weight * theta, -angle_clip, angle_clip)
                 if apply_clip else weight * theta)

    fd = diff.reshape(-1, c)
    dot = (fd * flat_u).sum(dim=1, keepdim=True)
    nrm = (flat_u * flat_u).sum(dim=1, keepdim=True)
    perp = (fd - (dot / (nrm + 1e-8)) * flat_u).reshape(n, t, c)

    v_new = torch.cos(theta_new).reshape(n, t, 1) * hat_c
    sin_t = torch.sin(theta)
    # near-parallel estimates (sin theta ~ 0) take `weight` as the ratio
    ratio = torch.where(sin_t > 1e-3, torch.sin(theta_new) / torch.where(
        sin_t > 1e-3, sin_t, 1.0), weight)
    latent_new = v_new + perp * ratio.reshape(n, t, 1)
    if apply_norm:
        latent_new = latent_new * torch.linalg.vector_norm(
            hat_c, dim=1, keepdim=True) / torch.linalg.vector_norm(
            latent_new, dim=1, keepdim=True)
    return ((x - latent_new) / sigma).to(pred_cond.dtype)


# ------------------------------------------------------------------
# Samplers
# ------------------------------------------------------------------


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


def step_noise(xt: torch.Tensor, generator: Optional[torch.Generator],
               noise_rows: Optional[tuple] = None) -> torch.Tensor:
    """The SDE renoise draw for xt. `noise_rows` (full batch, first row)
    marks xt as one dp rank's block of a batch split over a mesh: the
    rank draws the full batch's noise and keeps its rows, so the stream
    is the unsplit render's."""
    if noise_rows is None:
        return torch.randn(xt.shape, generator=generator, device=xt.device,
                           dtype=xt.dtype)
    full, first = noise_rows
    noise = torch.randn((full,) + tuple(xt.shape[1:]), generator=generator,
                        device=xt.device, dtype=xt.dtype)
    return noise[first:first + xt.shape[0]]


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
                 generator: Optional[torch.Generator] = None,
                 noise_rows: Optional[tuple] = None) -> torch.Tensor:
    """Discrete-schedule sampler. `schedule` lists the visited timesteps
    (no trailing 0); the last step lands on x0 (both updates reduce to it
    when t_next == 0). `generator` draws the SDE renoise noise
    (`step_noise`, with `noise_rows` on a dp rank)."""
    n = len(schedule)
    ts = torch.tensor(list(schedule) + [0.0], dtype=x_init.dtype,
                      device=x_init.device)
    bsz = x_init.shape[0]
    cover_cut = n if cover_steps is None else cover_steps
    xt = x_init
    for i in range(n):
        with trace.span("dit.step", step=i):
            t, t_next = ts[i], ts[i + 1]
            t_vec = t.expand(bsz)
            kv, ctx = _select_condition(cond, cond_non_cover, i < cover_cut)
            vt = dit_decoder(model, cfg, xt, t_vec, t_vec, ctx,
                             cross_kv_cache=kv)
            if infer_method == "sde":
                noise = step_noise(xt, generator, noise_rows)
                xt = renoise(get_x0_from_noise(xt, vt, t_vec), t_next, noise)
            else:
                xt = xt - vt * (t - t_next)
        trace.count("dit_steps")
    return xt


def sample_guided(model, cfg: DiTConfig, *, x_init: torch.Tensor,
                  schedule: Sequence[float], cond: ConditionSet,
                  null_cond: Optional[ConditionSet],
                  cond_non_cover: Optional[ConditionSet] = None,
                  null_cond_non_cover: Optional[ConditionSet] = None,
                  cover_steps: Optional[int] = None,
                  guidance_scale: float = 7.0,
                  cfg_interval: tuple = (0.0, 1.0),
                  use_adg: bool = False,
                  infer_method: str = "ode",
                  generator: Optional[torch.Generator] = None,
                  noise_rows: Optional[tuple] = None) -> torch.Tensor:
    """Continuous-schedule CFG sampler (base/sft). `schedule` has steps + 1
    values ending at 0. CFG doubles the batch on dim 0 ([cond; null]);
    guidance is APG (with a float32 momentum buffer carried across steps)
    or ADG, applied only while t lies inside `cfg_interval`. The schedule
    and the interval test take `x_init`'s dtype, as in the JAX package;
    the host decides them from its own copy, so no step waits for the
    device. `generator` draws the SDE renoise noise (`step_noise`, with
    `noise_rows` on a dp rank)."""
    do_cfg = guidance_scale > 1.0 and null_cond is not None
    n = len(schedule) - 1
    dtype, dev = x_init.dtype, x_init.device
    ts_host = torch.tensor(list(schedule), dtype=dtype)
    ts = ts_host.to(dev)
    bsz = x_init.shape[0]
    cover_cut = n if cover_steps is None else cover_steps
    switches = cond_non_cover is not None or null_cond_non_cover is not None

    def batched_condition(use_cover: bool):
        kv_c, ctx_c = _select_condition(cond, cond_non_cover, use_cover)
        if not do_cfg:
            return kv_c, ctx_c
        kv_u, ctx_u = _select_condition(null_cond, null_cond_non_cover,
                                        use_cover)
        # cross K/V are stacked (n_layers, B, Lk, Hkv, D): batch is dim 1
        kv = tuple(torch.cat([a, b], dim=1) for a, b in zip(kv_c, kv_u))
        return kv, torch.cat([ctx_c, ctx_u], dim=0)

    momentum = torch.zeros(x_init.shape, dtype=torch.float32, device=dev)
    xt = x_init
    side = None
    for i in range(n):
        with trace.span("dit.step", step=i):
            use_cover = i < cover_cut
            if side is None or (switches and side[0] != use_cover):
                side = (use_cover, *batched_condition(use_cover))
            _, kv, ctx = side
            t, t_next = ts[i], ts[i + 1]
            rows = 2 * bsz if do_cfg else bsz
            x_in = torch.cat([xt, xt], dim=0) if do_cfg else xt
            v = dit_decoder(model, cfg, x_in, t.expand(rows), t.expand(rows),
                            ctx, cross_kv_cache=kv)
            if do_cfg:
                v_cond, v_uncond = v.chunk(2, dim=0)
                vt = v_cond
                if cfg_interval[0] <= ts_host[i] <= cfg_interval[1]:
                    if use_adg:
                        vt = adg_step(xt, v_cond, v_uncond, t,
                                      guidance_scale=guidance_scale)
                    else:
                        vt, momentum = apg_step(v_cond, v_uncond, momentum,
                                                guidance_scale=guidance_scale)
            else:
                vt = v
            if infer_method == "sde":
                noise = step_noise(xt, generator, noise_rows)
                # renoise at the UNSHIFTED linear timestep 1 - (i+1)/n, n the
                # step count after cover-noise truncation (not the next
                # schedule value: the two agree only at shift 1)
                lin_next = 1.0 - torch.tensor(float(i + 1), dtype=dtype) / n
                xt = renoise(get_x0_from_noise(xt, vt, t.expand(bsz)),
                             lin_next, noise)
            else:
                xt = xt - vt * (t - t_next)
        trace.count("dit_steps")
    return xt
