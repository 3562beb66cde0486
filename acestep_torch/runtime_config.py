"""Device-memory tier policy: batch and duration ceilings, VAE decode chunk
size and which LM planner fits, keyed off the device's memory, with a CPU
tier for tests. The tier table is the JAX package's, unchanged; on a CUDA
device the memory comes from `torch.cuda.mem_get_info`.

`ACESTEP_MAX_HBM_GB` overrides detection so every tier is testable anywhere.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DeviceTierConfig:
    name: str
    hbm_gb: float
    max_duration_s: int          # generation ceiling
    max_batch: int               # simultaneous songs
    lm_size: Optional[str]       # "0.6B" | "1.7B" | "4B" | None
    decode_chunk: int            # tiled VAE decode chunk (latent frames)
    encode_chunk: int
    lm_max_len: int              # planner context budget
    lm_quantization: Optional[str] = None   # None | int8 | fp8 | w8a8
    notes: str = ""


# Tier table (ascending device memory), as in acestep_tpu/runtime_config.py.
_TIERS = (
    DeviceTierConfig("tier_cpu", 0.0, 600, 8, None, 128, 512, 2048,
                     notes="CPU/testing: host RAM is not the constraint; "
                           "no LM planner by default"),
    # any POSITIVE hbm below 8 GB (e.g. ACESTEP_MAX_HBM_GB=4 tier
    # simulation) lands here, NOT on the unconstrained CPU tier — a
    # 4 GB device must get tighter ceilings than an 8 GB one
    DeviceTierConfig("tier_4g", 0.1, 120, 1, None, 64, 256, 1024,
                     notes="small-memory accelerator: tight ceilings, "
                           "no LM planner"),
    DeviceTierConfig("tier_8g", 8.0, 240, 2, "0.6B", 128, 512, 2048,
                     lm_quantization="w8a8"),
    DeviceTierConfig("tier_16g", 16.0, 600, 8, "4B", 256, 1024, 4096,
                     lm_quantization="w8a8",
                     notes="4B planner at w8a8 (int8 trunk + int8 "
                           "output head)"),
    DeviceTierConfig("tier_32g", 32.0, 600, 8, "4B", 512, 2048, 4096,
                     notes="4B planner at bf16"),
    DeviceTierConfig("tier_96g", 96.0, 600, 8, "4B", 512, 2048, 8192,
                     notes="large-memory budget"),
)

# Planner downgrade ladder (reference acestep_v15_pipeline.py:221-232
# downgrades the 4B planner to 1.7B when VRAM is short; here the ladder
# also tightens quantization before shrinking the model).
_LM_SMALLER = {"4B": "1.7B", "1.7B": "0.6B", "0.6B": None}


def lm_fallback_plan(tier: Optional[DeviceTierConfig] = None) -> list:
    """Ordered (size, quantization) attempts for the tier's LM planner.

    First the tier's own choice, then tighter quantization at the same
    size (w8a8, then int4 — quarter-size resident weights), then each
    smaller size at w8a8 — callers try each until one initializes without
    exhausting device memory. Keeping the model and shrinking its bytes
    first mirrors the reference's intent (downgrade only when the 4B
    can't fit, acestep_v15_pipeline.py:221-232) with one extra rung."""
    tier = tier or get_global_config()
    if tier.lm_size is None:
        return []
    # same-size rungs strictly by DECREASING weight bytes — an OOM is
    # byte-driven, so retrying the failed mode or a bigger one just
    # triggers another allocation storm (which can wedge the backend)
    rank = {None: 4, "int8": 2, "fp8": 2, "w8a8": 2, "int4": 1}
    pinned = tier.lm_quantization
    plan = [(tier.lm_size, pinned)]
    for q in ("w8a8", "int4"):
        if rank[q] < rank.get(pinned, 4) and (tier.lm_size, q) not in plan:
            plan.append((tier.lm_size, q))
    size = _LM_SMALLER.get(tier.lm_size)
    while size is not None:
        plan.append((size, "w8a8"))
        size = _LM_SMALLER.get(size)
    return plan

_GLOBAL: Optional[DeviceTierConfig] = None


def detect_hbm_gb(device=None) -> float:
    """Memory of the CUDA device in nominal GB; 0 for the CPU or when no
    GPU is present; the ACESTEP_MAX_HBM_GB override wins."""
    override = os.environ.get("ACESTEP_MAX_HBM_GB")
    if override:
        try:
            return float(override)
        except ValueError:
            pass
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return 0.0
    if not torch.cuda.is_available():
        return 0.0
    _free, total = torch.cuda.mem_get_info(device)
    usable = total / (1 << 30)
    # total is a little below the nominal size (an 80 GB card reports
    # ~79.1 GiB): snap up to the nominal capacity the tiers are keyed on
    for nominal in (96.0, 80.0, 48.0, 32.0, 24.0, 16.0, 8.0):
        if nominal * 0.88 <= usable <= nominal:
            return nominal
    return usable


def get_tier_config(hbm_gb: Optional[float] = None) -> DeviceTierConfig:
    """Largest tier whose hbm_gb <= available memory."""
    hbm = detect_hbm_gb() if hbm_gb is None else hbm_gb
    chosen = _TIERS[0]
    for tier in _TIERS:
        if hbm >= tier.hbm_gb:
            chosen = tier
    return chosen


def get_global_config() -> DeviceTierConfig:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = get_tier_config()
    return _GLOBAL


def set_global_config(cfg: DeviceTierConfig) -> None:
    global _GLOBAL
    _GLOBAL = cfg


def effective_batch(requested: int,
                    tier: Optional[DeviceTierConfig] = None) -> int:
    """Clamp a requested batch to the tier ceiling (the reference's
    VRAM-guard batch reduction, memory_utils.py:105-155)."""
    tier = tier or get_global_config()
    return max(1, min(requested, tier.max_batch))


def effective_duration(requested: float,
                       tier: Optional[DeviceTierConfig] = None) -> float:
    """Clamp to the tier ceiling only. No minimum: the reference passes
    short durations through unchanged (generate_music_request.py:73 only
    nulls non-positive values), and a silent 10 s floor both rewrote real
    sub-10 s requests and inflated every tiny test/dryrun ~13x."""
    tier = tier or get_global_config()
    return float(min(requested, tier.max_duration_s))
