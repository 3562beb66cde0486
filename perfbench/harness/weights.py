"""Seeded weights, made on the device in a few large calls.

One flat buffer holds every tensor of a model, in the order of their
sorted names. A torch.Generator on the device, seeded from the run's seed
and the model's name, fills it with N(0, 1) draws in chunks of float32;
each chunk is scaled and shifted by the tensor its elements belong to (a
per-element std and mean made by `repeat_interleave` over the chunk), and
rounded to the served dtype. The program gets views of that buffer; the
reference draws the same buffer again and widens it to float32, so both
compute from the same values.

Distributions, by the last part of a tensor's name: norm scales
1 + N(0, 0.1); biases N(0, 0.02); snake alpha and beta N(0, 0.1); AdaLN
tables N(0, hidden^-0.5); the null condition N(0, 1); every other weight
N(0, 0.02).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

CHUNK = 1 << 27           # elements drawn a call (512 MiB of float32)
_STREAMS = {"dit": 1, "vae": 2, "lm": 3}


def rule(name: str, shape: tuple) -> Tuple[float, float]:
    """(mean, std) of the tensor `name`."""
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return 1.0, 0.1
    if last == "bias":
        return 0.0, 0.02
    if last in ("alpha", "beta"):
        return 0.0, 0.1
    if last == "scale_shift_table":
        return 0.0, shape[-1] ** -0.5
    if name == "null_condition_emb":
        return 0.0, 1.0
    return 0.0, 0.02


def stream_seed(seed: int, model: str) -> int:
    """The generator seed of `model`'s weights in a run seeded `seed`."""
    return (int(seed) * 8 + _STREAMS[model]) % (1 << 63)


@torch.no_grad()
def draw(shapes: Dict[str, tuple], seed: int, model: str, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `shapes`, views into one flat `dtype` buffer on
    `device`, from the generator of (`seed`, `model`)."""
    names = sorted(shapes)
    sizes = np.array([int(np.prod(shapes[n])) for n in names], np.int64)
    params = np.array([rule(n, shapes[n]) for n in names], np.float32)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    total = int(ends[-1])
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(stream_seed(seed, model))
    for a in range(0, total, CHUNK):
        b = min(total, a + CHUNK)
        first = int(np.searchsorted(ends, a, side="right"))
        last = int(np.searchsorted(starts, b, side="left"))
        counts = np.minimum(ends[first:last], b) - np.maximum(starts[first:last], a)
        idx = torch.from_numpy(counts).to(device)
        pm = torch.from_numpy(params[first:last]).to(device)
        mean = torch.repeat_interleave(pm[:, 0], idx, output_size=b - a)
        std = torch.repeat_interleave(pm[:, 1], idx, output_size=b - a)
        x = torch.randn(b - a, generator=gen, device=device, dtype=torch.float32)
        flat[a:b] = torch.addcmul(mean, x, std)
        del x, mean, std
    return {n: flat[int(s):int(e)].view(shapes[n])
            for n, s, e in zip(names, starts, ends)}


def widen(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The same values in float32 (the reference's copy)."""
    return {n: t.float() for n, t in tensors.items()}
