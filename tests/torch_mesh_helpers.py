"""Mesh commands and world set-up for the tests of `acestep_torch.parallel`.

A follower process runs a command by importing its module, so the commands
the tests send live here, in a module that imports neither JAX nor the
JAX package."""

from __future__ import annotations

import contextlib
import tempfile

import torch

from acestep_torch.models.dit import dit_decoder
from acestep_torch.parallel import make_mesh


@contextlib.contextmanager
def store_under(path):
    """Worlds started inside the block keep their FileStore under `path`."""
    old = tempfile.tempdir
    tempfile.tempdir = str(path)
    try:
        yield
    finally:
        tempfile.tempdir = old


def cpu_world(path, ranks: int = 4):
    """Generator for a module fixture: a world of `ranks` CPU ranks (gloo)
    held open by a 1-rank-per-row mesh, closed (its followers stopped)
    after the module."""
    with store_under(path):
        anchor = make_mesh(ranks, 1, devices=["cpu"] * ranks)
    try:
        yield anchor
    finally:
        anchor.close()


def decoder_forward(ctx, root, key, cfg, xt, t, context, enc):
    """One `dit_decoder` pass on every rank's shard under `key`."""
    dev = ctx.device
    t = t.to(dev)
    return dit_decoder(ctx.objects[key], cfg, xt.to(dev), t, t,
                       context.to(dev), encoder_hidden_states=enc.to(dev))


def fail_on(ctx, root, rank: int):
    """Raise on one rank only."""
    if ctx.rank == rank:
        raise ValueError(f"planned failure on rank {rank}")
    return torch.zeros(1)


def oom_on(ctx, root, rank: int):
    """Run out of device memory, as the caching allocator says it, on one
    rank only."""
    if ctx.rank == rank:
        raise torch.cuda.OutOfMemoryError(
            f"CUDA out of memory (planned, rank {rank})")
    return torch.zeros(1)
