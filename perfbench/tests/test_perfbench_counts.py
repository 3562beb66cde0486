"""The frozen count formulas against the port's tooling they were copied
from: `bench_torch.dit_flops`, and the K1 / K4 operation and byte counts
written inline in `chip_smoke.py`, at that file's own shapes."""

import dataclasses
import inspect
import json
import os

import pytest
import torch
from conftest import PERFBENCH

from harness import counts

with open(os.path.join(PERFBENCH, "configs", "acestep-v15-turbo.json")) as f:
    CONF = json.load(f)


@pytest.mark.parametrize("frames,cond_len,steps,batch,cfg_steps", [
    (1500, 577, 8, 1, 0), (750, 577, 8, 8, 0), (15000, 577, 8, 1, 0),
    (1500, 577, 50, 1, 50), (751, 300, 8, 2, 0)])
def test_dit_flops_equal_bench_torch(frames, cond_len, steps, batch, cfg_steps):
    import bench_torch
    from acestep_torch.config import DiTConfig

    want = bench_torch.dit_flops(DiTConfig.turbo(), frames, cond_len, steps,
                                 batch, cfg_steps)
    assert counts.dit_flops(CONF["dit"], frames, cond_len, steps, batch,
                            cfg_steps) == want


def test_config_is_the_ports_turbo():
    from acestep_torch.config import DiTConfig, VAEConfig

    dit = dataclasses.asdict(DiTConfig.turbo())
    dit["layer_types"] = None
    assert {k: tuple(v) if isinstance(v, list) else v
            for k, v in CONF["dit"].items()} == dit
    assert {k: tuple(v) if isinstance(v, list) else v
            for k, v in CONF["vae"].items()} == dataclasses.asdict(VAEConfig())


def _chip_smoke_line(fn, lhs: str) -> str:
    """The right-hand side of `lhs = ...` in chip_smoke's `fn`, joined over
    continuation lines."""
    import chip_smoke

    src = inspect.getsource(getattr(chip_smoke, fn))
    start = src.index(f"{lhs} = ")
    expr, depth = "", 0
    for line in src[start + len(lhs) + 3:].splitlines():
        expr += line.strip() + " "
        depth += line.count("(") - line.count(")")
        if depth <= 0:
            break
    return expr


@pytest.mark.parametrize("B,L,window,heads", [
    (1, 750, None, (16, 8)), (1, 750, 128, (16, 8)), (2, 750, None, (16, 8)),
    (2, 750, 128, (16, 8)), (1, 7500, None, (16, 8)), (1, 750, None, (8, 4))])
def test_k1_counts_equal_chip_smoke(B, L, window, heads):
    """chip_smoke counts the pairs from the band mask itself."""
    (Hq, Hkv), D = heads, 128
    if window is None:
        pairs = L * L
    else:
        i = torch.arange(L)
        pairs = int(((i[:, None] - i[None, :]).abs() <= window).sum())
    env = dict(B=B, L=L, Hq=Hq, Hkv=Hkv, D=D, pairs=pairs)
    flops = eval(_chip_smoke_line("_k1_case", "flops"), {}, env)
    nbytes = eval(_chip_smoke_line("_k1_case", "nbytes"), {}, env)
    assert counts.k1_ops_bytes(B, L, Hq, Hkv, D, window) == (flops, nbytes)


@pytest.mark.parametrize("N,L,C", [(4, 491520, 128), (1, 30720, 256),
                                   (2, 122880, 64), (1, 7680, 16)])
def test_k4_counts_equal_chip_smoke(N, L, C):
    env = dict(N=N, L=L, C=C)
    flops = eval(_chip_smoke_line("_k4_case", "flops"), {}, env)
    nbytes = eval(_chip_smoke_line("_k4_case", "nbytes"), {}, env)
    assert counts.k4_ops_bytes(N, L, C) == (flops, nbytes)


def test_vae_decode_flops_count_the_decoder():
    """The decoder's convolutions counted layer by layer from the module
    (2 x MACs of every conv and transposed conv) over a T-frame decode."""
    from acestep_torch.config import VAEConfig
    from acestep_torch.models.vae import OobleckVAE

    T = 10
    vae = OobleckVAE(VAEConfig(), device="meta").decoder
    total, L = 0.0, T
    total += 2 * L * vae.conv1.weight[0].numel() * vae.conv1.weight.shape[0]
    for blk, s in zip(vae.blocks, reversed(VAEConfig().downsampling_ratios)):
        w = blk.up.weight                       # (in, out, k)
        total += 2 * L * w.numel()
        L *= s
        for u in (blk.res1, blk.res2, blk.res3):
            total += 2 * L * (u.conv1.weight.numel() + u.conv2.weight.numel())
    total += 2 * L * vae.conv2.weight.numel()
    assert counts.vae_decode_flops(CONF["vae"], T) == pytest.approx(total)


def test_banded_pairs():
    for L, w in [(10, 3), (5, 8), (375, 128), (1, 0), (3000, 128)]:
        i = torch.arange(L)
        assert counts.banded_pairs(L, w) == int(
            ((i[:, None] - i[None, :]).abs() <= w).sum())
    assert counts.banded_pairs(7, None) == 49
