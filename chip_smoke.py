#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (acestep_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines and its seconds; any failed check raises,
so the exit code is non-zero and no result line is printed:

1. device: the card's name and power limit (nvidia-smi) and the versions;
   no CUDA device is an error.
2. build: the hand-written kernels of acestep_torch/csrc, built with nvcc.
3. kernels: K1 (flash attention), K4 (snake + conv stack) and the flash
   backward's K2 (dQ) and K3 (dK/dV) against their plain PyTorch versions
   at the shapes the main paths give them, with kernel, plain-version and
   library times (CUDA events around calls queued behind a spin kernel,
   so host cost does not enter: `cuda_ms`) and the bound the card's
   published peaks set for the same work; K2/K3's limit is also held
   against controls (the plain backward with a fault) that it must catch,
   and both must give the same bits twice. K1 at (1, 750) also reports
   host microseconds per call (`k1_host_us`); K4 is timed through its C
   entry and through its wrapper (`wrapper_ms`, weights packed once a
   stack and cached).
4. reference: a small model through the port's handler on the card (bf16,
   kernels) against the same weights on the CPU (fp32, plain versions);
   then one LoRA step of a small model, card against CPU: the loss and
   every target's adapter gradient, and a control step with the attention
   backward's delta left out that the gradient limit must catch.
5. end to end: full-width turbo text2music (DiTConfig.turbo(), VAEConfig(),
   bf16, seeded random weights) through acestep_torch.inference.
   generate_music, three requests; the kernels' launch counters show the
   path went through K1 and K4.
6. training: two seeded 120 s songs through the port's training CLI at
   full width (DiTConfig(), VAEConfig(), bf16 base, fp32 adapters):
   `preprocess`, then `vanilla` for 8 LoRA steps (rank 16, all 11 targets,
   a checkpoint every 4), then a resume from checkpoint_4 to step 8; the
   counters show the path went through K1, K2, K3 (decoder) and K4 (VAE
   encoder, at least as often per song as phase 5's handler launches it
   to encode one such song).

The launch counts of the kernel table are those of phases 5 and 6. The
last two lines are the kernel table and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import statistics
import subprocess
import tempfile
import time
from unittest import mock

# Published peaks of one H100 SXM (dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# clock cycles a second the timer's spin kernel is sized with (an H100's
# boost clock, 1.98 GHz, rounded up: a longer spin only waits longer)
SPIN_CYCLES_PER_S = 2.0e9

# Tolerances, scaled by max(1, max|ref|); the reference is the plain
# version in fp32 from the same bf16 inputs. Both kernels round operands to
# bf16 (P before P.V; the snake outputs before each conv) and store bf16
# output (~4e-3 relative), over sums of 64-896 terms.
TOL_K1_OUT = 2e-2
TOL_K1_LSE = 2e-3       # absolute; lse is fp32 from the same logits
TOL_K4 = 2e-2
# K2/K3: ||kernel - plain|| / ||plain|| per gradient, plain in fp32 from the
# same bf16 inputs. The kernels round P and dS to bf16 before their products
# (K1's rule) and store bf16 gradients. The limit sits between these
# readings and controls read on the card at the same shapes: the plain
# backward with delta left out (dq, dk) and with the second query head of
# each KV group left out (dv); a control that does not exceed the limit
# fails the run, since the check could then not see that fault.
TOL_K23 = 1e-2
# bf16 on the card against fp32 on the CPU, same weights and noise, through
# 2 layers x 8 steps and the VAE: relative to the largest value.
TOL_REFERENCE = 5e-2
# One LoRA step of a 2-layer model, bf16 on the card (kernels) against fp32
# on the CPU (plain versions), same weights, adapter and draws: the loss
# relative to itself (a mean over every latent, so bf16's ~0.4% noise per
# operand averages out); each target's adapter gradient as ||card - CPU||
# / ||CPU||, whose limit sits between the readings and a control: the card
# step with the attention backward's delta left out.
TOL_TRAIN_LOSS = 1e-3
TOL_TRAIN_GRAD = 5e-2

# seconds of each seeded training song (the 120 s, 3000-frame sample cap)
TRAIN_SONG_SECONDS = 120.0

K1_SOURCE = "acestep_torch/csrc/flash_attention.cu"
K1_REPLACES = "acestep_tpu/ops/flash_attention.py:49"
K4_SOURCE = "acestep_torch/csrc/snake_conv.cu"
K4_REPLACES = "acestep_tpu/ops/snake_conv.py:78"
K23_SOURCE = "acestep_torch/csrc/flash_attention_bwd.cu"
K2_REPLACES = "acestep_tpu/ops/flash_attention.py:217"
K3_REPLACES = "acestep_tpu/ops/flash_attention.py:268"


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls, with the
    host out of the reading.

    A spin kernel (`torch.cuda._sleep`) holds the device while the host
    enqueues the start event, all `reps` calls and the end event behind
    it, so the calls run back to back on the device whatever each costs on
    the host (a wrapper's checks and ctypes call, PyTorch's dispatcher).
    The spin is sized from the host's own enqueue time. The reading holds
    if the start event had not fired when the host was done enqueueing, or
    if a call takes the device more than twice the host's cost of one call
    (then the host stays ahead once the spin has covered the first call,
    and a host blocked on a full launch queue does not starve the device).
    Otherwise it is taken again with twice the spin. The launches of the
    `reps` calls must fit the device's launch queue (about a thousand):
    past it the host waits behind the spin, and the check fails.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    one_call_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        one_call_s = min(one_call_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * host_s * SPIN_CYCLES_PER_S) + 1_000_000
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        caught_up = start.query()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        if not caught_up or ms > 2e3 * one_call_s:
            return ms
        cycles *= 2
    raise AssertionError("cuda_ms: the device caught up with the host four "
                         "times; the reading would include host time")


def host_us_per_call(fn, calls: int = 1000, chunk: int = 100) -> float:
    """Host microseconds per call of `fn` (its enqueue cost): `calls` calls
    in chunks timed with `time.perf_counter` and no synchronise inside a
    chunk; the device is drained between chunks, untimed, so its queue
    never fills and blocks the host. The median chunk, so that a chunk the
    shared host preempted does not set the reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls // chunk):
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        per_call.append((time.perf_counter() - t0) / chunk)
        torch.cuda.synchronize()
    return statistics.median(per_call) * 1e6


def k1_host_us(q, k, v, window) -> dict:
    """K1's host microseconds per call (`host_us_per_call`), read in
    alternating rounds in one process: its wrapper (checks, two
    `torch.empty`, the ctypes call) and its C entry alone with its
    arguments made once (the tensor-map encodes and the launch)."""
    import torch

    from acestep_torch.ops import _build
    from acestep_torch.ops import flash_attention as fa

    lib = _build.library()
    B, L, Hq, D = q.shape
    w = -1 if window is None else window
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    lse = torch.zeros((B, Hq, L), dtype=torch.float32, device="cuda")
    fwd = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr(), B, L, L, Hq, k.shape[2], *q.stride()[:3],
           *k.stride()[:3], *v.stride()[:3], w, D ** -0.5, stream)
    calls = {
        "wrapper": lambda: fa.flash_attention_cuda(q, k, v, window),
        "c_entry": lambda: lib.acestep_flash_fwd(*fwd)}
    _build.check(calls["c_entry"](), "acestep_flash_fwd")
    rounds = {name: [] for name in calls}
    for r in range(6):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            rounds[name].append(host_us_per_call(calls[name]))
    us = {name: statistics.median(x) for name, x in rounds.items()}
    return {**us, "rounds": rounds}


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    emit(phase="device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def phase_build():
    from acestep_torch.ops import _build

    t0 = time.time()
    _build.library()
    # ptxas's registers, spills and shared memory per kernel
    ptxas = [line.split("info    :")[-1].strip()
             for line in _build.build_log.splitlines()
             if "registers" in line or "spill" in line]
    emit(phase="build", seconds=time.time() - t0,
         nvcc_seconds=_build.build_seconds, ptxas=ptxas)


def _k1_case(B, L, window, seed, host=False):
    """K1 against its plain version; with `host`, also its host
    microseconds per call (`k1_host_us`)."""
    import torch
    import torch.nn.functional as F

    from acestep_torch.ops import flash_attention as fa

    Hq, Hkv, D = 16, 8, 128
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, L, h, D), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    out, lse = fa.flash_attention_with_lse(q, k, v, window=window)
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            window)
    scale = max(1.0, ref.abs().max().item())
    err = (out.float() - ref).abs().max().item()
    rel = err / scale
    lse_err = (lse - ref_lse).abs().max().item()
    if not (rel < TOL_K1_OUT and lse_err < TOL_K1_LSE):
        raise AssertionError(f"K1 B={B} L={L} W={window}: out err {rel:.3e} "
                             f"(tol {TOL_K1_OUT}), lse err {lse_err:.3e} "
                             f"(tol {TOL_K1_LSE})")
    if window is None:
        pairs, mask = L * L, None
    else:
        i = torch.arange(L, device="cuda")
        mask = (i[:, None] - i[None, :]).abs() <= window
        pairs = int(mask.sum())
    flops = 4.0 * B * Hq * D * pairs
    nbytes = 2 * (2 * B * L * Hq * D + 2 * B * L * Hkv * D) + 4 * B * Hq * L
    bound_ms, bound_by = bound(flops, nbytes)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec = dict(
        kernel="K1", B=B, L=L, Hq=Hq, Hkv=Hkv, D=D, window=window,
        max_abs_err=err, max_rel_err=rel, lse_err=lse_err,
        kernel_ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, window),
                          20),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, window),
                         5, 1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 20),
        bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
    if host:
        rec["host_us_per_call"] = k1_host_us(q, k, v, window)
    emit(phase="kernels", **rec)
    return rec


def _k4_units(C, seed):
    import torch

    from acestep_torch.models.vae import ResUnit

    g = torch.Generator("cuda").manual_seed(seed)
    units = []
    for _ in range(3):
        u = ResUnit(C, device="cuda", dtype=torch.float32)
        with torch.no_grad():
            for p in u.parameters():
                p.normal_(0.0, 0.05, generator=g)
            for sn in (u.snake1, u.snake2):
                sn.alpha.normal_(0.0, 0.3, generator=g)
                sn.beta.normal_(0.0, 0.3, generator=g)
        units.append(u.to(torch.bfloat16))
    return units


def _k4_case(N, L, C, seed):
    import torch

    from acestep_torch.ops import _build
    from acestep_torch.ops import snake_conv as sc

    units = _k4_units(C, seed)
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((N, L, C), generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        got = sc.res_unit_stack(units, x)
        ref_units = [copy.deepcopy(u).float() for u in units]
        ref = sc.res_unit_stack_plain(ref_units, x.float())
        scale = max(1.0, ref.abs().max().item())
        err = (got.float() - ref).abs().max().item()
        del ref, ref_units
        torch.cuda.empty_cache()
        rel = err / scale
        if not rel < TOL_K4:
            raise AssertionError(f"K4 N={N} L={L} C={C}: err {rel:.3e} "
                                 f"(tol {TOL_K4})")
        flops = 48.0 * C * C * N * L
        nbytes = 2 * 2 * N * L * C + 3 * 8 * C * C * 2
        bound_ms, bound_by = bound(flops, nbytes)
        # the kernel alone, through the C entry point the wrapper calls,
        # with its arguments made once; and through the wrapper, whose
        # packed weights are cached on the units (two torch.empty a call)
        lib = _build.library()
        packed = sc.packed_params(units, x.device)
        out = torch.empty_like(x)
        scratch = torch.empty((2, N, L, C), dtype=torch.float32,
                              device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                *[p.data_ptr() for p in packed.params], packed.wmap)

        def k4():
            return lib.acestep_snake_conv(*args, N, L, C, stream)

        _build.check(k4(), "acestep_snake_conv")
        rec = dict(
            kernel="K4", N=N, L=L, C=C, max_abs_err=err, max_rel_err=rel,
            kernel_ms=cuda_ms(k4, 20),
            wrapper_ms=cuda_ms(lambda: sc.res_unit_stack(units, x), 20),
            plain_ms=cuda_ms(lambda: sc.res_unit_stack_plain(units, x), 3, 1),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            flops=flops, bytes=nbytes)
    emit(phase="kernels", **rec)
    return rec


def _k23_case(B, L, window, seed):
    """K2 and K3 at a training shape: errors against the plain backward in
    fp32, each kernel's time alone, the plain backward's time (one call
    computes dq, dk and dv), and SDPA's backward (forward + backward minus
    forward) as the library time of the pair."""
    import torch
    import torch.nn.functional as F

    from acestep_torch.ops import _build
    from acestep_torch.ops import flash_attention as fa

    Hq, Hkv, D = 16, 8, 128
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn((B, L, h, D), generator=g, device="cuda")
                     .to(torch.bfloat16) for h in (Hq, Hkv, Hkv, Hq))
    out, lse = fa.flash_attention_cuda(q, k, v, window)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, window)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, window)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K2/K3 B={B} L={L} W={window}: two runs "
                             f"differ; the kernels must be deterministic")
    del again
    qf, kf, vf, of, df = (x.float() for x in (q, k, v, out, dout))
    ref = fa.flash_attention_bwd_plain(qf, kf, vf, of, lse, df, window)
    # the controls: delta = rowsum(dO * O) is 0 when O is; the second head
    # of each group is query head 1 + G * kv_head
    no_delta = fa.flash_attention_bwd_plain(qf, kf, vf, torch.zeros_like(of),
                                            lse, df, window)
    one_head = df.clone()
    one_head[:, :, 1::Hq // Hkv] = 0
    no_head = fa.flash_attention_bwd_plain(qf, kf, vf, of, lse, one_head,
                                           window)
    controls = {"dq": no_delta[0], "dk": no_delta[1], "dv": no_head[2]}

    def rel(a, r):
        return ((a.float() - r).norm() / r.norm()).item()

    errs = {name: ((a.float() - r).abs().max().item(), rel(a, r),
                   rel(controls[name], r))
            for name, a, r in zip(("dq", "dk", "dv"), got, ref)}
    del ref, got, no_delta, no_head, controls, one_head
    torch.cuda.empty_cache()
    bad = {n: e for n, e in errs.items()
           if not e[1] < TOL_K23 < e[2]}
    if bad:
        raise AssertionError(
            f"K2/K3 B={B} L={L} W={window}: (max abs, relative, control) "
            f"errors {bad}; want relative < {TOL_K23} < control")
    if window is None:
        pairs, mask = L * L, None
    else:
        i = torch.arange(L, device="cuda")
        mask = (i[:, None] - i[None, :]).abs() <= window
        pairs = int(mask.sum())
    reads = 2 * (2 * B * L * Hq * D + 2 * B * L * Hkv * D) + 2 * 4 * B * Hq * L
    k2_bound = bound(6.0 * B * Hq * D * pairs, reads + 2 * B * L * Hq * D)
    k3_bound = bound(8.0 * B * Hq * D * pairs, reads + 4 * B * L * Hkv * D)

    # each kernel alone, through the C entry points the wrapper calls
    lib = _build.library()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    w = -1 if window is None else window
    args = (B, L, L, Hq, Hkv, w, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)

    def k2():
        return lib.acestep_flash_bwd_dq(*ptrs, dq.data_ptr(), *args)

    def k3():
        return lib.acestep_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                         *args)

    _build.check(k2(), "acestep_flash_bwd_dq")
    _build.check(k3(), "acestep_flash_bwd_dkv")
    k2_ms, k3_ms = cuda_ms(k2, 20), cuda_ms(k3, 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, dout, window), 3, 1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    library_ms = (cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                      dot), 10)
                  - cuda_ms(sdpa, 10))
    common = dict(B=B, L=L, Hq=Hq, Hkv=Hkv, D=D, window=window,
                  plain_ms=plain_ms, library_ms=library_ms, pairs=pairs)
    k2_rec = dict(kernel="K2", max_abs_err=errs["dq"][0],
                  rel_err={"dq": errs["dq"][1]},
                  control_err={"dq": errs["dq"][2]}, kernel_ms=k2_ms,
                  bound_ms=k2_bound[0], bound_by=k2_bound[1], **common)
    k3_rec = dict(kernel="K3", max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                  rel_err={n: errs[n][1] for n in ("dk", "dv")},
                  control_err={n: errs[n][2] for n in ("dk", "dv")},
                  kernel_ms=k3_ms, bound_ms=k3_bound[0],
                  bound_by=k3_bound[1], **common)
    emit(phase="kernels", **k2_rec)
    emit(phase="kernels", **k3_rec)
    return k2_rec, k3_rec


def phase_kernels():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    k1 = [_k1_case(1, 750, None, 1, host=True), _k1_case(1, 750, 128, 2),
          _k1_case(2, 1500, None, 3), _k1_case(2, 1500, 128, 4),
          _k1_case(1, 1001, 128, 5), _k1_case(1, 1001, None, 6)]
    k4 = [_k4_case(4, 491520, 128, 7), _k4_case(4, 245760, 128, 8),
          _k4_case(4, 61440, 256, 9), _k4_case(3, 100003, 128, 10),
          _k4_case(2, 7001, 256, 11)]
    # the training shapes: a 120 s sample (3000 frames, 1500 patches) full
    # and banded, a ragged length, and two 60 s samples
    k23 = [_k23_case(1, 1500, None, 12), _k23_case(1, 1500, 128, 13),
           _k23_case(1, 1001, 128, 14), _k23_case(2, 750, None, 15)]
    torch.cuda.empty_cache()
    emit(phase="kernels", seconds=time.time() - t0)
    return k1, k4, [r[0] for r in k23], [r[1] for r in k23]


def phase_reference():
    """A small model through the handler on the card (bf16, kernels) and on
    the CPU (fp32, plain versions), same weights and noise."""
    import numpy as np
    import torch

    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.pipeline.handler import AceStepHandler

    t0 = time.time()
    cfgs = (DiTConfig.tiny(fsq_dim=64, head_dim=128),
            VAEConfig.tiny(decoder_input_channels=64))
    geom = dict(frame_bucket=20, min_frames=20, refer_frames=10)
    gpu = AceStepHandler(*cfgs, dtype=torch.bfloat16, **geom)
    gpu.initialize_service(seed=0)
    cpu = AceStepHandler(*cfgs, dtype=torch.float32, device="cpu", **geom)
    cpu.initialize_service(seed=0)
    # the memory tier picks the decode window; with the CPU's smaller one
    # the song would be decoded tiled, whose edge windows see zero context
    cpu.tier = gpu.tier
    cpu.model.load_state_dict(gpu.model.state_dict())
    cpu.vae.load_state_dict(gpu.vae.state_dict())
    noise = np.random.default_rng(0).standard_normal((2, 200, 64)).astype(
        np.float32)
    kw = dict(audio_duration=8.0, seeds=[1, 2], normalize=False,
              initial_noise=noise)
    a = gpu.generate_music(["reference a", "reference b"], ["la", "da"], **kw)
    b = cpu.generate_music(["reference a", "reference b"], ["la", "da"], **kw)
    lat = np.abs(a.pred_latents - b.pred_latents).max() / \
        np.abs(b.pred_latents).max()
    aud = max(np.abs(x - y).max() / np.abs(y).max()
              for x, y in zip(a.audios, b.audios))
    if not (lat < TOL_REFERENCE and aud < TOL_REFERENCE):
        raise AssertionError(f"card vs CPU reference: latents {lat:.3e}, "
                             f"audio {aud:.3e} (tol {TOL_REFERENCE})")
    emit(phase="reference", latent_rel_err=float(lat), audio_rel_err=float(aud),
         seconds=time.time() - t0)


def phase_train_reference():
    """One LoRA step of a 2-layer model (head_dim 128, the kernels' width)
    on the card in bf16 through K1/K2/K3, against the same weights, adapter
    and draws on the CPU in fp32 through the plain versions."""
    import torch

    from acestep_torch.config import DiTConfig
    from acestep_torch.lora.adapters import init_lora
    from acestep_torch.models.dit import build_dit, init_dit_params
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.training.lora import make_lora_train_step
    from acestep_torch.training.step import tiny_batch

    t0 = time.time()
    cfg = DiTConfig.tiny(head_dim=128, fsq_dim=64)
    gpu_model = init_dit_params(cfg, torch.Generator("cuda").manual_seed(0),
                                dtype=torch.bfloat16)
    cpu_model = build_dit(cfg, "cpu", torch.float32)
    cpu_model.load_state_dict(gpu_model.state_dict())
    cpu_gen = torch.Generator().manual_seed(1)
    adapter = init_lora(cpu_gen, cpu_model, rank=8, alpha=16.0)
    for pair in adapter["weights"].values():      # a non-zero delta
        pair["up"] = 0.02 * torch.randn(pair["up"].shape, generator=cpu_gen)
    # 200 frames = 100 patches: the banded layer's band (W = 8) is narrower
    batch = tiny_batch(cfg, cpu_gen, batch=2, frames=200)
    draws = dict(keep=torch.tensor([True, False]),
                 noise=torch.randn(batch["hidden_states"].shape,
                                   generator=cpu_gen),
                 t=torch.tensor([0.7, 0.3]))

    def one_step(model, device, dtype):
        weights = {n: {p: x.clone().to(device).requires_grad_()
                       for p, x in pair.items()}
                   for n, pair in adapter["weights"].items()}
        leaves = [x for pair in weights.values() for x in pair.values()]
        step = make_lora_train_step(model, cfg, adapter["meta"],
                                    torch.optim.SGD(leaves, lr=0.0),
                                    grad_clip=None)

        def put(x):
            x = x.to(device)
            return x.to(dtype) if x.is_floating_point() else x

        loss = step(weights, {k: put(v) for k, v in batch.items()},
                    **{k: put(v) for k, v in draws.items()})
        return float(loss), {n: torch.cat([pair[p].grad.float().cpu()
                                           .flatten() for p in sorted(pair)])
                             for n, pair in weights.items()}

    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    gpu_loss, gpu_grads = one_step(gpu_model, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip((fa.launches, fa.launches_bwd_dq,
                                  fa.launches_bwd_dkv), before)]
    # the control: the same card step with delta left out of the attention
    # backward (K2/K3 given O = 0, so delta = rowsum(dO * O) = 0)
    bwd = fa.flash_attention_bwd

    def without_delta(q, k, v, out, lse, dout, window=None):
        return bwd(q, k, v, torch.zeros_like(out), lse, dout, window)

    with mock.patch.object(fa, "flash_attention_bwd", without_delta):
        _, control_grads = one_step(gpu_model, "cuda", torch.bfloat16)
    cpu_loss, cpu_grads = one_step(cpu_model, "cpu", torch.float32)
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)

    def rel(grads):
        return {n: float((grads[n] - g).norm() / g.norm())
                for n, g in cpu_grads.items()}

    grad_err, control_err = rel(gpu_grads), rel(control_grads)
    worst, control = max(grad_err.values()), max(control_err.values())
    if not (loss_err < TOL_TRAIN_LOSS and worst < TOL_TRAIN_GRAD < control
            and all(r >= cfg.num_hidden_layers for r in ran)):
        raise AssertionError(
            f"LoRA step card vs CPU: loss {gpu_loss} vs {cpu_loss} (rel "
            f"{loss_err:.3e}, tol {TOL_TRAIN_LOSS}), worst gradient error "
            f"{worst:.3e} and control {control:.3e} (want error < "
            f"{TOL_TRAIN_GRAD} < control), K1/K2/K3 launches {ran}")
    emit(phase="train_reference", gpu_loss=gpu_loss, cpu_loss=cpu_loss,
         loss_rel_err=loss_err, grad_rel_err=grad_err,
         control_grad_rel_err=control_err, launches=ran,
         seconds=time.time() - t0)


def phase_end_to_end():
    import numpy as np
    import torch

    from acestep_torch import inference
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.pipeline.handler import AceStepHandler

    t0 = time.time()
    handler = AceStepHandler(DiTConfig.turbo(), VAEConfig(),
                             dtype=torch.bfloat16)
    handler.initialize_service(seed=0)
    torch.cuda.synchronize()
    emit(phase="init", seconds=time.time() - t0,
         params=sum(p.numel() for p in handler.model.parameters()),
         vae_params=sum(p.numel() for p in handler.vae.parameters()),
         memory_allocated=torch.cuda.memory_allocated())
    requests = [
        ("warm-up", 30.0, 1, "lofi hip hop, mellow keys, vinyl crackle",
         "[Instrumental]", 11),
        ("b1_60s", 60.0, 1, "upbeat synthpop, female vocals, 120 bpm",
         "[verse]\nneon lights across the bay\n[chorus]\nwe run, we run", 22),
        ("b2_60s", 60.0, 2, "cinematic orchestral, rising strings",
         "[verse]\nmountains call\n[chorus]\nhigher still", 33),
    ]
    # every decoder layer of every one of the 8 turbo steps (24 x 8 = 192
    # at full width); every C <= 256 decoder level per decoded group (3)
    need_k1 = handler.cfg.num_hidden_layers * 8
    need_k4 = sum(blk.res1.conv1.weight.shape[0] <= 256
                  for blk in handler.vae.decoder.blocks)
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        for name, duration, batch, caption, lyrics, seed in requests:
            k1_before, k4_before = fa.launches, sc.launches
            torch.cuda.reset_peak_memory_stats()
            t_req = time.time()
            res = inference.generate_music(
                handler, None,
                inference.GenerationParams(caption=caption, lyrics=lyrics,
                                           duration=duration, seed=seed,
                                           thinking=False),
                inference.GenerationConfig(batch_size=batch,
                                           use_random_seed=False,
                                           output_dir=out_dir))
            wall = time.time() - t_req
            if not res.success:
                raise AssertionError(f"{name}: generate_music failed: "
                                     f"{res.error}\n{res.status_message}")
            if len(res.audios) != batch:
                raise AssertionError(f"{name}: {len(res.audios)} audios for "
                                     f"batch {batch}")
            samples = int(duration * 25) * handler.vae_cfg.hop_length
            for entry in res.audios:
                audio = entry["audio"]
                if audio.shape != (samples, 2):
                    raise AssertionError(f"{name}: audio shape {audio.shape}")
                if not np.isfinite(audio).all():
                    raise AssertionError(f"{name}: non-finite audio")
                if not np.abs(audio).max() > 1e-4:
                    raise AssertionError(f"{name}: silent audio")
            k1 = fa.launches - k1_before
            k4 = sc.launches - k4_before
            if k1 < need_k1 or k4 < need_k4:
                raise AssertionError(
                    f"{name}: K1 launched {k1} times (need >= {need_k1}), "
                    f"K4 {k4} times (need >= {need_k4})")
            rec = dict(phase="end_to_end", request=name, duration=duration,
                       batch=batch, wall_s=wall, k1_launches=k1,
                       k4_launches=k4,
                       max_memory_allocated=torch.cuda.max_memory_allocated(),
                       time_costs=res.extra_outputs["time_costs"])
            emit(**rec)
    launches = {"K1": fa.launches, "K4": sc.launches,
                "K2": fa.launches_bwd_dq, "K3": fa.launches_bwd_dkv}
    emit(phase="end_to_end", seconds=time.time() - t0, launches=launches)
    return launches, handler


def _song(seconds: float, seed: int):
    """A seeded stereo 48 kHz song (samples, 2) float32: six harmonics of a
    random pitch under a 2 Hz pulse, plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 48000)) / 48000.0
    f0 = 110.0 * 2.0 ** (rng.integers(0, 12) / 12.0)
    tone = sum(0.3 / h * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3))
               for h in range(1, 7))
    pulse = 0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * t) ** 2
    audio = np.stack([tone * pulse, 0.8 * tone * pulse], axis=1)
    audio += 0.03 * rng.standard_normal(audio.shape)
    return audio.astype(np.float32)


def k4_launches_per_song(handler) -> int:
    """K4 launches of one training song's encode through `handler.
    encode_audio`, the code the training CLI's preprocess runs (the memory
    tier sets how many windows one encoder pass folds): phase 6's floor
    for K4 is this per song. These launches count in no phase."""
    from acestep_torch.ops import snake_conv as sc

    before = sc.launches
    handler.encode_audio(_song(TRAIN_SONG_SECONDS, 99))
    return sc.launches - before


def _steps(metrics_path: str):
    """(steps, losses, first timestamp of each step) from metrics.jsonl."""
    first = {}
    with open(metrics_path) as f:
        for line in f:
            e = json.loads(line)
            first.setdefault(e["step"], (e["loss"], e["ts"]))
    steps = sorted(first)
    return steps, [first[s][0] for s in steps], [first[s][1] for s in steps]


def _check_adapter(path: str) -> None:
    from acestep_torch.lora.manager import load_adapter_file

    if not os.path.exists(path):
        raise AssertionError(f"no adapter at {path}")
    weights = load_adapter_file(path)["weights"]
    if len(weights) != 11:
        raise AssertionError(f"{path}: {len(weights)} targets, want 11")
    zero = [n for n, pair in weights.items() if not pair["up"].abs().max() > 0]
    if zero:
        raise AssertionError(f"{path}: up factors still all zero: {zero}")


def phase_training(k4_per_song: int):
    """preprocess -> vanilla (8 steps) -> resume from checkpoint_4, through
    the port's training CLI at full width, in a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        return _training_in(work, k4_per_song)


def _training_in(work: str, k4_per_song: int):
    import numpy as np
    import torch

    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.lora.manager import load_adapter_file
    from acestep_torch.models.dit import build_dit
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.training import cli
    from acestep_torch.training.lora import LoRATrainer, LoRATrainingConfig
    from acestep_torch.utils.audio import save_wav

    t_phase = time.time()
    seconds, n_songs, steps, every = TRAIN_SONG_SECONDS, 2, 8, 4
    cfg, vae_cfg = DiTConfig(), VAEConfig()
    tensors = os.path.join(work, "tensors")
    out, out_resumed = os.path.join(work, "lora"), os.path.join(work, "resumed")
    samples = []
    for i in range(n_songs):
        path = os.path.join(work, f"song{i}.wav")
        save_wav(path, _song(seconds, 100 + i))
        samples.append({"audio_path": path, "caption": f"test song {i}",
                        "lyrics": "[verse]\nla la la\n[chorus]\noh oh",
                        "metas": {"bpm": 120, "keyscale": "C major"}})
    manifest = os.path.join(work, "dataset.json")
    with open(manifest, "w") as f:
        json.dump(samples, f)

    # the encoder's stacks with C <= 256 run on K4, each at least once per
    # song; the handler's own encode of one song sets the floor
    frames = int(seconds * 25)
    k4_stacks = sum(vae_cfg.encoder_hidden_size * m <= 256
                    for m in (1,) + tuple(vae_cfg.channel_multiples[:-1]))
    if k4_per_song < k4_stacks:
        raise AssertionError(f"one song's encode launched K4 {k4_per_song} "
                             f"times, fewer than its {k4_stacks} stacks")
    need = {"K4": n_songs * k4_per_song}

    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0
    t0 = time.time()
    cli.main(["preprocess", "--manifest", manifest, "--out-dir", tensors,
              "--seed", "0"])
    preprocess_s = time.time() - t0
    files = sorted(os.listdir(tensors))
    if len(files) != n_songs:
        raise AssertionError(f"preprocess wrote {files}")
    with np.load(os.path.join(tensors, files[0])) as z:
        lat = z["hidden_states"]
    if lat.shape != (frames, cfg.audio_acoustic_hidden_dim) or \
            not np.isfinite(lat).all():
        raise AssertionError(f"preprocessed latents {lat.shape}, finite "
                             f"{np.isfinite(lat).all()}")
    # the second (warm) song: the time between the two tensor files
    mtimes = [os.path.getmtime(os.path.join(tensors, f)) for f in files]
    s_per_song = mtimes[1] - mtimes[0]

    torch.cuda.reset_peak_memory_stats()
    common = ["--tensor-dir", tensors, "--max-steps", str(steps), "--rank",
              "16", "--batch-size", "1", "--checkpoint-every", str(every),
              "--log-every", "1", "--seed", "0"]
    t0 = time.time()
    cli.main(["vanilla", "--output-dir", out, *common])
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    got_steps, losses, ts = _steps(os.path.join(out, "metrics.jsonl"))
    if got_steps != list(range(1, steps + 1)) or \
            not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"vanilla: steps {got_steps}, losses {losses}")
    _check_adapter(os.path.join(out, "adapter.npz"))
    step_s = float(np.median(np.diff(ts)))      # steps 2..8

    # the resumed trainer starts from exactly the saved adapter, optimizer
    # state and step (the JAX trainer's resume semantics)
    ck = os.path.join(out, f"checkpoint_{every}")
    shell = build_dit(cfg, "cuda", torch.bfloat16)
    weights, opt, start = LoRATrainer(shell, cfg, LoRATrainingConfig(
        rank=16, resume_from=ck)).initial_state()
    saved = load_adapter_file(os.path.join(ck, "adapter.npz"))["weights"]
    same_adapter = all(torch.equal(x.detach().cpu(), saved[n][p])
                       for n, pair in weights.items() for p, x in pair.items())
    want = torch.load(os.path.join(ck, "opt_state.pt"), map_location="cpu",
                      weights_only=True)
    got = opt.state_dict()
    same_opt = got["param_groups"] == want["param_groups"] and all(
        torch.equal(got["state"][i][k].cpu(), v)
        for i, st in want["state"].items() for k, v in st.items())
    del shell, weights, opt, got, want
    torch.cuda.empty_cache()
    if not (start == every and same_adapter and same_opt):
        raise AssertionError(f"resume from {ck}: step {start}, adapter "
                             f"equal {same_adapter}, optimizer state equal "
                             f"{same_opt}")
    cli.main(["vanilla", "--output-dir", out_resumed, "--resume-from", ck,
              *common])
    r_steps, r_losses, _ = _steps(os.path.join(out_resumed, "metrics.jsonl"))
    if r_steps != list(range(every + 1, steps + 1)) or \
            not all(np.isfinite(x) for x in r_losses):
        raise AssertionError(f"resumed: steps {r_steps}, losses {r_losses}")
    _check_adapter(os.path.join(out_resumed, "adapter.npz"))

    n_steps = steps + (steps - every)
    layers = cfg.num_hidden_layers
    need.update(K1=2 * layers * n_steps, K2=layers * n_steps,
                K3=layers * n_steps)
    launches = {"K1": fa.launches, "K2": fa.launches_bwd_dq,
                "K3": fa.launches_bwd_dkv, "K4": sc.launches}
    short = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"training path launches (got, need): {short}")
    emit(phase="training", songs=n_songs, song_seconds=seconds,
         latent_frames=frames, preprocess_wall_s=preprocess_s,
         preprocess_s_per_song=s_per_song, train_wall_s=train_s,
         s_per_step_median=step_s, latent_frames_per_s=frames / step_s,
         max_memory_allocated=peak, losses=losses, resumed_losses=r_losses,
         launches=launches, need=need, seconds=time.time() - t_phase)
    return launches


def main() -> None:
    import torch

    t_all = time.time()
    phase_device()
    phase_build()
    k1, k4, k2, k3 = phase_kernels()
    phase_reference()
    phase_train_reference()
    text2music, handler = phase_end_to_end()
    k4_per_song = k4_launches_per_song(handler)
    del handler
    gc.collect()
    torch.cuda.empty_cache()
    training = phase_training(k4_per_song)
    launches = {k: text2music[k] + training[k] for k in training}

    def row(name, source, replaces, cases, rep, n):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"]}

    # the representative case of each kernel: K1 full attention at the
    # 60 s song's 750 patches (the costlier half of its launches), K4 at
    # the 48 kHz level of a 4-window decode group, K2/K3 full attention at
    # a 120 s training sample's 1500 patches
    emit(phase="total", seconds=time.time() - t_all)
    print(json.dumps({"kernels": [
        row("flash_attention_fwd", K1_SOURCE, K1_REPLACES, k1, k1[0],
            launches["K1"]),
        row("snake_conv_res_stack", K4_SOURCE, K4_REPLACES, k4, k4[0],
            launches["K4"]),
        row("flash_attention_bwd_dq", K23_SOURCE, K2_REPLACES, k2, k2[0],
            launches["K2"]),
        row("flash_attention_bwd_dkv", K23_SOURCE, K3_REPLACES, k3, k3[0],
            launches["K3"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
