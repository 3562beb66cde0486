#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (acestep_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines and its seconds; any failed check raises,
so the exit code is non-zero and no result line is printed:

1. device: the card's name and power limit (nvidia-smi) and the versions;
   no CUDA device is an error.
2. build: the hand-written kernels of acestep_torch/csrc, built with nvcc.
3. kernels: K1 (flash attention; also at the guided sampler's doubled
   batch, (2, 750) full and banded, and at a 600 s song's 7500 patches,
   (1, 7500) and (2, 7500) full), K4 (snake + conv stack) and the flash
   backward's K2 (dQ) and K3 (dK/dV) against their plain PyTorch versions
   at the shapes the main paths give them, with kernel, plain-version and
   library times (CUDA events around calls queued behind a spin kernel,
   so host cost does not enter: `cuda_ms`) and the bound the card's
   published peaks set for the same work (K2/K3 also at a tp=2 rank's
   8/4 heads, (1, 1500)); K2/K3's limit is also held
   against controls (the plain backward with a fault) that it must catch,
   and both must give the same bits twice. K1 at (1, 750) also reports
   host microseconds per call (`k1_host_us`); K4 is timed through its C
   entry and through its wrapper (`wrapper_ms`, weights packed once a
   stack and cached).
4. reference: a small model through the port's handler on the card (bf16,
   kernels) against the same weights on the CPU (fp32, plain versions):
   turbo text2music, a turbo cover (cover strength 0.5), repaint,
   extract, lego and complete of a seeded song, and a base model's 4
   guided (APG) steps;
   then one LoRA step of a small model, card against CPU: the loss and
   every target's adapter gradient, and a control step with the attention
   backward's delta left out that the gradient limit must catch; then
   `full_train_reference`: 3 full-parameter `FullTrainer` steps of the
   same small model, card against CPU: the first step's loss and
   gradients (per LoRA target and over every parameter; the same delta
   control), and the 3 steps' change of every parameter entry, with a
   control run (the warmup left out) the update limit must catch.
5. end to end: full-width turbo text2music (DiTConfig.turbo(), VAEConfig(),
   bf16, seeded random weights) through acestep_torch.inference.
   generate_music, three requests, then one 600 s request through the
   handler (finite audio of 600 x 48000 samples a channel); the kernels'
   launch counters show the path went through K1 and K4.
   Then `tasks`, at the same width and sharing phase 5's VAE: a base
   request (60 s, 50 steps, CFG 7 with APG, ODE) and an sft one (30 s, 8
   custom timesteps, ADG, SDE) through the facade; on a seeded 60 s song,
   through the handler: a cover (cover strength 0.5, cover noise 0.2), a
   repaint of 10-20 s, an outpaint from -5 s to 5 s past the end, a timbre
   reference, and `audio_to_codes` followed by a render from those codes.
   Each request meets its K1 floor (layers x steps) and K4 floor (the
   decode's stacks, plus one song's encode per encoder pass).
6. training: two seeded 120 s songs through the port's training CLI at
   full width (DiTConfig(), VAEConfig(), bf16 base, fp32 adapters):
   `preprocess`, then `vanilla` for 8 LoRA steps (rank 16, all 11 targets,
   a checkpoint every 4), then a resume from checkpoint_4 to step 8; the
   counters show the path went through K1, K2, K3 (decoder) and K4 (VAE
   encoder, at least as often per song as phase 5's handler launches it
   to encode one such song). Then `adapter`: the trained adapter loaded
   into a turbo handler with the training run's base seed renders another
   song than the base, the same bits as the base when toggled off, and
   another result key while it is active.

Between phases 5 and 6, on phase 5's full-width handler:
- checkpoint: its DiT and VAE written as an upstream-named checkpoint
  (safetensors by hand: the DiT in two shards named by an index, the VAE,
  `silence_latent.pt`; bf16), loaded by `initialize_service(
  checkpoint_dir=..., vae_dir=...)`; every tensor and the silence latent
  must equal what was written, and a 30 s turbo request renders from it.
- planner: `LLMHandler.initialize_auto()` (the 80 GB tier's 4B planner at
  bf16, seeded weights); teacher-forced logits of a 2-layer LM at the
  planner's head geometry, bf16 on the card against fp32 on the CPU;
  greedy CoT + codes at 4B as CUDA-graph replays against the eager step
  (identical tokens); the decode step's wall and device ms, eager and as
  a graph replay, beside its bound from bytes; then thinking=True
  text2music through `generate_music` at 60 s, batch 1, after a warm-up:
  CoT tokens, exactly 300 codes, tokens/s of each phase, K1 and K4
  launches, peak memory and the parsed metadata.
- quant: for each DiT mode (int8, fp8, w8a8, int4) a small card-vs-CPU
  reference (the card's codes equal to the CPU's), then phase 5's turbo
  weights quantized and a 30 s render through the facade (after a
  warm-up) beside a bf16 one: `quantized_bytes`, peak memory, wall,
  time_costs, K1 and K4. Then the 2-layer w8a8 card-vs-CPU logits, and
  the 16 GB and 8 GB tiers under a real cap, each in a child process
  (`chip_smoke.py --tier 16|8`: `ACESTEP_MAX_HBM_GB` and the allocator's
  cap, 15 / 7 GiB, set before any handler): a w8a8 DiT, the tier's
  planner from `initialize_auto` (4B / 0.6B at w8a8, int8 KV cache,
  `head_q`), at 16 GB graph against eager greedy tokens and the w8a8
  decode step beside its bound, then a 60 s thinking request after a
  warm-up, whose reserved peak must stay under the cap.
- serving (after the planner, on phase 5's handler and the planner's
  4B LLMHandler): the port's REST server in this process on 127.0.0.1
  (ephemeral port, `http.client`). DiT-only first: 4 compatible 60 s
  thinking=False jobs queued before the workers start fuse into one
  render (`coalesced_jobs` 4 in every result and in /v1/stats; K1 = 8
  steps x 24 layers, not 4x that; K4 = the decode's stacks per decode
  call; each item's latents within TOL_COALESCED of a solo facade render
  of its seed; songs/s fused and serial); a 30 s request against the
  facade's render of the same seed (bit-equal expected; the REST wall
  beside `total_time_cost`). With the planner attached: a 60 s thinking
  request with /v1/metrics and /v1/stats polled every 50 ms, the
  planner's graphs dropped first so it captures them during the polls;
  a chat completion whose audio decodes and /v1/models. A facade request
  with the default format (flac) decoded back equal to the int16 samples
  written, `audio_conversion_time` beside a wav save's. The CLI's
  `--once --no-think` as a subprocess on the card, its flac decoded.
- studio (after serving, on the same handler, DiT-only; the Studio's
  HTTP flows through the REST server in this process, user paths under
  a temporary safe root): GET /studio returns the page's bytes; the
  Studio's generate body for extract, lego (10-20 s) and complete on a
  seeded 30 s source sent base64 as the page sends it, and lego again as
  a multipart upload (its latents against the base64 one's): each 30 s,
  finite, K1 >= layers x 8 and K4 >= the decode's stacks plus one encoder
  pass, with its wall and peak; /create_random_sample and its blueprint
  rendered at 30 s; the LoRA panel at full width (a seeded rank-8 PEFT
  adapter on q/k/v/o of the 24 layers: load, status, scale 0.5, toggle
  off rendering the base's bits, toggle on another song, unload with
  `memory_allocated` back within 1% of before the load);
  /v1/reinitialize twice with allow_random_init (each followed by a
  render bit-identical to the base, allocated memory after the second
  within 1% of after the first, each swap's peak beside the DiT's
  bytes); /lrc_to_vtt on a want_lrc request's LRC (the capture pass's 7
  K1 layers counted). The handler leaves with phase 5's weights.
- dataset (after studio, the planner still attached, on the same
  handler): two seeded 60 s songs through POST /v1/dataset/build (K4 three
  times an encode, the planner's `understand` per song) polled through
  /v1/dataset/status, then the session routes scan -> auto_label_async
  -> save -> preprocess_async, then 1 LoRA step at full width over
  /v1/training/start on the built tensors; stage seconds per song.
- mesh (after dataset, on the same handler and the 4B planner): a 1-rank
  NCCL world (`enable_mesh()` with its defaults on the one card) whose
  60 s render must equal the unsharded one bit for bit; then a world of
  two ranks sharing the card
  over gloo (NCCL refuses two ranks on one device): tp=2 (a 60 s render
  within TOL_MESH of the unsharded one, K1 launches of each rank, K1 held
  to its plain version at the per-rank heads (1, 750, 8/4)), dp=2 (batch
  3 padded to 4 and trimmed, within TOL_MESH), and the planner at tp=2
  as the server builds it from `--lm-tensor-parallel 2` (teacher-forced
  logits against tp=1 within TOL_MESH_LM, a 10 s thinking request over
  REST); each world's start-up and render walls, labelled
  as gloo ranks sharing one H100.
- lrc: a turbo 60 s request with lyrics and want_lrc=True at 24 layers
  (DEFAULT_CAPTURE: the capture pass runs 7 layers through K1): LRC
  lines, the alignment score inside (0, 1), `auto_lrc_time`; the tiny
  capture pass card against CPU; the PMI reward score of the quant
  phase's codes under a 2-layer LM, card against CPU.

Before phase 6, `tools`: the tools beside the package as their users run
them, each a process of its own from the repo root: `scripts/check_gpu.py
--smoke` (the environment doctor; K1 full and banded and K4 against their
plain versions under the limits below), `profile_inference_torch.py`'s
`profile` of a 30 s turbo request at full width, its `understand` and its
8 GB `tier-test` (a child process whose allocator is capped at 7 GiB
before any handler), and `scripts/profile_vram.py`'s 30 s request; each
report must name this card, and its renders' K1 and K4 launches join the
kernel table's counts. Then `bench`: `bench_torch.py --headline-only`
as a process of its own (the port's benchmark program's headline: one 60
s song at batch 1, full width): its JSON line printed twice, a wall > 0,
0 < mfu_pct <= 100 against this card's published peak, this card's name
and power limit, and one song's K1 (192) and K4 (one a C <= 256 decoder
level) launches, which join the kernel table's counts.

Phase 6 goes on with `rest_training` on the tensors phase 6
preprocessed, at full width: `/v1/training/load_tensor_info`, a long run
stopped by `/v1/training/stop` after its first step, the restart (2 LoRA
steps) polled through `/v1/training/status` until done, its adapter
checked, `/v1/training/export`, the export loaded back through
`/v1/lora/load` and a 30 s song rendered under it, `start_lora` and
`start_lokr` for one step each, `/v1/training/tensorboard/start|stop`
(K1, K2, K3 counted for the steps); `full_training`: the CLI's `full` at
full width on the same tensors, 2 steps with a checkpoint every 2, the
latest checkpoint restored bit-equal in this process, a resume from
`latest` to step 4 (seconds per step, launches per step, peak memory,
checkpoint bytes, save and restore seconds; the output deleted after);
`full_training_mesh`: the full trainer over meshes on a batch of both
tensor files (one row cut to 60 s of valid frames), two updates each: a
1-rank NCCL mesh bit-equal to the plain trainer, then two gloo ranks
sharing the card at tp=2 and at dp=2, the loss and the gradient (per
family of parameters) within TOL_FULL_MESH of the plain update's, each
beside a fault control that must exceed it, every rank's peak memory,
seconds per update and K1-K3 launches, and tp=2's checkpoint (gathered
to the unsharded layout) restored bit-equal into an unsharded trainer;
and `estimate`: the CLI's `estimate --num-batches 2` (wall, ranked
targets) and a small model's estimate, card against CPU.

The launch counts of the kernel table are those of phases 5 and 6 with
their `tasks`, `adapter`, `rest_training`, `full_training`,
`full_training_mesh` and `estimate` parts, the checkpoint render, the
measured thinking requests, the serving, studio, dataset and mesh phases (the
meshes' follower ranks' launches summed in, as their command replies
return them), the quant phase's measured renders and its tier children's
measured requests (as the children report them), the lrc request, the
tools phase's renders (as the tools report them) and the bench
headline's song. The last two lines are
the kernel table and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
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
# Three full-parameter steps of a 2-layer model, the same card-vs-CPU pair
# (the first step's loss and gradients under the two limits above): an Adam
# step moves each entry by about lr, so an entry whose gradient is near 0
# can move the other way on a bf16 difference, and bf16 storage rounds the
# change of weights near 1. The share of parameter entries whose 3-step
# change differs by more than half the summed lr is held under this limit,
# which sits between the reading and a control run with the warmup left
# out (the first update at the peak lr), which the check must reject.
TOL_FULL_UPDATE = 2e-2

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


def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    card = _card()
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


def _k1_case(B, L, window, seed, host=False, heads=(16, 8)):
    """K1 against its plain version at `heads` (query, KV) heads; with
    `host`, also its host microseconds per call (`k1_host_us`)."""
    import torch
    import torch.nn.functional as F

    from acestep_torch.ops import flash_attention as fa

    (Hq, Hkv), D = heads, 128
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


def _k23_case(B, L, window, seed, heads=(16, 8)):
    """K2 and K3 at a training shape with `heads` (query, KV) heads: errors
    against the plain backward in fp32, each kernel's time alone, the
    plain backward's time (one call computes dq, dk and dv), and SDPA's
    backward (forward + backward minus forward) as the library time of the
    pair."""
    import torch
    import torch.nn.functional as F

    from acestep_torch.ops import _build
    from acestep_torch.ops import flash_attention as fa

    (Hq, Hkv), D = heads, 128
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
          _k1_case(1, 1001, 128, 5), _k1_case(1, 1001, None, 6),
          # the guided sampler's doubled batch: a 60 s song under CFG
          _k1_case(2, 750, None, 16), _k1_case(2, 750, 128, 17),
          # a 600 s song's 7500 patches, turbo and under CFG (the plain
          # version holds 16 x 7500^2 fp32 logits a row, 3.6 GB)
          _k1_case(1, 7500, None, 19), _k1_case(2, 7500, None, 20)]
    k4 = [_k4_case(4, 491520, 128, 7), _k4_case(4, 245760, 128, 8),
          _k4_case(4, 61440, 256, 9), _k4_case(3, 100003, 128, 10),
          _k4_case(2, 7001, 256, 11)]
    # the training shapes: a 120 s sample (3000 frames, 1500 patches) full
    # and banded, a ragged length, and two 60 s samples
    k23 = [_k23_case(1, 1500, None, 12), _k23_case(1, 1500, 128, 13),
           _k23_case(1, 1001, 128, 14), _k23_case(2, 750, None, 15),
           # a tp=2 rank's heads in the full trainer over a mesh
           _k23_case(1, 1500, None, 18, heads=(8, 4))]
    torch.cuda.empty_cache()
    emit(phase="kernels", seconds=time.time() - t0)
    return k1, k4, [r[0] for r in k23], [r[1] for r in k23]


def _reference_pair(dit_cfg, vae_cfg):
    """The same small model on the card (bf16) and on the CPU (fp32)."""
    import torch

    from acestep_torch.pipeline.handler import AceStepHandler

    geom = dict(frame_bucket=20, min_frames=20, refer_frames=10)
    gpu = AceStepHandler(dit_cfg, vae_cfg, dtype=torch.bfloat16, **geom)
    gpu.initialize_service(seed=0)
    cpu = AceStepHandler(dit_cfg, vae_cfg, dtype=torch.float32, device="cpu",
                         **geom)
    cpu.initialize_service(seed=0)
    # the memory tier picks the decode window; with the CPU's smaller one
    # the song would be decoded tiled, whose edge windows see zero context
    cpu.tier = gpu.tier
    cpu.model.load_state_dict(gpu.model.state_dict())
    cpu.vae.load_state_dict(gpu.vae.state_dict())
    return gpu, cpu


def _reference_case(name, gpu, cpu, **kw):
    """One request on both; latents and audio relative to the largest CPU
    value."""
    import numpy as np

    a = gpu.generate_music(**kw)
    b = cpu.generate_music(**kw)
    if a.extra != b.extra:
        raise AssertionError(f"reference {name}: card extra {a.extra} != "
                             f"CPU extra {b.extra}")
    lat = float(np.abs(a.pred_latents - b.pred_latents).max()
                / np.abs(b.pred_latents).max())
    aud = float(max(np.abs(x - y).max() / np.abs(y).max()
                    for x, y in zip(a.audios, b.audios)))
    if not (lat < TOL_REFERENCE and aud < TOL_REFERENCE):
        raise AssertionError(f"card vs CPU reference {name}: latents "
                             f"{lat:.3e}, audio {aud:.3e} (tol "
                             f"{TOL_REFERENCE})")
    return {"latent_rel_err": lat, "audio_rel_err": aud}


def phase_reference():
    """Small models through the handler on the card (bf16, kernels) and on
    the CPU (fp32, plain versions), same weights and noise: turbo
    text2music, a turbo cover, repaint, extract, lego and complete of a
    seeded song, and a base model's guided steps."""
    import numpy as np

    from acestep_torch.config import DiTConfig, VAEConfig

    t0 = time.time()
    vae_cfg = VAEConfig.tiny(decoder_input_channels=64)
    gpu, cpu = _reference_pair(DiTConfig.tiny(fsq_dim=64, head_dim=128),
                               vae_cfg)
    noise = np.random.default_rng(0).standard_normal((2, 200, 64)).astype(
        np.float32)
    common = dict(seeds=[1, 2], normalize=False, initial_noise=noise)
    errs = {"text2music": _reference_case(
        "text2music", gpu, cpu, captions=["reference a", "reference b"],
        lyrics=["la", "da"], audio_duration=8.0, **common)}
    # 200 latent frames of the tiny VAE (hop 8) at 48 kHz
    song = _song(200 * vae_cfg.hop_length / 48000, 5)
    errs["cover"] = _reference_case(
        "cover", gpu, cpu, captions=["cover a", "cover b"], task="cover",
        src_audio=song, audio_cover_strength=0.5, **common)
    errs["repaint"] = _reference_case(
        "repaint", gpu, cpu, captions=["repaint a", "repaint b"],
        task="repaint", src_audio=song, repainting_start=2.0,
        repainting_end=5.0, **common)
    # the track modes: the source in context without the cover flag
    for task, kw in (("extract", dict(track_name="vocals")),
                     ("lego", dict(track_name="drums", repainting_start=2.0,
                                   repainting_end=5.0)),
                     ("complete", dict(track_classes=["drums", "bass"]))):
        errs[task] = _reference_case(
            task, gpu, cpu, captions=[f"{task} a", f"{task} b"], task=task,
            src_audio=song, **kw, **common)
    del gpu, cpu
    gpu, cpu = _reference_pair(
        DiTConfig.tiny(fsq_dim=64, head_dim=128, model_version="base"),
        vae_cfg)
    errs["base_apg"] = _reference_case(
        "base_apg", gpu, cpu, captions=["guided a", "guided b"],
        lyrics=["la", "da"], audio_duration=8.0, infer_steps=4,
        guidance_scale=7.0, **common)
    emit(phase="reference", **errs["text2music"], cases=errs,
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


def _full_runs(model, cfg, batches, draws, lr, first_lr=None):
    """3 FullTrainer steps (warmup 1, so the first update has lr 0): each
    step's loss and clipped gradients (fp32, on the CPU), the change of
    every parameter (fp32) and the schedule's lrs. `first_lr` replaces the
    first update's lr (the control)."""
    import torch

    from acestep_torch.training.trainer_full import (FullTrainer,
                                                     FullTrainingConfig)

    init = {n: p.detach().float().cpu().clone()
            for n, p in model.named_parameters()}
    trainer = FullTrainer(model, cfg, FullTrainingConfig(
        learning_rate=lr, warmup_steps=1, max_steps=3, checkpoint_every=0,
        log_every=1))
    schedule = trainer.lr
    if first_lr is not None:
        trainer.lr = lambda c: first_lr if c == 0 else schedule(c)
    steps = []
    for _step, loss, _msg in trainer.train(iter(batches), draws=iter(draws)):
        steps.append((loss, {n: p.grad.float().cpu().clone()
                             for n, p in model.named_parameters()}))
    change = {n: p.detach().float().cpu() - init[n]
              for n, p in model.named_parameters()}
    return steps, change, [schedule(c) for c in range(3)]


def phase_full_train_reference():
    """3 full-parameter steps of a 2-layer model (head_dim 128), bf16 on
    the card through K1/K2/K3 against fp32 on the CPU, same weights,
    batches and draws, lr 1e-2 after a 1-step warmup (updates well above
    bf16's spacing at the weights' size). Checks: the first step's loss;
    its gradients, per LoRA target (the decoder's projections over the
    layers) and over every parameter, against TOL_TRAIN_GRAD, with a
    control step (the attention backward's delta left out) that must
    exceed it; and the 3 steps' change of every parameter entry: the share
    of entries whose change differs by more than half the summed lr
    (an Adam step moves an entry by about lr) must stay under
    TOL_FULL_UPDATE, with a control run (the warmup left out: the first
    update at the peak lr) that must exceed it."""
    import torch

    from acestep_torch.config import DiTConfig
    from acestep_torch.lora.adapters import LORA_TARGETS
    from acestep_torch.models.dit import build_dit, init_dit_params
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.training.step import tiny_batch

    t0 = time.time()
    lr = 1e-2
    cfg = DiTConfig.tiny(head_dim=128, fsq_dim=64)

    def gpu_model():
        return init_dit_params(cfg, torch.Generator("cuda").manual_seed(0),
                               dtype=torch.bfloat16)

    cpu_model = build_dit(cfg, "cpu", torch.float32)
    cpu_model.load_state_dict(gpu_model().state_dict())
    g = torch.Generator().manual_seed(1)
    batches, draws = [], []
    for i in range(3):
        batch = tiny_batch(cfg, g, batch=2, frames=200)
        batches.append(batch)
        draws.append(dict(keep=torch.tensor([True, i % 2 == 0]),
                          noise=torch.randn(batch["hidden_states"].shape,
                                            generator=g),
                          t=torch.rand(2, generator=g)))

    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    gpu_steps, gpu_change, lrs = _full_runs(gpu_model(), cfg, batches,
                                            draws, lr)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip((fa.launches, fa.launches_bwd_dq,
                                  fa.launches_bwd_dkv), before)]
    cpu_steps, cpu_change, _ = _full_runs(cpu_model, cfg, batches, draws, lr)
    bwd = fa.flash_attention_bwd

    def without_delta(q, k, v, out, lse, dout, window=None):
        return bwd(q, k, v, torch.zeros_like(out), lse, dout, window)

    with mock.patch.object(fa, "flash_attention_bwd", without_delta):
        control_steps, _, _ = _full_runs(gpu_model(), cfg, batches[:1],
                                         draws[:1], lr)
    _, control_change, _ = _full_runs(gpu_model(), cfg, batches, draws, lr,
                                      first_lr=lr)

    def grad_errs(grads):
        want = cpu_steps[0][1]
        groups = {".".join(t): [f"decoder.layers.{i}.{'.'.join(t)}.weight"
                                for i in range(cfg.num_hidden_layers)]
                  for t in LORA_TARGETS}
        groups["all"] = list(want)

        def rel(names):
            num = sum(float((grads[n] - want[n]).norm() ** 2) for n in names)
            return (num / sum(float(want[n].norm() ** 2)
                              for n in names)) ** 0.5
        return {name: rel(names) for name, names in groups.items()}

    def off_share(change):
        limit = 0.5 * sum(lrs)
        off = sum(int(((change[n] - d).abs() > limit).sum())
                  for n, d in cpu_change.items())
        return off / sum(d.numel() for d in cpu_change.values())

    loss_err = abs(gpu_steps[0][0] - cpu_steps[0][0]) / abs(cpu_steps[0][0])
    grad_err, control_err = grad_errs(gpu_steps[0][1]), \
        grad_errs(control_steps[0][1])
    share, control_share = off_share(gpu_change), off_share(control_change)
    worst, control = max(grad_err.values()), max(control_err.values())
    if not (loss_err < TOL_TRAIN_LOSS and worst < TOL_TRAIN_GRAD < control
            and share < TOL_FULL_UPDATE < control_share
            and all(r >= 3 * cfg.num_hidden_layers for r in ran)):
        raise AssertionError(
            f"full step card vs CPU: loss rel {loss_err:.3e} (tol "
            f"{TOL_TRAIN_LOSS}); worst gradient error {worst:.3e}, control "
            f"{control:.3e} (want error < {TOL_TRAIN_GRAD} < control); "
            f"update share off {share:.3e}, control {control_share:.3e} "
            f"(want share < {TOL_FULL_UPDATE} < control); K1/K2/K3 {ran}")
    emit(phase="full_train_reference", lrs=lrs,
         gpu_losses=[x[0] for x in gpu_steps],
         cpu_losses=[x[0] for x in cpu_steps], loss_rel_err=loss_err,
         grad_rel_err=grad_err, control_grad_rel_err=control_err,
         update_share_off=share, control_update_share_off=control_share,
         launches=ran, seconds=time.time() - t0)


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
    # the longest song the system takes: 600 s, 15000 latent frames, K1 at
    # L = 7500 in every full layer; through the handler, no save
    k1_before, k4_before = fa.launches, sc.launches
    torch.cuda.reset_peak_memory_stats()
    t_req = time.time()
    res = handler.generate_music("ambient drone, slow evolving pads",
                                 "[Instrumental]", audio_duration=600.0,
                                 seeds=44)
    wall = time.time() - t_req
    _check_audio("b1_600s", res.audios, 600 * 48000)
    k1, k4 = fa.launches - k1_before, sc.launches - k4_before
    if k1 < need_k1 or k4 < need_k4:
        raise AssertionError(f"b1_600s: K1 launched {k1} times (need >= "
                             f"{need_k1}), K4 {k4} times (need >= "
                             f"{need_k4})")
    emit(phase="end_to_end", request="b1_600s", duration=600.0, batch=1,
         wall_s=wall, k1_launches=k1, k4_launches=k4,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         time_costs=res.time_costs)
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


def _check_audio(name, audios, samples):
    import numpy as np

    for audio in audios:
        if audio.shape != (samples, 2):
            raise AssertionError(f"{name}: audio shape {audio.shape}, want "
                                 f"({samples}, 2)")
        if not np.isfinite(audio).all():
            raise AssertionError(f"{name}: non-finite audio")
        if not np.abs(audio).max() > 1e-4:
            raise AssertionError(f"{name}: silent audio")


def _counted(fn):
    """(result, K1 launches, K4 launches, wall s, peak bytes) of fn()."""
    import torch

    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc

    k1, k4 = fa.launches, sc.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (out, fa.launches - k1, sc.launches - k4, time.time() - t0,
            torch.cuda.max_memory_allocated())


def phase_tasks(turbo, k4_per_encode: int):
    """The guided models and the editing tasks at full width (seeded
    weights, bf16), sharing `turbo`'s VAE. The launch floors: K1 once per
    decoder layer per step, K4 once per C <= 256 decoder stack (the
    decode) plus `k4_per_encode` per encoder pass."""
    import torch

    from acestep_torch import inference
    from acestep_torch.config import DiTConfig
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.pipeline.handler import AceStepHandler

    t_phase = time.time()
    layers = turbo.cfg.num_hidden_layers
    k4_decode = sum(blk.res1.conv1.weight.shape[0] <= 256
                    for blk in turbo.vae.decoder.blocks)
    hop = turbo.vae_cfg.hop_length
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0

    def record(name, fn, *, steps, encodes, frames, extra=None):
        res, k1, k4, wall, peak = _counted(fn)
        need = {"K1": layers * steps, "K4": k4_decode + encodes * k4_per_encode}
        if k1 < need["K1"] or k4 < need["K4"]:
            raise AssertionError(f"{name}: K1 {k1} and K4 {k4} launches, "
                                 f"need {need}")
        rec = dict(phase="tasks", request=name, wall_s=wall, k1_launches=k1,
                   k4_launches=k4, need=need, steps=steps, frames=frames,
                   max_memory_allocated=peak, **(extra or {}))
        return res, rec

    # ---- base and sft, through the facade
    guided = [
        ("base_60s_apg_50", DiTConfig.base(), dict(
            caption="warm jazz trio, brushed drums, upright bass",
            lyrics="[Instrumental]", duration=60.0, seed=44,
            inference_steps=50, guidance_scale=7.0, infer_method="ode"), 50),
        ("sft_30s_adg_sde_8", DiTConfig.sft(), dict(
            caption="driving rock, distorted guitars, 140 bpm",
            lyrics="[verse]\nfaster now\n[chorus]\nhold on", duration=30.0,
            seed=55, timesteps=[1.0, 0.92, 0.82, 0.7, 0.55, 0.4, 0.25, 0.1],
            use_adg=True, guidance_scale=7.0, infer_method="sde"), 8),
    ]
    records = []
    with tempfile.TemporaryDirectory() as out_dir:
        for name, cfg, kw, steps in guided:
            handler = AceStepHandler(cfg, turbo.vae_cfg, dtype=torch.bfloat16)
            handler.initialize_service(seed=0, vae_params=turbo.vae)

            def run():
                return inference.generate_music(
                    handler, None,
                    inference.GenerationParams(thinking=False, **kw),
                    inference.GenerationConfig(batch_size=1,
                                               use_random_seed=False,
                                               output_dir=out_dir))

            res, rec = record(name, run, steps=steps, encodes=0,
                              frames=int(kw["duration"] * 25))
            if not res.success:
                raise AssertionError(f"{name}: {res.error}\n"
                                     f"{res.status_message}")
            _check_audio(name, [e["audio"] for e in res.audios],
                         int(kw["duration"] * 25) * hop)
            rec["time_costs"] = res.extra_outputs["time_costs"]
            emit(**rec)
            records.append(rec)
            del handler, res
            gc.collect()
            torch.cuda.empty_cache()

    # ---- the editing tasks on a seeded 60 s song, through the handler
    song = _song(60.0, 66)
    common = dict(captions="lofi remix, soft keys", lyrics="[Instrumental]",
                  seeds=[77])

    def task(name, *, steps, encodes, frames, spans=None, **kw):
        res, rec = record(name, lambda: turbo.generate_music(**common, **kw),
                          steps=steps, encodes=encodes, frames=frames)
        if res.extra["frames"] != frames:
            raise AssertionError(f"{name}: {res.extra['frames']} frames, "
                                 f"want {frames}")
        if len(res.extra["schedule"]) != steps:
            raise AssertionError(f"{name}: schedule {res.extra['schedule']}, "
                                 f"want {steps} steps")
        if spans is not None and res.extra["spans"] != spans:
            raise AssertionError(f"{name}: spans {res.extra['spans']}, want "
                                 f"{spans}")
        _check_audio(name, res.audios, frames * hop)
        rec.update(time_costs=res.time_costs, spans=res.extra["spans"],
                   schedule=res.extra["schedule"])
        emit(**rec)
        records.append(rec)
        return res

    # cover noise 0.2 starts the shift-3 schedule at its value nearest to
    # 0.8, 0.833: 5 of 8 steps
    task("cover_60s", steps=5, encodes=1, frames=1500, task="cover",
         src_audio=song, audio_cover_strength=0.5, cover_noise_strength=0.2)
    task("repaint_10_20s", steps=8, encodes=1, frames=1500, task="repaint",
         src_audio=song, repainting_start=10.0, repainting_end=20.0,
         spans=[("repainting", 250, 500)])
    task("outpaint_minus5_plus5s", steps=8, encodes=1, frames=1750,
         task="repaint", src_audio=song, repainting_start=-5.0,
         repainting_end=65.0, spans=[("repainting", 0, 1750)])
    task("timbre_reference_60s", steps=8, encodes=1, frames=1500,
         audio_duration=60.0, refer_audios=song)
    codes, _k1, k4, wall, _peak = _counted(lambda: turbo.audio_to_codes(song))
    n_codes = codes.count("<|audio_code_")
    if n_codes != 300 or k4 < k4_per_encode:
        raise AssertionError(f"audio_to_codes: {n_codes} codes (want 300), "
                             f"K4 {k4} launches (need >= {k4_per_encode})")
    emit(phase="tasks", request="audio_to_codes_60s", wall_s=wall,
         k4_launches=k4, codes=n_codes)
    res = task("code_hint_render", steps=8, encodes=0, frames=1500,
               audio_code_hints=codes)
    if res.extra["task"] != "cover" or res.extra["is_covers"] != [True]:
        raise AssertionError(f"code hints: task {res.extra['task']}, covers "
                             f"{res.extra['is_covers']}")
    launches = {"K1": fa.launches, "K4": sc.launches,
                "K2": fa.launches_bwd_dq, "K3": fa.launches_bwd_dkv}
    emit(phase="tasks", seconds=time.time() - t_phase, launches=launches)
    return launches


# ------------------------------------------------------------------
# checkpoint: a full-width synthetic upstream checkpoint, loaded and rendered
# ------------------------------------------------------------------


def _upstream_dit_name(key: str, t):
    """The port's DiT key -> upstream name and layout (the inverse of the
    converter's map; linear and conv layouts are PyTorch's on both sides)."""
    import re

    k = key.replace("decoder.proj_in.", "decoder.proj_in.1.")
    k = k.replace("decoder.proj_out.", "decoder.proj_out.1.")
    k = k.replace("tokenizer.pooler.", "tokenizer.attention_pooler.")
    k = k.replace("tokenizer.fsq.", "tokenizer.quantizer.layers.0.")
    k = re.sub(r"\.mlp\.(gate|up|down)\.", r".mlp.\1_proj.", k)
    if k.endswith(".scale"):
        k = k[: -len(".scale")] + ".weight"
    if k.endswith("scale_shift_table") or k == "detokenizer.special_tokens":
        t = t[None]
    return k, t


def _upstream_vae_name(key: str, t):
    """The port's VAE key -> diffusers AutoencoderOobleck name and layout."""
    import re

    k = re.sub(r"\.res([123])\.", r".res_unit\1.",
               key.replace(".blocks.", ".block."))
    k = k.replace(".snake.", ".snake1.").replace(".down.", ".conv1.")
    k = k.replace(".up.", ".conv_t1.")
    if k.endswith((".alpha", ".beta")):
        t = t.reshape(1, -1, 1)
    return k, t


def _write_safetensors(path: str, tensors: dict) -> None:
    """safetensors by hand (no package): an 8-byte little-endian header
    length, the JSON header (padded to 8 bytes), the raw buffers."""
    import struct

    import torch

    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(torch.uint8).numpy())


def _write_checkpoint(d: str, state: dict, shards: int) -> None:
    """`state` in `shards` files named by model.safetensors.index.json."""
    os.makedirs(d, exist_ok=True)
    names = list(state)
    weight_map = {}
    for i in range(shards):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: state[k] for k in names[i::shards]}
        _write_safetensors(os.path.join(d, fname), part)
        weight_map.update({k: fname for k in part})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)


def phase_checkpoint(turbo):
    """`turbo`'s full-width weights written as an upstream-named checkpoint
    (DiT in two shards + index, VAE, silence_latent.pt; bf16), loaded by
    `initialize_service(checkpoint_dir=..., vae_dir=...)`: every tensor must
    equal the one written, and the loaded handler renders a 30 s song."""
    import numpy as np
    import torch

    from acestep_torch import inference
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.pipeline.handler import AceStepHandler

    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        dit_dir = os.path.join(root, "acestep-v15-turbo")
        vae_dir = os.path.join(root, "vae")
        dit_state = dict(_upstream_dit_name(k, t)
                         for k, t in turbo.model.state_dict().items())
        _write_checkpoint(dit_dir, dit_state, shards=2)
        _write_checkpoint(vae_dir, dict(
            _upstream_vae_name(k, t)
            for k, t in turbo.vae.state_dict().items()), shards=1)
        silence = torch.randn((1, 15360, 64),
                              generator=torch.Generator().manual_seed(3))
        torch.save(silence, os.path.join(dit_dir, "silence_latent.pt"))
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(root) for f in fs)
        t_write = time.time() - t0
        del dit_state
        t1 = time.time()
        handler = AceStepHandler(turbo.cfg, turbo.vae_cfg,
                                 dtype=torch.bfloat16)
        handler.initialize_service(checkpoint_dir=dit_dir, vae_dir=vae_dir)
        torch.cuda.synchronize()
        t_load = time.time() - t1
    mismatched = []
    for mod, src in ((handler.model, turbo.model), (handler.vae, turbo.vae)):
        want = src.state_dict()
        mismatched += [k for k, t in mod.state_dict().items()
                       if not torch.equal(t, want[k])]
    if mismatched or not np.array_equal(handler.silence_latent,
                                        silence.numpy()):
        raise AssertionError(f"checkpoint: {len(mismatched)} tensors differ "
                             f"from the ones written ({mismatched[:5]}), or "
                             f"the silence latent does")
    fa.launches, sc.launches = 0, 0
    with tempfile.TemporaryDirectory() as out_dir:
        res, k1, k4, wall, peak = _counted(lambda: inference.generate_music(
            handler, None, inference.GenerationParams(
                caption="acoustic folk, fingerpicked guitar",
                lyrics="[Instrumental]", duration=30.0, seed=5,
                thinking=False),
            inference.GenerationConfig(batch_size=1, use_random_seed=False,
                                       output_dir=out_dir)))
    if not res.success:
        raise AssertionError(f"checkpoint render: {res.error}")
    _check_audio("checkpoint_render", [e["audio"] for e in res.audios],
                 750 * turbo.vae_cfg.hop_length)
    need_k1 = turbo.cfg.num_hidden_layers * 8
    if k1 < need_k1 or k4 < 1:
        raise AssertionError(f"checkpoint render: K1 {k1} (need >= "
                             f"{need_k1}), K4 {k4} launches")
    launches = {"K1": fa.launches, "K4": sc.launches, "K2": 0, "K3": 0}
    emit(phase="checkpoint", checkpoint_bytes=nbytes, write_s=t_write,
         load_s=t_load, tensors_checked=len(turbo.model.state_dict())
         + len(turbo.vae.state_dict()), render_wall_s=wall,
         k1_launches=k1, k4_launches=k4, max_memory_allocated=peak,
         seconds=time.time() - t0)
    del handler
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------
# planner: the 4B LM planner and a thinking=True request
# ------------------------------------------------------------------

# Teacher-forced logits of a 2-layer LM at the planner's head geometry,
# bf16 on the card (graph replays) against fp32 on the CPU (eager), same
# weights: relative to the largest CPU logit. The head is taken in the
# compute dtype as in JAX, so the card's logits carry bf16 rounding
# (~4e-3) on top of two layers of bf16 activations.
TOL_LM_REFERENCE = 5e-2


def _teacher_forced(engine, prompt: str, forced):
    """Logits after the prompt and after each forced token, through the
    engine's prefill and its decode step (graph or eager)."""
    import torch

    logits, cache, lens, _ = engine._prefill_prompts([prompt], len(forced))
    row_lens = torch.as_tensor(lens, device=engine.device)
    step = engine.decode_step(cache, row_lens, 0, engine.vocab_use)
    out = [logits.clone()]
    for t in forced:
        logits = step(torch.tensor([t], device=engine.device), row_lens)
        row_lens = row_lens + 1
        out.append(logits.clone())
    return torch.cat(out).float().cpu()


def _lm_reference(quantization=None):
    """Teacher-forced logits of a 2-layer LM at the planner's head
    geometry, bf16 on the card against the same weights in fp32 on the
    CPU; with `quantization` both are quantized (each from the same float
    values, so their codes are equal) and, for w8a8, the vocab is the 4B
    planner's (padded, as a real planner's is: the head windows' widths
    are then multiples of 8, as `torch._int_mm` takes them on the card)."""
    import torch

    from acestep_torch.config import LMConfig
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.llm.tokenizer import SimpleTokenizer
    from acestep_torch.models.lm import build_lm, init_lm_params

    tok = SimpleTokenizer(num_audio_codes=64_000)
    cfg = dataclasses.replace(
        LMConfig.qwen3_4b(), hidden_size=512, intermediate_size=1024,
        num_hidden_layers=2,
        vocab_size=(LMConfig.qwen3_4b().vocab_size if quantization
                    else tok.vocab_size))
    card = init_lm_params(cfg, torch.Generator("cuda").manual_seed(4),
                          dtype=torch.bfloat16)
    cpu = build_lm(cfg, "cpu", torch.float32)
    cpu.load_state_dict(card.state_dict())
    engines = []
    for model, dtype, device in ((card, torch.bfloat16, None),
                                 (cpu, torch.float32, "cpu")):
        llm = LLMHandler(dtype=dtype, device=device)
        llm.initialize(cfg=cfg, tokenizer=tok, params=model,
                       quantization=quantization)
        engines.append(llm.engine)
    prompt = ("<|im_start|>user\n# Caption\nwarm synthwave\n\n# Lyric\n"
              "la la<|im_end|>\n<|im_start|>assistant\n")
    forced = tok.encode("<think>\nbpm: 118\ncaption: neon nights\n")[:32]
    forced += [tok.audio_code_id(i * 997) for i in range(32 - len(forced))]
    got = _teacher_forced(engines[0], prompt, forced)
    want = _teacher_forced(engines[1], prompt, forced)
    err = float((got - want).abs().max() / want.abs().max())
    if not err < TOL_LM_REFERENCE:
        raise AssertionError(f"LM ({quantization}) card vs CPU: teacher-"
                             f"forced logits rel err {err:.3e} (tol "
                             f"{TOL_LM_REFERENCE})")
    return {"quantization": quantization, "logits_rel_err": err,
            "tol": TOL_LM_REFERENCE, "positions": len(forced) + 1,
            "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
            "heads": [cfg.num_attention_heads, cfg.num_key_value_heads],
            "head_dim": cfg.head_dim, "kv_quant": engines[0].kv_quant}


def _tensor_bytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def _step_times(engine, rows: int = 2, slots: int = 768, fill: int = 400):
    """One decode step of the planner (rows [cond; uncond], `fill` tokens
    in a `slots` cache of the engine's kind, the CoT's head window): wall
    ms per step eager and as a graph replay (host included, 64 steps,
    median of 3 rounds), the replay's device ms (`cuda_ms`), and the
    step's bound from bytes: every trunk weight (codes and scales of a
    quantized one), the head window's rows (the int8 `head_q` rows and
    their scales for w8a8) and the attended K/V (int8 values and scales
    in the int8 cache) once."""
    import torch

    from acestep_torch.llm.generator import _GraphStep
    from acestep_torch.models.lm import KVCache

    cfg, V = engine.cfg, engine.vocab_use
    cache = KVCache.create(cfg, rows, slots, dtype=engine.dtype,
                           quantized=engine.kv_quant, device=engine.device)
    row_lens = torch.full((rows,), fill, dtype=torch.long,
                          device=engine.device)
    toks = torch.zeros(rows, dtype=torch.long, device=engine.device)
    graph = _GraphStep(engine._step_eager, cache, row_lens, 0, V)
    calls = {"eager": lambda: engine._step_eager(toks, cache, row_lens, 0, V),
             "graph": lambda: graph(toks, row_lens)}
    walls = {name: [] for name in calls}
    for r in range(3):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            calls[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(64):
                calls[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / 64 * 1e3)
    trunk = _tensor_bytes(engine.model.layers)
    head_q = getattr(engine.model, "head_q", None)
    head = V * cfg.hidden_size * (1 if head_q is not None else 2) + \
        (V * 4 if head_q is not None else 0)
    per_vec = cfg.head_dim * (1 if engine.kv_quant else 2) + \
        (4 if engine.kv_quant else 0)
    kv = 2 * cfg.num_hidden_layers * rows * fill * cfg.num_key_value_heads \
        * per_vec
    weights = sum(p.numel() for p in engine.model.layers.parameters()
                  if p.dim() >= 2) + sum(
        b.numel() * (2 if b.dtype == torch.uint8 else 1)
        for n, b in engine.model.layers.named_buffers()
        if n.endswith("codes"))
    flops = 2 * rows * (weights + V * cfg.hidden_size)
    bound_ms, bound_by = bound(flops, trunk + head + kv)
    out = {"eager_wall_ms": statistics.median(walls["eager"]),
           "graph_wall_ms": statistics.median(walls["graph"]),
           "graph_device_ms": cuda_ms(calls["graph"], reps=50),
           "rounds": walls, "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": trunk + head + kv, "trunk_bytes": trunk,
           "head_bytes": head, "kv_bytes": kv, "rows": rows, "slots": slots,
           "fill": fill, "head_rows": V, "kv_quant": engine.kv_quant}
    del graph, cache
    return out


def _thinking_requests(dit, llm, phase: str, requests):
    """thinking=True text2music through the facade for each (name,
    caption, seed) of `requests` (60 s, batch 1): the CoT and codes phases
    timed on the card, exactly 300 codes, the code-hint render's K1 and K4
    floors and its audio checked. The kernels' counts are set to 0 before
    each request, so after the call they hold the last one's launches.
    Returns the last request's codes."""
    import torch

    from acestep_torch import inference
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc

    eng = llm.engine
    timing = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timing[name] = (time.time() - t, out)
            return out
        return wrapper

    codes = None
    with tempfile.TemporaryDirectory() as out_dir, \
            mock.patch.object(eng, "generate_cot_device",
                              timed("cot", eng.generate_cot_device)), \
            mock.patch.object(eng, "generate_codes",
                              timed("codes", eng.generate_codes)):
        for name, caption, seed in requests:
            captures = eng.graph_captures
            fa.launches, sc.launches = 0, 0
            res, k1, k4, wall, peak = _counted(
                lambda: inference.generate_music(
                    dit, llm, inference.GenerationParams(
                        caption=caption,
                        lyrics="[verse]\nlights on the water\n[chorus]\n"
                               "hold me close",
                        duration=60.0, seed=seed, thinking=True),
                    inference.GenerationConfig(batch_size=1,
                                               use_random_seed=False,
                                               output_dir=out_dir)))
            if not res.success:
                raise AssertionError(f"{phase} {name}: {res.error}\n"
                                     f"{res.status_message}")
            out = res.extra_outputs
            codes = out["audio_codes"]
            n_codes = codes.count("<|audio_code_")
            cot_s, cot_ids = timing["cot"][0], timing["cot"][1][0]
            codes_s = timing["codes"][0]
            need_k1 = dit.cfg.num_hidden_layers * 8
            if n_codes != 300 or k1 < need_k1 or k4 < 1:
                raise AssertionError(
                    f"{phase} {name}: {n_codes} codes (want 300), K1 {k1} "
                    f"(need >= {need_k1}), K4 {k4} launches")
            _check_audio(name, [e["audio"] for e in res.audios],
                         1500 * dit.vae_cfg.hop_length)
            emit(phase=phase, part="thinking", request=name, wall_s=wall,
                 lm_time_cost=out["time_costs"].get("lm_time_cost"),
                 cot_tokens=len(cot_ids), cot_s=cot_s,
                 cot_tokens_per_s=len(cot_ids) / cot_s, codes=n_codes,
                 codes_s=codes_s, codes_tokens_per_s=n_codes / codes_s,
                 graph_captures=eng.graph_captures - captures,
                 k1_launches=k1, k4_launches=k4, max_memory_allocated=peak,
                 lm_metadata=out["lm_metadata"],
                 time_costs=out["time_costs"])
    return codes


# CoT tokens of `_graph_vs_eager`'s plans: the eager step (33-97 ms at
# 4B) sets the check's time, and 64 tokens cross several graph buckets
GRAPH_CHECK_COT_TOKENS = 64


def _graph_vs_eager(llm, phase: str):
    """Greedy CoT (at most GRAPH_CHECK_COT_TOKENS) + codes of a 10 s plan
    as graph replays and with the eager step (no cross-request prefix: a
    reused prefix is another prefill shape): the tokens must be
    identical."""
    import torch

    eng = llm.engine
    eng.cross_prefix_enabled = False
    plans = {}
    for graphs in (True, False):
        eng.cuda_graphs = graphs
        eng._cross_prefix = None
        t1 = time.time()
        plans[graphs] = llm.plan(
            "dark techno, pounding kick, 130 bpm", "[Instrumental]",
            target_duration=10, seed=0, cfg_scale=2.0,
            metadata_temperature=0.0, codes_temperature=0.0,
            max_cot_tokens=GRAPH_CHECK_COT_TOKENS)
        torch.cuda.synchronize()
        plans[graphs]["wall_s"] = time.time() - t1
    eng.cuda_graphs, eng.cross_prefix_enabled = True, True
    same = all(plans[True][k] == plans[False][k]
               for k in ("cot_text", "audio_codes", "metadata"))
    emit(phase=phase, part="graph_vs_eager", identical=same,
         cot_tokens=len(llm.tokenizer.encode(plans[True]["cot_text"])),
         codes=plans[True]["audio_codes"].count("<|audio_code_"),
         graph_wall_s=plans[True]["wall_s"],
         eager_wall_s=plans[False]["wall_s"],
         metadata=plans[True]["metadata"])
    if not same:
        raise AssertionError(f"{phase}: graph replays and the eager step "
                             "decoded different greedy tokens")


def phase_planner(turbo):
    """The 5 Hz planner on the card: `initialize_auto` (the tier's choice:
    4B at bf16 on an 80 GB card), a card-vs-CPU logits reference at the
    planner's head geometry, greedy CoT + codes as graph replays against
    the eager step (identical tokens), the decode step's times, then a
    thinking=True text2music request through the facade (60 s, batch 1,
    after a warm-up): CoT metadata, 300 codes, the code-hint render through
    K1 and the VAE decode through K4. Returns (launches, the LLMHandler),
    which the serving phase reuses."""
    import torch

    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc

    t0 = time.time()
    reference = _lm_reference()
    emit(phase="planner", part="reference", **reference)
    llm = LLMHandler(dtype=torch.bfloat16)
    picked = llm.initialize_auto()
    torch.cuda.synchronize()
    cfg = llm.cfg
    print(f"planner: {picked['size']} quantization={picked['quantization']}",
          flush=True)
    if (picked["size"], picked["quantization"]) != ("4B", None):
        raise AssertionError(f"planner: the 80 GB tier picked {picked}")
    emit(phase="planner", part="init", picked=picked, init_s=time.time() - t0,
         params=sum(p.numel() for p in llm.engine.model.parameters()),
         hidden=cfg.hidden_size, layers=cfg.num_hidden_layers,
         heads=[cfg.num_attention_heads, cfg.num_key_value_heads],
         head_dim=cfg.head_dim, intermediate=cfg.intermediate_size,
         vocab=cfg.vocab_size, vocab_use=llm.engine.vocab_use,
         memory_allocated=torch.cuda.memory_allocated())
    _graph_vs_eager(llm, "planner")
    emit(phase="planner", part="decode_step", **_step_times(llm.engine))
    _thinking_requests(turbo, llm, "planner", [
        ("warm-up", "lofi hip hop, rainy window, soft keys", 12),
        ("thinking_60s", "melodic house, airy pads, female vocals", 21)])
    launches = {"K1": fa.launches, "K4": sc.launches, "K2": 0, "K3": 0}
    emit(phase="planner", seconds=time.time() - t0, launches=launches)
    return launches, llm


# ------------------------------------------------------------------
# mesh: the DiT's dp x tp mesh and the tensor-parallel planner
# ------------------------------------------------------------------

# The tp=2 and dp=2 renders (two ranks sharing the one card over gloo)
# against the unsharded render of the same seeds: relative L2 of the
# latents. tp sums each row-parallel product's bf16 halves over the group
# where the unsharded product sums in one pass; dp renders a row in
# another batch. The fused group's rows read ~1% against solo renders.
TOL_MESH = 2e-2
# The tp=2 planner's teacher-forced logits against tp=1's (both bf16 on
# the card, same weights) over 36 layers: relative to the largest tp=1
# logit (the card-vs-CPU limit of `_lm_reference`).
TOL_MESH_LM = 5e-2
MESH_LYRICS = "[verse]\nsplit across the ranks\n[chorus]\nall reduce"
# the tp=2 planner's thinking request over REST: a short song, since each
# decode step of two gloo ranks sharing the card costs 150-290 ms
MESH_THINKING_SECONDS = 10


def _rel_l2(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mesh_render(handler, world_launches, batch: int, label: str):
    """A 60 s text2music render of `batch` rows (seeds 41..) through the
    handler: (result, wall s, rank 0's K1/K4 launches, every rank's K1
    launches inside mesh commands)."""
    import numpy as np

    captions = ["cinematic synthwave, gated drums", "acoustic folk duet",
                "dub techno, deep chords"][:batch]
    before = world_launches() if world_launches else None
    res, k1, k4, wall, peak = _counted(lambda: handler.generate_music(
        captions, [MESH_LYRICS] * batch, batch_size=batch,
        seeds=list(range(41, 41 + batch)), audio_duration=60.0,
        normalize=False))
    if res.pred_latents.shape != (batch, 1500, 64) or len(res.audios) != \
            batch or not np.isfinite(res.pred_latents).all():
        raise AssertionError(f"mesh {label}: latents "
                             f"{res.pred_latents.shape}, {len(res.audios)} "
                             "audios")
    _check_audio(label, res.audios, 1500 * handler.vae_cfg.hop_length)
    ranks = None
    if before is not None:
        after = world_launches()
        ranks = [a - b for a, b in zip(after["K1"], before["K1"])]
    return res, wall, k1, k4, ranks, peak


def phase_mesh(turbo, llm):
    """The multi-device slice on the one card (phase 5's turbo handler at
    full width, the planner phase's 4B planner at bf16):

    1. `enable_mesh()` with its defaults on the one card, the handler on
       the bare `cuda` device as the server makes it: a 1-rank NCCL world
       whose 60 s render is bit-equal to the unsharded render;
    2. a world of two ranks sharing cuda:0 over gloo (NCCL refuses two
       ranks on one card): tp=2, a 60 s batch-1 render against the
       unsharded one (TOL_MESH), K1 launches of each rank, and K1 held to
       its plain version at the per-rank heads (1, 750, 8/4);
    3. dp=2 on the same world: batch 3, padded to 4 and trimmed back to 3,
       against the unsharded batch 3 (TOL_MESH);
    4. the planner at tp=2 on the same world, built by the server's own
       wiring from `--lm-size auto --lm-tensor-parallel 2` (the tier's 4B,
       seed 0: the planner phase's weights): teacher-forced logits against
       tp=1 (TOL_MESH_LM), then a MESH_THINKING_SECONDS thinking request
       through the REST server with that planner (wall, tokens/s).

    Walls and start-ups (spawn, weight transfer) are of ranks sharing one
    H100 over gloo, not of several cards. Returns the launches of the
    renders and the request, every rank's summed."""
    import numpy as np
    import torch

    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.parallel import make_mesh
    from acestep_torch.serving.server import (
        AppState, build_parser, load_planner,
    )

    t_phase = time.time()
    launches = {"K1": 0, "K4": 0, "K2": 0, "K3": 0}

    def count(k1, k4, ranks):
        launches["K1"] += k1 + (sum(ranks[1:]) if ranks else 0)
        launches["K4"] += k4

    base1, wall1, k1, k4, _, _ = _mesh_render(turbo, None, 1, "unsharded")
    base3, wall3, _, _, _, _ = _mesh_render(turbo, None, 3, "unsharded b3")
    emit(phase="mesh", part="unsharded", wall_b1_s=wall1, wall_b3_s=wall3,
         k1_launches=k1, k4_launches=k4)

    # -- 1: the defaults on one card: one rank, the default backend
    t0 = time.time()
    turbo.enable_mesh()
    start = time.time() - t0
    try:
        backend = turbo.mesh.backend
        if (turbo.mesh.dp, turbo.mesh.tp) != (1, 1) or \
                turbo.mesh.devices != [torch.device("cuda", 0)]:
            raise AssertionError(f"mesh defaults on one card: "
                                 f"{turbo.mesh.describe()}")
        res, wall, k1, k4, ranks, _ = _mesh_render(
            turbo, turbo.mesh.launches, 1, "nccl 1x1")
        count(k1, k4, ranks)
    finally:
        turbo.release_mesh()
    equal = bool(np.array_equal(res.pred_latents, base1.pred_latents))
    emit(phase="mesh", part="nccl_1x1", call="enable_mesh()",
         handler_device=str(turbo.device), backend=backend, startup_s=start,
         wall_s=wall, bit_equal=equal, k1_launches=ranks,
         max_abs_diff=float(np.abs(res.pred_latents
                                   - base1.pred_latents).max()))
    if backend != "nccl" or not equal:
        raise AssertionError(f"mesh 1x1 ({backend}): the render differs "
                             "from the unsharded one")

    # -- 2-4: two ranks on cuda:0 over gloo; the anchor mesh keeps the
    # world up between the handler's and the planner's meshes
    t0 = time.time()
    anchor = make_mesh(2, 1, devices=["cuda:0", "cuda:0"], backend="gloo")
    spawn = time.time() - t0
    lm2 = None
    try:
        # tp=2
        t0 = time.time()
        turbo.enable_mesh(dp=1, tp=2)
        start = time.time() - t0
        try:
            res, wall, k1, k4, ranks, peak = _mesh_render(
                turbo, anchor.launches, 1, "gloo tp=2")
            count(k1, k4, ranks)
        finally:
            turbo.release_mesh()
        rel = _rel_l2(res.pred_latents, base1.pred_latents)
        emit(phase="mesh", part="gloo_tp2", spawn_s=spawn,
             startup_s=start, wall_s=wall, unsharded_wall_s=wall1,
             latents_rel_l2=rel, tol=TOL_MESH, k1_launches_per_rank=ranks,
             k4_launches=k4, max_memory_allocated=peak,
             note="gloo, ranks sharing one H100")
        need = turbo.cfg.num_hidden_layers * 8
        if not rel < TOL_MESH or min(ranks) < need:
            raise AssertionError(f"mesh tp=2: latents rel L2 {rel:.3e} "
                                 f"(tol {TOL_MESH}), K1 per rank {ranks} "
                                 f"(need >= {need} each)")
        rank_heads = _k1_case(1, 750, None, 113, heads=(8, 4))
        emit(phase="mesh", part="k1_rank_heads", **rank_heads)

        # dp=2, batch 3 padded to 4
        t0 = time.time()
        turbo.enable_mesh(dp=2, tp=1)
        start = time.time() - t0
        try:
            res, wall, k1, k4, ranks, peak = _mesh_render(
                turbo, anchor.launches, 3, "gloo dp=2")
            count(k1, k4, ranks)
        finally:
            turbo.release_mesh()
        rel = _rel_l2(res.pred_latents, base3.pred_latents)
        emit(phase="mesh", part="gloo_dp2", startup_s=start, wall_s=wall,
             unsharded_wall_s=wall3, latents_rel_l2=rel, tol=TOL_MESH,
             rows=res.pred_latents.shape[0], k1_launches_per_rank=ranks,
             max_memory_allocated=peak, note="gloo, ranks sharing one H100")
        if not rel < TOL_MESH or res.seeds != [41, 42, 43]:
            raise AssertionError(f"mesh dp=2: latents rel L2 {rel:.3e} "
                                 f"(tol {TOL_MESH}), seeds {res.seeds}")

        # the planner at tp=2 as the server builds it: the tier's 4B drawn
        # from seed 0 on the bare `cuda` device, as the planner phase drew
        # `llm`
        t0 = time.time()
        args = build_parser().parse_args(
            ["--lm-size", "auto", "--lm-tensor-parallel", "2"])
        lm2 = load_planner(args, torch.bfloat16, llm.device)
        start = time.time() - t0
        half = lm2.engine.model.embed_tokens.shape[0]
        same = bool(torch.equal(lm2.engine.model.embed_tokens,
                                llm.engine.model.embed_tokens[:half]))
        if lm2.engine.mesh.tp != 2 or lm2.cfg != llm.cfg or not same:
            raise AssertionError(
                f"mesh planner from --lm-tensor-parallel 2: tp "
                f"{lm2.engine.mesh.tp}, the planner phase's weights {same}")
        tok = llm.tokenizer
        prompt = ("<|im_start|>user\n# Caption\nwarm synthwave\n\n# Lyric\n"
                  "la la<|im_end|>\n<|im_start|>assistant\n")
        forced = tok.encode("<think>\nbpm: 118\ncaption: neon nights\n")[:32]
        forced += [tok.audio_code_id(i * 997)
                   for i in range(32 - len(forced))]
        llm.engine._cross_prefix = lm2.engine._cross_prefix = None
        t0 = time.time()
        got = _teacher_forced(lm2.engine, prompt, forced)
        tf_s = time.time() - t0
        want = _teacher_forced(llm.engine, prompt, forced)
        err = float((got - want).abs().max() / want.abs().max())
        emit(phase="mesh", part="planner_tp2_logits", startup_s=start,
             argv="--lm-size auto --lm-tensor-parallel 2",
             embed_shard_equal=same,
             logits_rel_err=err, tol=TOL_MESH_LM, positions=len(forced) + 1,
             teacher_forced_s=tf_s, graph=llm.engine.cuda_graphs,
             tp2_graph=lm2.engine.cuda_graphs)
        if not err < TOL_MESH_LM:
            raise AssertionError(f"mesh planner tp=2: logits rel err "
                                 f"{err:.3e} (tol {TOL_MESH_LM})")

        # a thinking request over REST with the tp=2 planner
        eng = lm2.engine
        timing = {}

        def timed(name, fn):
            def wrapper(*a, **kw):
                t = time.time()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timing[name] = (time.time() - t, out)
                return out
            return wrapper

        with tempfile.TemporaryDirectory() as out_dir, \
                mock.patch.object(eng, "generate_cot_device",
                                  timed("cot", eng.generate_cot_device)), \
                mock.patch.object(eng, "generate_codes",
                                  timed("codes", eng.generate_codes)):
            state = AppState({SERVED_MODEL: turbo}, lm2, output_dir=out_dir)
            server, port = _serve(state)
            try:
                body = dict(prompt="melodic house, airy pads",
                            lyrics=MESH_LYRICS,
                            audio_duration=MESH_THINKING_SECONDS, seed=21,
                            use_random_seed=False, thinking=True,
                            audio_format="wav")
                before = anchor.launches()
                k1, k4 = fa.launches, sc.launches
                t0 = time.time()
                entry = _wait_task(port, _release(port, body))[0]
                wall = time.time() - t0
                ranks = [a - b for a, b in zip(anchor.launches()["K1"],
                                               before["K1"])]
            finally:
                state.shutdown()
                server.shutdown()
                server.server_close()
        costs = entry["time_costs"]
        cot_s, cot_ids = timing["cot"][0], timing["cot"][1][0]
        codes_s, codes = timing["codes"][0], timing["codes"][1][0]
        k1, k4 = fa.launches - k1, sc.launches - k4
        count(k1, k4, ranks)
        emit(phase="mesh", part="thinking_rest_tp2",
             duration=MESH_THINKING_SECONDS,
             wall_s=wall, lm_time_cost=costs.get("lm_time_cost"),
             cot_tokens=len(cot_ids), cot_s=cot_s,
             cot_tokens_per_s=len(cot_ids) / cot_s, codes=len(codes),
             codes_s=codes_s, codes_tokens_per_s=len(codes) / codes_s,
             planner_k1_per_rank=ranks, k1_launches=k1, k4_launches=k4,
             metas=entry.get("metas"), time_costs=costs,
             note="gloo, ranks sharing one H100; eager decode under tp")
        if len(codes) != 5 * MESH_THINKING_SECONDS or \
                not costs.get("lm_time_cost") or \
                k1 < 8 * turbo.cfg.num_hidden_layers:
            raise AssertionError(f"mesh thinking tp=2: {len(codes)} codes, "
                                 f"K1 {k1}, costs {costs}")
    finally:
        if lm2 is not None:
            lm2.release()
        anchor.close()
    emit(phase="mesh", seconds=time.time() - t_phase, launches=launches)
    return launches


# ------------------------------------------------------------------
# serving: the REST server, render coalescing, the chat adapter, FLAC and
# the CLI, on phase 5's turbo handler and the planner phase's LLMHandler
# ------------------------------------------------------------------

# served and fused renders against the facade's solo renders of the same
# seed: relative to the largest solo value (bf16 batch numerics)
TOL_COALESCED = 5e-2
SERVED_MODEL = "acestep-v15-turbo"


def _rest(port: int, method: str, route: str, body=None, headers=None):
    """(status, parsed JSON or raw bytes, seconds) of one HTTP call; a
    bytes `body` goes as it is, with `headers`."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    if isinstance(body, bytes):
        conn.request(method, route, body, headers or {})
    else:
        conn.request(method, route,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"}
                     if body is not None else {})
    resp = conn.getresponse()
    raw = resp.read()
    seconds = time.perf_counter() - t0
    ctype = resp.getheader("Content-Type") or ""
    conn.close()
    return (resp.status, json.loads(raw) if "json" in ctype else raw,
            seconds)


def _serve(state, start_workers: bool = True):
    """The port's server on 127.0.0.1 at an ephemeral port, in a thread:
    (server, port). Without `start_workers` jobs wait in the queue until
    `state.start_workers()`."""
    import threading

    from acestep_torch.serving import server as srv

    with mock.patch.object(state, "start_workers",
                           state.start_workers if start_workers
                           else (lambda: None)):
        server = srv.create_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _release(port: int, body: dict) -> str:
    status, out, _ = _rest(port, "POST", "/release_task", body)
    if status != 200:
        raise AssertionError(f"/release_task {status}: {out}")
    return out["data"]["task_id"]


def _wait_task(port: int, task_id: str, timeout: float = 600.0) -> list:
    """Poll /query_result every 20 ms until the task ends; its result
    entries (one per song). A failed task raises."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, out, _ = _rest(port, "POST", "/query_result",
                          {"task_id_list": [task_id]})
        entry = out["data"][0]
        if entry["status"] == 1:
            return json.loads(entry["result"])
        if entry["status"] == 2:
            raise AssertionError(f"task {task_id} failed: {entry['result']}")
        time.sleep(0.02)
    raise AssertionError(f"task {task_id} did not finish in {timeout} s")


class _Poller:
    """Polls GET routes every `every` s in a thread while a request runs:
    the worst latency of each route, and any status but 200."""

    def __init__(self, port, routes, every=0.05):
        import threading

        self.port, self.routes, self.every = port, routes, every
        self.worst = {r: 0.0 for r in routes}
        self.polls, self.bad = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            for route in self.routes:
                status, _, s = _rest(self.port, "GET", route)
                self.worst[route] = max(self.worst[route], s)
                if status != 200:
                    self.bad.append((route, status))
            self.polls += 1
            self._stop.wait(self.every)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _solo(turbo, req_body: dict, out_dir: str):
    """The facade render of a REST body (the params and config the server
    builds for it): (GenerationResult, wall s)."""
    import torch

    from acestep_torch import inference
    from acestep_torch.serving import server as srv
    from acestep_torch.serving.schemas import GenerateMusicRequest

    req = GenerateMusicRequest.from_dict(req_body)
    t0 = time.time()
    res = inference.generate_music(
        turbo, None, srv.request_to_params(req), inference.GenerationConfig(
            batch_size=1, use_random_seed=req.use_random_seed,
            audio_format=req.audio_format, output_dir=out_dir))
    torch.cuda.synchronize()
    if not res.success:
        raise AssertionError(f"solo render: {res.error}\n"
                             f"{res.status_message}")
    return res, time.time() - t0


def phase_serving(turbo, llm):
    """The port's REST server in this process on 127.0.0.1 (an ephemeral
    port, `http.client`), over phase 5's turbo handler, DiT-only at first:
    4 compatible 60 s thinking=False jobs queued before the workers start,
    fused into one render (K1 and K4 counted, each item against a solo
    render of its seed, songs/s fused and serial); a 30 s request against
    the facade's render of the same seed. Then with the planner phase's 4B
    LLMHandler attached: a 60 s thinking request with /v1/metrics and
    /v1/stats polled every 50 ms (the planner's graphs dropped first, so
    it captures while the polls run), and a chat completion. Then a facade
    request with the default format (flac) decoded back against the int16
    samples written, beside a wav save; and the CLI's `--once` as a
    subprocess on the card."""
    import base64

    import numpy as np
    import torch

    from acestep_torch import inference
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.serving import server as srv
    from acestep_torch.utils import flac_native
    from acestep_torch.utils.audio import load_wav
    from acestep_torch.utils.flac import decode_flac, encode_flac

    t_phase = time.time()
    fa.launches, sc.launches = 0, 0
    layers = turbo.cfg.num_hidden_layers
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as work:
        out_dir = os.path.join(work, "outputs")
        # DiT-only for the thinking=False renders (with a planner attached
        # the REST default also plans CoT metadata per job, serially,
        # before the fused render); the planner joins for the thinking
        # request and the chat completion
        state = srv.AppState({SERVED_MODEL: turbo}, None, output_dir=out_dir,
                             persist_dir=os.path.join(work, "persist"))
        server, port = _serve(state, start_workers=False)
        try:
            # -- 2: four compatible 60 s jobs queued before the workers
            bodies = [dict(prompt=f"deep house, rolling bass, take {i}",
                           lyrics="[verse]\nmove\n[chorus]\nhigher",
                           audio_duration=60, seed=40 + i,
                           use_random_seed=False, thinking=False,
                           audio_format="wav") for i in range(4)]
            ids = [_release(port, b) for b in bodies]
            fused_results = []
            group_fn = srv.inference.generate_music_group

            def capture_group(*a, **kw):
                out = group_fn(*a, **kw)
                fused_results.extend(out)
                return out

            k1, k4 = fa.launches, sc.launches
            t0 = time.time()
            with mock.patch.object(srv.inference, "generate_music_group",
                                   capture_group), \
                    _Poller(port, ["/v1/metrics"]) as group_poll:
                state.start_workers()
                entries = [_wait_task(port, i) for i in ids]
            group_wall = time.time() - t0
            group_k1, group_k4 = fa.launches - k1, sc.launches - k4
            _, stats, _ = _rest(port, "GET", "/v1/stats")
            coalesced = [e[0]["time_costs"].get("coalesced_jobs")
                         for e in entries]
            if (len(fused_results) != 4 or coalesced != [4] * 4
                    or stats["data"]["coalesced_jobs_total"] != 4):
                raise AssertionError(
                    f"coalescing: {len(fused_results)} fused results, "
                    f"coalesced_jobs {coalesced}, stats {stats['data']}")
            # K1 does not grow with the batch; K4 is the VAE decode's C <=
            # 256 stacks once per decode call, and the handler decodes
            # each 60 s item of a 4-item batch as its own group
            want_k4 = 4 * sum(blk.res1.conv1.weight.shape[0] <= 256
                              for blk in turbo.vae.decoder.blocks)
            if group_k1 != 8 * layers or group_k4 != want_k4:
                raise AssertionError(
                    f"fused group: K1 {group_k1} (want {8 * layers}), K4 "
                    f"{group_k4} (want {want_k4})")
            solo_walls, lat_err, audio_err, solo_k = [], [], [], []
            for body, fused in zip(bodies, fused_results):
                k1, k4 = fa.launches, sc.launches
                res, wall = _solo(turbo, body, os.path.join(work, "solo"))
                solo_k.append((fa.launches - k1, sc.launches - k4))
                solo_walls.append(wall)
                lat_err.append(_rel_err(
                    fused.extra_outputs["pred_latents"][0],
                    res.extra_outputs["pred_latents"][0]))
                audio_err.append(_rel_err(fused.audios[0]["audio"],
                                          res.audios[0]["audio"]))
            if max(lat_err) > TOL_COALESCED:
                raise AssertionError(
                    f"fused items against solo renders: latents rel err "
                    f"{lat_err} (tol {TOL_COALESCED})")
            emit(phase="serving", part="coalesced_group", jobs=4,
                 duration=60.0, wall_s=group_wall,
                 render_total_time_cost=entries[0][0]["time_costs"][
                     "total_time_cost"],
                 k1_launches=group_k1, k4_launches=group_k4,
                 solo_k1_k4=solo_k, solo_wall_s=solo_walls,
                 songs_per_s_fused=4 / group_wall,
                 songs_per_s_serial=4 / sum(solo_walls),
                 latent_rel_err=lat_err, audio_rel_err=audio_err,
                 tol=TOL_COALESCED, coalesced_jobs_total=stats["data"][
                     "coalesced_jobs_total"],
                 metrics_polls=group_poll.polls,
                 metrics_worst_s=group_poll.worst["/v1/metrics"],
                 metrics_bad=group_poll.bad)

            # -- 1: one REST request against the facade's render
            body = dict(prompt="lofi hip hop, mellow keys, vinyl crackle",
                        lyrics="[Instrumental]", audio_duration=30, seed=11,
                        use_random_seed=False, thinking=False,
                        audio_format="wav")
            t0 = time.time()
            entry = _wait_task(port, _release(port, body))[0]
            rest_wall = time.time() - t0
            res, solo_wall = _solo(turbo, body, os.path.join(work, "facade"))
            served, _ = load_wav(entry["file"])
            facade, _ = load_wav(res.audios[0]["path"])
            # bit-equal expected (one device, the same code and seed); the
            # difference is reported, and the run fails past the limit
            diff = float(np.abs(served - facade).max()) \
                if served.shape == facade.shape else float("inf")
            if diff > TOL_COALESCED:
                raise AssertionError(
                    f"served 30 s render against the facade's: shapes "
                    f"{served.shape} / {facade.shape}, max diff {diff}")
            total = entry["time_costs"]["total_time_cost"]
            emit(phase="serving", part="rest_request", duration=30.0,
                 rest_wall_s=rest_wall, render_total_time_cost=total,
                 rest_overhead_s=rest_wall - total, facade_wall_s=solo_wall,
                 max_abs_diff_vs_facade=diff, bit_equal=diff == 0.0,
                 time_costs=entry["time_costs"])

            # -- 3: a thinking request while /v1/metrics and /v1/stats
            # are polled; the planner's graphs are dropped first so that
            # it captures them again during the polls
            state.llm_handler = llm
            eng = llm.engine
            eng._graphs = {}
            captures = eng.graph_captures
            body = dict(prompt="melodic house, airy pads, female vocals",
                        lyrics="[verse]\nlights on the water\n[chorus]\n"
                               "hold me close",
                        audio_duration=60, seed=21, use_random_seed=False,
                        thinking=True, audio_format="wav")
            k1, k4 = fa.launches, sc.launches
            t0 = time.time()
            with _Poller(port, ["/v1/metrics", "/v1/stats"]) as poll:
                entry = _wait_task(port, _release(port, body))[0]
            wall = time.time() - t0
            new_captures = eng.graph_captures - captures
            costs = entry["time_costs"]
            if (new_captures < 1 or poll.bad or poll.polls < 10
                    or not costs.get("lm_time_cost")
                    or fa.launches - k1 < 8 * layers):
                raise AssertionError(
                    f"thinking over REST: captures {new_captures}, polls "
                    f"{poll.polls}, bad {poll.bad}, costs {costs}")
            emit(phase="serving", part="thinking_rest", duration=60.0,
                 wall_s=wall, lm_time_cost=costs["lm_time_cost"],
                 graph_captures=new_captures, polls=poll.polls,
                 worst_latency_s=poll.worst,
                 k1_launches=fa.launches - k1, k4_launches=sc.launches - k4,
                 metas=entry.get("metas"), time_costs=costs)

            # -- 4: the OpenRouter chat adapter
            status, models, _ = _rest(port, "GET", "/v1/models")
            names = [m["name"] for m in models["data"]["models"]]
            status_c, chat, chat_s = _rest(
                port, "POST", "/v1/chat/completions", {
                    "model": f"acestep/{SERVED_MODEL}", "seed": 5,
                    "messages": [{"role": "user", "content":
                                  "<prompt>warm jazz trio, brushed drums"
                                  "</prompt><lyrics>[inst]</lyrics>"}],
                    "audio_config": {"duration": 30, "format": "flac"}})
            audio = (chat.get("choices") or [{}])[0].get(
                "message", {}).get("audio") or []
            url = audio[0]["audio_url"]["url"] if audio else ""
            pcm, sr = decode_flac(base64.b64decode(url.split(",", 1)[-1])) \
                if url.startswith("data:audio/flac;base64,") else (None, 0)
            if (status != 200 or SERVED_MODEL not in names or status_c != 200
                    or pcm is None or pcm.shape != (750 * 1920, 2)
                    or sr != 48000):
                raise AssertionError(
                    f"chat: models {status} {names}, completion {status_c} "
                    f"{str(chat)[:300]}")
            emit(phase="serving", part="chat_completion", wall_s=chat_s,
                 models=names, samples=int(pcm.shape[0]), sample_rate=sr,
                 content=chat["choices"][0]["message"]["content"])
        finally:
            state.shutdown()
            server.shutdown()
            server.server_close()

        # -- 5: FLAC, the facade's default format, beside wav
        params = inference.GenerationParams(
            caption="indie rock, jangly guitars", lyrics="[verse]\nla la",
            duration=60.0, seed=31, thinking=False)
        saved = {}
        for fmt in ("flac", "wav"):
            config = inference.GenerationConfig(
                batch_size=1, use_random_seed=False,
                output_dir=os.path.join(work, fmt),
                **({} if fmt == "flac" else {"audio_format": fmt}))
            res = inference.generate_music(turbo, None, params, config)
            if not res.success:
                raise AssertionError(f"flac phase ({fmt}): {res.error}")
            saved[fmt] = res
        entry = saved["flac"].audios[0]
        want = np.clip(np.asarray(entry["audio"], np.float32) * 32767.0,
                       -32768, 32767).astype(np.int16)
        with open(entry["path"], "rb") as f:
            blob = f.read()
        got, sr = decode_flac(blob)
        if not entry["path"].endswith(".flac") or sr != 48000 or \
                not np.array_equal(got, want):
            raise AssertionError(f"flac: {entry['path']}, sr {sr}, decoded "
                                 f"equal {np.array_equal(got, want)}")
        encode_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            encode_flac(want, 48000)
            encode_s.append(time.perf_counter() - t0)
        emit(phase="serving", part="flac", duration=60.0,
             native=flac_native.native_rice_encode is not None,
             flac_audio_conversion_time=saved["flac"].extra_outputs[
                 "time_costs"]["audio_conversion_time"],
             wav_audio_conversion_time=saved["wav"].extra_outputs[
                 "time_costs"]["audio_conversion_time"],
             encode_s=encode_s, flac_bytes=len(blob),
             wav_bytes=os.path.getsize(saved["wav"].audios[0]["path"]),
             decoded_equal=True)

    # -- 7: the CLI as a subprocess on the card
    cli_out = os.path.join("build", "cli_out")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "acestep_torch.cli", "--once", "--no-think",
         "--duration", "30", "--seed", "1", "--output-dir", cli_out],
        capture_output=True, text=True, timeout=600)
    cli_wall = time.time() - t0
    lines = proc.stdout.strip().splitlines()
    path = lines[-1] if lines else ""
    ok = proc.returncode == 0 and path.endswith(".flac") and \
        os.path.exists(path)
    if ok:
        with open(path, "rb") as f:
            pcm, sr = decode_flac(f.read())
        ok = pcm.shape == (750 * 1920, 2) and sr == 48000
    if not ok:
        raise AssertionError(f"cli --once: rc {proc.returncode}, stdout "
                             f"{proc.stdout[-800:]}, stderr "
                             f"{proc.stderr[-1500:]}")
    emit(phase="serving", part="cli_once", wall_s=cli_wall, path=path,
         samples=int(pcm.shape[0]))
    launches = {"K1": fa.launches, "K4": sc.launches, "K2": 0, "K3": 0}
    emit(phase="serving", seconds=time.time() - t_phase, launches=launches)
    return launches


STUDIO_SECONDS = 30.0
# the LoRA panel's seeded PEFT-layout adapter: rank 8 on q/k/v/o of every
# layer, A ~ N(0, 1/in), B ~ N(0, LORA_B_STD^2)
LORA_RANK, LORA_B_STD = 8, 0.02


def _multipart(fields: dict, files: dict):
    """(body, headers) of a multipart/form-data request."""
    boundary = "----chipsmokeboundary"
    out = b""
    for name, value in fields.items():
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="{name}"\r\n\r\n{value}\r\n').encode()
    for name, (filename, data) in files.items():
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="{name}"; filename="{filename}"\r\n'
                "Content-Type: application/octet-stream\r\n\r\n").encode()
        out += data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return out, {"Content-Type": f"multipart/form-data; boundary={boundary}",
                 "Content-Length": str(len(out))}


def _write_peft_adapter(path: str, cfg, seed: int) -> int:
    """A seeded PEFT-layout LoRA (`lora_A` (r, in), `lora_B` (out, r)) on
    q/k/v/o of every decoder layer, in float32; its parameter count."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    hidden, hd = cfg.hidden_size, cfg.head_dim
    dims = {"q_proj": (hidden, cfg.num_attention_heads * hd),
            "k_proj": (hidden, cfg.num_key_value_heads * hd),
            "v_proj": (hidden, cfg.num_key_value_heads * hd),
            "o_proj": (cfg.num_attention_heads * hd, hidden)}
    tensors = {}
    for layer in range(cfg.num_hidden_layers):
        for proj, (d_in, d_out) in dims.items():
            key = f"layers.{layer}.self_attn.{proj}"
            tensors[f"{key}.lora_A.weight"] = torch.randn(
                LORA_RANK, d_in, generator=gen) / math.sqrt(d_in)
            tensors[f"{key}.lora_B.weight"] = LORA_B_STD * torch.randn(
                d_out, LORA_RANK, generator=gen)
    _write_safetensors(path, tensors)
    return sum(t.numel() for t in tensors.values())


def phase_studio(turbo):
    """The Studio's flows over the port's REST server in this process, on
    phase 5's full-width turbo handler (DiT-only), user paths under a
    temporary safe root: the page; the Studio's generate body for extract,
    lego and complete on a seeded 30 s source sent base64 as the page
    sends it (and lego once more as a multipart upload), each finite, 30 s
    long, K1 >= layers x 8 and K4 >= the decode's stacks plus one encoder
    pass; the dice and its blueprint rendered at 30 s; the LoRA panel at
    full width (load, status, scale 0.5, toggle off: the base's bits,
    toggle on: another song, unload: memory back within 1%);
    /v1/reinitialize twice with allow_random_init (each re-init's render
    the base's bits, memory after the second within 1% of after the
    first, each swap's peak beside the DiT's bytes); /lrc_to_vtt on a
    want_lrc request's LRC. The handler leaves as it came: the same
    weights (the re-init's seed is phase 5's) and no adapter."""
    import base64

    import numpy as np
    import torch

    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.scoring.alignment import DEFAULT_CAPTURE
    from acestep_torch.serving import server as srv
    from acestep_torch.utils.audio import load_wav, save_wav
    from acestep_torch.utils.path_safety import get_safe_root, set_safe_root

    t_phase = time.time()
    layers = turbo.cfg.num_hidden_layers
    vae_cfg = turbo.vae_cfg
    k4_decode = sum(blk.res1.conv1.weight.shape[0] <= 256
                    for blk in turbo.vae.decoder.blocks)
    k4_encode = sum(vae_cfg.encoder_hidden_size * m <= 256
                    for m in (1,) + tuple(vae_cfg.channel_multiples[:-1]))
    samples = int(STUDIO_SECONDS * 25) * vae_cfg.hop_length
    here = os.path.dirname(os.path.abspath(__file__))
    fa.launches, sc.launches = 0, 0
    old_root = get_safe_root()
    renders = []                    # the latents of each render
    real_generate = turbo.generate_music

    def capture(**kw):
        res = real_generate(**kw)
        renders.append(np.asarray(res.pred_latents))
        return res

    def memory():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_studio_") as work, \
            mock.patch.object(turbo, "generate_music", capture):
        set_safe_root(work)
        state = srv.AppState({SERVED_MODEL: turbo}, None,
                             output_dir=os.path.join(work, "outputs"),
                             persist_dir=os.path.join(work, "persist"),
                             examples_dir=os.path.join(here, "examples"))
        server, port = _serve(state)
        try:
            def render(name, body, *, encodes, raw=None, headers=None):
                """One request through /release_task -> /query_result: its
                items, the latents it rendered, and its record."""
                k1, k4 = fa.launches, sc.launches
                n = len(renders)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                if raw is None:
                    task = _release(port, body)
                else:
                    status, out, _ = _rest(port, "POST", "/release_task",
                                           raw, headers)
                    if status != 200:
                        raise AssertionError(f"{name}: {status} {out}")
                    task = out["data"]["task_id"]
                items = _wait_task(port, task)
                wall = time.time() - t0
                k1, k4 = fa.launches - k1, sc.launches - k4
                need = {"K1": layers * 8,
                        "K4": k4_decode + encodes * k4_encode}
                audio, sr = load_wav(items[0]["file"])
                _check_audio(name, [audio], samples)
                if sr != 48000 or len(renders) != n + 1 or \
                        k1 < need["K1"] or k4 < need["K4"]:
                    raise AssertionError(
                        f"{name}: sr {sr}, renders {len(renders) - n}, K1 "
                        f"{k1} and K4 {k4} launches, need {need}")
                rec = dict(phase="studio", request=name, wall_s=wall,
                           k1_launches=k1, k4_launches=k4, need=need,
                           max_memory_allocated=torch.cuda.
                           max_memory_allocated(),
                           time_costs=items[0].get("time_costs"))
                return items, renders[-1], rec

            # -- the page
            status, page, _ = _rest(port, "GET", "/studio")
            with open(os.path.join(here, "acestep_torch", "serving",
                                   "studio.html"), "rb") as f:
                want_page = f.read()
            if status != 200 or page != want_page:
                raise AssertionError(f"/studio: {status}, {len(page)} bytes "
                                     f"(want the page's {len(want_page)})")
            emit(phase="studio", part="page", bytes=len(page))

            # -- the editing modes on a seeded 30 s source
            src_path = os.path.join(work, "source.wav")
            save_wav(src_path, _song(STUDIO_SECONDS, 71))
            with open(src_path, "rb") as f:
                src_bytes = f.read()
            studio_body = dict(
                prompt="lofi remix, soft keys", lyrics="[Instrumental]",
                audio_duration=STUDIO_SECONDS, inference_steps=8, seed=81,
                use_random_seed=False, thinking=False, audio_format="wav",
                guidance_scale=7.0, infer_method="ode", shift=3.0,
                src_audio_b64=base64.b64encode(src_bytes).decode(),
                upload_audio_format="wav")
            modes = {"extract": dict(track_name="vocals"),
                     "lego": dict(track_name="drums", repainting_start=10.0,
                                  repainting_end=20.0),
                     "complete": dict(track_classes=["drums", "bass"])}
            lego = None
            for mode, extra in modes.items():
                _, lat, rec = render(mode, dict(studio_body, task_type=mode,
                                                **extra), encodes=1)
                if mode == "lego":
                    lego = lat
                emit(**rec)
            fields = {k: ("false" if v is False else v)
                      for k, v in studio_body.items()
                      if k not in ("src_audio_b64", "upload_audio_format")}
            raw, headers = _multipart(
                dict(fields, task_type="lego", **modes["lego"]),
                {"src_audio": ("source.wav", src_bytes)})
            _, lat, rec = render("lego_multipart", None, encodes=1, raw=raw,
                                 headers=headers)
            diff = _rel_err(lat, lego)
            if diff > TOL_COALESCED:
                raise AssertionError(f"lego: multipart upload against base64"
                                     f" latents rel err {diff}")
            emit(**rec, latent_rel_err_vs_base64=diff)

            # -- the dice, then its blueprint at 30 s
            status, dice, _ = _rest(port, "POST", "/create_random_sample",
                                    {"sample_mode": "custom_mode"})
            sample = dice.get("data") or {}
            if status != 200 or not sample.get("caption"):
                raise AssertionError(f"/create_random_sample: {status} "
                                     f"{dice}")
            _, _, rec = render("dice_blueprint", dict(
                prompt=sample["caption"], lyrics=sample.get("lyrics", ""),
                bpm=sample.get("bpm"), key_scale=sample.get("keyscale", ""),
                vocal_language=sample.get("language", "en"),
                audio_duration=STUDIO_SECONDS, seed=82,
                use_random_seed=False, thinking=False, audio_format="wav"),
                encodes=0)
            emit(**rec, sample_duration=sample.get("duration"))

            # -- the LoRA panel at full width
            base_body = dict(prompt="melodic techno, analog arps",
                             lyrics="[Instrumental]",
                             audio_duration=STUDIO_SECONDS, seed=83,
                             use_random_seed=False, thinking=False,
                             audio_format="wav")
            _, base, rec = render("lora_base", base_body, encodes=0)
            emit(**rec)
            adapter = os.path.join(work, "panel", "adapter_model.safetensors")
            os.makedirs(os.path.dirname(adapter))
            n_params = _write_peft_adapter(adapter, turbo.cfg, seed=84)
            before_load = memory()
            panel = {}
            for label, route, body in (
                    ("load", "/v1/lora/load", {"lora_path": adapter,
                                               "adapter_name": "panel"}),
                    ("status", "/v1/lora/status", None),
                    ("scale", "/v1/lora/scale", {"adapter_name": "panel",
                                                 "scale": 0.5}),
                    ("toggle_off", "/v1/lora/toggle", {"use_lora": False})):
                status, out, _ = _rest(port, "GET" if body is None
                                       else "POST", route, body)
                if status != 200:
                    raise AssertionError(f"LoRA {label}: {status} {out}")
                panel[label] = out["data"]
            _, off, rec_off = render("lora_toggled_off", base_body,
                                     encodes=0)
            status, out, _ = _rest(port, "POST", "/v1/lora/toggle",
                                   {"use_lora": True})
            panel["toggle_on"] = out["data"]
            _, on, rec_on = render("lora_on", base_body, encodes=0)
            with_merge = memory()
            status_u, out, _ = _rest(port, "POST", "/v1/lora/unload",
                                     {"adapter_name": "panel"})
            panel["unload"] = out["data"]
            after_unload = memory()
            moved = float(np.abs(on - base).max())
            off_bits = np.array_equal(off, base)
            unload_drift = abs(after_unload - before_load) / before_load
            if not (panel["load"]["params"] == n_params and off_bits
                    and moved > 1e-3 and panel["scale"]["scale"] == 0.5
                    and panel["toggle_off"]["use_lora"] is False
                    and panel["toggle_on"]["use_lora"] is True
                    and status_u == 200 and unload_drift < 0.01
                    and not turbo.lora.status()["adapters"]):
                raise AssertionError(
                    f"LoRA panel: {panel}, params {n_params}, toggled off "
                    f"bit-identical {off_bits}, latents moved {moved:.3e}, "
                    f"allocated before load / after unload {before_load} / "
                    f"{after_unload}")
            emit(phase="studio", part="lora_panel", panel=panel,
                 adapter_params=n_params, toggled_off_bit_identical=off_bits,
                 latent_max_change_on=moved, wall_off_s=rec_off["wall_s"],
                 wall_on_s=rec_on["wall_s"], k1_on=rec_on["k1_launches"],
                 allocated_before_load=before_load,
                 allocated_with_merge=with_merge,
                 allocated_after_unload=after_unload,
                 unload_drift=unload_drift)

            # -- /v1/reinitialize twice: the same seeded weights
            dit_bytes = sum(t.numel() * t.element_size() for t in
                            list(turbo.model.parameters())
                            + list(turbo.model.buffers()))
            swaps = []
            for i in range(2):
                before = memory()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                status, out, _ = _rest(port, "POST", "/v1/reinitialize",
                                       {"allow_random_init": True})
                swap_s = time.time() - t0
                peak = torch.cuda.max_memory_allocated()
                before_gc = torch.cuda.memory_allocated()
                after = memory()
                _, lat, rec = render(f"after_reinit_{i}", base_body,
                                     encodes=0)
                bits = np.array_equal(lat, base)
                swaps.append(dict(status=status, swap_s=swap_s,
                                  allocated_before=before,
                                  peak_allocated=peak,
                                  allocated_after_before_gc=before_gc,
                                  allocated_after=after,
                                  render_bit_identical=bits,
                                  render_wall_s=rec["wall_s"]))
                if status != 200 or not out["data"]["initialized"] or \
                        not bits:
                    raise AssertionError(f"reinitialize {i}: {status} {out},"
                                         f" render bit-identical {bits}")
            drift = abs(swaps[1]["allocated_after"]
                        - swaps[0]["allocated_after"]) / \
                swaps[0]["allocated_after"]
            if drift >= 0.01:
                raise AssertionError(f"reinitialize: allocated after the "
                                     f"swaps {swaps}, drift {drift}")
            emit(phase="studio", part="reinitialize", dit_bytes=dit_bytes,
                 swaps=swaps, allocated_drift=drift)

            # -- /lrc_to_vtt on a want_lrc request's LRC
            items, _, rec = render("want_lrc", dict(
                base_body, lyrics="[verse]\nlights on the water\n[chorus]"
                "\nhold me close, hold me close", want_lrc=True, seed=85),
                encodes=0)
            lrc = items[0].get("lrc")
            # the capture pass runs K1 in the layers up to the deepest
            # captured one (7 at full width; a model too shallow for the
            # table captures its own layers, at least one)
            capture = (max(DEFAULT_CAPTURE) + 1
                       if layers > max(DEFAULT_CAPTURE) else 1)
            if not lrc or rec["k1_launches"] < layers * 8 + capture:
                raise AssertionError(f"want_lrc: K1 {rec['k1_launches']}, "
                                     f"item {str(items[0])[:400]}")
            status, vtt, _ = _rest(port, "POST", "/lrc_to_vtt",
                                   {"lrc": lrc, "duration": STUDIO_SECONDS})
            vtt = vtt.get("data") or {}
            if status != 200 or not vtt.get("vtt", "").startswith(
                    "WEBVTT") or not vtt.get("cues"):
                raise AssertionError(f"/lrc_to_vtt: {status} {vtt}")
            emit(**rec, lrc_lines=len(lrc.splitlines()),
                 vtt_cues=len(vtt["cues"]),
                 alignment_score=items[0].get("alignment_score"))
        finally:
            state.shutdown()
            server.shutdown()
            server.server_close()
            set_safe_root(old_root)
    launches = {"K1": fa.launches, "K4": sc.launches, "K2": 0, "K3": 0}
    emit(phase="studio", seconds=time.time() - t_phase, launches=launches)
    return launches


DATASET_SONG_SECONDS = 60.0


def _poll_data(port: int, route: str, timeout: float = 600.0) -> dict:
    """Poll a GET route every 0.1 s until its data's status ends."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, out, _ = _rest(port, "GET", route)
        if out["data"]["status"] in ("completed", "failed", "stopped"):
            return out["data"]
        time.sleep(0.1)
    raise AssertionError(f"{route} did not finish in {timeout} s")


def phase_dataset(turbo, llm):
    """The dataset build and the dataset session over REST, on phase 5's
    turbo handler with the planner phase's 4B planner attached (the
    server's own AppState wiring): two seeded 60 s wav songs; POST
    /v1/dataset/build polled through /v1/dataset/status (scan -> encode,
    K4 three launches an encode -> label, the planner's `understand` on
    each song's codes -> manifest -> tensors from the cached latents); the
    session routes scan -> auto_label_async (polled) -> save ->
    preprocess_async (polled), each of the session's stages encoding the
    songs again (K4); then 1 LoRA step at full width over
    /v1/training/start on the built tensors (the output is training
    input), its adapter unloaded after. Seeded weights may give no
    caption: the build then falls back to the filename's, as JAX's does;
    the check is that every stage ran and wrote its files. Reports each
    stage's seconds per song, K4 launches and the planner's calls."""
    import numpy as np
    import torch

    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.serving import server as srv
    from acestep_torch.training import dataset_builder
    from acestep_torch.utils.audio import save_wav

    t_phase = time.time()
    n_songs, frames = 2, int(DATASET_SONG_SECONDS * 25)
    stage_s = {}

    def timed(name):
        real = getattr(dataset_builder.DatasetBuildPipeline, name)

        def run(self, *args, **kwargs):
            t0 = time.time()
            out = real(self, *args, **kwargs)
            torch.cuda.synchronize()
            stage_s[name] = time.time() - t0
            return out
        return run

    understood = []
    real_understand = llm.understand

    def understand(codes, *args, **kwargs):
        t0 = time.time()
        out = real_understand(codes, *args, **kwargs)
        understood.append({"s": time.time() - t0,
                           "codes": codes.count("<|audio_code_"),
                           "caption": bool(out.get("caption"))})
        return out

    os.makedirs("build", exist_ok=True)
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_",
                                     dir=os.path.abspath("build")) as work, \
            mock.patch.object(llm, "understand", understand), \
            mock.patch.multiple(dataset_builder.DatasetBuildPipeline,
                                stage_encode=timed("stage_encode"),
                                stage_label=timed("stage_label"),
                                stage_tensors=timed("stage_tensors")):
        audio_dir = os.path.join(work, "songs")
        os.makedirs(audio_dir)
        for i in range(n_songs):
            save_wav(os.path.join(audio_dir, f"seeded_song_{i}.wav"),
                     _song(DATASET_SONG_SECONDS, 300 + i))
        state = srv.AppState({SERVED_MODEL: turbo}, llm,
                             output_dir=os.path.join(work, "outputs"),
                             persist_dir=os.path.join(work, "persist"))
        server, port = _serve(state)
        try:
            # -- the staged build
            ds = os.path.join(work, "ds")
            t0 = time.time()
            status, out, _ = _rest(port, "POST", "/v1/dataset/build",
                                   {"audio_dir": audio_dir, "out_dir": ds})
            if status != 200:
                raise AssertionError(f"/v1/dataset/build {status}: {out}")
            built = _poll_data(port, "/v1/dataset/status")
            build_wall = time.time() - t0
            build_k4, build_calls = sc.launches, len(understood)
            if built["status"] != "completed" or \
                    built["result"]["num_samples"] != n_songs or \
                    built["progress"]["encoded"] != n_songs or \
                    built["progress"]["tensors"] != n_songs:
                raise AssertionError(f"dataset build: {built}")
            with open(os.path.join(ds, "dataset.json")) as f:
                manifest = json.load(f)
            for name in os.listdir(os.path.join(ds, "latents")):
                lat = np.load(os.path.join(ds, "latents", name))
                if lat.shape != (frames, 64) or not np.isfinite(lat).all():
                    raise AssertionError(f"latents {name}: {lat.shape}")
            if len(manifest) != n_songs or not all(
                    e.get("caption") for e in manifest):
                raise AssertionError(f"manifest: {manifest}")

            # -- the session: scan -> auto_label -> save -> preprocess
            k4 = sc.launches
            t0 = time.time()
            status, out, _ = _rest(port, "POST", "/v1/dataset/scan", {
                "audio_dir": audio_dir, "dataset_name": "chip_smoke_set"})
            if status != 200 or out["data"]["num_samples"] != n_songs:
                raise AssertionError(f"/v1/dataset/scan {status}: {out}")
            status, out, _ = _rest(port, "POST",
                                   "/v1/dataset/auto_label_async", {})
            labeled = _poll_data(port, "/v1/dataset/auto_label_status/"
                                 + out["data"]["task_id"])
            label_wall = time.time() - t0
            session_label_k4 = sc.launches - k4
            session_path = os.path.join(work, "session.json")
            status, saved, _ = _rest(port, "POST", "/v1/dataset/save",
                                     {"save_path": session_path})
            k4 = sc.launches
            t0 = time.time()
            session_tensors = os.path.join(work, "session_tensors")
            status, out, _ = _rest(port, "POST",
                                   "/v1/dataset/preprocess_async",
                                   {"output_dir": session_tensors})
            preprocessed = _poll_data(port, "/v1/dataset/preprocess_status/"
                                      + out["data"]["task_id"])
            preprocess_wall = time.time() - t0
            session_k4 = sc.launches - k4
            with open(session_path) as f:
                session = json.load(f)
            if labeled["status"] != "completed" or \
                    labeled["result"]["labeled_count"] != n_songs or \
                    status != 200 or \
                    preprocessed["status"] != "completed" or \
                    preprocessed["result"]["num_samples"] != n_songs or \
                    len(session["samples"]) != n_songs or \
                    len([f for f in os.listdir(session_tensors)
                         if f.endswith(".npz")]) != n_songs:
                raise AssertionError(f"dataset session: label {labeled}, "
                                     f"save {saved}, preprocess "
                                     f"{preprocessed}")

            # -- the built tensors are training input: 1 LoRA step
            k1 = fa.launches
            t0 = time.time()
            status, out, _ = _rest(port, "POST", "/v1/training/start", {
                "dataset_dir": os.path.join(ds, "tensors"), "config": {
                    "max_steps": 1, "rank": 16, "batch_size": 1,
                    "checkpoint_every": 0, "log_every": 1,
                    "output_dir": os.path.join(work, "lora"),
                    "adapter_name": "dataset_lora"}})
            if status != 200:
                raise AssertionError(f"/v1/training/start {status}: {out}")
            trained = _poll_data(port, "/v1/training/status")
            lora_wall = time.time() - t0
            lora_k1 = fa.launches - k1
        finally:
            state.shutdown()
            server.shutdown()
            server.server_close()
        turbo.lora.unload()
        if trained["status"] != "completed" or trained["step"] != 1 or \
                not np.isfinite(trained["loss"]) or \
                turbo.lora.status()["active_adapter"] is not None:
            raise AssertionError(f"LoRA step on the built tensors: "
                                 f"{trained}, {turbo.lora.status()}")
    launches = {"K1": fa.launches, "K2": fa.launches_bwd_dq,
                "K3": fa.launches_bwd_dkv, "K4": sc.launches}
    layers = turbo.cfg.num_hidden_layers
    # three encodes a song (the build's, the session's label and
    # preprocess), three C <= 256 stacks each
    need = {"K4": 3 * 3 * n_songs, "K1": 2 * layers, "K2": layers,
            "K3": layers}
    short = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
    if short or build_calls != n_songs or len(understood) != 2 * n_songs:
        raise AssertionError(f"dataset launches (got, need): {short}; "
                             f"understand calls {len(understood)}")
    emit(phase="dataset", card=_card(), songs=n_songs,
         song_seconds=DATASET_SONG_SECONDS, build_wall_s=build_wall,
         stage_s=stage_s,
         stage_s_per_song={k: v / n_songs for k, v in stage_s.items()},
         build_k4=build_k4, k4_per_encode=build_k4 / n_songs,
         understand=understood, understand_calls=len(understood),
         build_captions=[e["caption"] for e in manifest],
         session_label_wall_s=label_wall, session_label_k4=session_label_k4,
         session_preprocess_wall_s=preprocess_wall,
         session_preprocess_k4=session_k4, lora_step_wall_s=lora_wall,
         lora_step_loss=trained["loss"], lora_step_k1=lora_k1,
         launches=launches, need=need, seconds=time.time() - t_phase)
    return launches


def phase_rest_training(tensors: str, work: str):
    """LoRA training over REST at full width (DiTConfig.turbo(), batch 1)
    on the tensors the training phase preprocessed, on a seeded turbo
    handler: `/v1/training/load_tensor_info`; a long `/v1/training/start`
    stopped by `/v1/training/stop` once it has taken a step; the restart
    (2 steps, rank 16) polled through `/v1/training/status` until done and
    its adapter checked; `/v1/training/export` of that run, its adapter
    loaded back through `/v1/lora/load` and a 30 s song rendered under it
    through `/release_task`; `/v1/training/start_lora` and `start_lokr`
    for one step each; `/v1/training/tensorboard/start|stop` (the JAX
    server's error envelope where no tensorboard is installed). K1, K2, K3
    counted for the steps, K1 and K4 for the render."""
    import torch

    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.lora.manager import load_adapter_file
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.pipeline.handler import AceStepHandler
    from acestep_torch.serving import server as srv
    from acestep_torch.utils.audio import load_wav

    t0 = time.time()
    handler = AceStepHandler(DiTConfig.turbo(), VAEConfig(),
                             dtype=torch.bfloat16)
    handler.initialize_service(seed=0)
    layers = handler.cfg.num_hidden_layers
    state = srv.AppState({SERVED_MODEL: handler}, None,
                         output_dir=os.path.join(work, "rest_outputs"),
                         persist_dir=os.path.join(work, "rest_persist"))
    server, port = _serve(state)
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0
    record = {}

    def status():
        return _rest(port, "GET", "/v1/training/status")[1]["data"]

    def finished(timeout=600.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = status()
            if st["status"] in ("completed", "failed", "stopped"):
                return st
            time.sleep(0.2)
        raise AssertionError(f"REST training did not end: {st}")

    def start(route, name, **config):
        code, out, _ = _rest(port, "POST", route, {
            "dataset_dir": tensors, "config": dict(
                batch_size=1, checkpoint_every=0, log_every=1,
                output_dir=os.path.join(work, name), adapter_name=name,
                **config)})
        if code != 200 or out["data"]["status"] != "started":
            raise AssertionError(f"{route} {code}: {out}")
        return out["data"]["config"]

    try:
        code, info, _ = _rest(port, "POST", "/v1/training/load_tensor_info",
                              {"dataset_dir": tensors})
        info = info["data"]
        if code != 200 or info["num_samples"] != 2 or \
                info["frames_max"] != int(TRAIN_SONG_SECONDS * 25):
            raise AssertionError(f"load_tensor_info {code}: {info}")
        record["tensor_info"] = info

        # -- a long run stopped once it has taken a step
        start("/v1/training/start", "rest_stopped", max_steps=1000, rank=16)
        deadline = time.time() + 600
        while status().get("step", 0) < 1 and time.time() < deadline:
            time.sleep(0.1)
        code, stop, _ = _rest(port, "POST", "/v1/training/stop", {})
        stopped = finished()
        if code != 200 or stop["data"]["status"] != "stopping" or \
                stopped["status"] != "stopped" or \
                not 1 <= stopped["step"] < 1000:
            raise AssertionError(f"stop: {code} {stop}, then {stopped}")
        record["stopped_at_step"] = stopped["step"]

        # -- the restart, to its end
        t_train = time.time()
        start("/v1/training/start", "rest_lora", max_steps=2, rank=16)
        data = finished()
        train_wall = time.time() - t_train
        _, metrics, _ = _rest(port, "GET", "/v1/training/metrics")
        if data["status"] != "completed" or data.get("step") != 2 or \
                data.get("adapter_loaded") != "rest_lora":
            raise AssertionError(f"REST training: status {data}")
        path = os.path.join(work, "rest_lora", "rest_lora.npz")
        _check_adapter(path)

        # -- export, load it back, render under it
        code, exported, _ = _rest(port, "POST", "/v1/training/export", {})
        adapters = exported["data"]["adapters"] if code == 200 else []
        if adapters != [path]:
            raise AssertionError(f"export {code}: {exported}")
        code, loaded, _ = _rest(port, "POST", "/v1/lora/load", {
            "lora_path": adapters[0], "adapter_name": "exported"})
        if code != 200 or loaded["data"]["adapter_name"] != "exported":
            raise AssertionError(f"load of the export {code}: {loaded}")
        k1, k4 = fa.launches, sc.launches
        t_render = time.time()
        entry = _wait_task(port, _release(port, dict(
            prompt="test song 0", lyrics="[verse]\nla la la\n[chorus]\noh oh",
            audio_duration=30, seed=86, use_random_seed=False,
            thinking=False, audio_format="wav")))[0]
        render_wall = time.time() - t_render
        audio, _ = load_wav(entry["file"])
        _check_audio("render under the exported adapter", [audio],
                     750 * handler.vae_cfg.hop_length)
        render_k1, render_k4 = fa.launches - k1, sc.launches - k4
        _, lora_status, _ = _rest(port, "GET", "/v1/lora/status")
        if render_k1 < 8 * layers or render_k4 < 1 or \
                lora_status["data"]["active_adapter"] != "exported":
            raise AssertionError(f"render under the export: K1 {render_k1},"
                                 f" K4 {render_k4}, {lora_status['data']}")
        record["export_render"] = dict(
            wall_s=render_wall, k1_launches=render_k1,
            k4_launches=render_k4, time_costs=entry["time_costs"])

        # -- start_lora and start_lokr, one step each
        for route, kind in (("/v1/training/start_lora", "lora"),
                            ("/v1/training/start_lokr", "lokr")):
            name = f"rest_{kind}_route"
            config = start(route, name, max_steps=1, rank=16)
            st = finished()
            adapter = load_adapter_file(os.path.join(work, name,
                                                     f"{name}.npz"))
            if config["kind"] != kind or st["status"] != "completed" or \
                    st.get("step") != 1 or \
                    st.get("adapter_loaded") != name or \
                    adapter["meta"].get("kind", "lora") != kind:
                raise AssertionError(f"{route}: config {config}, status "
                                     f"{st}, adapter {adapter['meta']}")
            record[kind] = dict(loss=st["loss"], meta=adapter["meta"])

        # -- tensorboard: launched and stopped where it runs, else the
        # JAX server's 503 envelope (not installed, or exited at once)
        code, tb, _ = _rest(port, "POST", "/v1/training/tensorboard/start",
                            {"logdir": os.path.join(work, "rest_lora")})
        code_stop, tb_stop, _ = _rest(port, "POST",
                                      "/v1/training/tensorboard/stop", {})
        ran = code == 200 and tb_stop["data"]["status"] == "stopped"
        refused = (code == 503 and tb["error"]
                   and tb_stop["data"]["status"] == "not_running")
        if not (ran or refused) or code_stop != 200:
            raise AssertionError(f"tensorboard: start {code} {tb}, stop "
                                 f"{code_stop} {tb_stop}")
        record["tensorboard"] = dict(start=code, error=tb["error"],
                                     stop=tb_stop["data"])
    finally:
        state.shutdown()
        server.shutdown()
        server.server_close()
    launches = {"K1": fa.launches, "K2": fa.launches_bwd_dq,
                "K3": fa.launches_bwd_dkv, "K4": sc.launches}
    steps = record["stopped_at_step"] + 2 + 1 + 1
    need = {"K1": 2 * steps * layers + 8 * layers, "K2": steps * layers,
            "K3": steps * layers, "K4": 1}
    short = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"REST training launches (got, need): {short}")
    emit(phase="rest_training", steps=data["step"], loss=data["loss"],
         train_wall_s=train_wall, metrics_points=metrics["data"]["points"],
         adapter=path, adapter_loaded=data["adapter_loaded"],
         total_steps=steps, launches=launches, need=need,
         seconds=time.time() - t0, **record)
    del handler, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------
# quant: the DiT in every quantized mode; the 16 GB tier's w8a8 planner
# ------------------------------------------------------------------

# w8a8 last: its handler stays for the 16 GB tier's thinking request, and
# no other mode's render should count its DiT in its peak
QUANT_MODES = ("int8", "fp8", "int4", "w8a8")


def _quant_reference(mode):
    """The small reference model quantized on the card (bf16) and on the
    CPU (fp32) from the same values: codes and scales must be equal, then
    one turbo request on both within TOL_REFERENCE."""
    import numpy as np
    import torch

    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.ops.quant import QuantWeight, quantize_module_

    gpu, cpu = _reference_pair(DiTConfig.tiny(fsq_dim=64, head_dim=128),
                               VAEConfig.tiny(decoder_input_channels=64))
    for h in (gpu, cpu):
        quantize_module_(h.model, mode)
    mods = [(a, b) for a, b in zip(gpu.model.modules(), cpu.model.modules())
            if isinstance(a, QuantWeight)]
    codes = sum(not torch.equal(a.codes.cpu().view(torch.uint8),
                                b.codes.view(torch.uint8)) for a, b in mods)
    scales = sum(not torch.equal(a.scale.cpu(), b.scale) for a, b in mods)
    if not mods or codes or scales:
        raise AssertionError(f"quant {mode}: of {len(mods)} weights, the "
                             f"card's codes differ from the CPU's in {codes},"
                             f" its scales in {scales}")
    noise = np.random.default_rng(0).standard_normal((2, 200, 64)).astype(
        np.float32)
    return _reference_case(
        f"quant_{mode}", gpu, cpu, captions=["quant a", "quant b"],
        lyrics=["la", "da"], audio_duration=8.0, seeds=[1, 2],
        normalize=False, initial_noise=noise)


def _render_30s(handler, name, out_dir, seed=5):
    """A turbo 30 s text2music request through the facade: (wall s, K1,
    K4, peak bytes, time_costs), K1/K4 floors and audio checked."""
    from acestep_torch import inference

    res, k1, k4, wall, peak = _counted(lambda: inference.generate_music(
        handler, None, inference.GenerationParams(
            caption="bright funk, slap bass, brass stabs",
            lyrics="[verse]\nmove your feet\n[chorus]\nall night",
            duration=30.0, seed=seed, thinking=False),
        inference.GenerationConfig(batch_size=1, use_random_seed=False,
                                   output_dir=out_dir)))
    if not res.success:
        raise AssertionError(f"{name}: {res.error}\n{res.status_message}")
    _check_audio(name, [e["audio"] for e in res.audios],
                 750 * handler.vae_cfg.hop_length)
    need_k1 = handler.cfg.num_hidden_layers * 8
    if k1 < need_k1 or k4 < 3:
        raise AssertionError(f"{name}: K1 {k1} (need >= {need_k1}), K4 {k4} "
                             "(need >= 3)")
    return wall, k1, k4, peak, res.extra_outputs["time_costs"]


def phase_quant(turbo):
    """Quantized serving on the card. For each DiT mode: the small
    card-vs-CPU reference, then phase 5's turbo weights quantized in a
    handler of their own (sharing phase 5's VAE; phase 5's bf16 DiT waits
    in host memory, so the peak is the quantized service's) and a 30 s
    render through the facade after a warm-up, beside a bf16 render.
    Then the 2-layer w8a8 planner's card-vs-CPU logits, and the 16 GB and
    8 GB tiers under a real cap, each in a child process (`phase_tier`):
    the w8a8 DiT and the tier's planner, a 60 s thinking request after a
    warm-up. Returns the launches and the 16 GB tier's measured request's
    codes."""
    import torch

    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.ops.quant import quantized_bytes
    from acestep_torch.pipeline.handler import AceStepHandler

    t0 = time.time()
    launches = {"K1": 0, "K4": 0, "K2": 0, "K3": 0}

    def count(k1, k4):
        launches["K1"] += k1
        launches["K4"] += k4

    with tempfile.TemporaryDirectory() as out_dir:
        bf16_bytes = quantized_bytes(turbo.model)
        _render_30s(turbo, "quant bf16 warm-up", out_dir)
        resident = torch.cuda.memory_allocated()
        wall, k1, k4, peak, costs = _render_30s(turbo, "quant bf16", out_dir)
        count(k1, k4)
        emit(phase="quant", part="render", mode="bf16", dit_bytes=bf16_bytes,
             wall_s=wall, k1_launches=k1, k4_launches=k4,
             memory_allocated=resident, max_memory_allocated=peak,
             time_costs=costs)
        turbo.model.to("cpu")
        torch.cuda.empty_cache()
        for mode in QUANT_MODES:
            ref = _quant_reference(mode)
            t1 = time.time()
            h = AceStepHandler(DiTConfig.turbo(), VAEConfig(),
                               dtype=torch.bfloat16)
            h.initialize_service(params=copy.deepcopy(turbo.model).to("cuda"),
                                 vae_params=turbo.vae, quantization=mode)
            torch.cuda.synchronize()
            init_s = time.time() - t1
            _render_30s(h, f"quant {mode} warm-up", out_dir)
            resident = torch.cuda.memory_allocated()
            wall, k1, k4, peak, costs = _render_30s(h, f"quant {mode}",
                                                    out_dir)
            count(k1, k4)
            emit(phase="quant", part="render", mode=mode,
                 dit_bytes=quantized_bytes(h.model),
                 bytes_vs_bf16=quantized_bytes(h.model) / bf16_bytes,
                 quantize_s=init_s, wall_s=wall, k1_launches=k1,
                 k4_launches=k4, memory_allocated=resident,
                 max_memory_allocated=peak,
                 time_costs=costs, reference=ref)
            del h
            gc.collect()
            torch.cuda.empty_cache()
    emit(phase="quant", part="lm_reference", **_lm_reference("w8a8"))
    codes = None
    for gb in sorted(TIER_CAPS_GIB, reverse=True):
        result = _tier_child(gb)
        count(result["k1"], result["k4"])
        codes = codes or result["codes"]
    turbo.model.to("cuda")
    emit(phase="quant", seconds=time.time() - t0, launches=launches)
    return launches, codes


# The low-memory tiers under a real cap: the allocator of a process of its
# own capped at each tier's nominal size less 1 GiB (a card of that size
# reports up to its nominal GiB, and its CUDA context, outside the
# allocator's count, takes ~0.5 GiB), with ACESTEP_MAX_HBM_GB set, both
# before any handler is built. One process a tier: after the 16 GB tier's
# handlers were let go, the 8 GB tier's initialisation ran out of its cap
# in the same process (measured on one H100).
TIER_CAPS_GIB = {16: 15.0, 8: 7.0}
# the planner each tier picks (`runtime_config`'s table, JAX's)
TIER_PLANNERS = {16: ("4B", "w8a8"), 8: ("0.6B", "w8a8")}


def _tier_child(gb: int) -> dict:
    """`phase_tier(gb)` in a child process (`--tier gb`); its JSON lines
    are printed here; returns its result (codes, K1 and K4 launches)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--tier", str(gb)],
        capture_output=True, text=True, timeout=900)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"tier_result"'):
            result = json.loads(line)["tier_result"]
        else:
            print(line, flush=True)
    if proc.returncode or result is None:
        raise AssertionError(f"tier {gb} GB: the child exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    emit(phase="quant", part=f"tier_{gb}g_child", wall_s=time.time() - t0)
    return result


def phase_tier(gb: int) -> None:
    """One low-memory tier under a real cap, in a process of its own:
    ACESTEP_MAX_HBM_GB and the allocator's cap (TIER_CAPS_GIB) set before
    anything is built; the w8a8 turbo DiT (seeded, full width) and
    `initialize_auto`'s planner, which must be the tier's (TIER_PLANNERS;
    at w8a8 an int8 KV cache and `head_q`, no float head); at 16 GB the
    graph-vs-eager greedy tokens and the w8a8 decode step; then a 60 s
    thinking request (at 16 GB after a warm-up; at 8 GB it captures the
    graphs too), whose reserved peak must stay under the cap. Prints the
    result as the line {"tier_result": ...}."""
    os.environ["ACESTEP_MAX_HBM_GB"] = str(gb)
    import torch

    from acestep_torch import runtime_config as rc
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.ops.quant import quantized_bytes
    from acestep_torch.pipeline.handler import AceStepHandler

    cap = int(TIER_CAPS_GIB[gb] * (1 << 30))
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total)
    phase = f"tier_{gb}g"
    t0 = time.time()
    h = AceStepHandler(DiTConfig.turbo(), VAEConfig(), dtype=torch.bfloat16)
    h.initialize_service(seed=0, quantization="w8a8")
    llm = LLMHandler(dtype=torch.bfloat16)
    picked = llm.initialize_auto()
    torch.cuda.synchronize()
    eng, model = llm.engine, llm.engine.model
    tier = rc.get_global_config().name
    if tier != phase or h.tier.name != phase or \
            (picked["size"], picked["quantization"]) != TIER_PLANNERS[gb] \
            or not eng.kv_quant or not hasattr(model, "head_q") \
            or hasattr(model, "lm_head"):
        raise AssertionError(
            f"{phase}: tier {tier}, the handler's {h.tier.name}, picked "
            f"{picked}, kv_quant {eng.kv_quant}, head_q "
            f"{hasattr(model, 'head_q')}, lm_head "
            f"{hasattr(model, 'lm_head')}")
    emit(phase=phase, part="init", cap_bytes=cap, picked=picked,
         init_s=time.time() - t0, dit_bytes=quantized_bytes(h.model),
         lm_bytes=quantized_bytes(model),
         memory_allocated=torch.cuda.memory_allocated(),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if gb == 16:
        _graph_vs_eager(llm, phase)
        emit(phase=phase, part="decode_step", **_step_times(eng))
    torch.cuda.reset_peak_memory_stats()
    # the 8 GB tier's one request also captures the planner's graphs
    warm = [("warm-up", "lofi hip hop, rainy window, soft keys", 12)]
    codes = _thinking_requests(h, llm, phase, (warm if gb == 16 else []) + [
        (f"thinking_60s_w8a8_{gb}g",
         "melodic house, airy pads, female vocals", 21)])
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    emit(phase=phase, part="verdict", cap_bytes=cap,
         max_memory_allocated=peak, max_memory_reserved=reserved,
         fits=reserved <= cap, seconds=time.time() - t0)
    if reserved > cap:
        raise AssertionError(f"{phase}: reserved {reserved} over the cap "
                             f"{cap}")
    print(json.dumps({"tier_result": {"codes": codes, "k1": fa.launches,
                                      "k4": sc.launches}}), flush=True)


# ------------------------------------------------------------------
# lrc: lyric timestamps of a full-width render; the PMI reward score
# ------------------------------------------------------------------

# Cross-attention probabilities of the capture pass, bf16 on the card (K1
# in the self-attention) against fp32 on the CPU, same weights and inputs:
# relative to the largest CPU probability, the references' limit.
TOL_CAPTURE = 5e-2
# Sums of log-probabilities of ~400-token sequences under a 2-layer LM,
# bf16 on the card against fp32 on the CPU, same weights: relative to the
# CPU's sum.
TOL_REWARD = 5e-2


def _capture_reference():
    import torch

    from acestep_torch.config import DiTConfig
    from acestep_torch.models.dit import (
        build_dit, dit_decoder_attn_capture, init_dit_params)
    from acestep_torch.ops import flash_attention as fa

    cfg = DiTConfig.tiny(fsq_dim=64, head_dim=128)
    card = init_dit_params(cfg, torch.Generator("cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    cpu = build_dit(cfg, "cpu", torch.float32)
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    B, T, Lk = 1, 250, 40
    xt = torch.randn((B, T, 64), generator=g)
    ctx = torch.randn((B, T, cfg.in_channels - 64), generator=g)
    enc = torch.randn((B, Lk, cfg.hidden_size), generator=g)
    tt = torch.full((B,), 0.125)
    capture = {0: [0, 1], 1: [2]}
    k1 = fa.launches
    got = dit_decoder_attn_capture(
        card, cfg, *(x.to("cuda", torch.bfloat16)
                     for x in (xt, tt, tt, ctx, enc)), capture)
    k1 = fa.launches - k1
    want = dit_decoder_attn_capture(cpu, cfg, xt, tt, tt, ctx, enc, capture)
    err = max(float((got[i].cpu() - w).abs().max() / w.abs().max())
              for i, w in want.items())
    if not err < TOL_CAPTURE or k1 != 2:
        raise AssertionError(f"capture card vs CPU: rel err {err:.3e} (tol "
                             f"{TOL_CAPTURE}), K1 {k1} launches (want 2)")
    return {"probs_rel_err": err, "tol": TOL_CAPTURE, "k1_launches": k1}


def _reward_reference(codes: str):
    """`calculate_reward_score` of `codes` under a 2-layer LM at the
    planner's head geometry, bf16 on the card against fp32 on the CPU."""
    import torch

    from acestep_torch.config import LMConfig
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.llm.tokenizer import SimpleTokenizer
    from acestep_torch.models.lm import build_lm, init_lm_params
    from acestep_torch.scoring import calculate_reward_score

    tok = SimpleTokenizer(num_audio_codes=64_000)
    cfg = dataclasses.replace(LMConfig.qwen3_4b(), hidden_size=512,
                              intermediate_size=1024, num_hidden_layers=2)
    card = init_lm_params(cfg, torch.Generator("cuda").manual_seed(6),
                          dtype=torch.bfloat16)
    cpu = build_lm(cfg, "cpu", torch.float32)
    cpu.load_state_dict(card.state_dict())
    out = {}
    for name, model, dtype, device in (("card", card, torch.bfloat16, None),
                                       ("cpu", cpu, torch.float32, "cpu")):
        llm = LLMHandler(dtype=dtype, device=device)
        llm.initialize(cfg=cfg, tokenizer=tok, params=model)
        t1 = time.time()
        out[name] = calculate_reward_score(
            llm, codes, caption="melodic house, airy pads, female vocals",
            lyrics="[verse]\nlights on the water")
        out[name]["seconds"] = time.time() - t1
    err = max(abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
              for k in ("cond_logprob", "uncond_logprob"))
    if not err < TOL_REWARD or not 0.0 < out["card"]["score"] < 1.0:
        raise AssertionError(f"reward score card vs CPU: rel err {err:.3e} "
                             f"(tol {TOL_REWARD}), {out}")
    return {"logprob_rel_err": err, "tol": TOL_REWARD, **out}


def phase_lrc(turbo, codes: str):
    """LRC on the card: a turbo 60 s request with lyrics and want_lrc=True
    through the facade on phase 5's handler (the decoder's 24 layers,
    DEFAULT_CAPTURE: the capture pass runs layers 0-6, each through K1);
    the LRC's lines, its alignment score inside (0, 1), `auto_lrc_time`;
    then the tiny capture pass card against CPU, and the PMI reward score
    of the `quant` phase's 300 codes, card against CPU."""
    import torch

    from acestep_torch import inference
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.scoring.alignment import DEFAULT_CAPTURE

    t0 = time.time()
    lyrics = ("[verse]\nneon rivers in the rain\nwe were running through "
              "the night\n[chorus]\nhold on, hold on\nnever let the "
              "light go out")
    sung = [ln for ln in lyrics.splitlines() if not ln.startswith("[")]
    capture_k1 = []
    generate_lrc = turbo.generate_lrc

    def counted(*a, **kw):
        before = fa.launches
        out = generate_lrc(*a, **kw)
        torch.cuda.synchronize()
        capture_k1.append(fa.launches - before)
        return out

    fa.launches, sc.launches = 0, 0
    with tempfile.TemporaryDirectory() as out_dir, \
            mock.patch.object(turbo, "generate_lrc", counted):
        res, k1, k4, wall, peak = _counted(lambda: inference.generate_music(
            turbo, None, inference.GenerationParams(
                caption="dreamy synthwave, female vocals", lyrics=lyrics,
                duration=60.0, seed=8, thinking=False),
            inference.GenerationConfig(batch_size=1, use_random_seed=False,
                                       output_dir=out_dir, want_lrc=True)))
    launches = {"K1": fa.launches, "K4": sc.launches, "K2": 0, "K3": 0}
    if not res.success:
        raise AssertionError(f"lrc: {res.error}\n{res.status_message}")
    entry = res.audios[0]
    costs = res.extra_outputs["time_costs"]
    score = entry.get("alignment_score", {}).get("score", -1.0)
    lines = entry.get("lrc", "").splitlines()
    want_k1 = max(DEFAULT_CAPTURE) + 1
    if "lrc_error" in entry or not lines or not 0.0 < score < 1.0 \
            or capture_k1 != [want_k1] or not costs.get("auto_lrc_time"):
        raise AssertionError(
            f"lrc: error {entry.get('lrc_error')}, {len(lines)} lines, "
            f"score {score}, capture K1 {capture_k1} (want [{want_k1}]), "
            f"auto_lrc_time {costs.get('auto_lrc_time')}")
    emit(phase="lrc", part="request", wall_s=wall, lrc_lines=len(lines),
         lyric_sentences=len(sung), lrc=entry["lrc"],
         alignment_score=entry["alignment_score"],
         auto_lrc_time=costs["auto_lrc_time"],
         capture_k1_launches=capture_k1[0], k1_launches=k1, k4_launches=k4,
         max_memory_allocated=peak, time_costs=costs)
    emit(phase="lrc", part="capture_reference", **_capture_reference())
    emit(phase="lrc", part="reward_reference", **_reward_reference(codes))
    emit(phase="lrc", seconds=time.time() - t0, launches=launches)
    return launches


# ------------------------------------------------------------------
# tools: the port's tools around the package, each run as its user runs
# it, a process of its own from the repo root
# ------------------------------------------------------------------

TOOLS_SECONDS = 30.0       # the profiler's and the memory profiler's song
# K1's launches a render of the turbo DiT: 24 layers a decoder step
K1_PER_STEP = 24


def _run_tool(argv, timeout: float = 300.0, env=None) -> str:
    """`python3 <argv>` from the repo root; returns its stdout. A non-zero
    exit raises with the end of both streams."""
    proc = subprocess.run(
        [sys.executable, *argv], cwd=os.path.dirname(os.path.abspath(
            __file__)), capture_output=True, text=True, timeout=timeout,
        env=env)
    if proc.returncode:
        raise AssertionError(f"tools: {' '.join(argv)} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def _tool_report(argv, card: str, want_k1: int, want_k4: int) -> dict:
    """A tool's JSON report; its device must be this card (name and power
    limit) and its K1 / K4 launches at least the floors."""
    rep = json.loads(_run_tool(argv))
    dev = rep["device"]
    k1, k4 = dev["launches"]["K1"], dev["launches"]["K4"]
    if dev.get("card") != card or k1 < want_k1 or k4 < want_k4:
        raise AssertionError(f"tools: {' '.join(argv)}: device {dev}; want "
                             f"card {card!r}, K1 >= {want_k1}, K4 >= "
                             f"{want_k4}")
    return rep


def _vram_estimate(seconds: float) -> dict:
    """`scripts/profile_vram.py`'s analytic estimate of a `seconds` turbo
    request at batch 1, for the card's handler: its modules built on the
    meta device, so nothing is allocated."""
    import torch

    from acestep_torch.models.dit import build_dit
    from acestep_torch.models.vae import OobleckVAE
    from acestep_torch.pipeline.handler import AceStepHandler

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import profile_vram

    h = AceStepHandler(dtype=torch.bfloat16)
    h.model = build_dit(h.cfg, "meta", torch.bfloat16)
    h.vae = OobleckVAE(h.vae_cfg, device="meta", dtype=torch.bfloat16)
    return profile_vram.analytic_estimate(h, seconds, 1)


def phase_tools(card: str) -> dict:
    """The tools beside the package, each a subprocess as a user runs it:
    the environment doctor's `--smoke` (K1 full and banded, K4, against
    their plain versions, under chip_smoke's limits, every check [ok]);
    the profiler's `profile` of a 30 s turbo request at full width (cold
    and warm), its `understand` (the tiny planner) and its 8 GB
    `tier-test` (a child process capped at 7 GiB before any handler);
    and the memory profiler's 30 s request. Each report names this card;
    the renders' K1 and K4 launches (as the tools report them) are the
    phase's launches. The doctor's launches compare kernels with their
    plain versions and do not count."""
    t0 = time.time()
    # the doctor probes the hubs when no checkpoint is found: offline here
    env = dict(os.environ, HF_HUB_OFFLINE="1")
    t = time.time()
    text = _run_tool(["scripts/check_gpu.py", "--smoke"], env=env)
    smoke = [line for line in text.splitlines()
             if line.startswith(("[ok]   K1", "[ok]   K4"))]
    if "[RESULT] environment looks good" not in text or len(smoke) != 3:
        raise AssertionError(f"tools: check_gpu.py --smoke:\n{text[-3000:]}")
    emit(phase="tools", tool="check_gpu --smoke", wall_s=time.time() - t,
         smoke=smoke, card=card)

    steps = 8
    t = time.time()
    profile = _tool_report(
        ["profile_inference_torch.py", "--mode", "profile", "--duration",
         str(TOOLS_SECONDS), "--steps", str(steps)], card,
        2 * steps * K1_PER_STEP, 2)
    for run in ("cold", "warm"):
        r = profile[run]
        if (r["duration_s"], r["batch"], r["steps"]) != (
                TOOLS_SECONDS, 1, steps) or "batch_clamped_to" in r \
                or not r["wall_s"] > 0:
            raise AssertionError(f"tools: profile {run}: {r}")
    emit(phase="tools", tool="profile_inference_torch --mode profile",
         wall_s=time.time() - t, report=profile)

    t = time.time()
    understand = _tool_report(
        ["profile_inference_torch.py", "--mode", "understand"], card, 0, 0)
    if not isinstance(understand["output"], dict):
        raise AssertionError(f"tools: understand: {understand}")
    understand["output"] = sorted(understand["output"])
    emit(phase="tools", tool="profile_inference_torch --mode understand",
         wall_s=time.time() - t, report=understand)

    t = time.time()
    # the tier's 10 s request asks for 4 steps; turbo renders its 8-step
    # schedule whatever the steps (both packages)
    tier = _tool_report(
        ["profile_inference_torch.py", "--mode", "tier-test", "--tiers", "8"],
        card, steps * K1_PER_STEP, 1)
    row = tier["tiers"][0]
    if not row["ok"] or row["tier"] != "tier_8g" or row["cap_gb"] != 7.0 \
            or row["max_memory_reserved_gb"] > row["cap_gb"]:
        raise AssertionError(f"tools: tier-test 8: {row}")
    emit(phase="tools", tool="profile_inference_torch --mode tier-test "
         "--tiers 8", wall_s=time.time() - t, report=tier)

    t = time.time()
    vram = _tool_report(
        ["scripts/profile_vram.py", "--durations", str(TOOLS_SECONDS),
         "--batches", "1"], card, steps * K1_PER_STEP, 1)
    row = vram["stages"][0]
    if not (0 < row["peak_gb"] <= row["limit_gb"]
            and row["in_use_gb"] <= row["limit_gb"]):
        raise AssertionError(f"tools: profile_vram: {row}")
    emit(phase="tools", tool="profile_vram", wall_s=time.time() - t,
         report=vram, analytic_estimate=_vram_estimate(TOOLS_SECONDS))

    launches = {k: sum(r["device"]["launches"][k]
                       for r in (profile, understand, tier, vram))
                for k in ("K1", "K4")}
    launches.update(K2=0, K3=0)
    emit(phase="tools", seconds=time.time() - t0, launches=launches)
    return launches


def phase_bench(card: str) -> dict:
    """`bench_torch.py --headline-only` as a user runs it, a process of its
    own: its JSON line, printed twice, names the metric and this card;
    the headline's wall and its DiT share of the card's peak are in range;
    one 60 s song launched K1 in each of the 24 layers of the 8 steps and
    K4 once for each C <= 256 decoder level of its one tiled decode (7
    windows of 1500 frames, one group). Those launches are the phase's."""
    import torch

    from acestep_torch.config import VAEConfig
    from acestep_torch.models.vae import OobleckVAE

    t0 = time.time()
    out = _run_tool(["bench_torch.py", "--headline-only"])
    lines = [json.loads(x) for x in out.strip().splitlines()]
    vae = OobleckVAE(VAEConfig(), device="meta")
    want = {"K1": 8 * K1_PER_STEP,
            "K4": sum(blk.res1.conv1.weight.shape[0] <= 256
                      for blk in vae.decoder.blocks)}
    payload = lines[-1]
    extra = payload["extra"]
    if not (len(lines) == 2 and payload["metric"] == "seconds_per_song"
            and payload["value"] > 0 and extra["mfu_pct"] is not None
            and 0 < extra["mfu_pct"] <= 100 and extra["card"] == card
            and extra["device"] == torch.cuda.get_device_name(0)
            and extra["launches"] == want):
        raise AssertionError(f"bench: {out[-3000:]}; want the card {card!r}, "
                             f"launches {want}")
    emit(phase="bench", seconds=time.time() - t0, payload=payload)
    return {**extra["launches"], "K2": 0, "K3": 0}


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
    the port's training CLI at full width, in a temporary directory under
    ./build (inside the server's safe root for user paths); then the
    trained adapter at inference (`phase_adapter`), LoRA training over
    REST on the same tensors (`phase_rest_training`), full-parameter
    training (`phase_full_training`) and the gradient-sensitivity estimate
    (`phase_estimate`) on them."""
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=os.path.abspath("build")) as work:
        training = _training_in(work, k4_per_song)
        adapter = phase_adapter(os.path.join(work, "lora", "adapter.npz"))
        rest = phase_rest_training(os.path.join(work, "tensors"), work)
        full = phase_full_training(os.path.join(work, "tensors"), work)
        full_mesh = phase_full_training_mesh(os.path.join(work, "tensors"),
                                             work)
        estimate = phase_estimate(os.path.join(work, "tensors"))
    return training, adapter, rest, full, full_mesh, estimate


def _digest(t) -> int:
    """An order-sensitive integer digest of a tensor's bits (their
    weighted sum, on the card)."""
    import torch

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = t.detach().reshape(-1).to("cuda")
    x = flat.view(ints[flat.element_size()]).to(torch.int64)
    w = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
    return int((x * w).sum())


def _state_digests(model_state, opt):
    """`_digest` of each tensor of a model's and an optimizer's state
    dicts, and the optimizer's param groups: equal state gives equal
    digests, a stale or shuffled tensor almost surely another."""
    return {"model": {k: _digest(v) for k, v in model_state.items()},
            "optimizer": {(i, k): _digest(v)
                          for i, st in opt["state"].items()
                          for k, v in st.items()},
            "param_groups": opt["param_groups"]}


def phase_full_training(tensors: str, work: str):
    """The training CLI's `full` at full width (DiTConfig.turbo(), every
    parameter in bf16, AdamW with the default warmup) on phase 6's two
    120 s tensor files: 2 steps with a checkpoint every 2, then the latest
    checkpoint restored in this process into an uninitialised model and
    its optimizer, whose state must be bit-equal (by `_state_digests`) to
    the trainer's live state when it saved; a resume from `latest` to step
    4 (2 checkpoints, ~14 GB each, on disk), and the output directory
    deleted. The CLI runs as JAX's does; this
    phase times it from outside, through the trainer's step function and
    `save`: seconds per step (the device's, synchronised on both sides),
    K1/K2/K3 launches per step, peak memory (the digests' own excluded),
    checkpoint save seconds, restore seconds and bytes."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from acestep_torch.config import DiTConfig
    from acestep_torch.models.dit import build_dit
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.training import cli, trainer_full
    from acestep_torch.training.trainer_full import (FullTrainer,
                                                     FullTrainingConfig)

    t_phase = time.time()
    out = os.path.join(work, "full")
    ckpts = os.path.join(out, "checkpoints")
    common = ["--tensor-dir", tensors, "--output-dir", out,
              "--checkpoint-every", "2", "--seed", "0"]
    step_s, losses, peaks, saves = [], [], [], {}
    real_make, real_save = trainer_full.make_train_step, FullTrainer.save

    def timed_make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            loss = step(*a, **kw)
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            losses.append(float(loss))
            return loss
        return timed

    def timed_save(self):
        fresh = not os.path.isdir(os.path.join(self.ckpt_root,
                                               str(self.step)))
        torch.cuda.synchronize()
        t0 = time.time()
        real_save(self)
        if fresh:
            seconds = time.time() - t0
            peaks.append(torch.cuda.max_memory_allocated())
            saves[self.step] = (seconds, _state_digests(
                self.model.state_dict(), self.optimizer.state_dict()))
            torch.cuda.reset_peak_memory_stats()

    def run(*extra):
        buf = io.StringIO()
        t0 = time.time()
        with mock.patch.object(trainer_full, "make_train_step", timed_make), \
                mock.patch.object(FullTrainer, "save", timed_save), \
                contextlib.redirect_stdout(buf):
            cli.main(["full", *common, *extra])
        wall = time.time() - t0
        peaks.append(torch.cuda.max_memory_allocated())
        gc.collect()
        torch.cuda.empty_cache()
        return wall, buf.getvalue().splitlines()

    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first_wall, printed = run("--max-steps", "2")
    per_run = {"K1": fa.launches, "K2": fa.launches_bwd_dq,
               "K3": fa.launches_bwd_dkv}
    if len(losses) != 2 or sorted(saves) != [2] or \
            sorted(os.listdir(ckpts)) != ["2"] or \
            not all(np.isfinite(losses)) or \
            [line.split(" (")[0] for line in printed if
             line.startswith("step")] != [f"step 2/2 loss {losses[-1]:.4f}"]:
        raise AssertionError(f"full: losses {losses}, saves {sorted(saves)},"
                             f" checkpoints {sorted(os.listdir(ckpts))}, "
                             f"printed {printed}")
    path = os.path.join(ckpts, "2")
    ckpt_bytes = {name: os.path.getsize(os.path.join(path, name))
                  for name in sorted(os.listdir(path))}

    # the latest checkpoint into an uninitialised model: bit-equal to the
    # trainer's state when it saved step 2
    cfg = DiTConfig.turbo()
    shell = build_dit(cfg, "cuda", torch.bfloat16)
    trainer = FullTrainer(shell, cfg, FullTrainingConfig(
        output_dir=out, checkpoint_every=2))
    torch.cuda.synchronize()
    t0 = time.time()
    restored = trainer.restore()
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    got = _state_digests(shell.state_dict(),
                         trainer.optimizer.state_dict())
    want = saves[2][1]
    same_model = got["model"] == want["model"]
    same_opt = got["optimizer"] == want["optimizer"] and \
        got["param_groups"] == want["param_groups"] and \
        len({i for i, _ in got["optimizer"]}) == len(list(shell.parameters()))
    finite = all(torch.isfinite(p).all() for p in shell.parameters())
    step_after = trainer.step
    del trainer, shell
    gc.collect()
    torch.cuda.empty_cache()
    if not (restored and step_after == 2 and same_model and same_opt
            and finite):
        raise AssertionError(f"full restore: restored {restored}, step "
                             f"{step_after}, model bit-equal {same_model}, "
                             f"optimizer bit-equal {same_opt}, finite "
                             f"{finite}")

    torch.cuda.reset_peak_memory_stats()
    resume_wall, printed = run("--max-steps", "4", "--resume-from", "latest")
    if len(losses) != 4 or sorted(saves) != [2, 4] or \
            sorted(os.listdir(ckpts)) != ["2", "4"] or \
            not all(np.isfinite(losses)) or \
            not any(line.startswith("step 4/4") for line in printed):
        raise AssertionError(f"full resume: losses {losses}, checkpoints "
                             f"{sorted(os.listdir(ckpts))}, printed "
                             f"{printed}")
    shutil.rmtree(out)

    layers = cfg.num_hidden_layers
    launches = {"K1": fa.launches, "K2": fa.launches_bwd_dq,
                "K3": fa.launches_bwd_dkv, "K4": sc.launches}
    need = {"K1": 2 * layers * 4, "K2": layers * 4, "K3": layers * 4}
    short = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"full training launches (got, need): {short}")
    warm = step_s[1:2] + step_s[3:]     # the first step of each run aside
    emit(phase="full_training", card=_card(), steps=4, losses=losses,
         s_per_step=step_s, s_per_step_median=statistics.median(warm),
         launches_per_step={k: v / 2 for k, v in per_run.items()},
         max_memory_allocated=max(peaks), checkpoint_bytes=ckpt_bytes,
         checkpoint_total_bytes=sum(ckpt_bytes.values()),
         checkpoint_save_s=[saves[k][0] for k in sorted(saves)],
         checkpoint_restore_s=restore_s,
         first_run_wall_s=first_wall, resume_run_wall_s=resume_wall,
         restored_bit_equal=True, launches=launches, need=need,
         seconds=time.time() - t_phase)
    return launches


# The full trainer's tp=2 and dp=2 updates (two gloo ranks sharing the
# card) against the unsharded trainer's from the same weights and draws,
# both bf16 on the card: the loss relative to itself, and the gradient the
# optimizer took (summed over the mesh, clipped) as ||mesh - unsharded|| /
# ||unsharded|| per family of parameters and over all of them. tp rounds
# each row-parallel product's halves to bf16 before their sum, a rounding
# the unsharded product does not make, in every layer's forward: the
# gradients read 1.0-1.9e-2 on the card; dp rounds each rank's gradient
# before their sum, 0.4-0.9e-2. The limit is the card-vs-CPU gradient
# limit, TOL_TRAIN_GRAD. The control it must catch: a dp loss that is the
# mean of the ranks' means (rows of 120 s and 60 s of valid frames; on the
# card it read 0.10-0.13, and tp without the per-head q_norm / k_norm sum
# read 0.69 in that family, a control the CPU tests keep).
TOL_FULL_MESH = 5e-2
# valid frames of the mesh batch's second row: a 60 s song padded to the
# 120 s bucket, so a mean of the dp ranks' means differs from the mean
MESH_ROW1_FRAMES = 1500


def _family(name: str) -> str:
    owner = name.split(".")[-2] if "." in name else name
    if owner in ("q_proj", "k_proj", "v_proj", "o_proj"):
        return "attention"
    if owner in ("q_norm", "k_norm"):
        return "qk_norm"
    if owner in ("gate", "up", "down"):
        return "mlp"
    return "other"


def _grad_rel_l2(got, want) -> dict:
    """||got - want|| / ||want|| per `_family` and over every gradient
    ({name: tensor} each, on any device), in fp32 on the card."""
    import torch

    num, den = {}, {}
    for name, w in want.items():
        w = w.to("cuda", torch.float32)
        d = got[name].to("cuda", torch.float32) - w
        for fam in (_family(name), "all"):
            num[fam] = num.get(fam, 0.0) + float(d.square().sum())
            den[fam] = den.get(fam, 0.0) + float(w.square().sum())
    return {f: math.sqrt(num[f] / den[f]) if den[f] else math.sqrt(num[f])
            for f in num}


def phase_full_training_mesh(tensors: str, work: str):
    """The full trainer over a dp x tp mesh at full width (DiTConfig.turbo,
    bf16, the default warmup, so the first update has lr 0) on phase 6's
    two 120 s tensor files, one batch of both songs, the second cut to
    MESH_ROW1_FRAMES valid frames; two updates each:

    1. the unsharded trainer from a seeded DiT: losses, the gradients the
       optimizer took (kept on the host) and their digests, peak memory;
    2. a 1-rank NCCL mesh (`make_mesh(1, 1)` with its defaults) from the
       same weights: losses and gradients bit-equal to step 1's;
    3. a world of two gloo ranks sharing cuda:0 (NCCL refuses two ranks
       on one card), started before the trainers' `make_mesh`: tp=2 (its
       gradients gathered from both ranks to the unsharded layout), then
       dp=2, each against step 1 (TOL_FULL_MESH for the loss and for each
       family's gradient), with each rank's peak memory, seconds per
       update and K1/K2/K3 launches per rank; the fault control (a dp
       loss that is the mean of the ranks' means, one update) must
       exceed the limit;
    4. dp=2 saves a checkpoint at step 2 in the unsharded layout,
       restored into an unsharded trainer bit-equal by `_state_digests`
       to the state the trainer saved.

    Step times are of ranks sharing one H100 through host memory, not of
    several cards. Returns the launches, every rank's summed."""
    import shutil

    import torch

    from acestep_torch.config import DiTConfig
    from acestep_torch.models.dit import build_dit, init_dit_params
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.parallel import make_mesh
    from acestep_torch.training.data import make_batches
    from acestep_torch.training.trainer_full import (FullTrainer,
                                                     FullTrainingConfig)

    t_phase = time.time()
    cfg = DiTConfig.turbo()
    files = sorted(os.path.join(tensors, f) for f in os.listdir(tensors))
    batches = []
    for b in make_batches(files, 2, latent_dim=cfg.audio_acoustic_hidden_dim,
                          shuffle=False, seed=0):
        b["attention_mask"][1, MESH_ROW1_FRAMES:] = 0
        batches.append(b)
        if len(batches) == 2:
            break
    out = os.path.join(work, "full_mesh")
    init = {n: p.cpu() for n, p in init_dit_params(
        cfg, torch.Generator("cuda").manual_seed(0),
        dtype=torch.bfloat16).state_dict().items()}
    launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    kernels = ("K1", "K2", "K3")

    def model():
        m = build_dit(cfg, "cuda", torch.bfloat16)
        m.load_state_dict(init)
        return m

    def tcfg(**kw):
        return FullTrainingConfig(**{**dict(
            checkpoint_every=0, max_steps=2, log_every=1, seed=0,
            output_dir=out), **kw})

    def run(trainer, n=2, want=None, host=True):
        """n updates: losses, each update's gradients as digests (and with
        `host` as host copies) or, with `want`, as `_grad_rel_l2` against
        `want`'s; seconds per update."""
        losses, digests, grads, secs = [], [], [], []
        torch.cuda.synchronize()
        t0 = time.time()
        for _step, loss, msg in trainer.train(iter(batches[:n])):
            if not msg.startswith("step"):
                continue                        # a checkpoint's event
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            losses.append(loss)
            g = trainer.gradients()
            if want is None:
                digests.append({k: _digest(v) for k, v in g.items()})
                if host:
                    grads.append({k: v.detach().to("cpu", copy=True)
                                  for k, v in g.items()})
            else:
                grads.append(_grad_rel_l2(g, want[len(losses) - 1]))
            del g
            t0 = time.time()
        return losses, digests, grads, secs

    def counted(world_launches, fn):
        """fn() with K1-K3 counted: rank 0's process counters and the
        other ranks' command replies."""
        fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
        before = world_launches() if world_launches else None
        result = fn()
        own = [fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv]
        ranks = {k: [own[i]] for i, k in enumerate(kernels)}
        if before is not None:
            after = world_launches()
            for k in kernels:
                ranks[k] += [a - b for a, b in
                             zip(after[k][1:], before[k][1:])]
        for k in kernels:
            launches[k] += sum(ranks[k])
        return result, ranks

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # -- 1: the unsharded trainer
    torch.cuda.reset_peak_memory_stats()
    ref = FullTrainer(model(), cfg, tcfg())
    (want_loss, want_digests, want, ref_s), ref_ranks = counted(
        None, lambda: run(ref))
    ref_peak = torch.cuda.max_memory_allocated()
    del ref
    free()
    emit(phase="full_training_mesh", part="unsharded", rows=2,
         valid_frames=[3000, MESH_ROW1_FRAMES], losses=want_loss,
         s_per_update=ref_s, max_memory_allocated=ref_peak,
         launches_per_rank=ref_ranks, seconds=time.time() - t_phase)

    # -- 2: one NCCL rank, the defaults
    t0 = time.time()
    mesh = make_mesh(1, 1)
    start = time.time() - t0
    try:
        trainer = FullTrainer(model(), cfg, tcfg(), mesh=mesh)
        (losses, digests, _, secs), ranks = counted(
            mesh.launches, lambda: run(trainer, host=False))
        backend = mesh.backend
        trainer.close()
        del trainer
    finally:
        mesh.close()
    free()
    equal = losses == want_loss and digests == want_digests
    emit(phase="full_training_mesh", part="nccl_1x1", backend=backend,
         startup_s=start, losses=losses, bit_equal=equal, s_per_update=secs,
         launches_per_rank=ranks, seconds=time.time() - t_phase)
    if backend != "nccl" or not equal:
        raise AssertionError(f"full mesh 1x1 ({backend}): losses {losses} "
                             f"against {want_loss}, gradients bit-equal "
                             f"{digests == want_digests}")

    # -- 3, 4: two gloo ranks on cuda:0
    t0 = time.time()
    anchor = make_mesh(2, 1, devices=["cuda:0", "cuda:0"], backend="gloo")
    spawn = time.time() - t0
    saved = {}
    real_state_dicts = FullTrainer.state_dicts

    def digested_save(self):
        """state_dicts() as save() takes them, digested on the way."""
        t1 = time.time()
        states = real_state_dicts(self)
        saved.update(digests=_state_digests(*states),
                     step=self.step, gather_s=time.time() - t1)
        return states

    def mean_of_means(batch, dp):
        m = batch["attention_mask"]
        n = m.shape[0] // dp
        return [dp * float(m[d * n:(d + 1) * n].sum())
                * batch["hidden_states"].shape[-1] for d in range(dp)]

    try:
        for axis, (dp, tp) in (("tp", (1, 2)), ("dp", (2, 1))):
            ckpt = axis == "dp"
            anchor.gather(torch.cuda.reset_peak_memory_stats)
            t0 = time.time()
            trainer = FullTrainer(model(), cfg, tcfg(
                mesh_dp=dp, mesh_tp=tp, checkpoint_every=2 if ckpt else 0))
            install_s = time.time() - t0
            with mock.patch.object(FullTrainer, "state_dicts",
                                   digested_save):
                (losses, _, errs, secs), ranks = counted(
                    anchor.launches, lambda: run(trainer, want=want))
            peaks = anchor.gather(torch.cuda.max_memory_allocated)
            trainer.close()
            del trainer
            free()
            loss_err = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                            want_loss)]
            rec = dict(phase="full_training_mesh", part=f"gloo_{axis}2",
                       dp=dp, tp=tp, spawn_s=spawn, install_s=install_s,
                       losses=losses, loss_rel_err=loss_err,
                       grad_rel_l2=errs, tol=TOL_FULL_MESH,
                       s_per_update=secs, max_memory_allocated_per_rank=peaks,
                       plain_max_memory_allocated=ref_peak,
                       launches_per_rank=ranks,
                       note="gloo, ranks sharing one H100")
            worst = max(max(e.values()) for e in errs)
            if ckpt:
                # the fault control: one update with the loss as the mean
                # of the dp ranks' means
                with mock.patch.object(FullTrainer, "_counts",
                                       staticmethod(mean_of_means)):
                    trainer = FullTrainer(model(), cfg, tcfg(mesh_dp=dp,
                                                             mesh_tp=tp))
                    (_, _, bad, _), _ = counted(
                        anchor.launches, lambda: run(trainer, n=1,
                                                     want=want))
                trainer.close()
                del trainer
                free()
                rec.update(control="the dp loss as the mean of the ranks' "
                                   "means", control_rel_l2=bad[0])
            if not (worst < TOL_FULL_MESH and max(loss_err) < TOL_FULL_MESH
                    and max(rec.get("control_rel_l2", {"": 1.0}).values())
                    > TOL_FULL_MESH):
                emit(**rec)
                raise AssertionError(
                    f"full mesh {axis}=2: gradient rel L2 {errs}, loss rel "
                    f"err {loss_err} (tol {TOL_FULL_MESH}); control "
                    f"{rec.get('control_rel_l2')} must exceed it")
            need = cfg.num_hidden_layers
            short = {k: v for k, v in ranks.items()
                     if min(v) < (4 if k == "K1" else 2) * need}
            if short:
                raise AssertionError(f"full mesh {axis}=2 launches per rank "
                                     f"{short}")
            if ckpt:
                # the mesh's checkpoint into an unsharded trainer
                shell = build_dit(cfg, "cuda", torch.bfloat16)
                plain = FullTrainer(shell, cfg, tcfg(checkpoint_every=2))
                t0 = time.time()
                restored = plain.restore()
                torch.cuda.synchronize()
                restore_s = time.time() - t0
                same = restored and plain.step == saved["step"] == 2 and \
                    _state_digests(shell.state_dict(),
                                   plain.optimizer.state_dict()) == \
                    saved["digests"]
                del plain, shell
                free()
                rec.update(checkpoint_state_s=saved["gather_s"],
                           checkpoint_restore_s=restore_s,
                           checkpoint_restored_bit_equal=same,
                           checkpoint_bytes=sum(
                               os.path.getsize(os.path.join(
                                   out, "checkpoints", "2", f))
                               for f in ("model.pt", "opt_state.pt")))
                shutil.rmtree(out)
                if not same:
                    raise AssertionError("full mesh dp=2: the checkpoint "
                                         "did not restore bit-equal into an "
                                         "unsharded trainer")
            rec["seconds"] = time.time() - t_phase
            emit(**rec)
    finally:
        anchor.close()
        shutil.rmtree(out, ignore_errors=True)
    del want, init
    free()
    emit(phase="full_training_mesh", seconds=time.time() - t_phase,
         launches=launches)
    return launches


TOL_ESTIMATE = 5e-2


def phase_estimate(tensors: str):
    """The training CLI's `estimate --num-batches 2` at full width on phase
    6's tensors: its wall (and the estimate's own seconds, handler set-up
    aside), the ranked targets, K1/K2/K3 launches. Then a 2-layer model's
    estimate, bf16 on the card against fp32 on the CPU (same weights,
    batch and draws): each target's value within TOL_ESTIMATE relative,
    and the same ranking up to ties inside that limit."""
    import contextlib
    import io

    import numpy as np
    import torch

    from acestep_torch.config import DiTConfig
    from acestep_torch.models.dit import build_dit, init_dit_params
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc
    from acestep_torch.training import cli, presets
    from acestep_torch.training.step import tiny_batch

    t_phase = time.time()
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0
    inner = []
    real = presets.estimate_gradient_sensitivity

    def timed(*args, **kwargs):
        t0 = time.time()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        inner.append((time.time() - t0, out))
        return out

    buf = io.StringIO()
    t0 = time.time()
    with mock.patch.object(presets, "estimate_gradient_sensitivity", timed), \
            contextlib.redirect_stdout(buf):
        cli.main(["estimate", "--tensor-dir", tensors, "--num-batches", "2",
                  "--seed", "0"])
    wall = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    lines = buf.getvalue().strip().splitlines()
    estimate_s, ranked = inner[0]
    launches = {"K1": fa.launches, "K2": fa.launches_bwd_dq,
                "K3": fa.launches_bwd_dkv, "K4": sc.launches}
    layers = DiTConfig.turbo().num_hidden_layers
    need = {"K1": 2 * 2 * layers, "K2": 2 * layers, "K3": 2 * layers}
    values = [v for _, v in ranked]
    if len(ranked) != 11 or not all(np.isfinite(values)) or \
            not all(v > 0 for v in values) or \
            [line.split()[0] for line in lines[1:12]] != \
            [n for n, _ in ranked] or \
            not lines[-1].startswith("suggested LoRA targets") or \
            any(launches[k] < n for k, n in need.items()):
        raise AssertionError(f"estimate: output {lines}, launches "
                             f"{launches} (need {need})")

    # the small model, card against CPU
    cfg = DiTConfig.tiny(head_dim=128, fsq_dim=64)
    gpu = init_dit_params(cfg, torch.Generator("cuda").manual_seed(0),
                          dtype=torch.bfloat16)
    cpu = build_dit(cfg, "cpu", torch.float32)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    batches = [tiny_batch(cfg, g, batch=2, frames=200) for _ in range(2)]
    draws = [dict(keep=torch.tensor([True, False]),
                  noise=torch.randn(b["hidden_states"].shape, generator=g),
                  t=torch.tensor([0.7, 0.3])) for b in batches]
    got = real(gpu, cfg, batches, num_batches=2, draws=draws)
    want = real(cpu, cfg, batches, num_batches=2, draws=draws)
    got_d = dict(got)
    errs = {n: abs(got_d[n] - v) / v for n, v in want}
    same_runs = all({n for n, _ in got[r]} == {n for n, _ in want[r]}
                    for r in presets.tie_runs(want, TOL_ESTIMATE))
    if not (max(errs.values()) < TOL_ESTIMATE and same_runs):
        raise AssertionError(f"estimate card vs CPU: card {got}, CPU "
                             f"{want}, errors {errs} (tol {TOL_ESTIMATE})")
    emit(phase="estimate", card=_card(), wall_s=wall,
         estimate_s=estimate_s, ranked=ranked, suggested=lines[-1],
         reference={"card": got, "cpu": want, "rel_err": errs,
                    "ranking_equal_up_to_ties": same_runs},
         launches=launches, need=need, seconds=time.time() - t_phase)
    return launches


def phase_adapter(path: str):
    """The trained adapter in a turbo handler with the training run's base
    seed (0): it must render another song than the base, the base's bits
    when toggled off, and another result key while it is active."""
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
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    sc.launches = 0
    params = inference.GenerationParams(
        caption="test song 0", lyrics="[verse]\nla la la\n[chorus]\noh oh",
        duration=30.0, seed=88, thinking=False)
    with tempfile.TemporaryDirectory() as out_dir:
        config = inference.GenerationConfig(batch_size=1,
                                            use_random_seed=False,
                                            output_dir=out_dir)

        def render():
            res = inference.generate_music(handler, None, params, config)
            if not res.success:
                raise AssertionError(f"adapter render: {res.error}\n"
                                     f"{res.status_message}")
            entry = res.audios[0]
            _check_audio("adapter render", [entry["audio"]], 750 * 1920)
            return (res.extra_outputs["pred_latents"], entry["audio"],
                    entry["key"], res.extra_outputs["time_costs"])

        base = render()
        info = handler.lora.load(path, adapter_name="chip_smoke_lora")
        on, k1, k4, wall, peak = _counted(render)
        signature = handler.lora.signature()
        handler.lora.toggle(False)
        off = render()
    moved = float(np.abs(on[0] - base[0]).max())
    same_bits = (np.array_equal(off[0], base[0])
                 and np.array_equal(off[1], base[1]))
    if not (moved > 1e-3 and same_bits and on[2] != base[2] == off[2]
            and k1 >= 8 * handler.cfg.num_hidden_layers):
        raise AssertionError(
            f"adapter: latents moved {moved:.3e} (want > 1e-3), toggled off "
            f"bit-identical {same_bits}, keys base/on/off {base[2]} / "
            f"{on[2]} / {off[2]}, K1 {k1}")
    launches = {"K1": fa.launches, "K4": sc.launches,
                "K2": fa.launches_bwd_dq, "K3": fa.launches_bwd_dkv}
    emit(phase="adapter", adapter=info, signature=signature,
         latent_max_change=moved, toggled_off_bit_identical=same_bits,
         keys={"base": base[2], "on": on[2], "off": off[2]}, wall_s=wall,
         k1_launches=k1, k4_launches=k4, max_memory_allocated=peak,
         time_costs=on[3], launches=launches, seconds=time.time() - t0)
    del handler
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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
    phase_full_train_reference()
    text2music, handler = phase_end_to_end()
    k4_per_song = k4_launches_per_song(handler)
    tasks = phase_tasks(handler, k4_per_song)
    checkpoint = phase_checkpoint(handler)
    planner, llm = phase_planner(handler)
    serving = phase_serving(handler, llm)
    studio = phase_studio(handler)
    dataset = phase_dataset(handler, llm)
    mesh = phase_mesh(handler, llm)
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    quant, codes = phase_quant(handler)
    lrc = phase_lrc(handler, codes)
    del handler
    gc.collect()
    torch.cuda.empty_cache()
    tools = phase_tools(_card())
    bench = phase_bench(_card())
    training, adapter, rest_training, full, full_mesh, estimate = \
        phase_training(k4_per_song)
    launches = {k: text2music[k] + tasks[k] + checkpoint[k] + planner[k]
                + serving[k] + studio[k] + dataset[k] + mesh[k] + quant[k]
                + lrc[k] + tools[k] + bench[k] + training[k] + adapter[k]
                + rest_training[k]
                + full[k] + full_mesh[k] + estimate[k] for k in training}

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
    if sys.argv[1:2] == ["--tier"]:
        phase_tier(int(sys.argv[2]))
    else:
        main()
