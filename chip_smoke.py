#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (acestep_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines and its seconds; any failed check raises,
so the exit code is non-zero and no result line is printed:

1. device: the card's name and power limit (nvidia-smi) and the versions;
   no CUDA device is an error.
2. build: the hand-written kernels of acestep_torch/csrc, built with nvcc.
3. kernels: K1 (flash attention) and K4 (snake + conv stack) against their
   plain PyTorch versions at the shapes the main path gives them, with
   kernel, plain-version and library times (CUDA events) and the bound the
   card's published peaks set for the same work.
4. reference: a small model through the port's handler on the card (bf16,
   kernels) against the same weights on the CPU (fp32, plain versions).
5. end to end: full-width turbo text2music (DiTConfig.turbo(), VAEConfig(),
   bf16, seeded random weights) through acestep_torch.inference.
   generate_music, three requests; the kernels' launch counters show the
   path went through both kernels.

The last two lines are the kernel table and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import copy
import json
import subprocess
import tempfile
import time

# Published peaks of one H100 SXM (dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances, scaled by max(1, max|ref|); the reference is the plain
# version in fp32 from the same bf16 inputs. Both kernels round operands to
# bf16 (P before P.V; the snake outputs before each conv) and store bf16
# output (~4e-3 relative), over sums of 64-896 terms.
TOL_K1_OUT = 2e-2
TOL_K1_LSE = 2e-3       # absolute; lse is fp32 from the same logits
TOL_K4 = 2e-2
# bf16 on the card against fp32 on the CPU, same weights and noise, through
# 2 layers x 8 steps and the VAE: relative to the largest value.
TOL_REFERENCE = 5e-2

K1_SOURCE = "acestep_torch/csrc/flash_attention.cu"
K1_REPLACES = "acestep_tpu/ops/flash_attention.py:49"
K4_SOURCE = "acestep_torch/csrc/snake_conv.cu"
K4_REPLACES = "acestep_tpu/ops/snake_conv.py:78"


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def _k1_case(B, L, window, seed):
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
        rec = dict(
            kernel="K4", N=N, L=L, C=C, max_abs_err=err, max_rel_err=rel,
            kernel_ms=cuda_ms(lambda: sc.res_unit_stack_cuda(units, x), 20),
            plain_ms=cuda_ms(lambda: sc.res_unit_stack_plain(units, x), 3, 1),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            flops=flops, bytes=nbytes)
    emit(phase="kernels", **rec)
    return rec


def phase_kernels():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    k1 = [_k1_case(1, 750, None, 1), _k1_case(1, 750, 128, 2),
          _k1_case(2, 1500, None, 3), _k1_case(2, 1500, 128, 4),
          _k1_case(1, 1001, 128, 5), _k1_case(1, 1001, None, 6)]
    k4 = [_k4_case(4, 491520, 128, 7), _k4_case(4, 245760, 128, 8),
          _k4_case(4, 61440, 256, 9), _k4_case(3, 100003, 128, 10),
          _k4_case(2, 7001, 256, 11)]
    torch.cuda.empty_cache()
    emit(phase="kernels", seconds=time.time() - t0)
    return k1, k4


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
    fa.launches = 0
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
    launches = {"K1": fa.launches, "K4": sc.launches}
    emit(phase="end_to_end", seconds=time.time() - t0, launches=launches)
    return launches


def main() -> None:
    import torch

    t_all = time.time()
    phase_device()
    phase_build()
    k1, k4 = phase_kernels()
    phase_reference()
    launches = phase_end_to_end()

    def row(name, source, replaces, cases, rep, n):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"]}

    # the representative case of each kernel: K1 full attention at the
    # 60 s song's 750 patches (the costlier half of its launches), K4 at
    # the 48 kHz level of a 4-window decode group
    emit(phase="total", seconds=time.time() - t_all)
    print(json.dumps({"kernels": [
        row("flash_attention_fwd", K1_SOURCE, K1_REPLACES, k1, k1[0],
            launches["K1"]),
        row("snake_conv_res_stack", K4_SOURCE, K4_REPLACES, k4, k4[0],
            launches["K4"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
