"""Training CLI of the PyTorch port.

    python -m acestep_torch.training.cli preprocess --manifest dataset.json \
        --out-dir tensors
    python -m acestep_torch.training.cli vanilla --tensor-dir tensors \
        --output-dir lora_output --max-steps 2000
    python -m acestep_torch.training.cli fixed ...
    python -m acestep_torch.training.cli estimate --tensor-dir tensors
    python -m acestep_torch.training.cli full --tensor-dir tensors \
        --output-dir full_train --max-steps 10000 [--resume-from latest]
    python -m acestep_torch.training.cli dataset --audio-dir songs \
        --out-dir ds [--label]
    python -m acestep_torch.training.cli presets

Port of `acestep_tpu/training/cli.py`: `preprocess` (manifest -> tensor
dir), `vanilla` (LoRA/LoKr, discrete turbo shift-3 timesteps), `fixed`
(continuous logit-normal timesteps), `estimate` (rank the decoder
projections by gradient sensitivity), `full` (every parameter, checkpoints
under `<output-dir>/checkpoints/<step>/`, `--resume-from latest|<step>`),
`dataset` (audio dir -> scan, encode, label, manifest, tensors; `--label`
captions with the 5 Hz planner) and `presets`. The model is the
full-width turbo DiT (`--tiny`: the miniature test config) with seeded
random weights, on the CUDA device in bf16 unless `--device cpu`
(float32, the plain versions of the kernels). `vanilla`/`fixed` append
every progress event to `<output-dir>/metrics.jsonl` ({"step", "loss",
"ts"}); `full`, as JAX's, prints its events and writes no metrics file.
`--log-every`, which only the port's parser has, sets the progress cadence
of all three.

Weights: `--checkpoint-dir` (an upstream DiT checkpoint dir), or `--pick
NAME` to find one by (fuzzy) name under `--checkpoint-root` (default
./checkpoints, training/discovery.py), and `--vae-dir` for the VAE; without
them, seeded random weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

from acestep_torch.config import DiTConfig, VAEConfig


def _resolve_pick(args) -> None:
    """--pick NAME: discover the checkpoint dir by (fuzzy) name under
    --checkpoint-root (an explicit --checkpoint-dir wins)."""
    if not args.pick or args.checkpoint_dir:
        return
    from acestep_torch.training.discovery import pick_model

    root = args.checkpoint_root or "checkpoints"
    info = pick_model(root, args.pick)
    if info is None:
        raise SystemExit(
            f"--pick {args.pick!r}: no matching model under {root}")
    print(f"[training] picked {info.name} "
          f"({'official' if info.is_official else 'custom'}, "
          f"base: {info.base_model}) at {info.path}")
    args.checkpoint_dir = info.path


def _build_handler(args):
    import torch

    from acestep_torch.pipeline.handler import AceStepHandler

    _resolve_pick(args)
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    if args.tiny:
        # the tiny VAE emits latents at the tiny DiT's acoustic dim (64)
        handler = AceStepHandler(DiTConfig.tiny(),
                                 VAEConfig.tiny(decoder_input_channels=64),
                                 dtype=dtype, frame_bucket=25, min_frames=25,
                                 refer_frames=10, device=args.device)
    else:
        handler = AceStepHandler(dtype=dtype, device=args.device)
    handler.initialize_service(checkpoint_dir=args.checkpoint_dir,
                               vae_dir=args.vae_dir, seed=args.seed)
    return handler


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint-dir", default=None,
                   help="DiT checkpoint dir (default: seeded random init)")
    p.add_argument("--checkpoint-root", default=None,
                   help="root scanned by --pick (default ./checkpoints)")
    p.add_argument("--pick", default=None, metavar="NAME",
                   help="discover the checkpoint by (fuzzy) name under "
                        "--checkpoint-root instead of a full path")
    p.add_argument("--vae-dir", default=None, help="VAE checkpoint dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="miniature model (tests)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels in float32)")


def _add_train_common(p: argparse.ArgumentParser) -> None:
    _add_common(p)
    p.add_argument("--tensor-dir", required=True,
                   help="directory of preprocessed sample_*.npz tensors")
    p.add_argument("--output-dir", default="lora_output")
    p.add_argument("--preset", default=None,
                   help="named preset (see `presets`); flags override it")
    p.add_argument("--kind", choices=["lora", "lokr"], default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--lokr-factor", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--resume-from", default=None,
                   help="checkpoint_<step> directory to resume from")
    p.add_argument("--adapter-name", default=None)
    p.add_argument("--val-fraction", type=float, default=0.0)


def _training_config(args, timestep_mode: str):
    from acestep_torch.training.lora import LoRATrainingConfig
    from acestep_torch.training.presets import get_preset

    overrides = {
        name: getattr(args, name)
        for name in ("kind", "rank", "alpha", "lokr_factor", "learning_rate",
                     "batch_size", "max_steps", "checkpoint_every",
                     "log_every", "resume_from", "adapter_name")
        if getattr(args, name) is not None
    }
    overrides["output_dir"] = args.output_dir
    overrides["seed"] = args.seed
    if args.preset:
        tcfg = get_preset(args.preset, **overrides)
    else:
        tcfg = LoRATrainingConfig(**overrides)
    # the subcommand is the timestep-mode selector; it overrides the preset
    return dataclasses.replace(tcfg, timestep_mode=timestep_mode)


def _run_adapter_training(args, timestep_mode: str) -> int:
    import os

    from acestep_torch.training.data import PreprocessedDataset, make_batches
    from acestep_torch.training.lora import LoRATrainer
    from acestep_torch.utils.fsio import append_jsonl

    handler = _build_handler(args)
    tcfg = _training_config(args, timestep_mode)
    dataset = PreprocessedDataset(args.tensor_dir,
                                  val_fraction=args.val_fraction,
                                  seed=args.seed)
    batches = make_batches(dataset.train_files, tcfg.batch_size,
                           latent_dim=handler.cfg.audio_acoustic_hidden_dim,
                           seed=args.seed)
    print(f"training {tcfg.kind} ({tcfg.timestep_mode}) on "
          f"{len(dataset.train_files)} samples "
          f"(+{len(dataset.val_files)} val) -> {tcfg.output_dir}",
          flush=True)
    trainer = LoRATrainer(handler.model, handler.cfg, tcfg)
    metrics = os.path.join(tcfg.output_dir, "metrics.jsonl")
    for step, loss, message in trainer.train(batches):
        append_jsonl(metrics, {"step": step, "loss": loss, "ts": time.time()})
        print(message, flush=True)
    return 0


def cmd_vanilla(args) -> int:
    return _run_adapter_training(args, "discrete_shift3")


def cmd_fixed(args) -> int:
    return _run_adapter_training(args, "continuous")


def cmd_estimate(args) -> int:
    from acestep_torch.training.data import PreprocessedDataset, make_batches
    from acestep_torch.training.presets import estimate_gradient_sensitivity

    handler = _build_handler(args)
    dataset = PreprocessedDataset(args.tensor_dir, seed=args.seed)
    batches = make_batches(dataset.train_files, args.batch_size,
                           latent_dim=handler.cfg.audio_acoustic_hidden_dim,
                           seed=args.seed)
    ranked = estimate_gradient_sensitivity(handler.model, handler.cfg,
                                           batches,
                                           num_batches=args.num_batches,
                                           seed=args.seed)
    print(f"{'target':<24} sensitivity")
    for name, score in ranked:
        print(f"{name:<24} {score:.6f}")
    top = [name for name, _ in ranked[: args.top_k]]
    print(f"\nsuggested LoRA targets (top {args.top_k}): {', '.join(top)}")
    return 0


def _resume_step(resume_from: str):
    """--resume-from of `full`: 'latest' (None) or a step number, also as
    checkpoint_<step>."""
    if resume_from == "latest":
        return None
    try:
        return int(resume_from.rsplit("_", 1)[-1])
    except ValueError:
        raise SystemExit(
            "full: --resume-from must be 'latest' or a step number "
            "(checkpoints live under --output-dir/checkpoints)") from None


def cmd_full(args) -> int:
    from acestep_torch.training.data import PreprocessedDataset, make_batches
    from acestep_torch.training.trainer_full import (FullTrainer,
                                                     FullTrainingConfig)

    handler = _build_handler(args)
    tcfg = FullTrainingConfig(
        learning_rate=args.learning_rate or 1e-4,
        max_steps=args.max_steps or 10_000,
        checkpoint_every=args.checkpoint_every or 1000,
        output_dir=args.output_dir, seed=args.seed,
        mesh_dp=args.mesh_dp, mesh_tp=args.mesh_tp)
    if args.log_every:
        tcfg.log_every = args.log_every
    dataset = PreprocessedDataset(args.tensor_dir,
                                  val_fraction=args.val_fraction,
                                  seed=args.seed)
    batches = make_batches(dataset.train_files, args.batch_size or 1,
                           latent_dim=handler.cfg.audio_acoustic_hidden_dim,
                           seed=args.seed)
    trainer = FullTrainer(handler.model, handler.cfg, tcfg)
    try:
        if args.resume_from:
            # the full trainer resumes from its own output dir's
            # checkpoints: 'latest' or a step number, not a foreign path
            if not trainer.restore(_resume_step(args.resume_from)):
                raise SystemExit(
                    f"full: no checkpoint to resume in {args.output_dir}")
        for _step, _loss, message in trainer.train(batches):
            print(message, flush=True)
    finally:
        trainer.close()
    return 0


def cmd_dataset(args) -> int:
    from acestep_torch.training.dataset_builder import DatasetBuildPipeline

    handler = _build_handler(args)
    llm = None
    if args.label:
        from acestep_torch.llm.handler import LLMHandler

        llm = LLMHandler(dtype=handler.dtype, device=args.device)
        llm.initialize(seed=args.seed)
    pipeline = DatasetBuildPipeline(args.audio_dir, args.out_dir, handler,
                                    llm, val_fraction=args.val_fraction)
    result = pipeline.build()
    print(json.dumps(result, indent=2, default=str))
    return 0


def cmd_preprocess(args) -> int:
    from acestep_torch.training.preprocess import preprocess_audio_files

    handler = _build_handler(args)
    written = preprocess_audio_files(handler, args.manifest, args.out_dir)
    print(f"wrote {len(written)} tensor files -> {args.out_dir}")
    return 0


def cmd_presets(_args) -> int:
    from acestep_torch.training.presets import PRESETS

    for name, kw in PRESETS.items():
        desc = ", ".join(f"{k}={v}" for k, v in kw.items())
        print(f"{name:<10} {desc}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m acestep_torch.training.cli",
        description="ACE-Step training CLI (PyTorch port)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("vanilla", help="LoRA/LoKr, discrete shift-3 "
                       "timesteps")
    _add_train_common(p)
    p.set_defaults(fn=cmd_vanilla)

    p = sub.add_parser("fixed", help="LoRA/LoKr, continuous timesteps "
                       "matching the model config")
    _add_train_common(p)
    p.set_defaults(fn=cmd_fixed)

    p = sub.add_parser("estimate", help="rank decoder projections by "
                       "gradient sensitivity on your dataset")
    _add_common(p)
    p.add_argument("--tensor-dir", required=True)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-batches", type=int, default=4)
    p.add_argument("--top-k", type=int, default=4)
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("full", help="full-parameter trainer (checkpoints "
                       "under --output-dir/checkpoints)")
    _add_train_common(p)
    p.add_argument("--mesh-dp", type=int, default=1,
                   help="data-parallel mesh axis: each batch's rows split "
                        "over dp ranks (the batch size must divide)")
    p.add_argument("--mesh-tp", type=int, default=1,
                   help="tensor-parallel mesh axis: heads and MLP features "
                        "split over tp ranks (one process a device; with "
                        "--device cpu, gloo CPU ranks)")
    p.set_defaults(fn=cmd_full)

    p = sub.add_parser("preprocess", help="manifest -> tensor dir")
    _add_common(p)
    p.add_argument("--manifest", required=True, help="dataset.json path")
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("dataset", help="audio dir -> staged dataset build")
    _add_common(p)
    p.add_argument("--audio-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--label", action="store_true",
                   help="auto-caption unlabeled audio with the planner LM")
    p.add_argument("--val-fraction", type=float, default=0.0)
    p.set_defaults(fn=cmd_dataset)

    p = sub.add_parser("presets", help="list named training presets")
    p.set_defaults(fn=cmd_presets)
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
