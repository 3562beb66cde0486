"""Interactive CLI wizard: configure-and-generate loop + analysis tools.

Port of `acestep_tpu/cli.py` (the reference wizard's capabilities):
interactive per-parameter editing, task-specific follow-up prompts
(repaint spans, cover sources, extract/lego track selection), $EDITOR hook
for long text, understand mode (audio -> LM metadata), audio-codes
import/export, LoRA load, repeated generation with tweaks, and
non-interactive one-shot flags for scripting (`--once`, `--understand`,
`--export-codes`, `-c` / `--save-config`).

It runs on the CUDA device unless `--device cpu` (float32, the plain
versions of the kernels); without a CUDA device and without that flag it
raises. `--tiny` builds the miniature DiT and VAE, and a miniature seeded
5 Hz planner when no `--lm-checkpoint-dir` is given (tests). Results
default to flac (the native encoder, utils/flac.py).

    python -m acestep_torch.cli --once --no-think --duration 30 --seed 1
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional

from acestep_torch.constants import (
    DURATION_MAX,
    DURATION_MIN,
    TASK_TYPES,
    TRACK_NAMES,
    VALID_LANGUAGES,
)
from acestep_torch.inference import (GenerationConfig, GenerationParams,
                                     generate_music)


def _input(prompt: str, default: str = "") -> str:
    suffix = f" [{default}]" if default else ""
    try:
        value = input(f"{prompt}{suffix}: ").strip()
    except EOFError:
        return default
    return value or default


def _edit_in_editor(initial: str) -> str:
    """Open $EDITOR on a temp file (reference cli.py:213-233 behavior)."""
    editor = os.environ.get("EDITOR")
    if not editor:
        return initial
    with tempfile.NamedTemporaryFile("w+", suffix=".txt", delete=False) as f:
        f.write(initial)
        path = f.name
    try:
        # EDITOR may carry arguments ("code --wait", "vim -u NONE")
        subprocess.run(shlex.split(editor) + [path], check=False)
        with open(path, "r", encoding="utf-8") as f:
            return f.read().strip()
    finally:
        os.unlink(path)


# (field, label, type) — the per-parameter edit surface
FIELDS = [
    ("caption", "Music description / caption", str),
    ("lyrics", "Lyrics ([inst] for instrumental; @edit opens $EDITOR)", str),
    ("duration", f"Duration seconds ({DURATION_MIN}-{DURATION_MAX}, -1 auto)", float),
    ("bpm", "BPM (blank = auto)", int),
    ("keyscale", "Key scale (e.g. 'C major', blank = auto)", str),
    ("timesignature", "Time signature (2/3/4/6, blank = auto)", str),
    ("vocal_language", f"Language ({'/'.join(VALID_LANGUAGES[:6])}/...)", str),
    ("task_type", f"Task ({'/'.join(TASK_TYPES)})", str),
    ("inference_steps", "Diffusion steps", int),
    ("guidance_scale", "Guidance scale (base/sft models)", float),
    ("infer_method", "Sampler method (ode/sde)", str),
    ("shift", "Timestep shift", float),
    ("thinking", "Use LM planner (y/n)", bool),
    ("lm_temperature", "LM temperature", float),
    ("lm_metadata_temperature", "LM metadata-phase temperature (blank = LM temperature)", float),
    ("lm_codes_temperature", "LM codes-phase temperature (blank = LM temperature)", float),
    ("lm_repetition_penalty", "LM repetition penalty (1.0 = off)", float),
    ("seed", "Seed (-1 random)", int),
]

_TASK_HELP = {
    "repaint": "regenerate a time span of the source audio",
    "cover": "re-render the song from its semantic codes",
    "extract": "isolate one track (vocals/drums/...)",
    "lego": "replace a span with a named track",
    "complete": "extend a partial arrangement",
}


def _collect_params(args) -> GenerationParams:
    params = GenerationParams(
        caption=args.caption or "",
        lyrics=args.lyrics or "",
        duration=args.duration,
        thinking=not args.no_think,
        inference_steps=args.steps,
        seed=args.seed,
        task_type=args.task,
        lm_temperature=args.lm_temperature,
        lm_metadata_temperature=args.lm_metadata_temperature,
        lm_codes_temperature=args.lm_codes_temperature,
        lm_repetition_penalty=args.lm_repetition_penalty,
    )
    if args.language:
        params.vocal_language = args.language
    if args.src_audio:
        params.src_audio = args.src_audio
    if args.reference_audio:
        params.reference_audio = args.reference_audio
    if args.audio_codes_file:
        params.audio_codes = _read_codes_file(args.audio_codes_file)
    return params


def _read_codes_file(path: str) -> str:
    """Codes import (reference wizard 'audio_codes' input): a file holding
    '<|audio_code_N|>...' (or bare integers one per line)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read().strip()
    if "<|audio_code_" in text:
        return text
    codes = [int(t) for t in text.replace(",", "\n").split() if t.strip()]
    return "".join(f"<|audio_code_{c}|>" for c in codes)


def _task_followups(params: GenerationParams) -> None:
    """Task-specific follow-up prompts (reference wizard per-task flow)."""
    task = params.task_type
    if task in ("repaint", "lego"):
        raw = _input("Repaint start seconds", str(params.repainting_start or 0))
        try:
            params.repainting_start = float(raw)
        except ValueError:
            pass
        raw = _input("Repaint end seconds (-1 = song end)",
                     str(params.repainting_end
                         if params.repainting_end is not None else -1))
        try:
            params.repainting_end = float(raw)
        except ValueError:
            pass
    if task in ("repaint", "cover", "extract", "lego", "complete"):
        raw = _input("Source audio path", params.src_audio or "")
        if raw:
            if os.path.exists(os.path.expanduser(raw)):
                params.src_audio = os.path.expanduser(raw)
            else:
                print(f"  ! no such file: {raw}")
    if task == "cover":
        raw = _input("Cover strength 0-1", str(params.audio_cover_strength))
        try:
            params.audio_cover_strength = float(raw)
        except ValueError:
            pass
    if task in ("extract", "lego"):
        names = ", ".join(TRACK_NAMES[:8]) + ", ..."
        raw = _input(f"Track name ({names})", params.track_name or "")
        if raw:
            params.track_name = raw


def _show_params(params: GenerationParams) -> None:
    print("\n-- Current configuration --")
    for idx, (name, label, _typ) in enumerate(FIELDS, 1):
        value = getattr(params, name, None)
        if value in (None, "", -1, -1.0):
            value = "(auto)"
        print(f"  {idx:2d}. {name:<16} {value}")
    for extra in ("src_audio", "reference_audio", "track_name",
                  "repainting_start", "repainting_end"):
        value = getattr(params, extra, None)
        if value not in (None, "", -1, -1.0):
            print(f"      {extra:<16} {value}")
    if params.audio_codes:
        n = params.audio_codes.count("<|audio_code_")
        print(f"      audio_codes      {n} codes imported")


def _edit_field(params: GenerationParams, name: str, raw: str = "",
                followups: bool = True) -> None:
    if name.isdigit():                   # '3 60' — index from _show_params
        idx = int(name)
        if not 1 <= idx <= len(FIELDS):
            print(f"  ! field index out of range: {idx} (1-{len(FIELDS)})")
            return
        name = FIELDS[idx - 1][0]
    match = [f for f in FIELDS if f[0] == name]
    if not match:
        print(f"  ! unknown field {name!r}")
        return
    name, label, typ = match[0]
    current = getattr(params, name, None)
    if not raw:
        raw = _input(label, "" if current in (None, "", -1, -1.0)
                     else str(current))
    if not raw:
        return
    if typ is bool:
        # pressing Enter returns the DISPLAYED default ('True'/'False'),
        # so 'True' must parse as true — startswith('y') alone silently
        # flipped every kept bool to False
        setattr(params, name,
                raw.strip().lower() in ("y", "yes", "true", "1", "on"))
        return
    if raw == "@edit" and typ is str:
        setattr(params, name, _edit_in_editor(str(current or "")))
        return
    try:
        setattr(params, name, typ(raw))
    except ValueError:
        print(f"  ! could not parse {raw!r}; keeping {current!r}")
        return
    if name == "task_type" and followups:
        _task_followups(params)


def _wizard_edit(params: GenerationParams) -> GenerationParams:
    print("\n-- Configure generation (enter keeps current value) --")
    for name, _label, _typ in FIELDS:
        # followups run ONCE after the walkthrough (changing task_type
        # mid-walk would otherwise prompt repaint/source twice)
        _edit_field(params, name, raw="", followups=False)
    _task_followups(params)
    return params


def _run_understand(dit_handler, llm_handler, audio_path: str) -> Dict[str, Any]:
    """Audio -> 5 Hz codes -> LM 'understand' metadata (reference
    analysis mode)."""
    import numpy as np

    from acestep_torch.utils.audio import load_audio

    if llm_handler is None:
        print("understand mode needs --lm-checkpoint-dir")
        return {}
    audio = load_audio(os.path.expanduser(audio_path))
    codes = dit_handler.audio_to_codes(np.asarray(audio))
    meta = llm_handler.understand(codes)
    print("\n-- Understanding --")
    for key, value in meta.items():
        print(f"  {key}: {value}")
    return meta


def _export_codes(dit_handler, audio_path: str,
                  out_path: Optional[str]) -> str:
    import numpy as np

    from acestep_torch.utils.audio import load_audio

    audio = load_audio(os.path.expanduser(audio_path))
    codes = dit_handler.audio_to_codes(np.asarray(audio))
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            f.write(codes)
        print(f"wrote {codes.count('<|audio_code_')} codes to {out_path}")
    return codes


WIZARD_HELP = """\
Commands:
  go | g                generate with the current configuration
  show                  print all parameters
  <name> [value]        edit one field (e.g. 'caption', 'bpm 120', '3 60')
  all                   walk through every field
  understand <audio>    analyze audio with the LM; merge its metadata
  codes <audio> [file]  audio -> semantic codes (optionally save to file)
  importcodes <file>    load codes from a file as generation hints
  lora <path> [scale]   load a LoRA adapter onto the DiT
  nolora                disable the active adapter
  help | ?              this help
  quit | q              exit"""


def run_wizard(dit_handler, llm_handler, args) -> None:
    params = _collect_params(args)
    config = GenerationConfig(batch_size=args.batch, output_dir=args.output_dir,
                              audio_format=args.format)
    if not params.caption:
        params = _wizard_edit(params)
    _show_params(params)
    print("\nType 'go' to generate, 'help' for commands.")
    while True:
        try:
            line = input("acestep> ").strip()
        except EOFError:
            break
        if not line:
            continue
        cmd, _, rest = line.partition(" ")
        cmd = cmd.lower()
        if cmd in ("q", "quit", "exit"):
            break
        if cmd in ("help", "?"):
            print(WIZARD_HELP)
        elif cmd == "show":
            _show_params(params)
        elif cmd == "all":
            params = _wizard_edit(params)
        elif cmd in ("go", "g"):
            print("Generating...")
            result = generate_music(dit_handler, llm_handler, params, config)
            if result.success:
                for audio in result.audios:
                    print(f"  -> {audio['path']}  (seed {audio['seed']})")
                costs = result.extra_outputs.get("time_costs", {})
                total = costs.get("total_time_cost")
                if total:
                    print(f"  total {total:.2f}s (diffusion "
                          f"{costs.get('diffusion_time_cost', 0):.2f}s, "
                          f"vae {costs.get('vae_decode_time_cost', 0):.2f}s)")
            else:
                print(f"  generation failed: {result.error}")
        elif cmd == "understand":
            try:
                meta = _run_understand(dit_handler, llm_handler, rest.strip())
            except (OSError, ValueError) as e:
                print(f"  ! {e}")      # a typo'd path must not kill the REPL
                meta = None
            if meta and _input("Merge into parameters? (y/n)",
                               "y").lower().startswith("y"):
                for key in ("caption", "bpm", "keyscale", "timesignature",
                            "duration"):
                    if meta.get(key) not in (None, ""):
                        try:
                            _edit_field(params, key, str(meta[key]))
                        except Exception:
                            pass
        elif cmd == "codes":
            parts = rest.split()
            if parts:
                try:
                    codes = _export_codes(dit_handler, parts[0],
                                          parts[1] if len(parts) > 1 else None)
                except (OSError, ValueError) as e:
                    print(f"  ! {e}")
                    codes = None
                if codes and _input("Use as generation hints? (y/n)",
                                    "n").lower().startswith("y"):
                    params.audio_codes = codes
            else:
                print("usage: codes <audio> [out_file]")
        elif cmd == "importcodes":
            try:
                params.audio_codes = _read_codes_file(rest.strip())
                n = params.audio_codes.count("<|audio_code_")
                print(f"  imported {n} codes")
            except (OSError, ValueError) as e:
                print(f"  ! {e}")
        elif cmd == "lora":
            parts = rest.split()
            if not parts:
                print("usage: lora <path> [scale]")
                continue
            try:
                info = dit_handler.lora.load(
                    parts[0],
                    scale=float(parts[1]) if len(parts) > 1 else 1.0)
                print(f"  loaded {info['adapter_name']} "
                      f"({info['params']} params, scale {info['scale']})")
            except Exception as e:
                print(f"  ! {e}")
        elif cmd == "nolora":
            print(f"  {dit_handler.lora.toggle(False)}")
        else:
            _edit_field(params, cmd, rest.strip())


def _toml_dump(values: dict) -> str:
    """Flat TOML writer for CLI configs (stdlib has only the reader)."""
    lines = []
    for k, v in sorted(values.items()):
        if v is None:
            continue
        if isinstance(v, bool):
            lines.append(f"{k} = {'true' if v else 'false'}")
        elif isinstance(v, (int, float)):
            lines.append(f"{k} = {v}")
        else:
            escaped = str(v).replace("\\", "\\\\").replace('"', '\\"')
            escaped = escaped.replace("\n", "\\n")
            lines.append(f'{k} = "{escaped}"')
    return "\n".join(lines) + "\n"


def load_config_defaults(parser: argparse.ArgumentParser,
                         path: str) -> None:
    """Apply a TOML config file as parser defaults (reference cli.py's
    `-c config.toml`, cli.py:1125-1137): explicit command-line flags
    still win because they parse after the defaults are set."""
    import tomllib

    with open(path, "rb") as f:
        values = tomllib.load(f)
    actions = {a.dest: a for a in parser._actions}
    unknown = set(values) - set(actions) - {"config", "save_config"}
    if unknown:
        print(f"config {path}: ignoring unknown keys {sorted(unknown)}")
    coerced = {}
    for k, v in values.items():
        action = actions.get(k)
        if action is None:
            continue
        # set_defaults bypasses argparse's type/choices machinery, so a
        # mistyped config value would crash minutes later inside
        # generation — validate here, at load time, with the same rules
        if action.type is not None and v is not None and \
                not isinstance(v, bool):
            try:
                v = action.type(v)
            except (TypeError, ValueError) as e:
                raise SystemExit(
                    f"config {path}: bad value for {k!r}: {v!r} ({e})")
        if action.choices is not None and v is not None and \
                v not in action.choices:
            raise SystemExit(
                f"config {path}: {k!r} must be one of "
                f"{sorted(map(str, action.choices))}, got {v!r}")
        coerced[k] = v
    parser.set_defaults(**coerced)


def save_config(args, path: str) -> str:
    """Persist the resolved args as a reusable TOML (reference
    `--configure`, cli.py:963-977)."""
    if not path.endswith(".toml"):
        path += ".toml"
    # one-shot mode flags stay out of the file: a config saved during an
    # analysis run must not flip every later `-c` run into analysis mode
    skip = ("config", "save_config", "understand", "export_codes",
            "codes_out", "once")
    values = {k: v for k, v in vars(args).items()
              if k not in skip and not k.startswith("_")}
    with open(path, "w", encoding="utf-8") as f:
        f.write(_toml_dump(values))
    print(f"configuration saved to {path}; reuse with: "
          f"acestep-torch -c {path}")
    return path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="acestep-torch",
        description="ACE-Step music generation CLI (PyTorch port)")
    parser.add_argument("-c", "--config", default=None,
                        help="TOML config file supplying defaults for any "
                             "flag (command-line flags win)")
    parser.add_argument("--save-config", metavar="PATH", default=None,
                        help="write the resolved settings to a TOML and "
                             "exit without generating (reference "
                             "--configure)")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--vae-dir", default=None)
    parser.add_argument("--lm-checkpoint-dir", default=None)
    parser.add_argument("--lm-quantization", default=None,
                        choices=["int8", "fp8", "w8a8", "int4"])
    parser.add_argument("--lm-kv-quant", default="auto",
                        choices=["auto", "on", "off"],
                        help="int8 KV cache for the LM planner ('auto' = "
                             "on when the weight mode is w8a8)")
    parser.add_argument("--caption", default=None)
    parser.add_argument("--lyrics", default=None)
    parser.add_argument("--duration", type=float, default=-1.0)
    parser.add_argument("--language", default=None)
    parser.add_argument("--task", default="text2music", choices=TASK_TYPES)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seed", type=int, default=-1)
    parser.add_argument("--lm-temperature", type=float, default=0.85)
    parser.add_argument("--lm-metadata-temperature", type=float, default=None,
                        help="metadata-phase temperature override")
    parser.add_argument("--lm-codes-temperature", type=float, default=None,
                        help="codes-phase temperature override")
    parser.add_argument("--lm-repetition-penalty", type=float, default=1.0)
    parser.add_argument("--no-think", action="store_true",
                        help="skip the LM planning phase")
    parser.add_argument("--format", default="flac",
                        help="output format (flac is the repo default; "
                             "native encoder, no ffmpeg needed)")
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--src-audio", default=None,
                        help="source audio for repaint/cover/extract/...")
    parser.add_argument("--reference-audio", default=None,
                        help="timbre reference audio")
    parser.add_argument("--audio-codes-file", default=None,
                        help="import semantic codes as generation hints")
    parser.add_argument("--lora", default=None,
                        help="LoRA adapter to load before generating")
    parser.add_argument("--lora-scale", type=float, default=1.0)
    parser.add_argument("--once", action="store_true",
                        help="non-interactive: generate once and exit")
    parser.add_argument("--understand", metavar="AUDIO", default=None,
                        help="analyze an audio file with the LM and exit")
    parser.add_argument("--export-codes", metavar="AUDIO", default=None,
                        help="print (or save with --codes-out) 5 Hz codes "
                             "for an audio file and exit")
    parser.add_argument("--codes-out", default=None)
    parser.add_argument("--mesh", default=os.environ.get("ACESTEP_MESH"),
                        help="multi-device DiT mesh 'DPxTP' (e.g. '4x2') or "
                             "device count: one process per device, this "
                             "one rank 0 (nccl on cards, gloo with --device "
                             "cpu; env: ACESTEP_MESH)")
    parser.add_argument("--lm-tensor-parallel", type=int,
                        default=int(os.environ.get("ACESTEP_LM_TP", "1")),
                        help="tensor-parallel degree for the LM planner; it "
                             "takes the first ranks of --mesh's processes "
                             "when both are given")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' "
                             "runs the plain versions of the kernels in "
                             "float32)")
    parser.add_argument("--tiny", action="store_true",
                        help="miniature models with seeded weights (tests)")
    return parser


def _build_handlers(args, mesh_spec=None):
    """(DiT handler, LM handler or None) on the requested device, the DiT
    over a (dp, tp) `mesh_spec` when one is given."""
    import torch

    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.pipeline.handler import AceStepHandler, resolve_device

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if args.tiny:
        # the tiny VAE emits latents at the tiny DiT's acoustic dim (64)
        handler = AceStepHandler(DiTConfig.tiny(),
                                 VAEConfig.tiny(decoder_input_channels=64),
                                 dtype=dtype, frame_bucket=25, min_frames=25,
                                 refer_frames=10, device=device)
    else:
        handler = AceStepHandler(dtype=dtype, device=device)
    print("Initializing service...", flush=True)
    handler.initialize_service(checkpoint_dir=args.checkpoint_dir,
                               vae_dir=args.vae_dir)
    if mesh_spec:
        handler.enable_mesh(dp=mesh_spec[0], tp=mesh_spec[1])
        print(f"mesh enabled: dp={mesh_spec[0]} x tp={mesh_spec[1]}",
              flush=True)
    llm = None
    if args.lm_checkpoint_dir or args.tiny:
        # without a checkpoint, LLMHandler.initialize builds the miniature
        # seeded planner over the built-in tokenizer
        llm = LLMHandler(dtype=dtype, device=device)
        llm.initialize(checkpoint_dir=args.lm_checkpoint_dir,
                       quantization=args.lm_quantization,
                       tensor_parallel=args.lm_tensor_parallel,
                       kv_quant={"auto": None, "on": True,
                                 "off": False}[args.lm_kv_quant])
    return handler, llm


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    # pre-pass for -c so the config file becomes the defaults layer and
    # explicit flags still override (reference cli.py:1125-1137)
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        load_config_defaults(parser, pre.config)
    args = parser.parse_args(argv)

    if args.save_config:
        save_config(args, args.save_config)
        return 0

    from acestep_torch.parallel import parse_mesh_spec

    # validate the mesh spec BEFORE the service init so a malformed
    # '--mesh 4x' fails immediately (the server's ordering)
    mesh_spec = parse_mesh_spec(args.mesh)
    handler, llm = _build_handlers(args, mesh_spec)
    try:
        return _run(args, handler, llm)
    finally:
        # stop the mesh's follower processes
        handler.release_mesh()
        if llm is not None:
            llm.release()


def _run(args, handler, llm) -> int:
    """The CLI's action on built handlers."""
    if args.lora:
        info = handler.lora.load(args.lora, scale=args.lora_scale)
        print(f"loaded LoRA {info['adapter_name']} (scale {info['scale']})")

    if args.understand:
        meta = _run_understand(handler, llm, args.understand)
        return 0 if meta else 1

    if args.export_codes:
        codes = _export_codes(handler, args.export_codes, args.codes_out)
        if not args.codes_out:
            print(codes)
        return 0

    if args.once:
        params = _collect_params(args)
        config = GenerationConfig(batch_size=args.batch,
                                  output_dir=args.output_dir,
                                  audio_format=args.format)
        result = generate_music(handler, llm, params, config)
        if not result.success:
            print(f"generation failed: {result.error}", file=sys.stderr)
            return 1
        for audio in result.audios:
            print(audio["path"])
        return 0

    run_wizard(handler, llm, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
