"""AceStepHandler: DiT-side orchestration of every generation task.

Port of `acestep_tpu/pipeline/handler.py`: request normalisation, code
hints (a text2music request with valid codes becomes a cover), source
audio through the VAE encoder, outpainting (the source padded with silence
and every row's repaint span shifted into the padded timeline), bucketed
frame geometry, per-row source latents, chunk masks, repaint spans and
cover flags, timbre references, text conditioning, the turbo trajectory or
the base/sft guided one (CFG with APG or ADG), the cover switch and cover
noise, the segmented tiled VAE decode, the int16 + peak audio format,
normalisation and saving. Encoding and decoding step down an out-of-memory
ladder and retry. The DiT renders with the effective weights of its
`LoraManager`. PyTorch runs eagerly, so there are no compiled programs to
cache; the handler keeps its model modules on one device.

`initialize_service(quantization=...)` stores the DiT quantized
(ops/quant); `generate_lrc` aligns lyrics to a render's latents through
the decoder's cross-attention; `enable_mesh(dp, tp)` runs the generate
program over a dp x tp mesh of processes (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import random
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from acestep_torch.config import DiTConfig, VAEConfig
from acestep_torch.constants import LATENT_RATE, SAMPLE_RATE, VAE_HOP
from acestep_torch.lora.adapters import call_with_weights
from acestep_torch.lora.manager import LoraManager
from acestep_torch.models.dit import (
    AceStepDiT, audio_tokenize, build_dit, dit_decoder_attn_capture,
    init_dit_params, prepare_condition,
)
from acestep_torch.models.sampler import (
    ConditionSet, build_continuous_schedule, build_turbo_schedule, renoise,
    sample_guided, sample_turbo, truncate_for_cover_noise,
)
from acestep_torch.models.vae import OobleckVAE, init_vae_params
from acestep_torch.models.vae_tiled import (
    DEFAULT_DECODE_OVERLAP, DEFAULT_ENCODE_CHUNK, tiled_decode, tiled_encode,
)
from acestep_torch.ops.quant import quantize_module_, resolve_mode
from acestep_torch.pipeline import text as textlib
from acestep_torch.pipeline.embedder import HashTextEmbedder
from acestep_torch.runtime_config import (
    detect_hbm_gb, effective_batch, effective_duration, get_tier_config,
)
from acestep_torch.utils.audio import (
    AudioSaver, generate_uuid_from_params, load_audio, peak_normalize,
)
from acestep_torch.utils.memory import is_oom_error
from acestep_torch.utils import trace
from acestep_torch.utils.progress import ProgressEstimator, ProgressTicker
from acestep_torch.utils.weights import dit_from_jax, vae_from_jax

FRAME_BUCKET = 250          # 10 s of 25 Hz latents
MIN_FRAMES = 128            # latents are padded to >= 128 frames
REFER_FRAMES = 750          # 30 s timbre reference budget (timbre_fix_frame)
SEG_FRAMES = 768            # latent frames per decode segment


def _pad_frames_to(T: int, bucket: int, min_frames: int) -> int:
    T = max(T, min_frames)
    return -(-T // bucket) * bucket


def _degrade_plan(e: Exception, chunk: int, groups: int, *,
                  min_chunk: int = 32) -> tuple:
    """One step down the out-of-memory ladder: halve the parallel window
    group, then the window; re-raises any other error, and the error
    itself once the ladder is spent."""
    if not is_oom_error(e):
        raise e
    if groups > 1:
        trace.count("vae_plan_retries")
        return chunk, max(1, groups // 2)
    if chunk > min_chunk:
        trace.count("vae_plan_retries")
        return max(min_chunk, chunk // 2), 1
    raise e


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; without a GPU only an explicit
    `device="cpu"` runs (on the CPU every kernel runs its plain version)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


_MESH_KEYS = itertools.count()


def _is_cover_instruction(instruction: Optional[str]) -> bool:
    ins = (instruction or "").lower()
    return ("generate audio semantic tokens" in ins
            and "based on the given conditions" in ins)


def trajectory(model, cfg: DiTConfig, inputs: Dict[str, torch.Tensor], *,
               dtype, schedule, method: str, start_t,
               generators: List[torch.Generator], guidance_scale: float,
               use_adg: bool, cfg_interval: tuple,
               cover_steps: Optional[int], sde_generator=None,
               noise_rows: Optional[tuple] = None) -> torch.Tensor:
    """Condition encode + trajectory -> x0 (B, T, 64) fp32: the JAX
    handler's generate program. `generators` draw each row's initial
    noise, `sde_generator` (default: the first row's) the SDE step noise;
    a dp rank of a mesh passes `noise_rows` (the full batch, its first
    row) so the step noise is its rows of the full batch's draw."""
    common = dict(
        lyric_hidden_states=inputs["lyric_hidden_states"],
        lyric_attention_mask=inputs["lyric_attention_mask"],
        refer_audio_packed=inputs["refer_audio_packed"],
        refer_order_mask=inputs["refer_order_mask"],
        chunk_masks=inputs["chunk_masks"],
        silence_latent=inputs["silence_latent"])
    codes = {k: inputs[k] for k in ("audio_codes",
                                    "audio_codes_valid_frames")
             if k in inputs}
    with trace.span("dit.condition"):
        enc, _m, ctx = prepare_condition(
            model, cfg, text_hidden_states=inputs["text_hidden_states"],
            text_attention_mask=inputs["text_attention_mask"],
            src_latents=inputs["src_latents"], is_covers=inputs["is_covers"],
            **common, **codes)
        cond = ConditionSet.build(model, cfg, enc, ctx)
        cond_nc = None
        if "non_cover_text_hidden_states" in inputs:
            enc_nc, _m2, ctx_nc = prepare_condition(
                model, cfg,
                text_hidden_states=inputs["non_cover_text_hidden_states"],
                text_attention_mask=inputs["non_cover_text_attention_mask"],
                src_latents=inputs["silence_src"],
                is_covers=torch.zeros_like(inputs["is_covers"]), **common)
            cond_nc = ConditionSet.build(model, cfg, enc_nc, ctx_nc)

    B, T = inputs["src_latents"].shape[:2]
    device = inputs["src_latents"].device
    if "initial_noise" in inputs:
        # seed-parity seam: externally supplied noise, so trajectories
        # can be compared across frameworks
        noise = inputs["initial_noise"].to(dtype)
    else:
        noise = torch.stack([
            torch.randn((T, cfg.audio_acoustic_hidden_dim), generator=g,
                        device=device, dtype=dtype)
            for g in generators])
    x_init = noise if start_t is None else renoise(
        inputs["src_latents"], start_t, noise)
    sde = dict(generator=(generators[0] if sde_generator is None
                          else sde_generator), noise_rows=noise_rows)
    if cfg.model_version == "turbo":
        x0 = sample_turbo(model, cfg, x_init=x_init, schedule=schedule,
                          cond=cond, cond_non_cover=cond_nc,
                          cover_steps=cover_steps, infer_method=method,
                          **sde)
    else:
        null_cond = None
        if guidance_scale > 1.0:
            # the null condition keeps the conditional context latents
            with trace.span("dit.condition"):
                null = model.null_condition_emb.to(enc.dtype).expand(
                    enc.shape)
                null_cond = ConditionSet.build(model, cfg, null, ctx)
        x0 = sample_guided(model, cfg, x_init=x_init, schedule=schedule,
                           cond=cond, null_cond=null_cond,
                           cond_non_cover=cond_nc, cover_steps=cover_steps,
                           guidance_scale=guidance_scale,
                           cfg_interval=cfg_interval, use_adg=use_adg,
                           infer_method=method, **sde)
    return x0.float()


def _mesh_render(ctx, root, key: str, cfg: DiTConfig, dtype,
                 inputs: Dict[str, torch.Tensor], seeds: List[int],
                 kwargs: dict):
    """One render on every rank of a DiT mesh: each dp rank takes its block
    of rows and makes generators from its rows' seeds, runs `trajectory`
    on its shard (the tp ranks of a block together), and rank 0 gets the
    whole batch's x0."""
    from acestep_torch.parallel.mesh import gather_rows

    dev = ctx.device
    B = len(seeds)
    n = B // ctx.dp
    first = ctx.dp_rank * n
    local = {k: v.to(dev) if k == "silence_latent"
             else v[first:first + n].to(dev) for k, v in inputs.items()}
    # the packed references' batch ids count from this block's first row
    local["refer_order_mask"] = local["refer_order_mask"] - first
    generators = [torch.Generator(dev).manual_seed(s)
                  for s in seeds[first:first + n]]
    sde_generator = None
    if first and kwargs["method"] == "sde":
        # the first row's generator, as it stands after its noise draw
        sde_generator = torch.Generator(dev).manual_seed(seeds[0])
        if "initial_noise" not in local:
            torch.randn((local["src_latents"].shape[1],
                         cfg.audio_acoustic_hidden_dim),
                        generator=sde_generator, device=dev, dtype=dtype)
    model = ctx.objects[key]
    x0 = call_with_weights(
        model, ctx.objects.get(key + "/weights", {}),
        lambda m: trajectory(m, cfg, local, dtype=dtype,
                             generators=generators,
                             sde_generator=sde_generator,
                             noise_rows=(B, first) if ctx.dp > 1 else None,
                             **kwargs))
    return gather_rows(ctx, x0, B)


@dataclasses.dataclass
class GenerationResult:  # noqa: D101
    audios: List[np.ndarray]              # (samples, 2) float32 each
    pred_latents: np.ndarray              # (B, T, 64)
    seeds: List[int]
    time_costs: Dict[str, float]
    sample_rate: int = SAMPLE_RATE
    audio_paths: Optional[List[str]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class AceStepHandler:
    """Service facade. Construct, `initialize_service()`, then
    `generate_music(...)`."""

    def __init__(self, dit_config: Optional[DiTConfig] = None,
                 vae_config: Optional[VAEConfig] = None,
                 dtype=torch.bfloat16, frame_bucket: int = FRAME_BUCKET,
                 min_frames: int = MIN_FRAMES,
                 refer_frames: int = REFER_FRAMES, device=None):
        self.device = resolve_device(device)
        self.cfg = dit_config or DiTConfig()
        self.vae_cfg = vae_config or VAEConfig()
        self.dtype = dtype
        self.frame_bucket = frame_bucket
        self.min_frames = min_frames
        self.refer_frames = refer_frames
        self.model = None                  # AceStepDiT
        self.quantization: Optional[str] = None
        self.vae = None                    # OobleckVAE
        self.silence_latent: Optional[np.ndarray] = None   # (1, T, 64)
        self.checkpoint_dir: Optional[str] = None
        self.text_embedder = None
        self.lora: Optional[LoraManager] = None
        self.mesh = None                   # parallel.mesh.Mesh (enable_mesh)
        self._mesh_key = f"dit-{next(_MESH_KEYS)}"
        self._seg_frames = SEG_FRAMES
        self.initialized = False
        self.tier = get_tier_config(detect_hbm_gb(self.device))
        self.progress_estimator = ProgressEstimator(
            device_key=self.device.type)

    # --------------------------------------------------------------
    # Init
    # --------------------------------------------------------------

    @torch.no_grad()
    def initialize_service(self, seed: int = 0, params=None, vae_params=None,
                           text_embedder=None, checkpoint_dir=None,
                           vae_dir=None,
                           quantization: Optional[str] = None) -> None:
        """Weights, in order of precedence:
        - `checkpoint_dir` / `vae_dir`: upstream checkpoint dirs
          (safetensors, read by utils/checkpoint.py); the DiT dir's
          `silence_latent.pt` becomes the silence latent;
        - `params` / `vae_params`: the JAX package's parameter trees as
          numpy arrays (carried across by utils/weights.py), or an
          `AceStepDiT` to use as is / an `OobleckVAE` module to share;
        - otherwise seeded random init on the device from
          `torch.Generator`s seeded `seed` (DiT) and `seed + 1` (VAE).
        With a checkpoint the text encoder is the Qwen3-Embedding trunk
        when one is found locally, else the hash embedder. Attaches a
        `LoraManager` over the DiT.

        `quantization` (int8 / fp8 / w8a8 / int4 or an alias of
        ops/quant.MODE_ALIASES) stores the DiT's weights quantized, in
        place, leaving the FSQ tokenizer and detokenizer and the VAE in
        full precision (the reference's DiT-only filter); every program
        that reads the DiT then computes from the codes."""
        if quantization:
            resolve_mode(quantization)        # reject before any load
        self.checkpoint_dir = checkpoint_dir
        silence = None
        if checkpoint_dir:
            from acestep_torch.utils.checkpoint import load_dit_checkpoint
            self.model, silence = load_dit_checkpoint(
                checkpoint_dir, self.cfg, self.device, self.dtype)
        elif isinstance(params, AceStepDiT):
            self.model = params
        elif params is not None:
            self.model = dit_from_jax(
                params, build_dit(self.cfg, self.device, self.dtype))
        else:
            gen = torch.Generator(self.device).manual_seed(seed)
            self.model = init_dit_params(self.cfg, gen, dtype=self.dtype)
        if isinstance(vae_params, OobleckVAE):
            self.vae = vae_params
        elif vae_params is not None:
            vae = OobleckVAE(self.vae_cfg, device="meta", dtype=self.dtype)
            vae = vae.to_empty(device=self.device).requires_grad_(False)
            self.vae = vae_from_jax(vae_params, vae)
        elif vae_dir:
            from acestep_torch.utils.checkpoint import load_vae_checkpoint
            self.vae = load_vae_checkpoint(vae_dir, self.vae_cfg, self.device,
                                           self.dtype)
        else:
            gen = torch.Generator(self.device).manual_seed(seed + 1)
            self.vae = init_vae_params(self.vae_cfg, gen, dtype=self.dtype)
        self.quantization = quantization
        if quantization:
            quantize_module_(self.model, quantization)
        self.silence_latent = silence if silence is not None else np.zeros(
            (1, 15360, self.cfg.audio_acoustic_hidden_dim), np.float32)
        if text_embedder is None and checkpoint_dir:
            text_embedder = self._build_qwen_embedder()
        self.text_embedder = text_embedder or HashTextEmbedder(
            dim=self.cfg.text_hidden_dim)
        self.lora = LoraManager(self.model)
        self.initialized = True
        if self.mesh is not None and not self._revive_mesh():
            self._install_mesh()

    def _build_qwen_embedder(self):
        """Qwen3-Embedding text encoder found locally: inside the
        checkpoint dir, beside it, or in the checkpoint roots
        (utils/downloads.resolve_local). None when there is none or it
        cannot load (no `transformers` for its tokenizer): the caller then
        uses the hash embedder."""
        from acestep_torch.config import LMConfig
        from acestep_torch.llm.tokenizer import load_hf_tokenizer
        from acestep_torch.pipeline.embedder import QwenTextEmbedder
        from acestep_torch.utils.checkpoint import load_lm_checkpoint
        from acestep_torch.utils.downloads import resolve_local

        name = "Qwen3-Embedding-0.6B"
        path = next((c for c in (
            os.path.join(self.checkpoint_dir, name),
            os.path.join(os.path.dirname(self.checkpoint_dir), name))
            if os.path.isdir(c)), None) or resolve_local(name)
        if path is None:
            return None
        try:
            tok = load_hf_tokenizer(path)
            cfg = LMConfig.from_checkpoint(path)
            model = load_lm_checkpoint(path, cfg, self.device, self.dtype)
        except (ImportError, OSError, ValueError, KeyError) as e:
            print(f"[acestep_torch] text encoder at {path} unavailable "
                  f"({e!r}); using the hash embedder")
            return None
        return QwenTextEmbedder(model, cfg, tok, dtype=self.dtype)

    def enable_mesh(self, dp: Optional[int] = None, tp: int = 1) -> None:
        """Shard generation over a dp x tp mesh (`parallel/mesh.py`).

        dp splits the batch (each dp rank holds the DiT whole, or its tp
        shard); tp splits attention heads and the MLP's intermediate
        features, so one song's denoising spreads over tp devices with an
        all-reduce after each row-parallel product. The mesh runs the
        generate program only (condition encoders, cross K/V, the
        sampler); text embedding, VAE decode and encode, LRC and scoring
        stay on this process's device, as in JAX. A batch pads to a
        multiple of dp with repeats of the request rows, trimmed from
        every output. The ranks are this handler's device and the other
        visible cards, with NCCL (`os.cpu_count()` CPU ranks over gloo for
        a CPU handler), or the ranks of the process's world when one
        exists (`parallel.mesh_devices`: ranks that share a card are a
        world made with gloo first); dp defaults to all of them over tp.
        A mesh that goes down (a rank failed a render) is made again, on
        a new world, before the next render."""
        from acestep_torch.parallel.mesh import mesh_devices

        if not self.initialized:
            raise RuntimeError("call initialize_service() first")
        if dp is None:
            dp = max(1, len(mesh_devices(self.device)) // tp)
        self.release_mesh()
        self._make_mesh(dp, tp)

    def _make_mesh(self, dp: int, tp: int) -> None:
        from acestep_torch.parallel.mesh import make_mesh, mesh_devices

        mesh = make_mesh(dp, tp, devices=mesh_devices(self.device))
        try:
            self.mesh = mesh
            self._install_mesh()
        except BaseException:
            self.mesh = None
            mesh.close()
            raise

    def _install_mesh(self) -> None:
        """The DiT's shards onto the mesh's ranks (at `enable_mesh` and
        after a re-initialisation)."""
        from acestep_torch.parallel.mesh import make_plan

        self._mesh_plan = make_plan(self.model, self.cfg, self.mesh.tp)
        self._mesh_weights = None
        self.mesh.install(self._mesh_key, self.model, self._mesh_plan)

    def _revive_mesh(self) -> bool:
        """Make the mesh again, on a new world, when it went down (a rank
        failed a command); True when it did, its shards installed."""
        if not self.mesh.down:
            return False
        # the new mesh is made before the old one lets its world go, so
        # the new world keeps the old one's devices and backend
        old = self.mesh
        try:
            self._make_mesh(old.dp, old.tp)
        except BaseException:
            self.mesh = old           # still down: the next render retries
            raise
        old.close()
        return True

    def _sync_mesh_weights(self) -> None:
        """Make the mesh again when it went down; send the ranks the LoRA
        manager's effective weights when they changed since the last
        render, so a mesh never renders stale adapter weights."""
        self._revive_mesh()
        weights = self.lora.effective_weights() if self.lora is not None \
            else {}
        if (weights or None) is not self._mesh_weights:
            self.mesh.send_weights(self._mesh_key, weights, self._mesh_plan)
            self._mesh_weights = weights or None

    def release_mesh(self) -> None:
        """Shut the mesh down (its followers stop with the last mesh of
        the process); the handler renders on its own device again."""
        mesh, self.mesh = self.mesh, None
        if mesh is not None:
            mesh.close()

    def get_service_status(self) -> Dict[str, Any]:
        """The JAX handler's status keys; `devices` names the handler's
        torch device (and the card's name on a CUDA device), or each rank
        of its mesh."""
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += f" {torch.cuda.get_device_name(self.device)}"
        return {
            "initialized": self.initialized,
            "model_version": self.cfg.model_version,
            "dtype": str(self.dtype).removeprefix("torch."),
            "devices": self.mesh.describe() if self.mesh is not None
            else [dev],
        }

    # --------------------------------------------------------------
    # Helpers
    # --------------------------------------------------------------

    def _silence(self, T: int) -> np.ndarray:
        """Host-side (T, 64) silence latent slice/tile."""
        sl = self.silence_latent
        if sl.shape[1] >= T:
            return sl[0, :T, :]
        reps = -(-T // sl.shape[1])
        return np.tile(sl[0], (reps, 1))[:T]

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a), device=self.device)
        if dtype is not None:
            t = t.to(dtype)
        elif t.is_floating_point():
            t = t.to(self.dtype)
        return t

    def _with_weights(self, fn):
        """`fn(model)` on the DiT with the LoRA manager's effective
        weights in place."""
        weights = self.lora.effective_weights() if self.lora is not None \
            else {}
        return call_with_weights(self.model, weights, fn)

    @staticmethod
    def _parse_code_hint(hint) -> Optional[np.ndarray]:
        """'<|audio_code_123|>...' or an int sequence -> int64 codes clamped
        to [0, 63999]; '', None and an empty sequence are no hint."""
        if hint is None or (isinstance(hint, str) and not hint.strip()):
            return None
        if isinstance(hint, str):
            vals = [int(v) for v in re.findall(r"<\|audio_code_(\d+)\|>",
                                               hint)]
        else:
            vals = [int(v) for v in hint]
        if not vals:
            return None
        return np.clip(np.asarray(vals, np.int64), 0, 63999)

    def _prepare_refer(self, refer_audios, B: int):
        """Reference audio -> packed (B, RF, 64) timbre latents + order
        arange(B). Missing rows take the silence latent; each distinct
        reference (by identity) is encoded once, 30 s of it at most
        (`_sample_reference_segments`), short encodes padded with silence.
        A silent or empty reference raises ValueError."""
        RF = self.refer_frames
        silence_ref = self._silence(RF).astype(np.float32)
        if refer_audios is None:
            packed = np.broadcast_to(
                silence_ref[None],
                (B, RF, self.cfg.audio_acoustic_hidden_dim)).copy()
            return packed, np.arange(B, dtype=np.int32)
        if isinstance(refer_audios, (str, np.ndarray)):
            refer_audios = [refer_audios]
        rows = []
        cache: Dict[int, np.ndarray] = {}
        for b in range(B):
            ra = refer_audios[b % len(refer_audios)]
            if ra is None:
                rows.append(silence_ref)
                continue
            key = id(ra)
            if key not in cache:
                if isinstance(ra, str):
                    ra = load_audio(ra)
                ra = np.asarray(ra)
                if ra.size == 0 or np.all(np.abs(ra) < 1e-6):
                    raise ValueError(
                        "Reference audio is invalid, unreadable, or "
                        "silent. Please upload a valid audible audio "
                        "file.")
                z = self.encode_audio(self._sample_reference_segments(ra))
                z = z[:RF]
                if z.shape[0] < RF:
                    z = np.concatenate([z, silence_ref[z.shape[0]:]], axis=0)
                cache[key] = z.astype(np.float32)
            rows.append(cache[key])
        return np.stack(rows), np.arange(B, dtype=np.int32)

    @staticmethod
    def _sample_reference_segments(audio: np.ndarray,
                                   budget_s: int = 30, seg_s: int = 10,
                                   sr: int = SAMPLE_RATE) -> np.ndarray:
        """30 s timbre budget: 10 s from the head, middle and tail of longer
        audio; shorter audio loops to fill the budget. The windows sit at
        fixed offsets (the JAX package's deterministic choice)."""
        n = audio.shape[0]
        budget = budget_s * sr
        if n < budget:
            reps = -(-budget // n)
            audio = np.tile(audio, (reps, 1))[:budget]
            n = audio.shape[0]
        if n <= budget:
            return audio
        seg = seg_s * sr
        mid = (n - seg) // 2
        return np.concatenate(
            [audio[:seg], audio[mid:mid + seg], audio[-seg:]], axis=0)

    # --------------------------------------------------------------
    # Encode / decode
    # --------------------------------------------------------------

    @torch.no_grad()
    def encode_audio(self, audio: np.ndarray) -> np.ndarray:
        """(samples, ch) float32 -> (T, 64) latents (the encoder's mean)
        through the tiled VAE encode. Audio pads to a frame-bucket multiple
        of hop samples, as in the JAX handler. Out of device memory, the
        window group and then the window halve and the encode retries."""
        x = np.asarray(audio, np.float32)
        hop = self.vae_cfg.hop_length
        T_real = -(-x.shape[0] // hop)
        pad = (-x.shape[0]) % (self.frame_bucket * hop)
        if pad:
            x = np.pad(x, ((0, pad), (0, 0)))
        x = self._tensor(x[None])
        chunk = min(self.tier.encode_chunk, DEFAULT_ENCODE_CHUNK)
        groups = 8
        while True:
            try:
                z = tiled_encode(self.vae, self.vae_cfg, x, chunk_size=chunk,
                                 parallel_windows=groups)
                return z[0, :T_real].float().cpu().numpy()
            except RuntimeError as e:        # the ladder re-raises the rest
                chunk, groups = _degrade_plan(e, chunk, groups, min_chunk=64)

    def _decode_plan(self, T: int) -> tuple:
        """(chunk, parallel_windows) for a T-frame decode; the tier caps
        the window."""
        chunk, groups = ((512, 8) if T > 2048 else (256, 16))
        return min(chunk, self.tier.decode_chunk), groups

    @torch.no_grad()
    def _decode_to_host(self, z: torch.Tensor, chunk: int,
                        groups: int) -> np.ndarray:
        """Tiled decode, then audio moves to the host as int16 + per-item
        peak (half the bytes of fp32) and is dequantised there. Out of
        device memory, the plan steps down the ladder and the decode
        retries."""
        while True:
            try:
                with trace.span("vae.decode", batch=int(z.shape[0]),
                                frames=int(z.shape[1])):
                    audio = tiled_decode(self.vae, self.vae_cfg,
                                         z.to(self.dtype), chunk_size=chunk,
                                         parallel_windows=groups).float()
                    peak = audio.abs().amax(dim=(1, 2), keepdim=True)
                    scale = peak.clamp_min(1e-8) / 32767.0
                    i16 = torch.clamp(torch.round(audio / scale), -32768,
                                      32767).to(torch.int16)
                    del audio
                with trace.span("vae.transfer"):
                    i16, peak = i16.cpu().numpy(), peak.cpu().numpy()
                    return i16.astype(np.float32) * (peak / 32767.0)
            except RuntimeError as e:        # the ladder re-raises the rest
                chunk, groups = _degrade_plan(e, chunk, groups)

    def decode_latents(self, latents) -> np.ndarray:
        """(B, T, 64) -> (B, samples, 2) float32. Long songs split into
        time segments, batches into item groups, as in the JAX handler."""
        z = torch.as_tensor(latents, device=self.device).float()
        B, T = z.shape[:2]
        segs = min(8, max(1, -(-T // self._seg_frames)))
        groups = 1
        if B > 1 and B * T >= self._seg_frames:
            want = min(B, -(-B * T // self._seg_frames))
            groups = max(g for g in range(1, want + 1) if B % g == 0)
        if segs > groups and segs > 1:
            return self._decode_segmented(z, segs)
        chunk, gw = self._decode_plan(T)
        g = B // groups
        return np.concatenate(
            [self._decode_to_host(z[i * g:(i + 1) * g], chunk, gw)
             for i in range(groups)], axis=0)

    def _decode_segmented(self, z: torch.Tensor, segs: int) -> np.ndarray:
        """Split the latent axis into equal segments, each with a 16-frame
        receptive-field margin on both sides, decode them one by one and
        keep each segment's core."""
        margin = DEFAULT_DECODE_OVERLAP
        B, T, _C = z.shape
        hop = self.vae_cfg.hop_length
        core = -(-T // segs)
        zp = torch.nn.functional.pad(
            z, (0, 0, margin, segs * core - T + margin))
        seg_len = core + 2 * margin
        chunk, groups = self._decode_plan(seg_len)
        parts = [self._decode_to_host(zp[:, i * core: i * core + seg_len],
                                      chunk, groups)
                 [:, margin * hop: (margin + core) * hop]
                 for i in range(segs)]
        return np.concatenate(parts, axis=1)[:, : T * hop]

    # --------------------------------------------------------------
    # Audio -> 5 Hz codes
    # --------------------------------------------------------------

    def audio_to_codes(self, audio: np.ndarray) -> str:
        """(samples, ch) -> '<|audio_code_N|>...' 5 Hz semantic codes."""
        return self.latents_to_codes(self.encode_audio(np.asarray(audio)))

    @torch.no_grad()
    def latents_to_codes(self, latents: np.ndarray) -> str:
        """(T, 64) latents, padded with silence to the pool window -> 5 Hz
        codes, through the tokenizer with the effective weights."""
        latents = np.asarray(latents)
        pad = (-latents.shape[0]) % self.cfg.pool_window_size
        if pad:
            latents = np.concatenate(
                [latents, self._silence(pad).astype(latents.dtype)], axis=0)
        z = self._tensor(latents[None])
        indices = self._with_weights(
            lambda model: audio_tokenize(model, self.cfg, z)[1])
        return "".join(f"<|audio_code_{int(i)}|>"
                       for i in indices[0].cpu().tolist())

    @torch.no_grad()
    def generate_lrc(self, pred_latents: np.ndarray, caption: str,
                     lyrics: str, *, metas=None, vocal_language: str = "en",
                     infer_steps: int = 8, seed: int = 0,
                     capture: Optional[dict] = None,
                     noise: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Lyric-timestamp LRC for a generated latent sequence.

        Re-noises x0 at t = 1/infer_steps, runs the decoder's first layers
        once capturing cross-attention on the alignment layers and heads
        (clipped to the model's), trims padded query frames, DTWs the
        lyric span of the attention and formats LRC. `noise` (B, T, 64),
        for T the bucketed frame count, replaces the draw from a generator
        seeded `seed` (the seam that lets two frameworks share it).
        Returns {lrc, sentences, tokens, score}."""
        from acestep_torch.scoring.alignment import (
            DEFAULT_CAPTURE, MusicStampsAligner)
        from acestep_torch.scoring.lyric_score import lyric_alignment_score

        cfg = self.cfg
        capture = capture or DEFAULT_CAPTURE
        capture = {layer: [h for h in heads if h < cfg.num_attention_heads]
                   or [0]
                   for layer, heads in capture.items()
                   if layer < cfg.num_hidden_layers} or {0: [0]}
        x0 = np.asarray(pred_latents, np.float32)
        if x0.ndim == 2:
            x0 = x0[None]
        T_real = x0.shape[1]
        T = _pad_frames_to(T_real, self.frame_bucket, self.min_frames)
        if T > T_real:
            x0 = np.pad(x0, ((0, 0), (0, T - T_real), (0, 0)))
        B = x0.shape[0]
        q_real = -(-T_real // cfg.patch_size)          # real query patches

        meta_strs = textlib.parse_metas([metas] if not isinstance(metas, list)
                                        else metas)
        text_prompt = textlib.build_text_prompt(
            textlib.resolve_instruction("text2music"), caption, meta_strs[0])
        lyric_prompt = textlib.format_lyrics(lyrics, vocal_language)
        text_h, text_m = self.text_embedder.encode_text([text_prompt] * B)
        lyric_h, lyric_m = self.text_embedder.encode_lyrics(
            [lyric_prompt] * B)
        token_strs = self.text_embedder.lyric_token_strings(lyric_prompt)
        lyric_len = int(np.asarray(lyric_m)[0].sum())
        refer_packed, refer_order = self._prepare_refer(None, B)
        t_small = 1.0 / max(infer_steps, 1)

        silence = self._tensor(self._silence(T)[None])
        x0_d = self._tensor(x0)
        if noise is None:
            gen = torch.Generator(self.device).manual_seed(int(seed))
            eps = torch.randn(x0_d.shape, generator=gen, device=self.device,
                              dtype=self.dtype)
        else:
            eps = self._tensor(noise)

        def capture_pass(model):
            enc, _m, ctx = prepare_condition(
                model, cfg,
                text_hidden_states=self._tensor(text_h),
                text_attention_mask=self._tensor(text_m, torch.int32),
                lyric_hidden_states=self._tensor(lyric_h),
                lyric_attention_mask=self._tensor(lyric_m, torch.int32),
                refer_audio_packed=self._tensor(refer_packed),
                refer_order_mask=self._tensor(refer_order, torch.int32),
                src_latents=silence.expand(B, T, -1),
                chunk_masks=torch.ones_like(x0_d),
                is_covers=torch.zeros((B,), dtype=torch.int32,
                                      device=self.device),
                silence_latent=silence)
            t = torch.full((B,), t_small, dtype=self.dtype,
                           device=self.device)
            xt = t_small * eps + (1.0 - t_small) * x0_d
            return dit_decoder_attn_capture(model, cfg, xt, t, t, ctx, enc,
                                            capture)

        captured = self._with_weights(capture_pass)
        # trim padded query frames so DTW only aligns real audio
        captured = {k: v[:, :, :q_real, :].cpu().numpy()
                    for k, v in captured.items()}
        aligner = MusicStampsAligner(patch_size=cfg.patch_size)
        tokens, sentences, lrc = aligner.get_timestamps_and_lrc(
            captured, token_strs[:lyric_len], lyric_len=lyric_len)
        score = lyric_alignment_score(captured, lyric_len)
        return {"lrc": lrc, "sentences": sentences, "tokens": tokens,
                "score": score}

    # --------------------------------------------------------------
    # Generation
    # --------------------------------------------------------------

    @torch.no_grad()
    def _generate_latents(self, inputs: Dict[str, torch.Tensor], *,
                          seeds: List[int], **kwargs) -> torch.Tensor:
        """`trajectory` on the DiT with the effective weights, one
        generator per row from `seeds`; under a mesh, a render command on
        its ranks."""
        if self.mesh is not None:
            self._sync_mesh_weights()
            return self.mesh.call(
                _mesh_render, self._mesh_key,
                self._mesh_plan.local_config(self.cfg), self.dtype,
                {k: v.cpu() for k, v in inputs.items()}, list(seeds),
                kwargs)
        generators = [torch.Generator(self.device).manual_seed(int(s))
                      for s in seeds]
        return self._with_weights(lambda model: trajectory(
            model, self.cfg, inputs, dtype=self.dtype,
            generators=generators, **kwargs))

    def _schedule(self, *, shift: float, infer_steps: int, timesteps,
                  cover_noise_strength: float, audio_cover_strength: float):
        """(schedule, start_t, cover_steps) by model version: turbo snaps
        to its discrete schedules (no trailing 0); sft takes the caller's
        timesteps plus a trailing 0; base (and sft without timesteps) is
        continuous. Cover noise truncates either family."""
        version = self.cfg.model_version
        if version == "turbo":
            schedule = build_turbo_schedule(shift=shift, timesteps=timesteps)
        elif version == "sft" and timesteps is not None:
            schedule = [float(t) for t in timesteps]
            if not schedule or schedule[-1] != 0.0:
                schedule = schedule + [0.0]
        else:
            schedule = build_continuous_schedule(infer_steps, shift=shift)
        start_t = None
        if cover_noise_strength > 0.0:
            schedule, start_t = truncate_for_cover_noise(
                schedule, cover_noise_strength)
        n_steps = len(schedule) if version == "turbo" else len(schedule) - 1
        cover_steps = (int(n_steps * audio_cover_strength)
                       if audio_cover_strength < 1.0 else None)
        return schedule, start_t, cover_steps, n_steps

    @trace.scoped
    def generate_music(
        self,
        captions: Union[str, Sequence[str]],
        lyrics: Union[str, Sequence[str]] = "",
        *,
        metas: Union[None, textlib.MetaLike, Sequence[textlib.MetaLike]] = None,
        task: str = "text2music",
        instructions: Union[None, str, Sequence[str]] = None,
        vocal_languages: Union[str, Sequence[str]] = "en",
        audio_duration: Optional[float] = None,
        batch_size: Optional[int] = None,
        seeds: Union[None, int, str, Sequence[int]] = None,
        use_random_seed: bool = False,
        src_audio: Union[None, str, np.ndarray] = None,
        refer_audios=None,
        audio_code_hints=None,
        repainting_start=None,
        repainting_end=None,
        audio_cover_strength: float = 1.0,
        cover_noise_strength: float = 0.0,
        infer_method: str = "ode",
        shift: float = 3.0,
        infer_steps: int = 8,
        timesteps: Optional[Sequence[float]] = None,
        guidance_scale: float = 7.0,
        use_adg: bool = False,
        cfg_interval: tuple = (0.0, 1.0),
        latent_shift: float = 0.0,
        latent_rescale: float = 1.0,
        normalize: bool = True,
        normalize_db: float = -1.0,
        save_dir: Optional[str] = None,
        audio_format: str = "wav",
        initial_noise: Optional[np.ndarray] = None,
        track_name: Optional[str] = None,
        track_classes: Optional[Sequence[str]] = None,
        progress_callback=None,
    ) -> GenerationResult:
        if not self.initialized:
            raise RuntimeError("call initialize_service() first")
        if infer_method not in ("ode", "sde"):
            raise ValueError(f"invalid infer_method {infer_method!r}: "
                             f"expected 'ode' or 'sde'")
        render = trace.begin("render")
        time_costs: Dict[str, float] = {}
        cfg = self.cfg
        C = cfg.audio_acoustic_hidden_dim

        # ---- normalize request lists
        if isinstance(captions, str):
            captions = [captions]
        B = B_req = effective_batch(batch_size or len(captions), self.tier)
        if self.mesh is not None:
            # the dp ranks split the batch evenly: pad with repeats of the
            # request rows, trimmed from every output below
            B = -(-B // self.mesh.dp) * self.mesh.dp
        if audio_duration and audio_duration > 0:
            audio_duration = effective_duration(audio_duration, self.tier)
        captions = (list(captions) * B)[:B]
        lyrics = [lyrics] * B if isinstance(lyrics, str) \
            else (list(lyrics) * B)[:B]
        if metas is None or isinstance(metas, (str, dict)):
            metas = [metas] * B
        metas = (list(metas) * B)[:B]
        if isinstance(vocal_languages, str):
            vocal_languages = [vocal_languages] * B
        vocal_languages = (list(vocal_languages) * B)[:B]
        if audio_code_hints is None or isinstance(audio_code_hints, str):
            audio_code_hints = [audio_code_hints] * B
        audio_code_hints = (list(audio_code_hints) * B)[:B]
        seeds_list = textlib.prepare_seeds(B, seeds, use_random_seed)

        # hints first: only valid codes make a request a cover (a junk hint
        # must not give an all-zero cover)
        codes_arrays = [self._parse_code_hint(h) for h in audio_code_hints]
        has_codes = any(c is not None and len(c) for c in codes_arrays)
        if not has_codes:
            codes_arrays = [None] * B
        if task == "text2music" and has_codes:
            task = "cover"
        default_instr = textlib.resolve_instruction(
            task, track_name=track_name, track_classes=track_classes)
        if isinstance(instructions, str):
            instructions = [instructions] * B
        if instructions is None:
            instructions = [default_instr] * B
        instructions = [i or default_instr
                        for i in (list(instructions) * B)[:B]]

        # ---- source audio -> latents, outpainting, frame geometry
        stage = trace.begin("render.prepare", stage=True)

        def _norm_repaint(v):
            # per-row lists; scalars broadcast; [] means no repaint
            if v is None:
                return [None] * B
            if isinstance(v, (int, float)):
                v = [float(v)]
            v = [None if x is None else float(x) for x in v]
            if not v:
                return [None] * B
            return (list(v) * B)[:B]

        rs_list = _norm_repaint(repainting_start)
        # a negative end means "to the end"
        re_list = [None if (x is not None and x < 0) else x
                   for x in _norm_repaint(repainting_end)]
        repaint_any = any(s is not None or e is not None
                          for s, e in zip(rs_list, re_list))

        if src_audio is not None and task == "text2music" \
                and not repaint_any:
            src_audio = None         # text2music does not use src_audio
        if src_audio is not None and has_codes:
            src_audio = None         # codes win over src_audio
        src_latent_single = None
        if src_audio is not None:
            if isinstance(src_audio, str):
                src_audio = load_audio(src_audio)
            src_latent_single = self.encode_audio(np.asarray(src_audio))

        if src_latent_single is not None and repaint_any:
            # outpainting: a negative start extends the song left of the
            # source, an end past it extends it right; the source pads with
            # silence latents, sized by the extremes across rows
            src_dur = src_latent_single.shape[0] / LATENT_RATE
            left_s = max((max(0.0, -(s or 0.0)) for s in rs_list),
                         default=0.0)
            right_s = max(
                (max(0.0, (e if e is not None else src_dur) - src_dur)
                 for e in re_list), default=0.0)
            left_f = int(left_s * LATENT_RATE)
            right_f = int(right_s * LATENT_RATE)
            if left_f or right_f:
                sil = np.asarray(self._silence(max(left_f, right_f)),
                                 np.float32)
                src_latent_single = np.concatenate(
                    [sil[:left_f], np.asarray(src_latent_single, np.float32),
                     sil[:right_f]], axis=0)
                # the timeline grew for every row: pin each repaint row's
                # implicit sides to its source window before shifting, so a
                # row that did not outpaint does not repaint the padding
                for i in range(B):
                    if rs_list[i] is None and re_list[i] is None:
                        continue
                    if rs_list[i] is None:
                        rs_list[i] = 0.0
                    if re_list[i] is None:
                        re_list[i] = src_dur
            if left_s > 0:
                rs_list = [None if s is None else s + left_s for s in rs_list]
                re_list = [None if e is None else e + left_s for e in re_list]

        if audio_duration and audio_duration > 0:
            T_req = int(audio_duration * LATENT_RATE)
        elif src_latent_single is not None:
            T_req = src_latent_single.shape[0]
        elif has_codes:
            T_req = max(len(c) for c in codes_arrays if c is not None) * \
                cfg.pool_window_size
        else:
            # an unspecified length draws a random 10-120 s song
            T_req = int(random.uniform(10.0, 120.0) * LATENT_RATE)
        # the tier's duration ceiling however the length was derived
        T_req = min(T_req, int(
            effective_duration(T_req / LATENT_RATE, self.tier) * LATENT_RATE))
        T = _pad_frames_to(T_req, self.frame_bucket, self.min_frames)
        silence_T = self._silence(T).astype(np.float32)
        # text2music sends only constants: a broadcast silence and ones
        plain_src = (not has_codes and src_latent_single is None
                     and not repaint_any)

        # ---- per row: target / source latents, chunk masks, spans, covers
        spans, is_cover_rows = [], []
        src_latents = chunk_masks = None
        if plain_src:
            spans = [("full", 0, T)] * B
            is_cover_rows = [_is_cover_instruction(i) for i in instructions]
        else:
            # codes win over src_audio, so a source and codes never meet
            target = silence_T
            if src_latent_single is not None:
                target = np.asarray(src_latent_single[:T], np.float32)
                if target.shape[0] < T:
                    target = np.concatenate(
                        [target, silence_T[target.shape[0]:]], axis=0)
            chunk = np.ones((B, T), np.float32)
            src_rows = []
            for i in range(B):
                is_cover_rows.append(
                    codes_arrays[i] is not None
                    or _is_cover_instruction(instructions[i]))
                rs_i, re_i = rs_list[i], re_list[i]
                if rs_i is not None or re_i is not None:
                    rs = max(0.0, rs_i if rs_i is not None else 0.0)
                    re_ = re_i if re_i is not None else T_req / LATENT_RATE
                    s_lat = int(rs * SAMPLE_RATE // VAE_HOP)
                    e_lat = int(re_ * SAMPLE_RATE // VAE_HOP)
                    s_lat = max(0, min(s_lat, T - 1))
                    e_lat = max(s_lat + 1, min(e_lat, T))
                    chunk[i] = 0.0
                    chunk[i, s_lat:e_lat] = 1.0
                    spans.append(("repainting", s_lat, e_lat))
                    row = target.copy()
                    row[s_lat:e_lat] = silence_T[s_lat:e_lat]
                    src_rows.append(row)
                    is_cover_rows[i] = False
                else:
                    spans.append(("full", 0, T))
                    src_rows.append(target)
            src_latents = np.stack(src_rows)
            if repaint_any:
                chunk_masks = np.broadcast_to(chunk[..., None],
                                              (B, T, C)).astype(np.float32)
        time_costs["prepare_time_cost"] = stage.end()

        # ---- timbre references, code matrix, text conditioning
        stage = trace.begin("render.text", stage=True)
        refer_packed, refer_order = self._prepare_refer(refer_audios, B)
        codes_inputs = {}
        if has_codes:
            T5 = T // cfg.pool_window_size
            codes_mat = np.zeros((B, T5), np.int32)
            valid_frames = np.zeros((B,), np.int32)
            for i, c in enumerate(codes_arrays):
                if c is not None:
                    n = min(len(c), T5)
                    codes_mat[i, :n] = c[:n]
                    valid_frames[i] = n * cfg.pool_window_size
            # frames past a row's real codes take the silence latent
            codes_inputs = dict(
                audio_codes=self._tensor(codes_mat, torch.int32),
                audio_codes_valid_frames=self._tensor(valid_frames,
                                                      torch.int32))
        actual_captions, actual_languages = \
            textlib.extract_caption_and_language(metas, captions,
                                                 vocal_languages)
        meta_strs = textlib.parse_metas(metas)
        text_prompts = [textlib.build_text_prompt(
            instructions[i], actual_captions[i], meta_strs[i])
            for i in range(B)]
        lyric_prompts = [textlib.format_lyrics(lyrics[i], actual_languages[i])
                         for i in range(B)]
        text_h, text_m = self.text_embedder.encode_text(text_prompts)
        lyric_h, lyric_m = self.text_embedder.encode_lyrics(lyric_prompts)
        has_non_cover = audio_cover_strength < 1.0
        if has_non_cover:
            nc_h, nc_m = self.text_embedder.encode_text([
                textlib.build_text_prompt(
                    textlib.resolve_instruction("text2music"),
                    actual_captions[i], meta_strs[i]) for i in range(B)])
            L = text_h.shape[1]                 # keep one text bucket
            if nc_h.shape[1] != L:
                nc_h = np.pad(nc_h[:, :L],
                              ((0, 0), (0, max(0, L - nc_h.shape[1])),
                               (0, 0)))
                nc_m = np.pad(nc_m[:, :L],
                              ((0, 0), (0, max(0, L - nc_m.shape[1]))))
        time_costs["text_encode_time_cost"] = stage.end()
        stage = trace.begin("render.dispatch", stage=True)

        schedule, start_t, cover_steps, n_steps = self._schedule(
            shift=shift, infer_steps=infer_steps, timesteps=timesteps,
            cover_noise_strength=cover_noise_strength,
            audio_cover_strength=audio_cover_strength)

        silence_dev = self._tensor(silence_T[None])
        inputs = dict(
            text_hidden_states=self._tensor(text_h),
            text_attention_mask=self._tensor(text_m, torch.int32),
            lyric_hidden_states=self._tensor(lyric_h),
            lyric_attention_mask=self._tensor(lyric_m, torch.int32),
            refer_audio_packed=self._tensor(refer_packed),
            refer_order_mask=self._tensor(refer_order, torch.int32),
            src_latents=(silence_dev.expand(B, T, C) if plain_src
                         else self._tensor(src_latents)),
            chunk_masks=(torch.ones((B, T, C), dtype=self.dtype,
                                    device=self.device)
                         if chunk_masks is None
                         else self._tensor(chunk_masks)),
            is_covers=self._tensor(np.asarray(is_cover_rows, np.int32),
                                   torch.int32),
            silence_latent=silence_dev,
            **codes_inputs,
        )
        if has_non_cover:
            inputs["non_cover_text_hidden_states"] = self._tensor(nc_h)
            inputs["non_cover_text_attention_mask"] = self._tensor(
                nc_m, torch.int32)
            inputs["silence_src"] = silence_dev.expand(B, T, C)
        if initial_noise is not None:
            noise_arr = np.asarray(initial_noise, np.float32)
            if noise_arr.ndim == 2:
                noise_arr = noise_arr[None]
            if noise_arr.shape[1] < T:
                noise_arr = np.pad(noise_arr, ((0, 0),
                                               (0, T - noise_arr.shape[1]),
                                               (0, 0)))
            noise_arr = noise_arr[:, :T]
            if noise_arr.shape[0] not in (1, B):
                # per-row noise cycles with the mesh's padding rows
                reps = -(-B // noise_arr.shape[0])
                noise_arr = np.tile(noise_arr, (reps, 1, 1))[:B]
            inputs["initial_noise"] = self._tensor(np.broadcast_to(
                noise_arr, (B, T, C)).copy())
        time_costs["dispatch_prep_time_cost"] = stage.end()

        # ---- trajectory
        stage = trace.begin("diffusion", stage=True, batch=B, frames=T)
        est = self.progress_estimator.estimate_seconds(
            n_steps, B, T_req / LATENT_RATE)
        with ProgressTicker(est, progress_callback or (lambda f: None)):
            x0 = self._generate_latents(
                inputs, schedule=schedule, method=infer_method,
                start_t=start_t, seeds=seeds_list,
                guidance_scale=guidance_scale, use_adg=use_adg,
                cfg_interval=cfg_interval, cover_steps=cover_steps)
            # two scalars bring the trajectory to an end on the device
            with trace.span("diffusion.sync"):
                finite = bool(torch.isfinite(x0).all())
                nonzero = bool(x0.abs().sum() > 0)
        dt = stage.end()
        time_costs["diffusion_time_cost"] = dt
        self.progress_estimator.record(n_steps, B, T_req / LATENT_RATE, dt)
        if not finite:
            raise RuntimeError("Generation produced NaN or Inf latents.")
        if x0.numel() > 0 and not nonzero:
            raise RuntimeError("Generation produced zero latents.")
        pred = x0
        if latent_shift != 0.0 or latent_rescale != 1.0:
            pred = pred * latent_rescale + latent_shift
        if B_req < B:
            # drop the mesh's padding rows before the decode
            B = B_req
            pred = pred[:B]
            seeds_list = seeds_list[:B]
            spans = spans[:B]
            is_cover_rows = is_cover_rows[:B]

        stage = trace.begin("vae", stage=True)
        audio = self.decode_latents(pred)[:, : T_req * VAE_HOP]
        time_costs["vae_decode_time_cost"] = stage.end()
        stage = trace.begin("render.fetch", stage=True)
        pred = pred.cpu().numpy()
        time_costs["latent_fetch_time_cost"] = stage.end()
        stage = trace.begin("render.postprocess", stage=True)
        audios = []
        for i in range(B):
            a = audio[i]
            if normalize and normalize_db <= 0.0:
                a = peak_normalize(a, normalize_db)
            audios.append(a)
        time_costs["postprocess_time_cost"] = stage.end()

        paths = None
        # one `save` span a song, each opening where the last closed: the
        # first holds the saver's set-up, and together they make
        # audio_conversion_time
        t_save = time.monotonic()
        if save_dir:
            saver = AudioSaver(save_dir)
            lora_sig = self.lora.signature() if self.lora is not None else ""
            paths = []
            t = t_save
            for i, a in enumerate(audios):
                stage = trace.begin("save", stage=True, t0=t,
                                    format=audio_format)
                uid = generate_uuid_from_params({
                    "caption": captions[i], "lyrics": lyrics[i],
                    "meta": meta_strs[i], "seed": seeds_list[i],
                    "task": task, "lora": lora_sig})
                paths.append(saver.save_audio(a, uid, audio_format))
                stage.end()
                t = stage.t1
            time_costs["audio_conversion_time"] = t - t_save
        render.set(batch=B, frames=T_req, format=audio_format)
        time_costs["total_time_cost"] = render.end()
        trace.count("renders")
        trace.count("songs", B)
        time_costs["dit_total_time_cost"] = (
            time_costs["total_time_cost"]
            - time_costs.get("audio_conversion_time", 0.0))
        return GenerationResult(
            audios=audios, pred_latents=pred[:, :T_req], seeds=seeds_list,
            time_costs=time_costs, audio_paths=paths,
            extra={"task": task, "spans": spans, "frames": T_req,
                   "schedule": list(schedule),
                   "is_covers": [bool(x) for x in is_cover_rows]})

    # the reference's batch-level entry (service_generate); generate_music
    # already takes batches
    service_generate = generate_music

    def warmup(self, durations: Sequence[float] = (10, 30, 60),
               batch_sizes: Sequence[int] = (1,),
               infer_steps: int = 8) -> Dict[str, float]:
        """Run one render per duration and batch size before traffic: on a
        CUDA device the first builds the kernels (ops/_build) and every
        render fills the caching allocator and cuDNN's plan cache for its
        shapes. Returns seconds per warmed shape."""
        timings: Dict[str, float] = {}
        for batch in batch_sizes:
            for duration in durations:
                t0 = time.time()
                self.generate_music(
                    ["warmup"] * batch, ["[inst]"] * batch,
                    audio_duration=float(duration), batch_size=batch,
                    seeds=list(range(batch)), infer_steps=infer_steps,
                    save_dir=None)
                timings[f"b{batch}_d{int(duration)}"] = round(
                    time.time() - t0, 2)
        return timings
