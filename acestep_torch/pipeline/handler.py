"""AceStepHandler: DiT-side orchestration of turbo text2music.

Port of the text2music branch of `acestep_tpu/pipeline/handler.py`:
request normalisation, bucketed frame geometry, silence source latents and
all-ones chunk masks, silence timbre references, text conditioning, the
turbo trajectory, the segmented tiled VAE decode, the int16 + peak audio
format, normalisation and saving. PyTorch runs eagerly, so there are no
compiled programs to cache; the handler keeps its model modules on one
device.

Requests that need a later slice of the port raise NotImplementedError:
source or reference audio, audio-code hints, repainting, partial cover
strength, and the base/sft models.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from acestep_torch.config import DiTConfig, VAEConfig
from acestep_torch.constants import LATENT_RATE, SAMPLE_RATE, VAE_HOP
from acestep_torch.models.dit import build_dit, init_dit_params, prepare_condition
from acestep_torch.models.sampler import (
    ConditionSet, build_turbo_schedule, renoise, sample_turbo,
    truncate_for_cover_noise,
)
from acestep_torch.models.vae import OobleckVAE, init_vae_params
from acestep_torch.models.vae_tiled import (
    DEFAULT_DECODE_OVERLAP, DEFAULT_ENCODE_CHUNK, tiled_decode, tiled_encode,
)
from acestep_torch.pipeline import text as textlib
from acestep_torch.pipeline.embedder import HashTextEmbedder
from acestep_torch.runtime_config import (
    detect_hbm_gb, effective_batch, effective_duration, get_tier_config,
)
from acestep_torch.utils.audio import (
    AudioSaver, generate_uuid_from_params, peak_normalize,
)
from acestep_torch.utils.progress import ProgressEstimator, ProgressTicker
from acestep_torch.utils.weights import dit_from_jax, vae_from_jax

FRAME_BUCKET = 250          # 10 s of 25 Hz latents
MIN_FRAMES = 128            # latents are padded to >= 128 frames
REFER_FRAMES = 750          # 30 s timbre reference budget (timbre_fix_frame)
SEG_FRAMES = 768            # latent frames per decode segment


def _pad_frames_to(T: int, bucket: int, min_frames: int) -> int:
    T = max(T, min_frames)
    return -(-T // bucket) * bucket


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; without a GPU only an explicit
    `device="cpu"` runs (on the CPU every kernel runs its plain version)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice "
        f"of the PyTorch port (acestep_tpu has it)")


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
        self.vae = None                    # OobleckVAE
        self.silence_latent: Optional[np.ndarray] = None   # (1, T, 64)
        self.text_embedder = None
        self.lora = None
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
                           text_embedder=None) -> None:
        """Weights: `params` / `vae_params` are the JAX package's parameter
        trees as numpy arrays (carried across by utils/weights.py), or an
        `OobleckVAE` module to share; otherwise seeded random init on the
        device from `torch.Generator`s seeded `seed` (DiT) and `seed + 1`
        (VAE)."""
        if params is not None:
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
        else:
            gen = torch.Generator(self.device).manual_seed(seed + 1)
            self.vae = init_vae_params(self.vae_cfg, gen, dtype=self.dtype)
        self.silence_latent = np.zeros(
            (1, 15360, self.cfg.audio_acoustic_hidden_dim), np.float32)
        self.text_embedder = text_embedder or HashTextEmbedder(
            dim=self.cfg.text_hidden_dim)
        self.initialized = True

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

    def _prepare_refer(self, refer_audios, B: int):
        """Silence timbre references: packed (B, RF, 64) + order arange(B)."""
        if refer_audios is not None:
            raise _not_ported("reference audio (refer_audios)",
                              "cover/repaint tasks")
        RF = self.refer_frames
        silence_ref = self._silence(RF).astype(np.float32)
        packed = np.broadcast_to(
            silence_ref[None],
            (B, RF, self.cfg.audio_acoustic_hidden_dim)).copy()
        return packed, np.arange(B, dtype=np.int32)

    # --------------------------------------------------------------
    # Encode / decode
    # --------------------------------------------------------------

    @torch.no_grad()
    def encode_audio(self, audio: np.ndarray) -> np.ndarray:
        """(samples, ch) float32 -> (T, 64) latents (the encoder's mean)
        through the tiled VAE encode. Audio pads to a frame-bucket multiple
        of hop samples, as in the JAX handler; an out-of-memory error
        raises (the JAX handler's retry ladder is not ported)."""
        x = np.asarray(audio, np.float32)
        hop = self.vae_cfg.hop_length
        T_real = -(-x.shape[0] // hop)
        pad = (-x.shape[0]) % (self.frame_bucket * hop)
        if pad:
            x = np.pad(x, ((0, pad), (0, 0)))
        z = tiled_encode(self.vae, self.vae_cfg, self._tensor(x[None]),
                         chunk_size=min(self.tier.encode_chunk,
                                        DEFAULT_ENCODE_CHUNK),
                         parallel_windows=8)
        return z[0, :T_real].float().cpu().numpy()

    def _decode_plan(self, T: int) -> tuple:
        """(chunk, parallel_windows) for a T-frame decode; the tier caps
        the window."""
        chunk, groups = ((512, 8) if T > 2048 else (256, 16))
        return min(chunk, self.tier.decode_chunk), groups

    @torch.no_grad()
    def _decode_to_host(self, z: torch.Tensor, chunk: int,
                        groups: int) -> np.ndarray:
        """Tiled decode, then audio moves to the host as int16 + per-item
        peak (half the bytes of fp32) and is dequantised there."""
        audio = tiled_decode(self.vae, self.vae_cfg, z.to(self.dtype),
                             chunk_size=chunk,
                             parallel_windows=groups).float()
        peak = audio.abs().amax(dim=(1, 2), keepdim=True)
        scale = peak.clamp_min(1e-8) / 32767.0
        i16 = torch.clamp(torch.round(audio / scale), -32768, 32767).to(
            torch.int16)
        i16, peak = i16.cpu().numpy(), peak.cpu().numpy()
        return i16.astype(np.float32) * (peak / 32767.0)

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
    # Generation
    # --------------------------------------------------------------

    @torch.no_grad()
    def _generate_latents(self, inputs: Dict[str, torch.Tensor], *,
                          schedule, method: str, start_t,
                          generators: List[torch.Generator]) -> torch.Tensor:
        """Condition encode + turbo trajectory -> x0 (B, T, 64) fp32."""
        cfg = self.cfg
        enc, _m, ctx = prepare_condition(
            self.model, cfg,
            text_hidden_states=inputs["text_hidden_states"],
            text_attention_mask=inputs["text_attention_mask"],
            lyric_hidden_states=inputs["lyric_hidden_states"],
            lyric_attention_mask=inputs["lyric_attention_mask"],
            refer_audio_packed=inputs["refer_audio_packed"],
            refer_order_mask=inputs["refer_order_mask"],
            src_latents=inputs["src_latents"],
            chunk_masks=inputs["chunk_masks"],
            is_covers=inputs["is_covers"],
            silence_latent=inputs["silence_latent"])
        cond = ConditionSet.build(self.model, cfg, enc, ctx)
        B, T = inputs["src_latents"].shape[:2]
        if "initial_noise" in inputs:
            # seed-parity seam: externally supplied noise, so trajectories
            # can be compared across frameworks
            noise = inputs["initial_noise"].to(self.dtype)
        else:
            noise = torch.stack([
                torch.randn((T, cfg.audio_acoustic_hidden_dim), generator=g,
                            device=self.device, dtype=self.dtype)
                for g in generators])
        x_init = noise if start_t is None else renoise(
            inputs["src_latents"], start_t, noise)
        x0 = sample_turbo(self.model, cfg, x_init=x_init, schedule=schedule,
                          cond=cond, infer_method=method,
                          generator=generators[0])
        return x0.float()

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
        src_audio=None,
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
        if self.cfg.model_version != "turbo":
            raise _not_ported(f"the {self.cfg.model_version} model "
                              f"(guided sampler)", "guided sampler")
        if task != "text2music":
            raise _not_ported(f"task {task!r}", "cover/repaint tasks")
        if src_audio is not None:
            raise _not_ported("src_audio", "cover/repaint tasks")
        if audio_code_hints is not None and any(
                h for h in ([audio_code_hints] if isinstance(
                    audio_code_hints, str) else audio_code_hints)):
            raise _not_ported("audio_code_hints", "cover/repaint tasks")
        if repainting_start is not None or repainting_end is not None:
            raise _not_ported("repainting", "cover/repaint tasks")
        if audio_cover_strength < 1.0:
            raise _not_ported("audio_cover_strength < 1",
                              "cover/repaint tasks")
        t_start = time.time()
        time_costs: Dict[str, float] = {}
        cfg = self.cfg

        # ---- normalize request lists
        if isinstance(captions, str):
            captions = [captions]
        B = effective_batch(batch_size or len(captions), self.tier)
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
        seeds_list = textlib.prepare_seeds(B, seeds, use_random_seed)
        default_instr = textlib.resolve_instruction(
            task, track_name=track_name, track_classes=track_classes)
        if isinstance(instructions, str):
            instructions = [instructions] * B
        if instructions is None:
            instructions = [default_instr] * B
        instructions = [i or default_instr
                        for i in (list(instructions) * B)[:B]]

        # ---- frame geometry, silence source, chunk masks
        t0 = time.time()
        if audio_duration and audio_duration > 0:
            T_req = int(audio_duration * LATENT_RATE)
        else:
            # an unspecified length draws a random 10-120 s song
            T_req = int(random.uniform(10.0, 120.0) * LATENT_RATE)
        T_req = min(T_req, int(
            effective_duration(T_req / LATENT_RATE, self.tier) * LATENT_RATE))
        T = _pad_frames_to(T_req, self.frame_bucket, self.min_frames)
        silence_T = self._silence(T).astype(np.float32)
        is_cover_rows = [
            "generate audio semantic tokens" in (ins or "").lower()
            and "based on the given conditions" in (ins or "").lower()
            for ins in instructions]
        spans = [("full", 0, T)] * B
        time_costs["prepare_time_cost"] = time.time() - t0

        # ---- timbre references + text conditioning
        t0 = time.time()
        refer_packed, refer_order = self._prepare_refer(refer_audios, B)
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
        time_costs["text_encode_time_cost"] = time.time() - t0
        t0 = time.time()

        # ---- schedule
        schedule = build_turbo_schedule(shift=shift, timesteps=timesteps)
        start_t = None
        if cover_noise_strength > 0.0:
            schedule, start_t = truncate_for_cover_noise(
                schedule, cover_noise_strength)

        C = cfg.audio_acoustic_hidden_dim
        silence_dev = self._tensor(silence_T[None])
        inputs = dict(
            text_hidden_states=self._tensor(text_h),
            text_attention_mask=self._tensor(text_m, torch.int32),
            lyric_hidden_states=self._tensor(lyric_h),
            lyric_attention_mask=self._tensor(lyric_m, torch.int32),
            refer_audio_packed=self._tensor(refer_packed),
            refer_order_mask=self._tensor(refer_order, torch.int32),
            src_latents=silence_dev.expand(B, T, C),
            chunk_masks=torch.ones((B, T, C), dtype=self.dtype,
                                   device=self.device),
            is_covers=self._tensor(np.asarray(is_cover_rows, np.int32),
                                   torch.int32),
            silence_latent=silence_dev,
        )
        if initial_noise is not None:
            noise_arr = np.asarray(initial_noise, np.float32)
            if noise_arr.ndim == 2:
                noise_arr = noise_arr[None]
            if noise_arr.shape[1] < T:
                noise_arr = np.pad(noise_arr, ((0, 0),
                                               (0, T - noise_arr.shape[1]),
                                               (0, 0)))
            inputs["initial_noise"] = self._tensor(np.broadcast_to(
                noise_arr[:, :T], (B, T, C)).copy())
        generators = [torch.Generator(self.device).manual_seed(int(s))
                      for s in seeds_list]
        time_costs["dispatch_prep_time_cost"] = time.time() - t0

        # ---- trajectory
        t0 = time.time()
        n_steps = len(schedule)
        est = self.progress_estimator.estimate_seconds(
            n_steps, B, T_req / LATENT_RATE)
        with ProgressTicker(est, progress_callback or (lambda f: None)):
            x0 = self._generate_latents(inputs, schedule=schedule,
                                        method=infer_method, start_t=start_t,
                                        generators=generators)
            # two scalars bring the trajectory to an end on the device
            finite = bool(torch.isfinite(x0).all())
            nonzero = bool(x0.abs().sum() > 0)
        dt = time.time() - t0
        time_costs["diffusion_time_cost"] = dt
        self.progress_estimator.record(n_steps, B, T_req / LATENT_RATE, dt)
        if not finite:
            raise RuntimeError("Generation produced NaN or Inf latents.")
        if x0.numel() > 0 and not nonzero:
            raise RuntimeError("Generation produced zero latents.")
        pred = x0
        if latent_shift != 0.0 or latent_rescale != 1.0:
            pred = pred * latent_rescale + latent_shift

        t0 = time.time()
        audio = self.decode_latents(pred)[:, : T_req * VAE_HOP]
        time_costs["vae_decode_time_cost"] = time.time() - t0
        t0 = time.time()
        pred = pred.cpu().numpy()
        time_costs["latent_fetch_time_cost"] = time.time() - t0
        t0 = time.time()
        audios = []
        for i in range(B):
            a = audio[i]
            if normalize and normalize_db <= 0.0:
                a = peak_normalize(a, normalize_db)
            audios.append(a)
        time_costs["postprocess_time_cost"] = time.time() - t0

        paths = None
        t_save = time.time()
        if save_dir:
            saver = AudioSaver(save_dir)
            paths = []
            for i, a in enumerate(audios):
                uid = generate_uuid_from_params({
                    "caption": captions[i], "lyrics": lyrics[i],
                    "meta": meta_strs[i], "seed": seeds_list[i],
                    "task": task, "lora": ""})
                paths.append(saver.save_audio(a, uid, audio_format))
            time_costs["audio_conversion_time"] = time.time() - t_save
        time_costs["total_time_cost"] = time.time() - t_start
        time_costs["dit_total_time_cost"] = (
            time_costs["total_time_cost"]
            - time_costs.get("audio_conversion_time", 0.0))
        return GenerationResult(
            audios=audios, pred_latents=pred[:, :T_req], seeds=seeds_list,
            time_costs=time_costs, audio_paths=paths,
            extra={"task": task, "spans": spans, "frames": T_req,
                   "schedule": list(schedule),
                   "is_covers": [bool(x) for x in is_cover_rows]})
