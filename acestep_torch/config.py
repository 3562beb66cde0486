"""Model / runtime configuration dataclasses.

Architecture hyperparameters mirror the reference checkpoints
(reference acestep/models/turbo/configuration_acestep_v15.py:148-216)
but are plain frozen dataclasses (hashable, so they can key caches).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _default_layer_types(n: int) -> Tuple[str, ...]:
    # Alternating sliding/full, starting with sliding
    # (reference configuration_acestep_v15.py:250-255).
    return tuple(
        "sliding_attention" if (i + 1) % 2 else "full_attention" for i in range(n)
    )


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Hyperparameters for the AceStep DiT stack (turbo/base/sft share these)."""

    vocab_size: int = 64003
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    sliding_window: int = 128
    use_sliding_window: bool = True
    layer_types: Optional[Tuple[str, ...]] = None

    # Condition encoders
    num_lyric_encoder_hidden_layers: int = 8
    num_timbre_encoder_hidden_layers: int = 4
    num_attention_pooler_hidden_layers: int = 2
    text_hidden_dim: int = 1024
    timbre_hidden_dim: int = 64
    timbre_fix_frame: int = 750

    # Audio latent geometry
    audio_acoustic_hidden_dim: int = 64
    pool_window_size: int = 5
    in_channels: int = 192          # context (128) + noisy latents (64)
    patch_size: int = 2

    # FSQ tokenizer
    fsq_dim: int = 2048
    fsq_levels: Tuple[int, ...] = (8, 8, 8, 5, 5, 5)

    # Flow-matching training
    data_proportion: float = 0.5
    timestep_mu: float = -0.4
    timestep_sigma: float = 1.0

    model_version: str = "turbo"    # turbo | base | sft

    # Kept so configs built for the JAX package construct unchanged. The
    # port reads neither: on a CUDA device every decoder self-attention
    # goes through the flash kernel (ops/flash_attention.py), and the
    # layer stack is always a Python loop.
    attention_impl: str = "auto"
    unroll_layers: bool = False

    def __post_init__(self):
        if self.layer_types is None:
            object.__setattr__(
                self, "layer_types", _default_layer_types(self.num_hidden_layers)
            )

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    def layer_is_sliding(self, layer_idx: int) -> bool:
        # use_sliding_window=False disables the band globally: the
        # reference then sets sliding_window=None and every layer attends
        # fully (configuration_acestep_v15.py:196)
        if not self.use_sliding_window:
            return False
        return self.layer_types[layer_idx] == "sliding_attention"

    def layers_alternate(self) -> bool:
        """True when layer_types strictly alternate [sliding, full]* — the
        geometry the paired-scan flash path exploits."""
        return (self.num_hidden_layers % 2 == 0 and all(
            self.layer_is_sliding(i) == (i % 2 == 0)
            for i in range(self.num_hidden_layers)))

    @classmethod
    def turbo(cls, **overrides) -> "DiTConfig":
        """Flagship 8-step CFG-free model (ref models/turbo/)."""
        return cls(model_version="turbo", **overrides)

    @classmethod
    def base(cls, **overrides) -> "DiTConfig":
        """50-step continuous-schedule model with CFG/APG/ADG guidance
        (ref models/base/modeling_acestep_v15_base.py). Same architecture;
        the sampler family differs (models/sampler.sample_guided)."""
        return cls(model_version="base", **overrides)

    @classmethod
    def sft(cls, **overrides) -> "DiTConfig":
        """Base + custom-timesteps support (ref models/sft/)."""
        return cls(model_version="sft", **overrides)

    @classmethod
    def tiny(cls, **overrides) -> "DiTConfig":
        """A miniature config for CPU unit tests."""
        kw = dict(
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            num_lyric_encoder_hidden_layers=2,
            num_timbre_encoder_hidden_layers=1,
            num_attention_pooler_hidden_layers=1,
            text_hidden_dim=32,
            fsq_dim=64,
            sliding_window=8,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Oobleck audio VAE geometry.

    Field meanings follow diffusers' AutoencoderOobleck; the reference ships
    the actual values in the checkpoint's ``vae/config.json`` (see the MLX
    twin reference acestep/models/mlx/vae_model.py:236-259). ACE-Step's
    VAE runs at 48 kHz with hop 1920 (25 Hz latents), hence downsampling
    ratios with product 1920.
    """

    encoder_hidden_size: int = 128
    downsampling_ratios: Tuple[int, ...] = (2, 4, 4, 6, 10)
    channel_multiples: Tuple[int, ...] = (1, 2, 4, 8, 16)
    decoder_channels: int = 128
    decoder_input_channels: int = 64
    audio_channels: int = 2
    sampling_rate: int = 48_000

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.downsampling_ratios:
            h *= r
        return h

    @classmethod
    def tiny(cls, **overrides) -> "VAEConfig":
        kw = dict(
            encoder_hidden_size=16,
            downsampling_ratios=(2, 4),
            channel_multiples=(1, 2),
            decoder_channels=16,
            decoder_input_channels=8,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Qwen3-style causal LM config for the 5 Hz planner
    (acestep-5Hz-lm-{0.6B,1.7B,4B}) and the Qwen3-Embedding text encoder.

    Defaults are the Qwen3-0.6B geometry.
    """

    vocab_size: int = 151_936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 40_960
    is_causal: bool = True

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str) -> "LMConfig":
        """Build from an HF checkpoint's config.json (Qwen3 field names)."""
        import json
        import os

        with open(os.path.join(checkpoint_dir, "config.json")) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in fields}
        return cls(**kw)

    # Public Qwen3 geometries for the acestep-5Hz-lm family
    # (reference llm_inference.py:448-661 serves 0.6B/1.7B/4B). The planner
    # checkpoints extend the Qwen3 vocab (151936) with the 64000
    # <|audio_code_N|> tokens; `audio_vocab` adds that block.

    @classmethod
    def qwen3_0_6b(cls, audio_vocab: int = 64_000) -> "LMConfig":
        return cls(vocab_size=151_936 + audio_vocab, hidden_size=1024,
                   intermediate_size=3072, num_hidden_layers=28,
                   num_attention_heads=16, num_key_value_heads=8)

    @classmethod
    def qwen3_1_7b(cls, audio_vocab: int = 64_000) -> "LMConfig":
        return cls(vocab_size=151_936 + audio_vocab, hidden_size=2048,
                   intermediate_size=6144, num_hidden_layers=28,
                   num_attention_heads=16, num_key_value_heads=8)

    @classmethod
    def qwen3_4b(cls, audio_vocab: int = 64_000) -> "LMConfig":
        return cls(vocab_size=151_936 + audio_vocab, hidden_size=2560,
                   intermediate_size=9728, num_hidden_layers=36,
                   num_attention_heads=32, num_key_value_heads=8,
                   tie_word_embeddings=False)

    @classmethod
    def for_size(cls, size: str, audio_vocab: int = 64_000) -> "LMConfig":
        """Planner geometry by tier size string ('0.6B'|'1.7B'|'4B')."""
        table = {"0.6B": cls.qwen3_0_6b, "1.7B": cls.qwen3_1_7b,
                 "4B": cls.qwen3_4b}
        if size not in table:
            raise ValueError(f"unknown LM size {size!r}; one of {sorted(table)}")
        return table[size](audio_vocab=audio_vocab)

    @classmethod
    def tiny(cls, **overrides) -> "LMConfig":
        kw = dict(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
        )
        kw.update(overrides)
        return cls(**kw)
