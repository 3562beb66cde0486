"""Checkpoint loading: upstream (PyTorch/HF) checkpoints -> the port's modules.

Port of `acestep_tpu/utils/checkpoint.py`. The converters are that file's,
rewritten on numpy: each turns an upstream state dict into the JAX
package's parameter tree (stacked layer axes, (in, out) linears, (k, in,
out) convs, weight norm fused), and `utils/weights.py` carries that tree
into the port's modules exactly as it carries the JAX package's own trees.
So the map from upstream names to the port's keys is the JAX converter's
map: for example upstream `decoder.proj_in.1.weight` becomes the port's
`decoder.proj_in.weight`.

Name layouts converted:
- DiT: the AceStepConditionGenerationModel state dict
  (`decoder.layers.3.self_attn.q_proj.weight`, ...);
- VAE: diffusers AutoencoderOobleck (weight-normed convs are fused at load:
  w = g * v / ||v||, both naming styles);
- LM / text encoder: HF Qwen3ForCausalLM or the bare Qwen3 model.

safetensors files are read by a reader of its own (8-byte header length,
JSON header, raw little-endian buffers), so no `safetensors` package is
needed. BF16 widens to float32 exactly (its 16 bits are a float32's upper
half).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

# ------------------------------------------------------------------
# safetensors / torch IO
# ------------------------------------------------------------------

_ST_DTYPES = {"F16": "<f2", "F32": "<f4", "F64": "<f8", "I8": "i1",
              "U8": "u1", "I16": "<i2", "I32": "<i4", "I64": "<i8",
              "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One safetensors file -> {name: array}. Floating tensors come back as
    float32 (BF16 widened exactly, F16/F64 converted); integer and bool
    tensors keep their type."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(n)))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + int(n))
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        start, end = info["data_offsets"]
        buf, dt = data[start:end], info["dtype"]
        if dt == "BF16":
            arr = (buf.view("<u2").astype(np.uint32) << 16).view(np.float32)
        elif dt in _ST_DTYPES:
            arr = np.array(buf.view(_ST_DTYPES[dt]))
            if arr.dtype.kind == "f":
                arr = arr.astype(np.float32)
        else:
            raise ValueError(f"{path}: tensor {key} has unsupported dtype "
                             f"{dt}")
        out[key] = arr.reshape(info["shape"])
    return out


def load_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """All tensors of a HF checkpoint: one file, the shards named by
    `model.safetensors.index.json`, or every *.safetensors in a dir."""
    p = Path(path)
    if p.is_file():
        return read_safetensors(str(p))
    out: Dict[str, np.ndarray] = {}
    index = p / "model.safetensors.index.json"
    if index.exists():
        shards = set(json.loads(index.read_text())["weight_map"].values())
        for shard in sorted(shards):
            out.update(read_safetensors(str(p / shard)))
        return out
    files = sorted(p.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors under {p}")
    for f in files:
        out.update(read_safetensors(str(f)))
    return out


def load_torch_file(path: str) -> np.ndarray:
    """A single-tensor torch file (e.g. silence_latent.pt) -> float32."""
    t = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(t, dict):  # state-dict style: first value
        t = next(iter(t.values()))
    return t.float().numpy()


# ------------------------------------------------------------------
# helpers
# ------------------------------------------------------------------


def _fuse_weight_norm(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fuse torch weight_norm pairs into plain ``weight`` entries.

    Handles both legacy (weight_g/weight_v) and parametrize-style
    (parametrizations.weight.original0/original1) naming."""
    out: Dict[str, np.ndarray] = {}
    done = set()
    for name in state:
        if name.endswith("weight_g"):
            base = name[: -len("weight_g")]
            g, v = state[name], state[base + "weight_v"]
        elif name.endswith("parametrizations.weight.original0"):
            base = name[: -len("parametrizations.weight.original0")]
            g, v = state[name], state[base + "parametrizations.weight.original1"]
        else:
            continue
        norm = np.sqrt(np.sum(v.astype(np.float64) ** 2,
                              axis=tuple(range(1, v.ndim)), keepdims=True))
        out[base + "weight"] = (g * v / np.maximum(norm, 1e-12)).astype(v.dtype)
        done.add(name)
        done.add(base + ("weight_v" if name.endswith("weight_g")
                         else "parametrizations.weight.original1"))
    for name, t in state.items():
        if name not in done and name not in out:
            out[name] = t
    return out


def _f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32)


class _Src:
    """Name-indexed tensor source with access tracking."""

    def __init__(self, state: Dict[str, np.ndarray]):
        self.state = state
        self.used: set = set()

    def has(self, name: str) -> bool:
        return name in self.state

    def raw(self, name: str) -> np.ndarray:
        self.used.add(name)
        return self.state[name]

    def _with_bias(self, prefix: str, w: np.ndarray) -> dict:
        p = {"w": _f32(w)}
        if self.has(prefix + ".bias"):
            p["b"] = _f32(self.raw(prefix + ".bias"))
        return p

    def linear(self, prefix: str) -> dict:
        return self._with_bias(prefix, self.raw(prefix + ".weight").T)

    def conv1d(self, prefix: str) -> dict:
        return self._with_bias(
            prefix, self.raw(prefix + ".weight").transpose(2, 1, 0))

    def conv1d_transpose(self, prefix: str) -> dict:
        return self._with_bias(
            prefix, self.raw(prefix + ".weight").transpose(2, 0, 1))

    def norm(self, prefix: str) -> dict:
        return {"scale": _f32(self.raw(prefix + ".weight"))}

    def tensor(self, name: str, squeeze=()) -> np.ndarray:
        t = self.raw(name)
        for ax in sorted(squeeze, reverse=True):
            t = np.squeeze(t, axis=ax)
        return _f32(t)

    def unused(self):
        return sorted(set(self.state) - self.used)


def _stack_layers(n: int, make: Callable[[int], dict]) -> dict:
    """n per-layer trees -> one tree whose leaves stack on a leading axis."""
    trees = [make(i) for i in range(n)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([t[k] for t in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    return stack(trees)


# ------------------------------------------------------------------
# DiT
# ------------------------------------------------------------------


def _attn(src: _Src, pfx: str) -> dict:
    return {
        "q_proj": src.linear(f"{pfx}.q_proj"),
        "k_proj": src.linear(f"{pfx}.k_proj"),
        "v_proj": src.linear(f"{pfx}.v_proj"),
        "o_proj": src.linear(f"{pfx}.o_proj"),
        "q_norm": src.norm(f"{pfx}.q_norm"),
        "k_norm": src.norm(f"{pfx}.k_norm"),
    }


def _mlp(src: _Src, pfx: str) -> dict:
    return {
        "gate": src.linear(f"{pfx}.gate_proj"),
        "up": src.linear(f"{pfx}.up_proj"),
        "down": src.linear(f"{pfx}.down_proj"),
    }


def _encoder_layer(src: _Src, pfx: str) -> dict:
    return {
        "input_layernorm": src.norm(f"{pfx}.input_layernorm"),
        "self_attn": _attn(src, f"{pfx}.self_attn"),
        "post_attention_layernorm": src.norm(f"{pfx}.post_attention_layernorm"),
        "mlp": _mlp(src, f"{pfx}.mlp"),
    }


def _dit_layer(src: _Src, pfx: str) -> dict:
    return {
        "self_attn_norm": src.norm(f"{pfx}.self_attn_norm"),
        "self_attn": _attn(src, f"{pfx}.self_attn"),
        "cross_attn_norm": src.norm(f"{pfx}.cross_attn_norm"),
        "cross_attn": _attn(src, f"{pfx}.cross_attn"),
        "mlp_norm": src.norm(f"{pfx}.mlp_norm"),
        "mlp": _mlp(src, f"{pfx}.mlp"),
        "scale_shift_table": src.tensor(f"{pfx}.scale_shift_table", squeeze=(0,)),
    }


def _timestep_embedding(src: _Src, pfx: str) -> dict:
    return {
        "linear_1": src.linear(f"{pfx}.linear_1"),
        "linear_2": src.linear(f"{pfx}.linear_2"),
        "time_proj": src.linear(f"{pfx}.time_proj"),
    }


def _encoder_stack(src: _Src, pfx: str, n: int) -> dict:
    return {
        "embed_tokens": src.linear(f"{pfx}.embed_tokens"),
        "layers": _stack_layers(n, lambda i: _encoder_layer(src, f"{pfx}.layers.{i}")),
        "norm": src.norm(f"{pfx}.norm"),
    }


def convert_dit_state(state: Dict[str, np.ndarray], cfg,
                      strict: bool = False) -> dict:
    """Upstream DiT state dict -> the JAX `init_dit_params` tree (numpy
    float32), the input of `utils.weights.dit_from_jax`."""
    src = _Src(state)

    decoder = {
        "layers": _stack_layers(
            cfg.num_hidden_layers, lambda i: _dit_layer(src, f"decoder.layers.{i}")),
        "proj_in": src.conv1d("decoder.proj_in.1"),
        "time_embed": _timestep_embedding(src, "decoder.time_embed"),
        "time_embed_r": _timestep_embedding(src, "decoder.time_embed_r"),
        "condition_embedder": src.linear("decoder.condition_embedder"),
        "norm_out": src.norm("decoder.norm_out"),
        "proj_out": src.conv1d_transpose("decoder.proj_out.1"),
        "scale_shift_table": src.tensor("decoder.scale_shift_table", squeeze=(0,)),
    }
    encoder = {
        "text_projector": src.linear("encoder.text_projector"),
        "lyric_encoder": _encoder_stack(
            src, "encoder.lyric_encoder", cfg.num_lyric_encoder_hidden_layers),
        "timbre_encoder": {
            **_encoder_stack(src, "encoder.timbre_encoder",
                             cfg.num_timbre_encoder_hidden_layers),
            "special_token": src.tensor("encoder.timbre_encoder.special_token"),
        },
    }
    tokenizer = {
        "audio_acoustic_proj": src.linear("tokenizer.audio_acoustic_proj"),
        "pooler": {
            **_encoder_stack(src, "tokenizer.attention_pooler",
                             cfg.num_attention_pooler_hidden_layers),
            "special_token": src.tensor("tokenizer.attention_pooler.special_token"),
        },
        "fsq": {
            "project_in": src.linear("tokenizer.quantizer.layers.0.project_in"),
            "project_out": src.linear("tokenizer.quantizer.layers.0.project_out"),
        },
    }
    detokenizer = {
        **_encoder_stack(src, "detokenizer", cfg.num_attention_pooler_hidden_layers),
        "special_tokens": src.tensor("detokenizer.special_tokens", squeeze=(0,)),
        "proj_out": src.linear("detokenizer.proj_out"),
    }
    params = {
        "decoder": decoder,
        "encoder": encoder,
        "tokenizer": tokenizer,
        "detokenizer": detokenizer,
        "null_condition_emb": src.tensor("null_condition_emb"),
    }
    if strict and src.unused():
        leftover = [n for n in src.unused() if "rotary_emb" not in n]
        if leftover:
            raise ValueError(f"unconverted tensors: {leftover[:20]}")
    return params


# ------------------------------------------------------------------
# VAE (diffusers AutoencoderOobleck)
# ------------------------------------------------------------------


def _snake(src: _Src, pfx: str) -> dict:
    return {"alpha": _f32(np.reshape(src.raw(f"{pfx}.alpha"), (-1,))),
            "beta": _f32(np.reshape(src.raw(f"{pfx}.beta"), (-1,)))}


def _res_unit(src: _Src, pfx: str) -> dict:
    return {
        "snake1": _snake(src, f"{pfx}.snake1"),
        "conv1": src.conv1d(f"{pfx}.conv1"),
        "snake2": _snake(src, f"{pfx}.snake2"),
        "conv2": src.conv1d(f"{pfx}.conv2"),
    }


def convert_vae_state(state: Dict[str, np.ndarray], cfg) -> dict:
    """diffusers AutoencoderOobleck state dict -> the JAX `init_vae_params`
    tree (numpy float32)."""
    state = _fuse_weight_norm(state)
    src = _Src(state)
    n = len(cfg.downsampling_ratios)

    encoder = {
        "conv1": src.conv1d("encoder.conv1"),
        "blocks": [
            {
                "res1": _res_unit(src, f"encoder.block.{i}.res_unit1"),
                "res2": _res_unit(src, f"encoder.block.{i}.res_unit2"),
                "res3": _res_unit(src, f"encoder.block.{i}.res_unit3"),
                "snake": _snake(src, f"encoder.block.{i}.snake1"),
                "down": src.conv1d(f"encoder.block.{i}.conv1"),
            }
            for i in range(n)
        ],
        "snake": _snake(src, "encoder.snake1"),
        "conv2": src.conv1d("encoder.conv2"),
    }
    decoder = {
        "conv1": src.conv1d("decoder.conv1"),
        "blocks": [
            {
                "snake": _snake(src, f"decoder.block.{i}.snake1"),
                "up": src.conv1d_transpose(f"decoder.block.{i}.conv_t1"),
                "res1": _res_unit(src, f"decoder.block.{i}.res_unit1"),
                "res2": _res_unit(src, f"decoder.block.{i}.res_unit2"),
                "res3": _res_unit(src, f"decoder.block.{i}.res_unit3"),
            }
            for i in range(n)
        ],
        "snake": _snake(src, "decoder.snake1"),
        "conv2": src.conv1d("decoder.conv2"),
    }
    return {"encoder": encoder, "decoder": decoder}


# ------------------------------------------------------------------
# Qwen3 LM / embedding trunk
# ------------------------------------------------------------------


def convert_lm_state(state: Dict[str, np.ndarray], cfg) -> dict:
    """HF Qwen3 (ForCausalLM or bare model) -> the JAX `init_lm_params`
    tree (numpy float32)."""
    pfx = "model." if any(k.startswith("model.") for k in state) else ""
    src = _Src(state)

    def layer(i: int) -> dict:
        base = f"{pfx}layers.{i}"
        return {
            "input_layernorm": src.norm(f"{base}.input_layernorm"),
            "self_attn": _attn(src, f"{base}.self_attn"),
            "post_attention_layernorm": src.norm(f"{base}.post_attention_layernorm"),
            "mlp": _mlp(src, f"{base}.mlp"),
        }

    params = {
        "embed_tokens": src.tensor(f"{pfx}embed_tokens.weight"),
        "layers": _stack_layers(cfg.num_hidden_layers, layer),
        "norm": src.norm(f"{pfx}norm"),
    }
    if not cfg.tie_word_embeddings:
        if src.has("lm_head.weight"):
            params["lm_head"] = src.linear("lm_head")
        else:  # tied on disk even though cfg says untied
            params["lm_head"] = {"w": params["embed_tokens"].T}
    return params


# ------------------------------------------------------------------
# Top-level loaders: checkpoint dir -> module on `device` in `dtype`
# ------------------------------------------------------------------


def load_dit_checkpoint(ckpt_dir: str, cfg, device, dtype=torch.bfloat16):
    """Upstream DiT checkpoint dir -> (AceStepDiT, silence latent (1, T, 64)
    float32 or None)."""
    from acestep_torch.models.dit import build_dit
    from acestep_torch.utils.weights import dit_from_jax

    tree = convert_dit_state(load_safetensors_dir(ckpt_dir), cfg)
    model = dit_from_jax(tree, build_dit(cfg, device, dtype))
    silence: Optional[np.ndarray] = None
    sp = Path(ckpt_dir) / "silence_latent.pt"
    if sp.exists():
        silence = load_torch_file(str(sp)).astype(np.float32)
    return model, silence


def load_vae_checkpoint(ckpt_dir: str, cfg, device, dtype=torch.bfloat16):
    """diffusers Oobleck VAE checkpoint dir -> OobleckVAE."""
    from acestep_torch.models.vae import OobleckVAE
    from acestep_torch.utils.weights import vae_from_jax

    vae = OobleckVAE(cfg, device="meta", dtype=dtype)
    vae = vae.to_empty(device=device).requires_grad_(False)
    return vae_from_jax(convert_vae_state(load_safetensors_dir(ckpt_dir), cfg),
                        vae)


def load_lm_checkpoint(ckpt_dir: str, cfg, device, dtype=torch.bfloat16):
    """HF Qwen3 checkpoint dir -> QwenLM."""
    from acestep_torch.models.lm import build_lm
    from acestep_torch.utils.weights import lm_from_jax

    return lm_from_jax(convert_lm_state(load_safetensors_dir(ckpt_dir), cfg),
                       build_lm(cfg, device, dtype))
