"""One-command real-checkpoint parity harness: the PyTorch port
(acestep_torch) against its reference, the JAX package (acestep_tpu).

The counterpart of scripts/parity_real.py. Both packages load the same
upstream checkpoint files, each through its own loader (`acestep_tpu.
utils.checkpoint`'s converters; `acestep_torch.utils.checkpoint`'s
`load_dit_checkpoint` and its VAE and LM siblings), in float32 on the CPU
on both sides (JAX products at full float32 precision), and the harness
reports each module's max error on the same seeded inputs:
- the condition encoder (`prepare_condition`: encoder states and context
  latents);
- one decoder step (`dit_decoder`);
- a short VAE decode (with `--vae-dir`);
- the LM's logits on a prompt (with `--lm-dir`);
and a seeded turbo request end to end through both handlers, the same
noise passed through their `initial_noise` seam (the predicted latents;
the audio too with `--vae-dir`, since without one each handler draws its
own VAE).

    python scripts/parity_real_torch.py --checkpoint-dir \
        checkpoints/acestep-v15-turbo --vae-dir checkpoints/vae \
        --lm-dir checkpoints/acestep-5Hz-lm-0.6B
    python scripts/parity_real_torch.py --synthetic      # no weights needed

Each error is relative to the largest magnitude of the JAX result; the run
exits 1 when any exceeds `--tol`. It exits 0 with a SKIP line when the
checkpoint directory is absent or the `safetensors` package is missing.
`--synthetic` writes a seeded upstream-named checkpoint at tiny geometry
(the DiT in two shards named by an index, the VAE and the LM in one file
each, config.json files and a silence latent) and runs the same
real-checkpoint path over it. The machine needs both packages, so this
runs on the CPU; the card's machine has no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _skip(msg: str) -> int:
    print(f"parity_real_torch: SKIP — {msg}")
    return 0


def _jax():
    """JAX on the CPU backend (set before the first backend use)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _config(cls, ckpt_dir):
    """`cls` (a DiTConfig or VAEConfig of either package) from the
    checkpoint's config.json fields it knows; its defaults without one."""
    path = os.path.join(ckpt_dir, "config.json")
    raw = {}
    if os.path.isfile(path):
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items() if k in fields})


# ------------------------------------------------------------------
# --synthetic: a seeded upstream-named checkpoint at tiny geometry
# (the key specs of the JAX package's checkpoint tests)
# ------------------------------------------------------------------


def _dit_state_spec(cfg) -> dict:
    h, hd = cfg.hidden_size, cfg.head_dim
    q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    inter = cfg.intermediate_size
    spec = {}

    def attn(p):
        spec[f"{p}.q_proj.weight"] = (q, h)
        spec[f"{p}.k_proj.weight"] = (kv, h)
        spec[f"{p}.v_proj.weight"] = (kv, h)
        spec[f"{p}.o_proj.weight"] = (h, q)
        spec[f"{p}.q_norm.weight"] = (hd,)
        spec[f"{p}.k_norm.weight"] = (hd,)

    def mlp(p):
        spec[f"{p}.gate_proj.weight"] = (inter, h)
        spec[f"{p}.up_proj.weight"] = (inter, h)
        spec[f"{p}.down_proj.weight"] = (h, inter)

    def enc_layer(p):
        attn(f"{p}.self_attn")
        mlp(f"{p}.mlp")
        spec[f"{p}.input_layernorm.weight"] = (h,)
        spec[f"{p}.post_attention_layernorm.weight"] = (h,)

    for i in range(cfg.num_hidden_layers):
        p = f"decoder.layers.{i}"
        attn(f"{p}.self_attn")
        attn(f"{p}.cross_attn")
        mlp(f"{p}.mlp")
        for nm in ["self_attn_norm", "cross_attn_norm", "mlp_norm"]:
            spec[f"{p}.{nm}.weight"] = (h,)
        spec[f"{p}.scale_shift_table"] = (1, 6, h)
    spec["decoder.proj_in.1.weight"] = (h, cfg.in_channels, cfg.patch_size)
    spec["decoder.proj_in.1.bias"] = (h,)
    spec["decoder.proj_out.1.weight"] = (h, cfg.audio_acoustic_hidden_dim,
                                         cfg.patch_size)
    spec["decoder.proj_out.1.bias"] = (cfg.audio_acoustic_hidden_dim,)
    for te in ["time_embed", "time_embed_r"]:
        spec[f"decoder.{te}.linear_1.weight"] = (h, 256)
        spec[f"decoder.{te}.linear_1.bias"] = (h,)
        spec[f"decoder.{te}.linear_2.weight"] = (h, h)
        spec[f"decoder.{te}.linear_2.bias"] = (h,)
        spec[f"decoder.{te}.time_proj.weight"] = (6 * h, h)
        spec[f"decoder.{te}.time_proj.bias"] = (6 * h,)
    spec["decoder.condition_embedder.weight"] = (h, h)
    spec["decoder.condition_embedder.bias"] = (h,)
    spec["decoder.norm_out.weight"] = (h,)
    spec["decoder.scale_shift_table"] = (1, 2, h)

    spec["encoder.text_projector.weight"] = (h, cfg.text_hidden_dim)
    spec["encoder.lyric_encoder.embed_tokens.weight"] = (h,
                                                         cfg.text_hidden_dim)
    spec["encoder.lyric_encoder.embed_tokens.bias"] = (h,)
    spec["encoder.lyric_encoder.norm.weight"] = (h,)
    for i in range(cfg.num_lyric_encoder_hidden_layers):
        enc_layer(f"encoder.lyric_encoder.layers.{i}")
    spec["encoder.timbre_encoder.embed_tokens.weight"] = (
        h, cfg.timbre_hidden_dim)
    spec["encoder.timbre_encoder.embed_tokens.bias"] = (h,)
    spec["encoder.timbre_encoder.norm.weight"] = (h,)
    spec["encoder.timbre_encoder.special_token"] = (1, 1, h)
    for i in range(cfg.num_timbre_encoder_hidden_layers):
        enc_layer(f"encoder.timbre_encoder.layers.{i}")

    spec["tokenizer.audio_acoustic_proj.weight"] = (
        h, cfg.audio_acoustic_hidden_dim)
    spec["tokenizer.audio_acoustic_proj.bias"] = (h,)
    spec["tokenizer.attention_pooler.embed_tokens.weight"] = (h, h)
    spec["tokenizer.attention_pooler.embed_tokens.bias"] = (h,)
    spec["tokenizer.attention_pooler.norm.weight"] = (h,)
    spec["tokenizer.attention_pooler.special_token"] = (1, 1, h)
    for i in range(cfg.num_attention_pooler_hidden_layers):
        enc_layer(f"tokenizer.attention_pooler.layers.{i}")
    klev = len(cfg.fsq_levels)
    spec["tokenizer.quantizer.layers.0.project_in.weight"] = (klev,
                                                              cfg.fsq_dim)
    spec["tokenizer.quantizer.layers.0.project_in.bias"] = (klev,)
    spec["tokenizer.quantizer.layers.0.project_out.weight"] = (cfg.fsq_dim,
                                                               klev)
    spec["tokenizer.quantizer.layers.0.project_out.bias"] = (cfg.fsq_dim,)

    spec["detokenizer.embed_tokens.weight"] = (h, h)
    spec["detokenizer.embed_tokens.bias"] = (h,)
    spec["detokenizer.norm.weight"] = (h,)
    spec["detokenizer.special_tokens"] = (1, cfg.pool_window_size, h)
    spec["detokenizer.proj_out.weight"] = (cfg.audio_acoustic_hidden_dim, h)
    spec["detokenizer.proj_out.bias"] = (cfg.audio_acoustic_hidden_dim,)
    for i in range(cfg.num_attention_pooler_hidden_layers):
        enc_layer(f"detokenizer.layers.{i}")

    spec["null_condition_emb"] = (1, 1, h)
    return spec


def _vae_state_spec(cfg) -> dict:
    cm = [1] + list(cfg.channel_multiples)
    h = cfg.encoder_hidden_size
    n = len(cfg.downsampling_ratios)
    spec = {}

    def snake(p, c):
        spec[f"{p}.alpha"] = (1, c, 1)
        spec[f"{p}.beta"] = (1, c, 1)

    def res(p, c):
        snake(f"{p}.snake1", c)
        spec[f"{p}.conv1.weight"] = (c, c, 7)
        spec[f"{p}.conv1.bias"] = (c,)
        snake(f"{p}.snake2", c)
        spec[f"{p}.conv2.weight"] = (c, c, 1)
        spec[f"{p}.conv2.bias"] = (c,)

    spec["encoder.conv1.weight"] = (h, cfg.audio_channels, 7)
    spec["encoder.conv1.bias"] = (h,)
    for i, s in enumerate(cfg.downsampling_ratios):
        cin, cout = h * cm[i], h * cm[i + 1]
        for r in ["res_unit1", "res_unit2", "res_unit3"]:
            res(f"encoder.block.{i}.{r}", cin)
        snake(f"encoder.block.{i}.snake1", cin)
        spec[f"encoder.block.{i}.conv1.weight"] = (cout, cin, 2 * s)
        spec[f"encoder.block.{i}.conv1.bias"] = (cout,)
    snake("encoder.snake1", h * cm[-1])
    spec["encoder.conv2.weight"] = (2 * cfg.decoder_input_channels,
                                    h * cm[-1], 3)
    spec["encoder.conv2.bias"] = (2 * cfg.decoder_input_channels,)

    d = cfg.decoder_channels
    up = list(cfg.downsampling_ratios)[::-1]
    spec["decoder.conv1.weight"] = (d * cm[-1], cfg.decoder_input_channels, 7)
    spec["decoder.conv1.bias"] = (d * cm[-1],)
    for i, s in enumerate(up):
        cin, cout = d * cm[n - i], d * cm[n - i - 1]
        snake(f"decoder.block.{i}.snake1", cin)
        spec[f"decoder.block.{i}.conv_t1.weight"] = (cin, cout, 2 * s)
        spec[f"decoder.block.{i}.conv_t1.bias"] = (cout,)
        for r in ["res_unit1", "res_unit2", "res_unit3"]:
            res(f"decoder.block.{i}.{r}", cout)
    snake("decoder.snake1", d)
    spec["decoder.conv2.weight"] = (cfg.audio_channels, d, 7)
    return spec


def _lm_state_spec(cfg) -> dict:
    h, hd = cfg.hidden_size, cfg.head_dim
    q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    spec = {"model.embed_tokens.weight": (cfg.vocab_size, h),
            "model.norm.weight": (h,)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        spec[f"{p}.self_attn.q_proj.weight"] = (q, h)
        spec[f"{p}.self_attn.k_proj.weight"] = (kv, h)
        spec[f"{p}.self_attn.v_proj.weight"] = (kv, h)
        spec[f"{p}.self_attn.o_proj.weight"] = (h, q)
        spec[f"{p}.self_attn.q_norm.weight"] = (hd,)
        spec[f"{p}.self_attn.k_norm.weight"] = (hd,)
        spec[f"{p}.input_layernorm.weight"] = (h,)
        spec[f"{p}.post_attention_layernorm.weight"] = (h,)
        spec[f"{p}.mlp.gate_proj.weight"] = (cfg.intermediate_size, h)
        spec[f"{p}.mlp.up_proj.weight"] = (cfg.intermediate_size, h)
        spec[f"{p}.mlp.down_proj.weight"] = (h, cfg.intermediate_size)
    if not cfg.tie_word_embeddings:
        spec["lm_head.weight"] = (cfg.vocab_size, h)
    return spec


def _write_checkpoint(d: str, spec: dict, cfg, seed: int, scale: float,
                      shards: int = 1) -> None:
    """Seeded float32 tensors of `spec` as safetensors (one file, or
    `shards` files named by an index) and `cfg` as config.json."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    state = {k: (scale * rng.standard_normal(v)).astype(np.float32)
             for k, v in spec.items()}
    os.makedirs(d, exist_ok=True)
    if shards == 1:
        save_file(state, os.path.join(d, "model.safetensors"))
    else:
        names = sorted(state)
        weight_map = {}
        for i in range(shards):
            part = {k: state[k] for k in names[i::shards]}
            fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
            save_file(part, os.path.join(d, fname))
            weight_map.update({k: fname for k in part})
        with open(os.path.join(d, "model.safetensors.index.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"weight_map": weight_map}, f)
    raw = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(cfg).items()
           if k not in ("attention_impl", "unroll_layers")}
    with open(os.path.join(d, "config.json"), "w", encoding="utf-8") as f:
        json.dump(raw, f)


def make_synthetic_checkpoint(out_dir: str, seed: int) -> dict:
    """The DiT (two shards, silence latent), VAE and LM directories of a
    tiny seeded checkpoint under `out_dir`; returns their paths."""
    import torch

    from acestep_torch.config import DiTConfig, LMConfig, VAEConfig

    dit_cfg = DiTConfig.tiny(fsq_dim=64)
    vae_cfg = VAEConfig.tiny(decoder_input_channels=64)
    lm_cfg = LMConfig.tiny(tie_word_embeddings=False)
    dirs = {k: os.path.join(out_dir, k) for k in ("dit", "vae", "lm")}
    # weights at a scale that keeps activations O(1) through the layers
    _write_checkpoint(dirs["dit"], _dit_state_spec(dit_cfg), dit_cfg, seed,
                      0.05, shards=2)
    _write_checkpoint(dirs["vae"], _vae_state_spec(vae_cfg), vae_cfg,
                      seed + 1, 0.1)
    _write_checkpoint(dirs["lm"], _lm_state_spec(lm_cfg), lm_cfg, seed + 2,
                      0.05)
    g = torch.Generator().manual_seed(seed + 3)
    torch.save(0.1 * torch.randn((1, 750, dit_cfg.audio_acoustic_hidden_dim),
                                 generator=g),
               os.path.join(dirs["dit"], "silence_latent.pt"))
    return dirs


# ------------------------------------------------------------------
# the comparison
# ------------------------------------------------------------------


def _err(results: dict, name: str, got, want) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"{name}: shape {got.shape} against {want.shape}")
    scale = max(1e-6, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    results[name] = {"max_abs_err": err, "scale": scale, "rel": err / scale}
    print(f"parity_real_torch: {name} max err {err:.3e} (scale "
          f"{scale:.3f}, rel {err / scale:.3e})")


def _cond_inputs(rng, cfg, B: int, T: int) -> dict:
    """Seeded condition-encoder inputs: padding in every mask, row 0 a
    cover row (its source goes through the FSQ tokenizer)."""
    def randn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    Lt, Ll, Rf = 8, 16, 10
    text_m = np.ones((B, Lt), np.int32)
    text_m[-1, 5:] = 0
    lyric_m = np.ones((B, Ll), np.int32)
    lyric_m[0, 12:] = 0
    H = cfg.audio_acoustic_hidden_dim
    return dict(
        text_hidden_states=randn(B, Lt, cfg.text_hidden_dim),
        text_attention_mask=text_m,
        lyric_hidden_states=randn(B, Ll, cfg.text_hidden_dim),
        lyric_attention_mask=lyric_m,
        refer_audio_packed=randn(B, Rf, cfg.timbre_hidden_dim, scale=0.5),
        refer_order_mask=np.arange(B, dtype=np.int32),
        src_latents=randn(B, T, H, scale=0.5),
        chunk_masks=np.ones((B, T, H), np.float32),
        is_covers=(np.arange(B) == 0).astype(np.int32),
        silence_latent=randn(1, T + cfg.pool_window_size, H, scale=0.1),
    )


def run_parity(ckpt_dir: str, vae_dir, lm_dir, seconds: float, seed: int,
               tol: float) -> int:
    jax = _jax()
    import jax.numpy as jnp
    import torch

    from acestep_torch import config as tconfig
    from acestep_torch.models import dit as tdit
    from acestep_torch.models import lm as tlm
    from acestep_torch.models import vae as tvae
    from acestep_torch.pipeline.handler import AceStepHandler
    from acestep_torch.utils import checkpoint as tckpt
    from acestep_tpu import config as jconfig
    from acestep_tpu.models import dit as jdit
    from acestep_tpu.models import lm as jlm
    from acestep_tpu.models import vae as jvae
    from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
    from acestep_tpu.utils import checkpoint as jckpt

    highest = lambda: jax.default_matmul_precision("highest")  # noqa: E731
    jcfg = _config(jconfig.DiTConfig, ckpt_dir)
    tcfg = _config(tconfig.DiTConfig, ckpt_dir)
    jvcfg = _config(jconfig.VAEConfig, vae_dir) if vae_dir \
        else jconfig.VAEConfig()
    tvcfg = _config(tconfig.VAEConfig, vae_dir) if vae_dir \
        else tconfig.VAEConfig()
    print(f"parity_real_torch: loading {ckpt_dir} (hidden "
          f"{tcfg.hidden_size}, layers {tcfg.num_hidden_layers}), VAE "
          f"{vae_dir or 'not given (each side draws its own)'}, LM "
          f"{lm_dir or 'not given'}")

    # both handlers load through their packages' real-checkpoint path
    jh = JaxHandler(jcfg, jvcfg, dtype=jnp.float32)
    jh.initialize_service(checkpoint_dir=ckpt_dir, vae_dir=vae_dir)
    th = AceStepHandler(tcfg, tvcfg, dtype=torch.float32, device="cpu")
    th.initialize_service(checkpoint_dir=ckpt_dir, vae_dir=vae_dir)

    results: dict = {}
    rng = np.random.default_rng(seed)
    B, T = 2, int(seconds * 25)
    H = tcfg.audio_acoustic_hidden_dim

    # ---- the condition encoder
    inputs = _cond_inputs(rng, tcfg, B, T)
    with torch.no_grad():
        tenc, _tm, tctx = tdit.prepare_condition(
            th.model, tcfg, **{k: torch.from_numpy(v)
                               for k, v in inputs.items()})
    with highest():
        jenc, _jm, jctx = jdit.prepare_condition(
            jh.params, jcfg, **{k: jnp.asarray(v) for k, v in inputs.items()})
    _err(results, "condition_encoder_states", tenc.numpy(), jenc)
    _err(results, "condition_context_latents", tctx.numpy(), jctx)

    # ---- one decoder step
    xt = rng.standard_normal((B, T, H)).astype(np.float32)
    ctx = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    enc = rng.standard_normal((B, 32, tcfg.hidden_size)).astype(np.float32)
    tv = np.asarray([0.7, 0.3], np.float32)
    with torch.no_grad():
        got = tdit.dit_decoder(
            th.model, tcfg, torch.from_numpy(xt), torch.from_numpy(tv),
            torch.from_numpy(tv), torch.from_numpy(ctx),
            encoder_hidden_states=torch.from_numpy(enc))
    with highest():
        want = jdit.dit_decoder(
            jh.params, jcfg, jnp.asarray(xt), jnp.asarray(tv),
            jnp.asarray(tv), jnp.asarray(ctx),
            encoder_hidden_states=jnp.asarray(enc))
    _err(results, "decoder_step", got.numpy(), want)

    # ---- a short VAE decode (1 s of latents)
    if vae_dir:
        z = rng.standard_normal(
            (1, min(T, 25), tvcfg.decoder_input_channels)).astype(np.float32)
        with torch.no_grad():
            got = tvae.vae_decode(th.vae, tvcfg, torch.from_numpy(z))
        with highest():
            want = jvae.vae_decode(jh.vae_params, jvcfg, jnp.asarray(z))
        _err(results, "vae_decode", got.numpy(), want)

    # ---- the LM's logits on a prompt
    if lm_dir:
        jlcfg = jconfig.LMConfig.from_checkpoint(lm_dir)
        tlcfg = tconfig.LMConfig.from_checkpoint(lm_dir)
        jparams = jckpt.load_lm_checkpoint(lm_dir, jlcfg, dtype=jnp.float32)
        tmodel = tckpt.load_lm_checkpoint(lm_dir, tlcfg, "cpu", torch.float32)
        ids = rng.integers(1, tlcfg.vocab_size, (1, 32)).astype(np.int32)
        with torch.no_grad():
            cache = tlm.KVCache.create(tlcfg, 1, ids.shape[1],
                                       dtype=torch.float32)
            h = tlm.lm_forward(tmodel, tlcfg, torch.from_numpy(ids).long(),
                               cache, start_pos=torch.as_tensor(0))
            got = tlm.lm_logits(tmodel, tlcfg, h)
        with highest():
            jcache = jlm.KVCache.create(jlcfg, 1, ids.shape[1],
                                        dtype=jnp.float32)
            jh_, _ = jlm.lm_forward(jparams, jlcfg, jnp.asarray(ids), jcache,
                                    start_pos=jnp.asarray(0, jnp.int32))
            want = jlm.lm_logits(jparams, jlcfg, jh_)
        _err(results, "lm_logits", got.numpy(), want)
        del jparams, tmodel

    # ---- a seeded turbo request end to end, the same noise on both sides
    frames = -(-max(T, th.min_frames) // th.frame_bucket) * th.frame_bucket
    noise = rng.standard_normal((1, frames, H)).astype(np.float32)
    kw = dict(audio_duration=seconds, seeds=[seed], infer_steps=8,
              initial_noise=noise, metas={"bpm": 100, "duration": seconds})
    caption, lyrics = "an upbeat synthpop track", "[verse]\nparity check"
    with highest():
        want = jh.generate_music(caption, lyrics, **kw)
    got = th.generate_music(caption, lyrics, **kw)
    _err(results, f"turbo_{seconds:g}s_latents", got.pred_latents,
         want.pred_latents)
    if vae_dir:
        _err(results, f"turbo_{seconds:g}s_audio", got.audios[0],
             want.audios[0])

    ok = all(r["rel"] <= tol for r in results.values())
    print(json.dumps({"ok": ok, "tol": tol, **{k: r["rel"] for k, r in
                                               results.items()}}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint-dir",
                    default="checkpoints/acestep-v15-turbo")
    ap.add_argument("--vae-dir", default=None,
                    help="the VAE checkpoint dir (its decode and the "
                         "request's audio are compared only with one)")
    ap.add_argument("--lm-dir", default=None,
                    help="a 5 Hz planner checkpoint dir (its logits are "
                         "compared only with one)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tol", type=float, default=2e-2,
                    help="relative tolerance on each check")
    ap.add_argument("--synthetic", action="store_true",
                    help="write a seeded tiny checkpoint and run the real "
                         "path over it (no weights needed)")
    args = ap.parse_args(argv)

    try:
        import safetensors  # noqa: F401
    except ImportError:
        return _skip("the safetensors package is missing")
    if args.synthetic:
        with tempfile.TemporaryDirectory(
                prefix="acestep_parity_torch_") as tmp:
            dirs = make_synthetic_checkpoint(tmp, args.seed)
            print(f"parity_real_torch: synthetic checkpoint at {tmp}")
            return run_parity(dirs["dit"], dirs["vae"], dirs["lm"],
                              args.seconds, args.seed, args.tol)
    if not os.path.isdir(args.checkpoint_dir):
        return _skip(f"checkpoint dir {args.checkpoint_dir} not found — "
                     "run acestep-torch-download first")
    return run_parity(args.checkpoint_dir, args.vae_dir, args.lm_dir,
                      args.seconds, args.seed, args.tol)


if __name__ == "__main__":
    sys.exit(main())
