"""The port's checkpoint loading against the JAX package's converters.

Synthetic upstream state dicts (the specs of tests/test_checkpoint.py, seeded
numpy float32) are written as safetensors files, one file and sharded with
an index, and go through the port's loader; the loaded modules must equal
`dit_from_jax` / `vae_from_jax` / `lm_from_jax` of the JAX converters'
trees exactly (tolerance 0: both sides move the same float32 values). BF16
files widen exactly. Weight-norm fusion is held against `torch.nn.utils`
(1e-6: float64 norms on one side, float32 on the other). Discovery and local
checkpoint resolution are held against the JAX package's functions on the
same directory trees.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import DiTConfig, LMConfig, VAEConfig
from acestep_tpu.training import discovery as jdisc
from acestep_tpu.utils import checkpoint as jckpt
from acestep_tpu.utils import downloads as jdl
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.training import cli as tcli
from acestep_torch.training import discovery as tdisc
from acestep_torch.utils import checkpoint as tckpt
from acestep_torch.utils import downloads as tdl
from acestep_torch.utils.weights import dit_from_jax, lm_from_jax, vae_from_jax
from test_checkpoint import _dit_state_spec, _lm_state_spec, _vae_state_spec
from torch_parity import np_tree, port_cfg

st = pytest.importorskip("safetensors.numpy")

DIT = DiTConfig.tiny(fsq_dim=64)
VAE = VAEConfig.tiny(decoder_input_channels=64)
LM = LMConfig.tiny(tie_word_embeddings=False)


def _state(spec, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v).astype(np.float32)
            for k, v in spec.items()}


def _write(d, state, shards: int = 1):
    """One model.safetensors, or `shards` files named by an index."""
    os.makedirs(d, exist_ok=True)
    if shards == 1:
        st.save_file(state, os.path.join(d, "model.safetensors"))
        return d
    names = sorted(state)
    weight_map = {}
    for i in range(shards):
        part = {k: state[k] for k in names[i::shards]}
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        st.save_file(part, os.path.join(d, fname))
        weight_map.update({k: fname for k in part})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)
    return d


def _assert_equal_states(got: torch.nn.Module, want: dict):
    got = got.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("shards", [1, 3])
def test_dit_checkpoint_equals_jax_converter(tmp_path, shards):
    state = _state(_dit_state_spec(DIT), 0)
    d = _write(str(tmp_path / "dit"), state, shards)
    model, silence = tckpt.load_dit_checkpoint(d, port_cfg(DIT), "cpu",
                                               torch.float32)
    want = dit_from_jax(np_tree(jckpt.convert_dit_state(state, DIT,
                                                        dtype=jnp.float32)))
    _assert_equal_states(model, want)
    assert silence is None


@pytest.mark.parametrize("shards", [1, 2])
def test_vae_checkpoint_equals_jax_converter(tmp_path, shards):
    state = _state(_vae_state_spec(VAE), 1)
    d = _write(str(tmp_path / "vae"), state, shards)
    vae = tckpt.load_vae_checkpoint(d, port_cfg(VAE), "cpu", torch.float32)
    want = vae_from_jax(np_tree(jckpt.convert_vae_state(state, VAE,
                                                        dtype=jnp.float32)))
    _assert_equal_states(vae, want)


@pytest.mark.parametrize("tied", [False, True])
def test_lm_checkpoint_equals_jax_converter(tmp_path, tied):
    """The bare embed table and the untied lm_head map by name; a bare
    Qwen3 model (no `model.` prefix, no head) loads as the tied LM."""
    cfg = LMConfig.tiny(tie_word_embeddings=tied)
    state = _state(_lm_state_spec(cfg), 2)
    if tied:
        state = {k.removeprefix("model."): v for k, v in state.items()}
    else:
        state["lm_head.weight"] = np.random.default_rng(3).standard_normal(
            (cfg.vocab_size, cfg.hidden_size)).astype(np.float32)
    d = _write(str(tmp_path / "lm"), state, 1 if tied else 2)
    lm = tckpt.load_lm_checkpoint(d, port_cfg(cfg), "cpu", torch.float32)
    want = lm_from_jax(np_tree(jckpt.convert_lm_state(state, cfg,
                                                      dtype=jnp.float32)))
    _assert_equal_states(lm, want)
    assert ("lm_head.weight" in want) != tied
    assert torch.equal(lm.embed_tokens,
                       torch.from_numpy(state[("" if tied else "model.")
                                              + "embed_tokens.weight"]))


def test_bf16_and_integer_tensors_read_exactly(tmp_path):
    sttorch = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
               "h": torch.randn(3, generator=g).to(torch.float16),
               "i": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    path = str(tmp_path / "x.safetensors")
    sttorch.save_file(tensors, path)
    got = tckpt.read_safetensors(path)
    assert got["w"].dtype == np.float32 and got["h"].dtype == np.float32
    assert torch.equal(torch.from_numpy(got["w"]), tensors["w"].float())
    assert torch.equal(torch.from_numpy(got["h"]), tensors["h"].float())
    assert got["i"].dtype == np.int32
    np.testing.assert_array_equal(got["i"], tensors["i"].numpy())
    assert tckpt.load_safetensors_dir(path).keys() == got.keys()


@pytest.mark.parametrize("style", ["legacy", "parametrize"])
def test_weight_norm_fusion_matches_torch(style):
    torch.manual_seed(0)
    conv = torch.nn.Conv1d(3, 5, 7)
    if style == "legacy":
        wn = torch.nn.utils.weight_norm(conv)
    else:
        wn = torch.nn.utils.parametrizations.weight_norm(conv)
    state = {k: v.detach().numpy() for k, v in wn.state_dict().items()}
    fused = tckpt._fuse_weight_norm(state)
    assert set(fused) == {"weight", "bias"}
    np.testing.assert_allclose(fused["weight"], wn.weight.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(fused["weight"],
                                  jckpt._fuse_weight_norm(state)["weight"])


def _dit_ckpt(root, cfg):
    """An upstream-named DiT dir with a silence latent, and a VAE dir."""
    d = _write(str(root / "acestep-v15-turbo"), _state(_dit_state_spec(cfg), 4))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_version": "turbo"}, f)
    silence = np.random.default_rng(5).standard_normal((1, 40, 64)).astype(
        np.float32)
    torch.save(torch.from_numpy(silence), os.path.join(d, "silence_latent.pt"))
    v = _write(str(root / "vae"), _state(_vae_state_spec(VAE), 6))
    return d, v, silence


def test_initialize_service_loads_checkpoint(tmp_path):
    d, v, silence = _dit_ckpt(tmp_path, DIT)
    h = AceStepHandler(port_cfg(DIT), port_cfg(VAE), dtype=torch.float32,
                       device="cpu", frame_bucket=20, min_frames=20,
                       refer_frames=10)
    h.initialize_service(checkpoint_dir=d, vae_dir=v)
    want, _ = tckpt.load_dit_checkpoint(d, port_cfg(DIT), "cpu",
                                        torch.float32)
    _assert_equal_states(h.model, want.state_dict())
    _assert_equal_states(h.vae, tckpt.load_vae_checkpoint(
        v, port_cfg(VAE), "cpu", torch.float32).state_dict())
    np.testing.assert_array_equal(h.silence_latent, silence)
    res = h.generate_music("a song", "", audio_duration=0.8, seeds=0,
                           normalize=False)
    assert np.isfinite(res.pred_latents).all()


def test_cli_pick_and_checkpoint_dir_load(tmp_path, capsys):
    """--pick finds the model dir under --checkpoint-root, --vae-dir loads
    the VAE; the handler's weights equal the checkpoint's."""
    cfg = DiTConfig.tiny()
    d, v, _ = _dit_ckpt(tmp_path, cfg)
    args = tcli.build_parser().parse_args(
        ["preprocess", "--tiny", "--device", "cpu", "--manifest", "m.json",
         "--out-dir", str(tmp_path / "t"), "--checkpoint-root", str(tmp_path),
         "--pick", "turbo", "--vae-dir", v])
    h = tcli._build_handler(args)
    assert args.checkpoint_dir == d and "picked acestep-v15-turbo" in \
        capsys.readouterr().out
    want, _ = tckpt.load_dit_checkpoint(d, port_cfg(cfg), "cpu",
                                        torch.float32)
    _assert_equal_states(h.model, want.state_dict())
    args = tcli.build_parser().parse_args(
        ["preprocess", "--tiny", "--device", "cpu", "--manifest", "m.json",
         "--out-dir", "t", "--checkpoint-root", str(tmp_path),
         "--pick", "no-such-model-zzz"])
    with pytest.raises(SystemExit, match="no matching model"):
        tcli._build_handler(args)


def test_llm_handler_loads_checkpoint_dir(tmp_path):
    """initialize(checkpoint_dir=...) reads config.json and the weights;
    the tokenizer is passed in (the HF one needs `transformers`)."""
    state = _state(_lm_state_spec(LM), 7)
    state["lm_head.weight"] = np.zeros((LM.vocab_size, LM.hidden_size),
                                       np.float32)
    d = _write(str(tmp_path / "acestep-5Hz-lm-0.6B"), state)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({k: getattr(LM, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "head_dim", "tie_word_embeddings")}, f)
    from acestep_torch.llm.tokenizer import SimpleTokenizer
    h = LLMHandler(dtype=torch.float32, device="cpu")
    h.initialize(checkpoint_dir=d, tokenizer=SimpleTokenizer(32))
    assert h.cfg == port_cfg(LM)
    want = lm_from_jax(np_tree(jckpt.convert_lm_state(state, LM,
                                                      dtype=jnp.float32)))
    _assert_equal_states(h.engine.model, want)


# ------------------------------------------------------------------
# Discovery and local resolution, against the JAX package's functions
# ------------------------------------------------------------------


def _mk_model(root, name, config=None, weights=True):
    d = root / name
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(config or {}))
    if weights:
        (d / "model.safetensors").write_bytes(b"x")
    return d


def _tree(root):
    _mk_model(root, "acestep-v15-turbo", {"is_turbo": True})
    _mk_model(root, "acestep-v15-base", {})
    _mk_model(root, "my-finetune", {"model_version": "sft"})
    _mk_model(root, "mystery", {})
    _mk_model(root, "config-only", {}, weights=False)
    (root / "not_a_model").mkdir()
    a = root / "my-lora"
    a.mkdir()
    (a / "adapter_config.json").write_text(json.dumps({"peft_type": "LORA"}))
    (a / "adapter_model.safetensors").write_bytes(b"x")
    (root / "loose.safetensors").write_bytes(b"x")


@pytest.mark.parametrize("case", ["scan", "adapters", "fuzzy", "pick",
                                  "detect", "defaults"])
def test_discovery_matches_jax(tmp_path, case):
    _tree(tmp_path)
    root = str(tmp_path)

    def run(mod):
        if case == "scan":
            return [m.to_dict() for m in mod.scan_models(root)]
        if case == "adapters":
            return mod.scan_adapters(root)
        if case == "fuzzy":
            models = mod.scan_models(root)
            return [[m.name for m in mod.fuzzy_search(q, models)]
                    for q in ("", "turbo", "finetnue", "zzzz")]
        if case == "pick":
            return [None if m is None else m.to_dict() for m in (
                mod.pick_model(root), mod.pick_model(root, "my-finetune"),
                mod.pick_model(root, "base"), mod.pick_model(root, "qqqq"),
                mod.pick_model(str(tmp_path / "absent"), "x"))]
        if case == "detect":
            return [mod.detect_base_model(c, n) for c, n in (
                ({"model_version": "SFT"}, "x-turbo"), ({"is_turbo": True}, ""),
                ({}, "acestep-v15-base"), ({}, "zzz"))]
        return [mod.get_base_defaults(v) for v in ("turbo", "base", "sft",
                                                   "unknown")]

    assert run(tdisc) == run(jdisc)


@pytest.mark.parametrize("case", ["resolve", "empty", "partial", "manifest",
                                  "no_manifest"])
def test_local_resolution_matches_jax(tmp_path, case):
    if case == "resolve":
        _mk_model(tmp_path, "acestep-v15-turbo")
        got = tdl.resolve_local("acestep-v15-turbo", root=str(tmp_path))
        assert got == jdl.resolve_local("acestep-v15-turbo",
                                        root=str(tmp_path))
        assert got == str(tmp_path / "acestep-v15-turbo")
    elif case in ("empty", "partial"):
        d = tmp_path / "vae"
        d.mkdir()
        if case == "partial":
            (d / "config.json").write_text("{}")
        assert tdl.resolve_local("vae", root=str(tmp_path)) is None
        assert jdl.resolve_local("vae", root=str(tmp_path)) is None
    elif case == "manifest":
        d = tmp_path / "m"
        d.mkdir()
        (d / "model.safetensors").write_bytes(b"weights-v1")
        (d / "config.json").write_text("{}")
        hashes = tdl.write_manifest(str(d))
        assert list(hashes) == ["model.safetensors"]
        assert tdl.verify_checkpoint(str(d)) == []
        assert jdl.verify_checkpoint(str(d)) == []
        (d / "model.safetensors").write_bytes(b"weights-CORRUPT")
        assert tdl.verify_checkpoint(str(d)) == ["model.safetensors"]
        assert jdl.write_manifest(str(d)) == tdl.write_manifest(str(d))
    else:
        d = tmp_path / "vae"
        d.mkdir()
        (d / "model.safetensors").write_bytes(b"x")
        assert tdl.verify_checkpoint(str(d)) == []
        assert tdl.resolve_local("vae", root=str(tmp_path)) == str(d)
