"""The LoRA runtime at inference, port against `acestep_tpu.lora`: adapter
files of every format load to the same weights in both packages, the
merged weights equal JAX's `effective_params`, a handler renders with an
adapter as the JAX handler does, and the manager's lifecycle (load,
toggle, scale, unload, signature, the merged-weights cache) holds.
Float32 on the CPU, tiny geometry (DiTConfig.tiny, 40 frames).

Tolerances: loaded factors exact (the same float32 values; BF16 files
widen exactly); merged weights 1e-6 absolute (float32 products of the
factors, summation order); the render 2e-4 on latents and 2e-4 + two
int16 grid steps on audio, as in test_torch_pipeline.py. Toggled off, the
render must equal a handler's that never loaded an adapter, bit for bit.

Writing safetensors files needs the `safetensors` package (skipped
without it); the port reads them without it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.lora import manager as jman
from acestep_tpu.models import dit as jdit
from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_torch import inference as tinf
from acestep_torch.lora import manager as tman
from acestep_torch.models import dit as tdit
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.utils.weights import dit_from_jax
from torch_parity import (highest, np_tree, port_cfg, randn, tiny_dit_cfg,
                          tiny_vae_cfg)

GEOM = dict(frame_bucket=20, min_frames=20, refer_frames=10)
L = 2                                       # the tiny decoder's layers
# (target, PEFT module path, LyCORIS module name, in, out) of the tiny DiT
TARGETS = [("self_attn.q_proj", "self_attn.q_proj", "self_attn_q_proj",
            64, 64),
           ("mlp.gate", "mlp.gate_proj", "mlp_gate_proj", 64, 128)]


def _st():
    return pytest.importorskip("safetensors.numpy")


def _peft(tmp_path, dora=False, alpha=None, rank=4):
    g = np.random.default_rng(1)
    tensors = {}
    for _, path, _, d_in, d_out in TARGETS:
        for i in range(L):
            base = f"base_model.model.layers.{i}.{path}"
            tensors[f"{base}.lora_A.weight"] = \
                g.standard_normal((rank, d_in)).astype(np.float32) * 0.2
            tensors[f"{base}.lora_B.weight"] = \
                g.standard_normal((d_out, rank)).astype(np.float32) * 0.2
            if dora:
                tensors[f"{base}.lora_magnitude_vector.weight"] = \
                    (1 + 0.1 * g.standard_normal(d_out)).astype(np.float32)
    _st().save_file(tensors, str(tmp_path / "adapter_model.safetensors"))
    if alpha is not None:
        (tmp_path / "adapter_config.json").write_text(
            json.dumps({"r": rank, "lora_alpha": alpha}))
    return str(tmp_path / "adapter_model.safetensors")


def _lokr(tmp_path, factored=False, dora=False):
    g = np.random.default_rng(2)
    tensors = {}
    for _, _, name, d_in, d_out in TARGETS:
        o1, i1 = 4 if d_out == 64 else 8, 4
        o2, i2 = d_out // o1, d_in // i1
        for i in range(L):
            base = f"lycoris_layers_{i}_{name}"
            tensors[f"{base}.lokr_w1"] = \
                g.standard_normal((o1, i1)).astype(np.float32) * 0.1
            if factored:
                tensors[f"{base}.lokr_w2_a"] = \
                    g.standard_normal((o2, 3)).astype(np.float32) * 0.1
                tensors[f"{base}.lokr_w2_b"] = \
                    g.standard_normal((3, i2)).astype(np.float32) * 0.1
            else:
                tensors[f"{base}.lokr_w2"] = \
                    g.standard_normal((o2, i2)).astype(np.float32) * 0.1
            tensors[f"{base}.alpha"] = np.asarray(6.0, np.float32)
            if dora:
                tensors[f"{base}.dora_scale"] = \
                    (1 + 0.1 * g.standard_normal((d_out, 1))).astype(
                        np.float32)
    _st().save_file(tensors, str(tmp_path / "lokr.safetensors"))
    return str(tmp_path / "lokr.safetensors")


def _npz(tmp_path):
    """A LoRA adapter saved by the JAX package, with non-zero `up`."""
    params = jdit.init_dit_params(jax.random.PRNGKey(0), tiny_dit_cfg())
    from acestep_tpu.lora import init_lora
    adapter = init_lora(jax.random.PRNGKey(3), params, rank=4, alpha=8.0)
    weights = jax.tree.map(np.asarray, adapter["weights"])
    for pair in weights.values():
        pair["up"] = randn(7, *pair["up"].shape, scale=0.05)
    jman.save_adapter(str(tmp_path / "adapter.npz"),
                      {"meta": adapter["meta"], "weights": weights})
    return str(tmp_path / "adapter.npz")


FORMATS = {
    "npz": _npz,
    "peft_sidecar": lambda p: _peft(p, alpha=32),
    "peft_no_sidecar": lambda p: _peft(p),
    "peft_dora": lambda p: _peft(p, dora=True, alpha=8),
    "lokr_full": lambda p: _lokr(p),
    "lokr_factored_dora": lambda p: _lokr(p, factored=True, dora=True),
    "directory": lambda p: (_peft(p, alpha=16), str(p))[1],
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_adapter_files_load_equal(tmp_path, fmt):
    path = FORMATS[fmt](tmp_path)
    want = jman.load_adapter_file(path)
    got = tman.load_adapter_file(path)
    assert got["meta"] == want["meta"]
    assert set(got["weights"]) == set(want["weights"])
    for name, pair in want["weights"].items():
        assert set(got["weights"][name]) == set(pair)
        for part, x in pair.items():
            np.testing.assert_array_equal(
                got["weights"][name][part].numpy(), np.asarray(x, np.float32),
                err_msg=f"{name}:{part}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_precision_files_widen(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    a = torch.randn((4, 64)).to(getattr(torch, dtype))
    b = torch.randn((64, 4)).to(getattr(torch, dtype))
    path = str(tmp_path / "adapter_model.safetensors")
    st.save_file({"m.layers.0.self_attn.q_proj.lora_A.weight": a,
                  "m.layers.0.self_attn.q_proj.lora_B.weight": b}, path)
    got = tman.load_adapter_file(path)["weights"]["self_attn.q_proj"]
    assert got["down"].dtype == torch.float32
    assert torch.equal(got["down"][0], a.float().T)
    assert torch.equal(got["up"][0], b.float().T)


def test_malformed_files_fail_loudly(tmp_path):
    st = _st()
    g = np.random.default_rng(0)
    pair = {f"b.layers.{i}.self_attn.q_proj.lora_{k}.weight":
            g.standard_normal((4, 4)).astype(np.float32)
            for i in range(2) for k in "AB"}
    cases = {
        "only 1/2 layers": {**pair,
                            "b.layers.0.self_attn.q_proj.lora_magnitude_vector"
                            ".weight": np.ones(4, np.float32)},
        "mixes PEFT": {**pair, "lycoris_layers_0_mlp_gate_proj.lokr_w1":
                       np.ones((2, 2), np.float32),
                       "lycoris_layers_0_mlp_gate_proj.lokr_w2":
                       np.ones((2, 2), np.float32)},
        "no recognizable adapter keys": {"x.y": np.ones(2, np.float32)},
    }
    for i, (msg, tensors) in enumerate(cases.items()):
        path = str(tmp_path / f"bad{i}.safetensors")
        st.save_file(tensors, path)
        for load in (jman.load_adapter_file, tman.load_adapter_file):
            with pytest.raises(ValueError, match=msg):
                load(path)
    d = tmp_path / "two"
    d.mkdir()
    st.save_file(pair, str(d / "a.safetensors"))
    st.save_file(pair, str(d / "b.safetensors"))
    with pytest.raises(ValueError, match="cannot resolve"):
        tman.load_adapter_file(str(d))


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    tmodel = dit_from_jax(jparams, tdit.build_dit(port_cfg(cfg), "cpu"))
    return jparams, tmodel


@pytest.mark.parametrize("fmt", ["npz", "peft_dora", "lokr_factored_dora",
                                 "lokr_full"])
def test_merged_weights_equal_jax_effective_params(tmp_path, models, fmt):
    jparams, tmodel = models
    path = FORMATS[fmt](tmp_path)
    jm = jman.LoraManager(jax.tree.map(jnp.asarray, jparams))
    tm = tman.LoraManager(tmodel)
    jm.load(path, scale=0.7)
    tm.load(path, scale=0.7)
    with highest():
        layers = jm.effective_params()["decoder"]["layers"]
    merged = tm.effective_weights()
    want_names = jman.load_adapter_file(path)["weights"]
    assert len(merged) == L * len(want_names)
    for name in want_names:
        node = layers
        for part in name.split("."):
            node = node[part]
        for i in range(L):
            got = merged[f"decoder.layers.{i}.{name}.weight"]
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(node["w"][i]).T, atol=1e-6)


def test_manager_lifecycle(tmp_path, models):
    """tests/test_lora.py's lifecycle and signature semantics, in the
    port's terms: no effective weights means the base model serves."""
    _, tmodel = models
    mgr = tman.LoraManager(tmodel)
    assert mgr.effective_weights() == {} and mgr.signature() == ""
    path = _npz(tmp_path)
    info = mgr.load(path, adapter_name="style_a", scale=0.7)
    assert info["adapter_name"] == "style_a" and info["kind"] == "lora"
    eff = mgr.effective_weights()
    key = "decoder.layers.0.self_attn.q_proj.weight"
    base_w = tmodel.decoder.layers[0].self_attn.q_proj.weight
    assert not torch.allclose(eff[key], base_w)
    assert mgr.effective_weights() is eff             # cached
    status = mgr.status()
    assert status["active_adapter"] == "style_a"
    assert status["adapters"][0]["scale"] == 0.7
    sig = mgr.signature()
    assert "style_a" in sig

    mgr.toggle(False)
    assert mgr.effective_weights() == {} and mgr.signature() == ""
    assert mgr._merged is None                        # the copy is dropped
    mgr.toggle(True)
    mgr.set_scale(0.5, "style_a")
    assert mgr.signature() != sig
    eff = mgr.effective_weights()
    mgr.set_scale(0.5)                                # unchanged: no rebuild
    assert mgr.effective_weights() is eff
    mgr.add("other", tman.load_adapter_file(path), scale=0.2)
    assert mgr.signature() == "other@0.2"
    eff_other = mgr.effective_weights()
    mgr.load(path, adapter_name="third")
    mgr.unload("other")                               # inactive: cache kept
    assert mgr.status()["active_adapter"] == "third"
    assert mgr.effective_weights() is not eff_other
    kept = mgr.effective_weights()
    mgr.unload("style_a")
    assert mgr.effective_weights() is kept

    mgr.set_scale(0.0)
    zero = mgr.effective_weights()
    torch.testing.assert_close(zero[key], base_w, atol=1e-7, rtol=0)
    assert mgr.unload()["unloaded"] == "third"
    assert mgr.effective_weights() == {} and mgr.unload()["unloaded"] is None
    with pytest.raises(KeyError):
        mgr.set_scale(1.0)
    np.testing.assert_array_equal(
        tmodel.decoder.layers[0].self_attn.q_proj.weight.detach().numpy(),
        models[0]["decoder"]["layers"]["self_attn"]["q_proj"]["w"][0].T)


@pytest.fixture(scope="module")
def handlers():
    jh = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    jh.initialize_service(seed=0)
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(params=np_tree(jh.params),
                          vae_params=np_tree(jh.vae_params))
    return jh, th


KW = dict(audio_duration=1.6, seeds=[4], normalize=False,
          initial_noise=randn(9, 1, 40, 64))


def test_render_with_adapter_matches_jax_handler(tmp_path, handlers):
    jh, th = handlers
    path = _npz(tmp_path)
    jh.lora.load(path, adapter_name="a", scale=0.5)
    th.lora.load(path, adapter_name="a", scale=0.5)
    try:
        with highest():
            want = jh.generate_music("adapter song", "la", **KW)
        got = th.generate_music("adapter song", "la", **KW)
        th.lora.toggle(False)
        off = th.generate_music("adapter song", "la", **KW)
    finally:
        jh.lora.unload("a")
        th.lora.unload("a")
    np.testing.assert_allclose(got.pred_latents, want.pred_latents, atol=2e-4)
    lsb = np.abs(want.audios[0]).max() / 32767.0
    np.testing.assert_allclose(got.audios[0], want.audios[0],
                               atol=2e-4 + 2 * lsb)
    assert np.abs(off.pred_latents - got.pred_latents).max() > 1e-3
    th.lora.toggle(True)


def test_toggled_off_render_is_bit_identical_to_base(tmp_path, handlers):
    jh, th = handlers
    fresh = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                           dtype=torch.float32, device="cpu", **GEOM)
    fresh.initialize_service(params=np_tree(jh.params),
                             vae_params=np_tree(jh.vae_params))
    base = fresh.generate_music("adapter song", "la", **KW)
    th.lora.load(_npz(tmp_path), adapter_name="b", scale=1.0)
    try:
        on = th.generate_music("adapter song", "la", **KW)
        th.lora.toggle(False)
        off = th.generate_music("adapter song", "la", **KW)
    finally:
        th.lora.toggle(True)
        th.lora.unload("b")
    assert not np.array_equal(on.pred_latents, base.pred_latents)
    np.testing.assert_array_equal(off.pred_latents, base.pred_latents)
    np.testing.assert_array_equal(off.audios[0], base.audios[0])


def test_facade_keys_follow_the_adapter_scale(tmp_path, handlers):
    """Two scales of one adapter give two result keys, and the params
    dict records the signature (the JAX facade's rule)."""
    _, th = handlers
    th.lora.load(_npz(tmp_path), adapter_name="c", scale=0.5)
    params = tinf.GenerationParams(caption="keyed", duration=1.6, seed=3,
                                   thinking=False)
    config = tinf.GenerationConfig(batch_size=1, output_dir=str(tmp_path))
    try:
        a = tinf.generate_music(th, None, params, config)
        th.lora.set_scale(1.0)
        b = tinf.generate_music(th, None, params, config)
        th.lora.toggle(False)
        c = tinf.generate_music(th, None, params, config)
    finally:
        th.lora.toggle(True)
        th.lora.unload("c")
    assert a.success and b.success and c.success, (a.error, b.error)
    keys = [r.audios[0]["key"] for r in (a, b, c)]
    assert len(set(keys)) == 3
    assert [r.audios[0]["params"]["lora"] for r in (a, b, c)] == \
        ["c@0.5", "c@1", ""]
