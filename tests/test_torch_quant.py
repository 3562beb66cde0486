"""The port's weight quantization (ops/quant.py) against the JAX package's,
on the CPU: the same seeded numpy weights through both.

- Codes and scales are compared bit for bit (fp8 as its bytes, int4 as
  the packed nibbles): both quantize from the same float32 weights with
  the same float32 divisions and round-half-even.
- Dequantized weights are bit-equal (the same float32 products).
- `w8a8_matmul` on identical inputs is exact: the int32 sums are exact and
  the float32 scale products are taken in the same order.
- Model-level comparisons run float32 on both sides (JAX at "highest"
  precision). Weight-only modes compute with bit-equal weights, so they
  keep the unquantized tolerances (latents 2e-4, as
  `test_torch_pipeline.py`). For w8a8, summation-order bits upstream can
  move one activation across a rounding edge of its int8 code: one code
  step of a token is amax/127 of that token, so the latents' tolerance
  there is 2e-3, and greedy token ids must still be equal.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from acestep_tpu import runtime_config as jrc
from acestep_tpu.llm.handler import LLMHandler as JaxLLM
from acestep_tpu.lora import manager as jman
from acestep_tpu.models import dit as jdit
from acestep_tpu.ops import quant as jq
from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_torch import runtime_config as trc
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.lora import manager as tman
from acestep_torch.models.dit import build_dit
from acestep_torch.ops import quant as tq
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.utils.weights import dit_from_jax, jax_leaf
from torch_parity import (capped, highest, np_tree, one_torch_thread,
                          port_cfg, randn, tiny_dit_cfg, tiny_vae_cfg)

MODES = ["int8", "fp8", "w8a8", "int4"]
GEOM = dict(frame_bucket=20, min_frames=20, refer_frames=10)
_KEY = {"int8": jq.QUANT_KEY, "fp8": jq.FP8_KEY, "w8a8": jq.W8A8_KEY,
        "int4": jq.INT4_KEY}


@pytest.fixture(scope="module")
def jparams():
    return np_tree(jdit.init_dit_params(jax.random.PRNGKey(0),
                                        tiny_dit_cfg()))


def _port_dit(jparams, mode=None):
    model = dit_from_jax(jparams, build_dit(port_cfg(tiny_dit_cfg()), "cpu",
                                            torch.float32))
    return tq.quantize_module_(model, mode) if mode else model


def _quant_modules(model):
    return {n: m for n, m in model.named_modules()
            if isinstance(m, tq.QuantWeight)}


def _jax_node(tree, name: str):
    """The JAX quant node of port module `name`, its layer entry taken
    for stacked leaves."""
    keys, _ = jax_leaf(f"{name}.weight", 0)
    node = tree
    for k in keys[:-1]:
        node = node[k]
    node = node["w"]
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit() and parts[i - 1] == "layers":
            node = {k: v[int(p)] for k, v in node.items()}
    return node


def _canon(a):
    """JAX leaf layout -> the port's: output axis first."""
    return np.moveaxis(np.asarray(a), -1, 0)


def _bits(a):
    """The bytes of 1-byte codes (torch or numpy), else the array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("mode", MODES)
def test_codes_and_scales_bit_equal_jax(jparams, mode):
    jt = jq.quantize_tree(jparams, mode)
    mods = _quant_modules(_port_dit(jparams, mode))
    stored = set()
    for name, m in mods.items():
        node = _jax_node(jt, name)
        key = next(k for k in node if k != "scale")
        stored.add(key)
        assert key == _KEY[m.mode], name
        np.testing.assert_array_equal(_bits(m.codes),
                                      _bits(_canon(node[key])), err_msg=name)
        np.testing.assert_array_equal(m.scale.numpy(),
                                      _canon(node["scale"]), err_msg=name)
    # int4 stores int8 where the in-features do not split into groups
    # (the decoder's proj_in: 192 in-features)
    want = {_KEY[mode]} | ({jq.QUANT_KEY} if mode == "int4" else set())
    assert stored == want


@pytest.mark.parametrize("fin,packed", [(192, False), (100, False),
                                        (256, True)])
def test_int4_falls_back_to_int8(fin, packed):
    w = randn(fin, fin, 24, scale=0.1)                 # JAX (in, out)
    node = jq.quantize_tree({"p": {"w": w}}, "int4")["p"]["w"]
    lin = nn.Linear(fin, 24, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    q = tq.quantize_weight(lin, "int4")
    assert (jq.INT4_KEY in node) == packed == (q.mode == "int4")
    key = jq.INT4_KEY if packed else jq.QUANT_KEY
    np.testing.assert_array_equal(q.codes.numpy(), _canon(node[key]))
    np.testing.assert_array_equal(q.dequantize().numpy(), np.asarray(
        jq.dequantize_params(node, jnp.float32)).T)


def test_unknown_mode_rejected(jparams):
    with pytest.raises(ValueError, match="unsupported quantization"):
        tq.quantize_module_(_port_dit(jparams), "int3")
    with pytest.raises(ValueError, match="unsupported quantization"):
        AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                       dtype=torch.float32, device="cpu",
                       **GEOM).initialize_service(quantization="int3")
    with pytest.raises(ValueError, match="unsupported quantization"):
        LLMHandler(dtype=torch.float32, device="cpu").initialize(
            quantization="nf4")


@pytest.mark.parametrize("model", ["dit", "lm"])
def test_quantized_leaf_set_equals_jax(jparams, model):
    """Every quantized weight of the port is a JAX quant node and back."""
    if model == "dit":
        jt = jq.quantize_tree(jparams, "w8a8")
        tmodel = _port_dit(jparams, "w8a8")
    else:
        jh = JaxLLM(dtype=jnp.float32)
        jh.initialize(num_fallback_codes=32, seed=0)
        jt = jq.quantize_tree(np_tree(jh.engine.params), "w8a8",
                              exclude_prefixes=("lm_head",))
        th = LLMHandler(dtype=torch.float32, device="cpu")
        th.initialize(cfg=port_cfg(jh.cfg), num_fallback_codes=32,
                      params=np_tree(jh.engine.params), quantization="w8a8")
        tmodel = th.engine.model
    want = {tuple(k.key for k in path[:-1])
            for path, _ in jax.tree_util.tree_leaves_with_path(jt)
            if path[-1].key == jq.W8A8_KEY}
    got = {jax_leaf(f"{n}.weight", 0)[0] for n in _quant_modules(tmodel)}
    assert got == want and got


def test_w8a8_matmul_equals_jax():
    """Exact: same int8 codes, exact int32 sums, same float32 scale
    products; rows 3 and 40 (CPU `_int_mm` takes any row count)."""
    w = randn(1, 64, 48, scale=0.05)
    node = jq.quantize_tree({"p": {"w": w}}, "w8a8")["p"]["w"]
    lin = nn.Linear(64, 48, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    q = tq.quantize_weight(lin, "w8a8")
    for rows in (3, 40):
        x = randn(rows, 2, rows, 64)
        want = np.asarray(jq.w8a8_matmul(jnp.asarray(x), node))
        got = tq.w8a8_matmul(torch.from_numpy(x), q.codes, q.scale)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_dequantized_weights_equal_jax(jparams, mode):
    jt = jq.quantize_tree(jparams, mode)
    jd = jq.dequantize_params(jt, jnp.float32, materialize_w8a8=True)
    want = dit_from_jax(np_tree(jd))
    got = tq.dequantized_weights(_port_dit(jparams, mode), torch.float32)
    assert got
    for key, w in got.items():
        np.testing.assert_array_equal(w.numpy(), want[key].numpy(),
                                      err_msg=key)


@pytest.fixture(scope="module")
def vae_params():
    jh = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    jh.initialize_service(seed=0)
    return jh.vae_params


@pytest.mark.parametrize("mode", MODES)
def test_quantized_text2music_equals_jax(vae_params, mode):
    """Turbo text2music of a quantized tiny DiT, JAX against the port on
    the same weights, captions and `initial_noise`."""
    jh = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    jh.initialize_service(seed=0, quantization=mode, vae_params=vae_params)
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    jplain = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                        dtype=jnp.float32, **GEOM)
    jplain.initialize_service(seed=0, vae_params=vae_params)
    th.initialize_service(params=np_tree(jplain.params),
                          vae_params=np_tree(vae_params), quantization=mode)
    assert tq.quantized_bytes(th.model) == jq.quantized_bytes(jh.params)
    kw = dict(audio_duration=1.6, seeds=[0], normalize=False,
              initial_noise=randn(4, 1, 40, 64),
              metas={"bpm": 90, "duration": 1.6})
    with highest():
        want = jh.generate_music(["warm tape jazz"], ["la la"], **kw)
    got = th.generate_music(["warm tape jazz"], ["la la"], **kw)
    atol = 2e-3 if mode == "w8a8" else 2e-4
    np.testing.assert_allclose(got.pred_latents, want.pred_latents,
                               atol=atol)


def test_adapter_over_quantized_base_equals_jax(tmp_path, jparams):
    """A LoRA merged over a w8a8 base: every quantized weight is
    materialized in bfloat16 first (targets then take the delta), as the
    JAX manager's `effective_params`. bf16 both sides, rounded once each:
    equal to one bf16 step (4e-3 relative) of the merged weight."""
    from acestep_tpu.lora import init_lora

    adapter = init_lora(jax.random.PRNGKey(3), jparams, rank=4, alpha=8.0)
    weights = jax.tree.map(np.asarray, adapter["weights"])
    for pair in weights.values():
        pair["up"] = randn(7, *pair["up"].shape, scale=0.05)
    path = str(tmp_path / "adapter.npz")
    jman.save_adapter(path, {"meta": adapter["meta"], "weights": weights})
    jm = jman.LoraManager(jq.quantize_tree(
        jax.tree.map(jnp.asarray, jparams), "w8a8"))
    tmodel = _port_dit(jparams, "w8a8")
    tm = tman.LoraManager(tmodel)
    jm.load(path, scale=0.7)
    tm.load(path, scale=0.7)
    with highest():
        want = dit_from_jax(np_tree(jm.effective_params()))
    got = tm.effective_weights()
    assert set(got) == {f"{n}.weight" for n in _quant_modules(tmodel)}
    for key, w in got.items():
        assert w.dtype == torch.bfloat16, key
        np.testing.assert_allclose(w.float().numpy(), want[key].numpy(),
                                   rtol=4e-3, atol=1e-6, err_msg=key)


_one_thread = pytest.fixture(scope="module")(one_torch_thread)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_lm_greedy_ids_equal_jax(_one_thread, mode):
    """A quantized tiny planner (w8a8: `head_q`, the untied head dropped
    and the int8 KV cache) decodes the same greedy CoT and codes as JAX's
    from the same weights."""
    jh = JaxLLM(dtype=jnp.float32)
    jh.initialize(num_fallback_codes=32, seed=0, quantization=mode)
    jplain = JaxLLM(dtype=jnp.float32)
    jplain.initialize(num_fallback_codes=32, seed=0)
    th = LLMHandler(dtype=torch.float32, device="cpu")
    th.initialize(cfg=port_cfg(jh.cfg), num_fallback_codes=32,
                  params=np_tree(jplain.engine.params), quantization=mode)
    eng = th.engine
    assert eng.kv_quant == jh.engine.kv_quant == (mode == "w8a8")
    assert hasattr(eng.model, "head_q") == (mode == "w8a8")
    assert hasattr(eng.model, "lm_head") == ("lm_head" in jh.engine.params)
    for name, m in _quant_modules(eng.model).items():
        node = _jax_node(jh.engine.params, name)
        key = next(k for k in node if k != "scale")
        np.testing.assert_array_equal(_bits(m.codes),
                                      _bits(_canon(node[key])), err_msg=name)
    if mode == "w8a8":
        np.testing.assert_array_equal(
            eng.model.head_q.q.numpy(), np.asarray(jh.engine.params[
                "head_q"]["q"]))

    def run(h):
        with capped(h):
            return h.plan("neon city pop", "[verse]\nstreet lights",
                          target_duration=2, seed=1, cfg_scale=2.0,
                          metadata_temperature=0.0, codes_temperature=0.0)

    with highest():
        want = run(jh)
    got = run(th)
    assert got["cot_text"] == want["cot_text"] and got["cot_text"]
    assert got["audio_codes"] == want["audio_codes"]


@pytest.mark.parametrize("hbm", [4.0, 8.0, 16.0, 32.0])
def test_initialize_auto_tier_pick_equals_jax(monkeypatch, hbm):
    """The (size, quantization, kv_quant) `initialize_auto` tries first on
    each simulated tier, and after an out-of-memory error the next rung,
    equal to JAX's ladder (initialize itself is recorded, not run)."""
    def picks(pkg_rc, handler, dtype):
        monkeypatch.setattr(pkg_rc, "_GLOBAL", pkg_rc.get_tier_config(hbm))
        calls = []

        def initialize(self, **kw):
            calls.append((kw["cfg"].num_hidden_layers if kw.get("cfg")
                          else None, kw["quantization"], kw["kv_quant"]))
            if len(calls) == 1:
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

        monkeypatch.setattr(handler, "initialize", initialize)
        try:
            kw = {} if handler is JaxLLM else {"device": "cpu"}
            out = handler(dtype=dtype, **kw).initialize_auto()
        except RuntimeError as e:
            return str(e), calls
        return out, calls

    got = picks(trc, LLMHandler, torch.float32)
    want = picks(jrc, JaxLLM, jnp.float32)
    assert got == want
    if hbm == 16.0:
        assert got[1][0][:2] == (36, "w8a8")


@pytest.mark.parametrize("mode", [None, "int4"])
def test_layerwise_init_equals_whole_model_draws(mode):
    """`init_lm_params` materializes (and quantizes) one layer at a time:
    the same draws as seeding the whole model at once, and the same codes
    as quantizing it afterwards."""
    from acestep_torch.config import LMConfig
    from acestep_torch.models.lm import build_lm, init_lm_params
    from acestep_torch.ops.basic import seeded_init_

    cfg = LMConfig.tiny(vocab_size=300, tie_word_embeddings=False)
    want = build_lm(cfg, "cpu", torch.bfloat16)
    seeded_init_(want, torch.Generator().manual_seed(3))
    if mode:
        tq.quantize_module_(want, mode, exclude_prefixes=("lm_head",))
    got = init_lm_params(cfg, torch.Generator().manual_seed(3),
                         dtype=torch.bfloat16, quantization=mode)
    w, g = want.state_dict(), got.state_dict()
    assert set(w) == set(g)
    for k in w:
        assert torch.equal(w[k].view(torch.uint8) if w[k].element_size() == 1
                           else w[k], g[k].view(torch.uint8)
                           if g[k].element_size() == 1 else g[k]), k
    assert not any(p.requires_grad for p in got.parameters())
