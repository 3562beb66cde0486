"""The port's tensor-parallel 5 Hz planner (`LLMHandler.initialize(
tensor_parallel=)`, `LMEngine(mesh=)`) against the JAX package, on the CPU.

One world of 2 CPU ranks (gloo, FileStore under the test's temp dir,
every wait bounded by 60 s) serves the module. Both packages hold the same
tiny LM (JAX's seeded init, float32); sampling draws differ between the
packages, so every comparison decodes greedily (temperature 0): JAX's
tp=1 token ids, the port's tp=1 ids and the port's tp=2 ids must be EQUAL
(tests/test_mesh_inference.py holds JAX's tp=2 codes to its tp=1 codes).

The shard rules of the LM (the DiT's, plus `embed_tokens` and w8a8's
`head_q` along the vocabulary) are held to JAX's `lm_param_pspecs` after
`sanitize_pspecs`: an odd vocabulary is replicated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import LMConfig as JaxLMConfig
from acestep_tpu.llm.handler import LLMHandler as JaxLLM
from acestep_tpu.models import lm as jlm
from acestep_tpu.ops.quant import quantize_tree
from acestep_tpu.parallel import lm_param_pspecs as jax_lm_pspecs
from acestep_tpu.parallel import make_mesh as jax_make_mesh
from acestep_tpu.parallel.mesh import sanitize_pspecs
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.llm.tokenizer import SimpleTokenizer
from acestep_torch.models.lm import build_head_q, build_lm
from acestep_torch.ops.quant import quantize_module_
from acestep_torch.parallel import lm_param_pspecs
from acestep_torch.scoring.lm_score import calculate_reward_score
from acestep_torch.utils.weights import jax_leaf
from torch_mesh_helpers import cpu_world
from torch_parity import capped, highest, np_tree, one_torch_thread, port_cfg

GREEDY = dict(metadata_temperature=0.0, codes_temperature=0.0)

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    yield from cpu_world(tmp_path_factory.mktemp("mesh_lm"), ranks=2)


def _planners(codes: int, quantization=None, tp: int = 2):
    """(JAX tp=1, port tp=1, port tp=`tp`) planners with the JAX seed-0
    weights; the port's quantize the same float weights JAX quantized."""
    jh = JaxLLM(dtype=jnp.float32)
    jh.initialize(num_fallback_codes=codes, seed=0, quantization=quantization)
    float_params = jh.engine.params
    if quantization:
        plain = JaxLLM(dtype=jnp.float32)
        plain.initialize(num_fallback_codes=codes, seed=0)
        float_params = plain.engine.params
    ports = []
    for n in (1, tp):
        th = LLMHandler(dtype=torch.float32, device="cpu")
        th.initialize(cfg=port_cfg(jh.cfg), num_fallback_codes=codes,
                      params=np_tree(float_params),
                      quantization=quantization, tensor_parallel=n)
        ports.append(th)
    return jh, ports[0], ports[1]


def _plan(h):
    with capped(h):
        return h.plan("neon city pop", "[verse]\nstreet lights",
                      target_duration=2, seed=1, cfg_scale=2.0, **GREEDY)


def _codes(h):
    return h.engine.generate_codes(["make music"], n_codes=10, seed=5,
                                   temperature=0.0)


def _three(jh, one, two, fn):
    with highest():
        want = fn(jh)
    return want, fn(one), fn(two)


@pytest.fixture(scope="module")
def planners(world):
    jh, one, two = _planners(64)
    yield jh, one, two
    two.release()


def test_tp2_greedy_codes_equal_jax(planners):
    want, one, two = _three(*planners, _codes)
    assert want == one == two
    assert planners[2].engine.mesh.tp == 2


def test_tp2_greedy_plan_equals_jax(planners):
    """CoT on the device FSM tables with CFG, then the codes phase from
    the CoT's prefix state (a cache graft on every rank)."""
    want, one, two = _three(*planners, _plan)
    for k in ("cot_text", "audio_codes", "metadata"):
        assert want[k] == one[k] == two[k], k
    assert two["cot_text"] and two["audio_codes"]
    stats = planners[2].engine.prefill_stats
    assert stats["reused_tokens"] > 0       # the phase-2 prefix was grafted


def test_tp2_reward_score_equals_tp1(planners):
    _, one, two = planners
    codes = "".join(f"<|audio_code_{i}|>" for i in (3, 9, 27, 5))
    got = calculate_reward_score(two, codes, caption="energetic rock")
    want = calculate_reward_score(one, codes, caption="energetic rock")
    for k in ("cond_logprob", "uncond_logprob", "pmi"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4)


def test_tp2_w8a8_head_q_split_equals_jax(world):
    """w8a8 with 65 codes (an even vocabulary, 168): `head_q` and the
    embedding table split along it, and the greedy codes and plan equal
    JAX's tp=1 and the port's tp=1."""
    jh, one, two = _planners(65, "w8a8")
    try:
        model = two.engine.model
        V = jh.cfg.vocab_size
        assert V % 2 == 0 and model.tp_vocab[:2] == (0, V // 2)
        assert model.head_q.q.shape[0] == model.head_q.scale.shape[0] == \
            model.embed_tokens.shape[0] == V // 2
        want, got1, got2 = _three(jh, one, two, _codes)
        assert want == got1 == got2
        want, got1, got2 = _three(jh, one, two, _plan)
        assert want["audio_codes"] == got1["audio_codes"] == \
            got2["audio_codes"]
        assert want["cot_text"] == got1["cot_text"] == got2["cot_text"]
    finally:
        two.release()


@pytest.mark.parametrize("mode,codes", [
    (None, 64), (None, 65), ("int8", 65), ("fp8", 65), ("w8a8", 65),
    ("int4", 65)])
def test_lm_shard_dims_match_jax_pspecs(mode, codes):
    """Every tensor of the tiny planner, stored as `LLMHandler.initialize`
    stores it (the trunk quantized, `lm_head` excluded, w8a8's `head_q`),
    splits on the dim JAX's sanitized `lm_param_pspecs` give over tp=2
    (the vocabulary's 167 ids with 64 codes do not divide: `embed_tokens`
    replicated). Under int4 the intermediate is 256, so `down` splits on a
    group boundary; its group scales split with its codes, where JAX
    replicates them. The rules read names, shapes and dtypes only: JAX's
    tree is its shapes, the port's model lives on the meta device."""
    vocab = SimpleTokenizer(num_audio_codes=codes).vocab_size
    jcfg = JaxLMConfig.tiny(vocab_size=vocab, **(
        dict(intermediate_size=256) if mode == "int4" else {}))

    def jax_tree(key):
        p = jlm.init_lm_params(key, jcfg)
        if mode:
            p = dict(quantize_tree(p, mode, exclude_prefixes=("lm_head",)))
            if mode == "w8a8":
                p["head_q"] = jlm.build_head_q(p, jcfg)
        return p

    params = jax.eval_shape(jax_tree, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = build_lm(cfg, "meta")
    if mode:
        quantize_module_(model, mode, exclude_prefixes=("lm_head",))
        if mode == "w8a8":
            model.head_q = build_head_q(model, cfg)
    specs = sanitize_pspecs(params, jax_lm_pspecs(params),
                            jax_make_mesh(dp=1, tp=2))
    got = lm_param_pspecs(model, cfg, 2)
    tensors = dict(list(model.named_parameters())
                   + list(model.named_buffers()))
    for name, dim in got.items():
        keys, _ = jax_leaf(name, tensors[name].ndim)
        node, spec = params, specs
        for k in keys[:-1]:
            node, spec = node[k], spec[k]
        if keys[-1] in ("codes", "scale") and keys[-1] not in node:
            node, spec = node["w"], spec["w"]
            sub = "scale" if keys[-1] == "scale" else next(
                k for k in node if k != "scale")
            spec = spec[sub]
            linear = True
        else:
            spec = spec[keys[-1]]
            linear = keys[-1] == "w"
        axes = [i for i, a in enumerate(spec) if a is not None]
        want = None
        if axes:
            axis = axes[0] - (len(spec) - 2)
            want = 1 - axis if linear else axis
        if mode == "int4" and name.endswith("down.scale") and \
                tensors[name.replace("scale", "codes")].dtype == torch.uint8:
            want = 1                           # the group scales split
        assert dim == want, (name, dim, want)
    split = {n for n, d in got.items() if d is not None}
    assert ("embed_tokens" in split) == (vocab % 2 == 0)
    if mode == "w8a8":
        assert {"head_q.q", "head_q.scale"} <= split
