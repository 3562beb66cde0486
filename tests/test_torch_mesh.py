"""The port's dp x tp DiT mesh (`acestep_torch.parallel`, the handler's
`enable_mesh`) against the JAX package, on the CPU.

One world of 4 CPU ranks (gloo, FileStore under the test's temp dir,
every wait bounded by 60 s) serves the module; each test's mesh takes
ranks of it. The handlers hold the JAX handler's seeded tiny weights,
float32, and both sides take the same `initial_noise`, so each sharded
render is held to JAX's unsharded `generate_music` with JAX's own mesh
tolerance, rtol = atol = 2e-4 (tests/test_mesh_inference.py, where JAX's
sharded renders equal its unsharded ones to the same tolerance). The SDE
steps draw from each package's own generator, so the SDE render under dp
is held to the port's unsharded SDE render instead.

The shard rules are held to JAX's PartitionSpecs (after
`sanitize_pspecs`) mapped to the torch layout: a linear's JAX (in, out)
weight splits `out` where the torch (out, in) weight splits dim 0. Where
the port departs by design it is asserted as such: a row-parallel int4
weight's group scales split with its codes (JAX replicates them and lets
GSPMD dequantize whole)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import DiTConfig as JaxDiTConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.ops.quant import quantize_tree
from acestep_tpu.parallel import dit_param_pspecs as jax_pspecs
from acestep_tpu.parallel import make_mesh as jax_make_mesh
from acestep_tpu.parallel.mesh import sanitize_pspecs
from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_torch.models.dit import build_dit
from acestep_torch.ops.quant import quantize_module_
from acestep_torch.parallel import dit_param_pspecs, make_mesh, make_plan
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.utils.weights import dit_from_jax, jax_leaf
from torch_mesh_helpers import cpu_world, decoder_forward
from torch_parity import (
    highest, np_tree, one_torch_thread, port_cfg, tiny_dit_cfg, tiny_vae_cfg,
)

GEOM = dict(frame_bucket=20, min_frames=20, refer_frames=10)
TOL = dict(rtol=2e-4, atol=2e-4)
T = 20                                      # 0.8 s of 25 Hz latents

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    yield from cpu_world(tmp_path_factory.mktemp("mesh"))


def _pair(quantization=None, float_params=None):
    """(JAX handler, port handler) with JAX's seed-0 tiny weights; under
    `quantization` both quantize the same float weights."""
    jh = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    jh.initialize_service(seed=0, quantization=quantization)
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(params=float_params or np_tree(jh.params),
                          vae_params=np_tree(jh.vae_params),
                          quantization=quantization)
    return jh, th


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _noise(rows, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (rows, T, 64)).astype(np.float32)


def _render(h, captions, **kw):
    kw = dict(dict(audio_duration=0.8, normalize=False), **kw)
    if isinstance(h, JaxHandler):
        with highest():
            return h.generate_music(captions, ["x"] * len(captions), **kw)
    return h.generate_music(captions, ["x"] * len(captions), **kw)


def _held_to_jax(pair, dp, tp, captions, **kw):
    jh, th = pair
    want = _render(jh, captions, **kw)
    th.enable_mesh(dp=dp, tp=tp)
    try:
        got = _render(th, captions, **kw)
    finally:
        th.release_mesh()
    np.testing.assert_allclose(got.pred_latents, want.pred_latents, **TOL)
    return got, want


# ------------------------------------------------------------------
# shard rules
# ------------------------------------------------------------------


def _jax_dims(params, tp):
    """{JAX key path: spec} of the sanitized pspecs over a 1 x tp mesh."""
    specs = sanitize_pspecs(params, jax_pspecs(params),
                            jax_make_mesh(dp=1, tp=tp))
    out = {}

    def walk(p, s, keys):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], keys + (k,))
        else:
            out[keys] = tuple(s)
    walk(params, specs, ())
    return out


def _as_torch_dim(keys, spec):
    """A JAX spec's split axis in the torch layout: linears' (in, out)
    weights and quant payloads are transposed in torch; anything else
    keeps its axes. Leading stacked-layer axes are dropped."""
    split = [i for i, a in enumerate(spec) if a is not None]
    if not split:
        return None
    axis = split[0] - (len(spec) - 2)          # of the last two axes
    linear = "w" in keys[-2:]
    return 1 - axis if linear else axis


def _port_dims_vs_jax(model, params, got, tp=2):
    """(name, JAX keys, port dim, JAX dim) of every port tensor; every
    JAX leaf is met."""
    want = _jax_dims(params, tp)
    tensors = dict(list(model.named_parameters())
                   + list(model.named_buffers()))
    seen = set()
    for name, dim in got.items():
        keys, _ = jax_leaf(name, tensors[name].ndim)
        if keys not in want:
            # a QuantWeight's codes / scale: the {payload, scale} node
            # that replaced the JAX leaf `w`
            node = keys[:-1] + ("w",)
            sub = "scale" if keys[-1] == "scale" else next(
                k[-1] for k in want if k[:-1] == node and k[-1] != "scale")
            keys = node + (sub,)
        assert keys in want, (name, keys)
        seen.add(keys)
        yield name, keys, dim, _as_torch_dim(keys, want[keys])
    assert seen == set(want)


@pytest.mark.parametrize("mode", [None, "int8", "fp8", "w8a8", "int4"])
def test_dit_shard_dims_match_jax_pspecs(mode):
    """Every tensor of a tiny DiT with intermediate 256 (an int4 `down`
    then splits on a group boundary at tp=2) splits on the dim JAX's
    sanitized pspecs give over tp=2, plain and under each quantized mode.
    The rules read names, shapes and dtypes only: JAX's tree is its
    shapes (`jax.eval_shape`), the port's model lives on the meta
    device."""
    jcfg = JaxDiTConfig.tiny(fsq_dim=64, intermediate_size=256)
    params = jax.eval_shape(lambda k: jdit.init_dit_params(k, jcfg),
                            jax.random.PRNGKey(0))
    model = build_dit(port_cfg(jcfg), "meta", torch.float32)
    if mode:
        params = jax.eval_shape(lambda p: quantize_tree(p, mode), params)
        quantize_module_(model, mode)
    split = 0
    for name, keys, got, want in _port_dims_vs_jax(
            model, params, dit_param_pspecs(model, port_cfg(jcfg), 2)):
        if mode == "int4" and keys[-3:-2] == ("down",) and keys[-1] == \
                "scale" and model.get_submodule(
                    name.rpartition(".")[0]).codes.dtype == torch.uint8:
            assert (got, want) == (1, None), name   # group scales split
            continue
        assert got == want, (name, got, want)
        split += got is not None
    assert split >= 7 * 6          # q/k/v/o/gate/up/down of 6 stacks


def test_kv_heads_replicate_at_tp4():
    """4 query / 2 KV heads over tp=4: each rank holds one query head and
    the KV head it reads (ranks 0-1 KV head 0, ranks 2-3 KV head 1)."""
    cfg = port_cfg(tiny_dit_cfg())
    model = build_dit(cfg, "cpu", torch.float32)
    plan = make_plan(model, cfg, 4)
    assert plan.local_heads == (1, 1)
    D = cfg.head_dim
    assert [plan.ranges(r)["kv"] for r in range(4)] == [
        (0, D), (0, D), (D, 2 * D), (D, 2 * D)]
    assert [plan.ranges(r)["q"] for r in range(4)] == [
        (r * D, (r + 1) * D) for r in range(4)]
    local = plan.local_config(cfg)
    assert (local.num_attention_heads, local.num_key_value_heads,
            local.intermediate_size) == (1, 1, cfg.intermediate_size // 4)
    # 3 KV heads over 2 ranks do not divide: the attention runs whole
    odd = make_plan(model, dataclasses.replace(cfg, num_attention_heads=6,
                                               num_key_value_heads=3), 2)
    assert not odd.heads and odd.mlp


# ------------------------------------------------------------------
# renders against JAX
# ------------------------------------------------------------------


def test_dp4_matches_jax(world, pair):
    _held_to_jax(pair, 4, 1, ["a", "b", "c", "d"], seeds=[1, 2, 3, 4],
                 initial_noise=_noise(4))


def test_dp2_tp2_matches_jax(world, pair):
    _held_to_jax(pair, 2, 2, ["a", "b"], seeds=[1, 2],
                 initial_noise=_noise(2))


def test_tp4_single_item_replicated_kv_matches_jax(world, pair):
    got, _ = _held_to_jax(pair, 1, 4, ["solo"], seeds=[7],
                          initial_noise=_noise(1))
    assert got.pred_latents.shape == (1, T, 64)


def test_padded_batch_is_trimmed(world, pair):
    """Batch 3 under dp=4 renders 4 rows (the first repeated) and returns
    3: latents, audios, seeds and every `extra` list."""
    got, want = _held_to_jax(pair, 4, 1, ["a", "b", "c"], batch_size=3,
                             seeds=[1, 2, 3], initial_noise=_noise(1))
    assert got.pred_latents.shape[0] == len(got.audios) == 3
    assert got.seeds == [1, 2, 3]
    assert len(got.extra["spans"]) == len(got.extra["is_covers"]) == 3
    assert got.extra == {k: want.extra[k] for k in got.extra}


def test_per_row_noise_cycles_with_padding(world, pair):
    got, _ = _held_to_jax(pair, 4, 1, ["a", "b", "c"], batch_size=3,
                          seeds=[1, 2, 3], initial_noise=_noise(3, seed=5))
    assert got.pred_latents.shape[0] == 3


def test_w8a8_dit_under_2x2_matches_jax(world, pair):
    float_params = np_tree(pair[0].params)
    _held_to_jax(_pair("w8a8", float_params), 2, 2, ["a", "b"],
                 seeds=[1, 2], initial_noise=_noise(2))


def test_sde_under_dp2_matches_unsharded(world, pair):
    """Each dp rank draws the whole batch's step noise from the first
    row's generator and keeps its rows: the port's unsharded SDE render
    exactly (JAX's step noise comes from another generator)."""
    _, th = pair
    kw = dict(seeds=[1, 2, 3, 4], infer_method="sde")
    want = _render(th, ["a", "b", "c", "d"], **kw)
    th.enable_mesh(dp=2, tp=1)
    try:
        got = _render(th, ["a", "b", "c", "d"], **kw)
        assert th.get_service_status()["devices"] == [
            "rank 0: cpu (dp 0, tp 0, gloo)",
            "rank 1: cpu (dp 1, tp 0, gloo)"]
    finally:
        th.release_mesh()
    np.testing.assert_allclose(got.pred_latents, want.pred_latents, **TOL)


def test_lora_weights_reach_the_ranks(world, pair):
    """A LoRA adapter attached after `enable_mesh` reaches every rank
    before the next render; toggled off, the ranks render the base."""
    from acestep_torch.lora.adapters import init_lora

    _, th = pair
    kw = dict(seeds=[1, 2], initial_noise=_noise(2))
    base = _render(th, ["a", "b"], **kw)
    adapter = init_lora(torch.Generator().manual_seed(1), th.model, rank=4,
                        alpha=8.0)
    for ws in adapter["weights"].values():
        ws["up"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    th.lora.add("mesh-test", adapter)
    try:
        want = _render(th, ["a", "b"], **kw)
        th.enable_mesh(dp=1, tp=2)
        got = _render(th, ["a", "b"], **kw)
        th.lora.toggle(False)
        off = _render(th, ["a", "b"], **kw)
    finally:
        th.release_mesh()
        th.lora.unload("mesh-test")
        th.lora.toggle(True)
    assert np.abs(want.pred_latents - base.pred_latents).max() > 1e-3
    np.testing.assert_allclose(got.pred_latents, want.pred_latents, **TOL)
    np.testing.assert_allclose(off.pred_latents, base.pred_latents, **TOL)


def test_reinitialize_reinstalls_the_shards(world):
    """`initialize_service` on a handler with a mesh sends the ranks the
    new weights: the next render is the new weights' unsharded one."""
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(seed=0)
    kw = dict(seeds=[1, 2], initial_noise=_noise(2))
    th.enable_mesh(dp=2, tp=2)
    try:
        before = _render(th, ["a", "b"], **kw)
        th.initialize_service(seed=1)
        got = _render(th, ["a", "b"], **kw)
    finally:
        th.release_mesh()
    want = _render(th, ["a", "b"], **kw)
    assert np.abs(want.pred_latents - before.pred_latents).max() > 1e-3
    np.testing.assert_allclose(got.pred_latents, want.pred_latents, **TOL)


def test_flash_path_under_tp2_matches_dense(world):
    """The decoder's self-attention through `ops.flash_attention` (its
    plain version on the CPU) on tp=2 shards of 2 query / 1 KV heads,
    against JAX's dense single-device forward
    (tests/test_dit_flash_path.py:74-106)."""
    jcfg = JaxDiTConfig.tiny(num_attention_heads=4, num_key_value_heads=2,
                             intermediate_size=128, num_hidden_layers=2)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), jcfg)
    B, L = 1, 512
    rng = np.random.default_rng(1)
    xt = rng.standard_normal((B, L, 64)).astype(np.float32)
    enc = rng.standard_normal((B, 16, jcfg.hidden_size)).astype(np.float32)
    t = np.full((B,), 0.5, np.float32)
    context = np.zeros((B, L, 128), np.float32)
    dense = dataclasses.replace(jcfg, attention_impl="dense")
    with highest():
        want = np.asarray(jax.jit(lambda p, x, c, e: jdit.dit_decoder(
            p, dense, x, jnp.asarray(t), jnp.asarray(t), c,
            encoder_hidden_states=e))(params, xt, context, enc))
    cfg = port_cfg(jcfg)
    model = dit_from_jax(np_tree(params), build_dit(cfg, "cpu",
                                                    torch.float32))
    plan = make_plan(model, cfg, 2)
    mesh = make_mesh(1, 2)
    try:
        mesh.install("flash", model, plan)
        got = mesh.call(decoder_forward, "flash", plan.local_config(cfg),
                        *map(torch.from_numpy, (xt, t, context, enc)))
    finally:
        mesh.close()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------------
# errors
# ------------------------------------------------------------------


def test_mesh_errors(world, pair):
    _, th = pair
    with pytest.raises(ValueError, match="needs 4096"):
        th.enable_mesh(dp=4096)
    assert th.mesh is None
    with pytest.raises(ValueError, match="one world per process"):
        make_mesh(8, 1)
    with pytest.raises(ValueError, match="nccl needs one distinct CUDA"):
        make_mesh(1, 2, devices=["cpu", "cpu"], backend="nccl")
