"""The DiT decoder cut into segments (`models/dit.py`) and its step
replayed as graphs between the eager cores (`models/dit_graphs.py`), on
the CPU at tiny widths:

- the segmented decoder, run eagerly, equals the decoder as it was before
  the cut (kept below as `_uncut_decoder`) bit for bit;
- the graph path, with each CUDA graph replaced by a replay that runs its
  segment again (`torch_graph_helpers.replay_eagerly`), equals the eager
  trajectories bit for bit through its static buffers: rows 1-4, banded
  and full layers, a cover switch mid-trajectory, guided 2B rows, T not a
  multiple of the patch size; its keys, arena and counters;
- the graph path engages only on a CUDA device in inference through the
  flash kernel, with no tensor-parallel group and no quantized codes;
- the key changes when `call_with_weights` swaps an adapter's weights in.

The card's own tests (graphs against eager on the card, K1 launches,
held memory) are in `test_torch_cuda.py`.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from acestep_torch.config import DiTConfig
from acestep_torch.lora.adapters import call_with_weights
from acestep_torch.models import dit, dit_graphs, sampler
from acestep_torch.ops.basic import (attention, attention_flash, attention_kv,
                                     linear, rms_norm, rope_cos_sin)
from acestep_torch.ops.conv import conv1d, conv1d_transpose
from acestep_torch.ops.masks import bidirectional_mask
from acestep_torch.ops.quant import quantize_module_
from acestep_torch.utils import trace
from torch_graph_helpers import replay_eagerly

STEPS = 8


def _uncut_decoder(model, cfg, xt, timestep, timestep_r, context_latents,
                   encoder_hidden_states=None, cross_kv_cache=None,
                   remat=False):
    """`dit_decoder` as it was before the cut into segments, verbatim."""
    p = model.decoder
    eps = cfg.rms_norm_eps
    dtype = xt.dtype
    B, T0, _ = xt.shape

    temb_t, proj_t = dit._timestep_embed(p.time_embed, timestep, dtype)
    temb_r, proj_r = dit._timestep_embed(p.time_embed_r,
                                         timestep - timestep_r, dtype)
    temb = temb_t + temb_r
    tproj = proj_t + proj_r

    h = torch.cat([context_latents.to(dtype), xt], dim=-1)
    pad = (-T0) % cfg.patch_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    h = conv1d(p.proj_in, h, stride=cfg.patch_size)
    L = h.shape[1]

    if cross_kv_cache is None:
        enc = linear(p.condition_embedder, encoder_hidden_states.to(dtype))
    rope = rope_cos_sin(L, cfg.head_dim, cfg.rope_theta, dtype=dtype,
                        device=h.device)
    heads = dict(num_heads=cfg.num_attention_heads,
                 num_kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
                 rope=rope, eps=eps)
    if dit.resolve_attention_impl(cfg) == "flash":
        def self_attention(ap, x, window):
            return attention_flash(ap, x, window=window, **heads)
    else:
        masks = {w: bidirectional_mask(L, window=w, device=h.device)
                 for w in (None, cfg.sliding_window)}

        def self_attention(ap, x, window):
            return attention(ap, x, mask=masks[window], **heads)

    def layer(i, lp, h):
        mods = lp.scale_shift_table[None].to(dtype) + tproj
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = [
            mods[:, j:j + 1] for j in range(6)]
        norm_h = rms_norm(lp.self_attn_norm, h, eps) * (1 + scale_msa) \
            + shift_msa
        window = cfg.sliding_window if cfg.layer_is_sliding(i) else None
        h = h + self_attention(lp.self_attn, norm_h.to(dtype),
                               window) * gate_msa
        norm_h = rms_norm(lp.cross_attn_norm, h, eps)
        if cross_kv_cache is None:
            ca = attention(lp.cross_attn, norm_h,
                           num_heads=cfg.num_attention_heads,
                           num_kv_heads=cfg.num_key_value_heads,
                           head_dim=cfg.head_dim, kv_src=enc, eps=eps)
        else:
            ca = attention_kv(lp.cross_attn, norm_h, cross_kv_cache[0][i],
                              cross_kv_cache[1][i],
                              num_heads=cfg.num_attention_heads,
                              head_dim=cfg.head_dim, eps=eps)
        h = h + ca
        norm_h = rms_norm(lp.mlp_norm, h, eps) * (1 + c_scale) + c_shift
        return (h + dit.mlp(lp.mlp, norm_h.to(dtype)) * c_gate).to(dtype)

    for i, lp in enumerate(p.layers):
        h = checkpoint(layer, i, lp, h, use_reentrant=False) if remat \
            else layer(i, lp, h)
    mods = p.scale_shift_table[None].to(dtype) + temb[:, None]
    shift, scale = mods[:, 0:1], mods[:, 1:2]
    h = rms_norm(p.norm_out, h, eps) * (1 + scale) + shift
    h = conv1d_transpose(p.proj_out, h.to(dtype), stride=cfg.patch_size)
    return h[:, :T0]


def _model(version="turbo", dtype=torch.float32, seed=0, **overrides):
    cfg = DiTConfig.tiny(fsq_dim=64, model_version=version, **overrides)
    return cfg, dit.init_dit_params(cfg, torch.Generator().manual_seed(seed),
                                    dtype=dtype)


def _randn(g, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=g).to(dtype)


def _condition(model, cfg, g, rows, frames, lk, dtype):
    enc = _randn(g, rows, lk, cfg.hidden_size, dtype=dtype)
    ctx = _randn(g, rows, frames, cfg.in_channels - 64, dtype=dtype)
    return sampler.ConditionSet.build(model, cfg, enc, ctx)


# ------------------------------------------------------------------
# The segments run eagerly against the uncut decoder
# ------------------------------------------------------------------


@pytest.mark.parametrize("rows,frames,kv,impl,dtype", [
    *[(r, f, "cache", "auto", torch.float32)
      for r in (1, 2, 3, 4) for f in (40, 37)],
    (2, 37, "cache", "auto", torch.bfloat16),
    (3, 40, "encoder", "auto", torch.float32),
    (2, 37, "cache", "dense", torch.float32),
    (2, 40, "remat", "auto", torch.float32),
])
def test_segmented_decoder_equals_uncut(rows, frames, kv, impl, dtype):
    """Both layer kinds (the tiny config alternates banded and full)."""
    cfg, model = _model(dtype=dtype, attention_impl=impl)
    g = torch.Generator().manual_seed(rows * 100 + frames)
    xt = _randn(g, rows, frames, 64, dtype=dtype)
    ctx = _randn(g, rows, frames, cfg.in_channels - 64, dtype=dtype)
    enc = _randn(g, rows, 11, cfg.hidden_size, dtype=dtype)
    t = torch.full((rows,), 0.7, dtype=dtype)
    r = torch.full((rows,), 0.4, dtype=dtype)
    args = dict(encoder_hidden_states=enc) if kv != "cache" else dict(
        cross_kv_cache=dit.decoder_cross_kv(model, cfg, enc))
    with torch.set_grad_enabled(kv == "remat"):
        want = _uncut_decoder(model, cfg, xt, t, r, ctx, remat=kv == "remat",
                              **args)
        got = dit.dit_decoder(model, cfg, xt, t, r, ctx, remat=kv == "remat",
                              **args)
    assert torch.equal(got, want)
    assert got.stride() == want.stride()


def test_attn_capture_equals_uncut_probabilities():
    """The LRC pass, now over the segments, gives the uncut layers'
    cross-attention probabilities."""
    cfg, model = _model()
    g = torch.Generator().manual_seed(5)
    xt = _randn(g, 2, 30, 64)
    ctx = _randn(g, 2, 30, cfg.in_channels - 64)
    enc = _randn(g, 2, 9, cfg.hidden_size)
    t = torch.full((2,), 0.5)
    got = dit.dit_decoder_attn_capture(model, cfg, xt, t, t, ctx, enc,
                                       {1: [0, 3]})
    p = model.decoder
    h, tproj, _ = dit.decoder_in(p, cfg, xt, t, t, ctx)
    enc_p = linear(p.condition_embedder, enc)
    for i in range(2):
        lp = p.layers[i]
        q, k, v = dit.self_attn_in(lp, cfg, h, tproj, dit.decoder_rope(
            cfg, h.shape[1], h.dtype, h.device))
        a = dit.self_attention_core(cfg, h.shape[1], h.device)(
            q, k, v, dit.layer_window(cfg, i))
        h, _ = dit.self_attn_out(lp, cfg, h, a, tproj)
        norm_h = rms_norm(lp.cross_attn_norm, h, cfg.rms_norm_eps)
        ca, probs = attention(lp.cross_attn, norm_h, kv_src=enc_p,
                              num_heads=cfg.num_attention_heads,
                              num_kv_heads=cfg.num_key_value_heads,
                              head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
                              return_weights=True)
        h = h + ca
        norm_h = rms_norm(lp.mlp_norm, h, cfg.rms_norm_eps)
        mods = dit._modulation(lp, tproj, h.dtype)
        h = (h + dit.mlp(lp.mlp, norm_h * (1 + mods[4]) + mods[3])
             * mods[5]).to(h.dtype)
    assert set(got) == {1}
    assert torch.equal(got[1], probs[:, [0, 3]].float())


# ------------------------------------------------------------------
# The graph path, replayed eagerly, against the eager trajectories
# ------------------------------------------------------------------


def _counts():
    return {k: trace.counters[k] for k in ("dit_steps", "dit_graph_captures",
                                            "dit_graph_replays")}


def _turbo(model, cfg, rows, frames, dtype, cover):
    g = torch.Generator().manual_seed(rows * 10 + frames)
    x = _randn(g, rows, frames, 64, dtype=dtype)
    cond = _condition(model, cfg, g, rows, frames, 11, dtype)
    nc = _condition(model, cfg, g, rows, frames, 13, dtype) if cover else None
    with torch.no_grad():
        return sampler.sample_turbo(
            model, cfg, x_init=x, schedule=sampler.build_turbo_schedule(3.0),
            cond=cond, cond_non_cover=nc, cover_steps=3 if cover else None)


def _guided(model, cfg, rows, frames, dtype):
    g = torch.Generator().manual_seed(rows * 10 + frames)
    x = _randn(g, rows, frames, 64, dtype=dtype)
    cond = _condition(model, cfg, g, rows, frames, 11, dtype)
    null = _condition(model, cfg, g, rows, frames, 11, dtype)
    nc = _condition(model, cfg, g, rows, frames, 7, dtype)
    null_nc = _condition(model, cfg, g, rows, frames, 7, dtype)
    with torch.no_grad():
        return sampler.sample_guided(
            model, cfg, x_init=x,
            schedule=sampler.build_continuous_schedule(STEPS, 3.0),
            cond=cond, null_cond=null, cond_non_cover=nc,
            null_cond_non_cover=null_nc, cover_steps=3, guidance_scale=5.0)


@pytest.mark.parametrize("rows,frames,dtype,cover", [
    (1, 40, torch.float32, True),
    (2, 37, torch.float32, True),
    (3, 40, torch.bfloat16, False),
    (4, 37, torch.bfloat16, True),
])
def test_graph_path_turbo_equals_eager(monkeypatch, rows, frames, dtype,
                                       cover):
    cfg, model = _model(dtype=dtype)
    want = _turbo(model, cfg, rows, frames, dtype, cover)
    replay_eagerly(monkeypatch)
    before = _counts()
    got = _turbo(model, cfg, rows, frames, dtype, cover)
    again = _turbo(model, cfg, rows, frames, dtype, cover)
    after = _counts()
    assert torch.equal(got, want) and torch.equal(again, want)
    # one capture at the first step of the key, every other step replayed
    assert {k: after[k] - before[k] for k in after} == {
        "dit_steps": 2 * STEPS, "dit_graph_captures": 1,
        "dit_graph_replays": 2 * STEPS - 1}


def test_replayed_results_outlive_later_steps(monkeypatch):
    """A caller holds each step's result: later steps of the same key and
    of another key (whose buffers sit elsewhere in the one arena) leave
    it as it was."""
    cfg, model = _model()
    g = torch.Generator().manual_seed(5)
    cond = _condition(model, cfg, g, 2, 40, 11, torch.float32)
    other = _condition(model, cfg, g, 1, 37, 11, torch.float32)

    def step(c, rows, frames, seed):
        x = _randn(torch.Generator().manual_seed(seed), rows, frames, 64)
        t = torch.full((rows,), 0.25 * (1 + seed % 3))
        with torch.no_grad():
            return dit.dit_decoder(model, cfg, x, t, t, c.context_latents,
                                   cross_kv_cache=c.cross_kv)

    cases = [(cond, 2, 40, s) for s in range(3)] + [(other, 1, 37, 3),
                                                   (cond, 2, 40, 4)]
    want = [step(*c) for c in cases]
    replay_eagerly(monkeypatch)
    before = _counts()
    held = [step(*c) for c in cases]
    after = _counts()
    assert after["dit_graph_replays"] - before["dit_graph_replays"] == 3
    assert all(torch.equal(h, w) for h, w in zip(held, want))
    assert len({h.data_ptr() for h in held}) == len(held)


@pytest.mark.parametrize("rows,frames", [(1, 37), (2, 40)])
def test_graph_path_guided_equals_eager(monkeypatch, rows, frames):
    """CFG doubles the rows: the key is 2B rows; APG runs eagerly between
    the steps; both conditions switch sides at the cover cut."""
    cfg, model = _model("base")
    want = _guided(model, cfg, rows, frames, torch.float32)
    replay_eagerly(monkeypatch)
    got = _guided(model, cfg, rows, frames, torch.float32)
    assert torch.equal(got, want)
    (key, _), = dit_graphs.graphs_of(model).steps.items()
    assert key.inputs[0][0] == (2 * rows, frames, 64)


def test_arena_grows_and_keys_stay_bounded(monkeypatch):
    """Rows 1-4 in turn, as a REST warm-up forms them: each growth of the
    arena captures the earlier keys again at once, so the next pass over
    the same keys only replays; keys beyond MAX_KEYS are let go, least
    recently used first."""
    cfg, model = _model()
    replay_eagerly(monkeypatch)
    graphs = dit_graphs.graphs_of(model)
    before = _counts()
    for rows in (1, 2, 3, 4):
        _turbo(model, cfg, rows, 40, torch.float32, False)
    grown = _counts()
    for rows in (1, 2, 3, 4):
        _turbo(model, cfg, rows, 40, torch.float32, False)
    after = _counts()
    captures = grown["dit_graph_captures"] - before["dit_graph_captures"]
    # 1 + 2 (grown) + 3 (grown, doubled) + 1: the doubling spares one
    assert 4 < captures <= 7
    assert after["dit_graph_captures"] == grown["dit_graph_captures"]
    assert after["dit_graph_replays"] - grown["dit_graph_replays"] == \
        4 * STEPS
    for frames in range(41, 41 + dit_graphs.MAX_KEYS):
        _turbo(model, cfg, 1, frames, torch.float32, False)
    assert len(graphs.steps) == dit_graphs.MAX_KEYS
    assert all(k.inputs[0][0][1] > 40 for k in graphs.steps)


def test_graph_buffers_share_qs_bytes_and_keep_eager_strides(monkeypatch):
    """The attention output, the cross query and the cross output sit on
    q's bytes; h keeps the channel-major strides `proj_in` gives it."""
    cfg, model = _model()
    replay_eagerly(monkeypatch)
    _turbo(model, cfg, 2, 40, torch.float32, False)
    (_, (specs, step)), = dit_graphs.graphs_of(model).steps.items()
    bufs = step.bufs
    assert {bufs[n].data_ptr() for n in ("q", "attn", "cq", "ca")} == \
        {bufs["q"].data_ptr()}
    others = [bufs[n].data_ptr() for n in bufs if n not in dit_graphs.SHARES_Q]
    assert len(set(others)) == len(others)
    L, H = 20, cfg.hidden_size
    assert specs["h"].stride == (L * H, 1, L)
    assert bufs["h"].stride() == specs["h"].stride


# ------------------------------------------------------------------
# When the graph path engages, and its key
# ------------------------------------------------------------------


@pytest.mark.parametrize("case,engaged", [
    ("inference on a card", True),
    ("cpu", False),
    ("grad enabled", False),
    ("dense", False),
    ("tp_group", False),
    ("quantized", False),
])
def test_engagement(case, engaged):
    cfg, model = _model(attention_impl="dense" if case == "dense" else "auto")
    device = torch.device("cpu" if case == "cpu" else "cuda")
    if case == "tp_group":
        model.decoder.layers[0].self_attn.o_proj.tp_group = object()
    if case == "quantized":
        quantize_module_(model, "int8")
    with torch.set_grad_enabled(case == "grad enabled"):
        assert dit_graphs.engages(model, cfg, device) is engaged


def test_cpu_steps_take_the_eager_path():
    cfg, model = _model()
    before = _counts()
    _turbo(model, cfg, 2, 40, torch.float32, False)
    after = _counts()
    assert after["dit_steps"] - before["dit_steps"] == STEPS
    assert after["dit_graph_captures"] == before["dit_graph_captures"]
    assert after["dit_graph_replays"] == before["dit_graph_replays"]


def test_key_changes_under_an_adapters_weights():
    """`call_with_weights` swaps merged weights in: other pointers, so
    another key; outside the call the key is the base weights' again."""
    cfg, model = _model()
    graphs = dit_graphs.graphs_of(model)
    base = graphs.weights()
    name = "decoder.layers.1.self_attn.q_proj.weight"
    merged = model.get_parameter(name).detach().clone() + 1.0
    inside = call_with_weights(model, {name: merged},
                               lambda m: dit_graphs.graphs_of(m).weights())
    assert inside != base and merged.data_ptr() in inside
    assert graphs.weights() == base


def test_adapter_steps_replay_their_own_graphs(monkeypatch):
    """Base, adapter, base: each set of weights captures once, and the
    adapter's trajectory equals its eager one."""
    cfg, model = _model()
    name = "decoder.layers.0.mlp.gate.weight"
    merged = {name: model.get_parameter(name).detach() * 1.5}

    def both():
        return (_turbo(model, cfg, 2, 40, torch.float32, False),
                call_with_weights(model, merged, lambda m: _turbo(
                    m, cfg, 2, 40, torch.float32, False)))

    want = both()
    replay_eagerly(monkeypatch)
    before = _counts()
    got, again = both(), both()
    after = _counts()
    assert not torch.equal(want[0], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got + again, want + want))
    assert after["dit_graph_captures"] - before["dit_graph_captures"] == 2
