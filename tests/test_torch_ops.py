"""The port's primitives (acestep_torch/ops) against the JAX package's, on
the same seeded numpy inputs, float32 on the CPU.

Tolerance: 1e-5 absolute on O(1) values unless stated. Both sides compute
in float32 with full-precision products; what differs is summation order,
a few ulp per reduction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from acestep_tpu.ops import basic as jb
from acestep_tpu.ops import conv as jc
from acestep_tpu.ops import fsq as jf
from acestep_tpu.ops import masks as jm
from acestep_torch.ops import basic as tb
from acestep_torch.ops import conv as tc
from acestep_torch.ops import fsq as tf
from acestep_torch.ops import masks as tm
from torch_parity import assert_close, highest, randn, t

ATOL = 1e-5


def _linear(w, b=None):
    m = nn.Linear(w.shape[0], w.shape[1], bias=b is not None)
    with torch.no_grad():
        m.weight.copy_(t(w.T))
        if b is not None:
            m.bias.copy_(t(b))
    return m


def _attn_params(seed, hidden=32, hq=4, hkv=2, d=8):
    ws = {n: randn(seed + i, hidden, o, scale=0.2) for i, (n, o) in enumerate(
        [("q_proj", hq * d), ("k_proj", hkv * d), ("v_proj", hkv * d)])}
    ws["o_proj"] = randn(seed + 3, hq * d, hidden, scale=0.2)
    qs, ks = 1 + randn(seed + 4, d, scale=0.1), 1 + randn(seed + 5, d, scale=0.1)
    jp = {n: {"w": jnp.asarray(w)} for n, w in ws.items()}
    jp["q_norm"], jp["k_norm"] = {"scale": jnp.asarray(qs)}, {"scale": jnp.asarray(ks)}
    tp = tb.Attention(hidden, hq, hkv, d)
    with torch.no_grad():
        for n, w in ws.items():
            getattr(tp, n).weight.copy_(t(w.T))
        tp.q_norm.scale.copy_(t(qs))
        tp.k_norm.scale.copy_(t(ks))
    return jp, tp


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    w, x = randn(0, 12, 20), randn(1, 3, 5, 12)
    b = randn(2, 20) if bias else None
    jp = {"w": jnp.asarray(w)} | ({"b": jnp.asarray(b)} if bias else {})
    with highest():
        want = jb.linear(jp, jnp.asarray(x))
    assert_close(tb.linear(_linear(w, b), t(x)), want, atol=ATOL)


def test_rms_norm_and_mlp():
    x, scale = randn(0, 2, 7, 16), 1 + randn(1, 16, scale=0.1)
    norm = tb.RMSNorm(16)
    with torch.no_grad():
        norm.scale.copy_(t(scale))
    want = jb.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert_close(tb.rms_norm(norm, t(x)), want, atol=ATOL)

    g, u, d = randn(2, 16, 24, scale=0.3), randn(3, 16, 24, scale=0.3), \
        randn(4, 24, 16, scale=0.3)
    m = tb.MLP(16, 24)
    with torch.no_grad():
        m.gate.weight.copy_(t(g.T))
        m.up.weight.copy_(t(u.T))
        m.down.weight.copy_(t(d.T))
    with highest():
        want = jb.mlp({"gate": {"w": g}, "up": {"w": u}, "down": {"w": d}},
                      jnp.asarray(x))
    assert_close(tb.mlp(m, t(x)), want, atol=ATOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    x = randn(0, 2, 9, 3, 16)
    if per_row:
        pos = np.stack([np.arange(9), np.arange(9) + 5]).astype(np.float32)
        jcs = jb.rope_cos_sin(None, 16, 1e6, positions=jnp.asarray(pos))
        tcs = tb.rope_cos_sin(None, 16, 1e6, positions=t(pos))
    else:
        jcs, tcs = jb.rope_cos_sin(9, 16, 1e6), tb.rope_cos_sin(9, 16, 1e6)
    # cos/sin of arguments up to ~14 rad: float32 argument reduction
    assert_close(tcs[0], jcs[0], atol=ATOL)
    assert_close(tcs[1], jcs[1], atol=ATOL)
    assert_close(tb.apply_rope(t(x), *tcs),
                 jb.apply_rope(jnp.asarray(x), *jcs), atol=ATOL)


@pytest.mark.parametrize("window", [None, 3])
def test_sdpa_masked_gqa(window):
    q, k, v = randn(0, 2, 11, 4, 8), randn(1, 2, 13, 2, 8), randn(2, 2, 13, 2, 8)
    pad = np.ones((2, 13), np.int32)
    pad[1, 9:] = 0
    jmask = jm.bidirectional_mask(13, jnp.asarray(pad), window=window)[:, :, :11]
    tmask = tm.bidirectional_mask(13, t(pad), window=window)[:, :, :11]
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    with highest():
        want, _ = jb._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask)
    assert_close(tb._sdpa(t(q), t(k), t(v), tmask), want, atol=ATOL)


def test_masks():
    pad = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    for w in (None, 1):
        assert np.array_equal(tm.causal_mask(5, t(pad), window=w).numpy(),
                              np.asarray(jm.causal_mask(5, jnp.asarray(pad), window=w)))
    assert np.array_equal(tm.cross_mask(3, t(pad)).numpy(),
                          np.asarray(jm.cross_mask(3, jnp.asarray(pad))))


def test_self_cross_attention_and_cached_kv():
    jp, tp = _attn_params(10)
    x, enc = randn(0, 2, 9, 32), randn(1, 2, 6, 32)
    jr, tr = jb.rope_cos_sin(9, 8, 1e6), tb.rope_cos_sin(9, 8, 1e6)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8)
    jmask = jm.bidirectional_mask(9, window=2)
    tmask = tm.bidirectional_mask(9, window=2)
    with highest():
        want_self = jb.attention(jp, jnp.asarray(x), mask=jmask, rope=jr, **kw)
        want_cross = jb.attention(jp, jnp.asarray(x), kv_src=jnp.asarray(enc), **kw)
        jk, jv = jb.cross_kv(jp, jnp.asarray(enc), num_kv_heads=2, head_dim=8)
        want_kv = jb.attention_kv(jp, jnp.asarray(x), jk, jv, num_heads=4, head_dim=8)
    assert_close(tb.attention(tp, t(x), mask=tmask, rope=tr, **kw), want_self, atol=ATOL)
    assert_close(tb.attention(tp, t(x), kv_src=t(enc), **kw), want_cross, atol=ATOL)
    tk, tv = tb.cross_kv(tp, t(enc), num_kv_heads=2, head_dim=8)
    assert_close(tk, jk, atol=ATOL)
    assert_close(tv, jv, atol=ATOL)
    assert_close(tb.attention_kv(tp, t(x), tk, tv, num_heads=4, head_dim=8),
                 want_kv, atol=ATOL)


def test_attention_flash_matches_dense_attention():
    """The decoder's flash path (plain version on the CPU) equals the dense
    masked attention of the JAX package, banded and full."""
    jp, tp = _attn_params(20)
    x = randn(0, 2, 21, 32)
    jr, tr = jb.rope_cos_sin(21, 8, 1e6), tb.rope_cos_sin(21, 8, 1e6)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8)
    for window in (4, None):
        with highest():
            want = jb.attention(jp, jnp.asarray(x), rope=jr,
                                mask=jm.bidirectional_mask(21, window=window), **kw)
        assert_close(tb.attention_flash(tp, t(x), rope=tr, window=window, **kw),
                     want, atol=ATOL)


@pytest.mark.parametrize("dim", [256, 7])
def test_timestep_sinusoidal(dim):
    ts = np.array([0.0, 0.3, 0.875, 1.0], np.float32)
    # arguments up to 1000 rad: float32 cos/sin of large arguments differ
    # by a few ulp of the argument between libms (~6e-5 at 1000)
    assert_close(tb.timestep_sinusoidal(t(ts), dim),
                 jb.timestep_sinusoidal(jnp.asarray(ts), dim), atol=2e-4)


def test_fsq_roundtrip_and_indices():
    """FSQ indices agree exactly away from rounding ties; none of these
    inputs sits within 1e-4 of a tie."""
    levels = (8, 8, 8, 5, 5, 5)
    z = randn(0, 3, 17, 6, scale=1.5)
    jcodes, jidx = jf.fsq_quantize(jnp.asarray(z), levels, ste=False)
    tcodes, tidx = tf.fsq_quantize(t(z), levels)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert_close(tcodes, jcodes, atol=1e-6)
    assert np.array_equal(tf.fsq_codes_to_indices(tcodes, levels).numpy(),
                          np.asarray(jf.fsq_codes_to_indices(jcodes, levels)))
    idx = np.arange(0, 64000, 997, dtype=np.int32)
    assert_close(tf.fsq_indices_to_codes(t(idx), levels),
                 jf.fsq_indices_to_codes(jnp.asarray(idx), levels), atol=0)


@pytest.mark.parametrize("stride,padding,dilation,k", [
    (1, 3, 1, 7), (1, 9, 3, 7), (2, 0, 1, 2), (4, 2, 1, 8)])
def test_conv1d(stride, padding, dilation, k):
    w, b, x = randn(0, k, 6, 10, scale=0.3), randn(1, 10), randn(2, 2, 33, 6)
    m = nn.Conv1d(6, 10, k)
    with torch.no_grad():
        m.weight.copy_(t(w.transpose(2, 1, 0)))
        m.bias.copy_(t(b))
    want = jc.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     stride=stride, padding=padding, dilation=dilation)
    got = tc.conv1d(m, t(x), stride=stride, padding=padding, dilation=dilation)
    assert_close(got, want, atol=ATOL)


@pytest.mark.parametrize("stride,padding,k", [(2, 0, 2), (4, 2, 8), (10, 5, 20)])
def test_conv1d_transpose(stride, padding, k):
    w, b, x = randn(0, k, 6, 5, scale=0.3), randn(1, 5), randn(2, 2, 9, 6)
    m = nn.ConvTranspose1d(6, 5, k)
    with torch.no_grad():
        m.weight.copy_(t(w.transpose(1, 2, 0)))
        m.bias.copy_(t(b))
    want = jc.conv1d_transpose({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x), stride=stride, padding=padding)
    got = tc.conv1d_transpose(m, t(x), stride=stride, padding=padding)
    assert_close(got, want, atol=ATOL)
