"""The fused snake + conv stack's packed weights are cached on the stack
(`ops/snake_conv.packed_params`), on the CPU: the same tensors until a
parameter changes in place, then fresh ones equal to `pack_params`."""

import pytest
import torch

from acestep_torch.models.vae import ResUnit
from acestep_torch.ops import snake_conv as sc


def _stack(C=16, seed=0):
    torch.manual_seed(seed)
    return [ResUnit(C) for _ in range(3)]


def _same(a, b):
    return all(x is y for x, y in zip(a, b))


def test_packed_params_cached_until_a_parameter_changes():
    units = _stack()
    first = sc.packed_params(units, "cpu").params
    assert _same(sc.packed_params(units, "cpu").params, first)
    assert all(torch.equal(x, y) for x, y in
               zip(first, sc.pack_params(units, "cpu")))
    assert first[0].shape == (3, 8, 16, 16)


@pytest.mark.parametrize("update", [
    lambda us: us[0].conv1.weight.mul_(2.0),          # a k=7 tap
    lambda us: us[1].conv2.weight.add_(0.5),          # the k=1 conv
    lambda us: us[2].snake2.beta.fill_(0.3),          # a snake table
    lambda us: us[1].conv1.bias.zero_(),              # a bias
])
def test_packed_params_repacked_after_an_in_place_update(update):
    units = _stack(seed=1)
    first = sc.packed_params(units, "cpu").params
    with torch.no_grad():
        update(units)
    again = sc.packed_params(units, "cpu").params
    assert not _same(again, first)
    assert all(torch.equal(x, y) for x, y in
               zip(again, sc.pack_params(units, "cpu")))
    assert not all(torch.equal(x, y) for x, y in zip(again, first))
    assert _same(sc.packed_params(units, "cpu").params, again)


def test_packed_params_follow_new_parameter_tensors():
    """`load_state_dict` copies in place; a module moved to another dtype
    gets new tensors: both repack."""
    units, other = _stack(seed=2), _stack(seed=3)
    first = sc.packed_params(units, "cpu").params
    for u, o in zip(units, other):
        u.load_state_dict(o.state_dict())
    loaded = sc.packed_params(units, "cpu").params
    assert torch.equal(loaded[0], sc.pack_params(other, "cpu")[0])
    assert not torch.equal(loaded[0], first[0])
    doubled = [u.double() for u in units]
    assert not _same(sc.packed_params(doubled, "cpu").params, loaded)
