"""The process layer of `acestep_torch.parallel.mesh` on the CPU: a world
of 2 CPU ranks (gloo) whose waits inside a command are bounded by 12 s in
place of the default 60 s. An idle world stays up longer than that bound
(a follower's wait for its next command has none; its watch of rank 0's
process ends it); a rank that raises makes rank 0 raise `MeshError` with
its traceback and takes the world down; an out-of-memory failure is an
out-of-memory error to rank 0; the next `make_mesh`, and the handlers'
next calls, start a new world on the same devices; closing the last mesh
stops the followers (exit code 0) and leaves the process group. A world
holds to the devices and backend it was made with."""

import time
from unittest import mock

import numpy as np
import pytest
import torch

from acestep_torch.config import DiTConfig, VAEConfig
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.parallel import MeshError, MeshOutOfMemoryError, make_mesh
from acestep_torch.parallel import mesh as pm
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.utils.memory import is_oom_error
from torch_mesh_helpers import fail_on, oom_on, store_under

BOUND_S = 12.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp, \
            store_under(tmp_path_factory.mktemp("world")):
        mp.setattr(pm, "TIMEOUT_S", BOUND_S)
        mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
    yield mesh
    mesh.close()


def test_idle_world_stays_up(world):
    assert world.world.timeout == BOUND_S
    time.sleep(BOUND_S + 2)
    assert world.call(fail_on, 9).tolist() == [0.0]
    assert world.world.down is None


def test_follower_failure_surfaces_and_close_stops_followers(world):
    """Rank 1 raises: rank 0 raises MeshError naming it, with its
    traceback, and every later command raises; closing the mesh still
    stops the follower cleanly and leaves the process group."""
    import torch.distributed as dist

    with pytest.raises(MeshError, match="planned failure on rank 1"):
        world.call(fail_on, 1)
    with pytest.raises(MeshError, match="down"):
        world.call(fail_on, 9)
    procs = world.world.procs
    world.close()
    assert [p.exitcode for p in procs] == [0]
    assert not dist.is_initialized()


def test_follower_oom_and_a_new_world(tmp_path):
    """A follower's out-of-memory error reaches rank 0 as one (the
    handlers' out-of-memory ladders take it); the next `make_mesh` starts
    a new world on the down world's devices. A world refuses a mesh on
    other devices or another backend, and a handler whose device is not
    its rank 0's."""
    with store_under(tmp_path):
        mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
        again = None
        try:
            with pytest.raises(MeshOutOfMemoryError, match="planned") as e:
                mesh.call(oom_on, 1)
            assert isinstance(e.value, torch.cuda.OutOfMemoryError)
            assert is_oom_error(e.value) and mesh.down
            with pytest.raises(ValueError, match="world runs 'gloo'"):
                make_mesh(2, 1, backend="nccl")
            with pytest.raises(ValueError, match="ranks are on"):
                make_mesh(2, 1, devices=["cpu", "meta"])
            with pytest.raises(ValueError, match="rank 0 on cpu"):
                pm.mesh_devices("cuda:1")
            again = make_mesh(2, 1)
            assert again.world is not mesh.world and not again.down
            assert again.world.devices == mesh.world.devices
            assert again.call(fail_on, 9).tolist() == [0.0]
        finally:
            mesh.close()
            if again is not None:
                again.close()
    assert pm._WORLD is None


def _render(h):
    return h.generate_music(["a", "b"], ["x", "x"], seeds=[1, 2],
                            audio_duration=1.0, normalize=False)


def _codes(lm):
    return lm.engine.generate_codes(["make music"], n_codes=6, seed=5,
                                    temperature=0.0)


def test_handlers_make_their_meshes_again_after_a_failure(tmp_path):
    """A rank fails a command of the DiT's dp=2 mesh, which the tp=2
    planner shares: the next render makes the DiT's mesh again on a new
    world and renders what the unsharded handler renders, and the planner
    builds its engine again on that world, with the same greedy codes."""
    th = AceStepHandler(DiTConfig.tiny(),
                        VAEConfig.tiny(decoder_input_channels=64),
                        dtype=torch.float32, device="cpu", frame_bucket=25,
                        min_frames=25, refer_frames=10)
    th.initialize_service(seed=0)
    want = _render(th)
    lm = LLMHandler(dtype=torch.float32, device="cpu")
    with store_under(tmp_path):
        th.enable_mesh(dp=2, tp=1)
        try:
            lm.initialize(num_fallback_codes=64, seed=0, tensor_parallel=2)
            codes = _codes(lm)
            old = th.mesh.world
            with pytest.raises(MeshError, match="planned failure"):
                th.mesh.call(fail_on, 1)
            assert th.mesh.down and lm.mesh.down
            got = _render(th)
            assert th.mesh.world is not old and not th.mesh.down
            assert _codes(lm) == codes
            assert lm.mesh.world is th.mesh.world
        finally:
            lm.release()
            th.release_mesh()
    assert pm._WORLD is None
    np.testing.assert_allclose(got.pred_latents, want.pred_latents,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", 2, ["cuda:0", "cuda:1"]),
    ("cuda:1", 2, ["cuda:1", "cuda:0"]),
    ("cuda", 1, ["cuda:0"]),
])
def test_default_mesh_devices_count_each_card_once(monkeypatch, device,
                                                   cards, want):
    """A handler on the bare 'cuda' device (the default of the server, the
    CLI and the facades) makes its mesh over each card once, its own
    first: `enable_mesh()` on one card is a 1-rank NCCL mesh."""
    monkeypatch.setattr(pm, "_WORLD", None)
    with mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "device_count", lambda: cards), \
            mock.patch.object(torch.cuda, "current_device", lambda: 0):
        got = pm.mesh_devices(torch.device(device))
    assert [str(d) for d in got] == want
