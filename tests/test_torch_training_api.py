"""LoRA training over REST on the CPU: the port's `TrainingService` runs 2
steps on tiny preprocessed tensors beside the JAX package's service on the
same tensors (the JAX handler's seeded weights carried across); status and
metrics carry the JAX service's keys, the adapter file loads into the
`LoraManager`, a quantized service trains against its dequantized weights,
and the tfevents export reads back with its CRCs, record for record equal
to the JAX export. The two trainers draw their noise from different RNGs,
so losses are compared only for being finite; keys and records exactly."""

import json
import os
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_tpu.serving.training_service import TrainingService as JService
from acestep_tpu.utils import tfevents as jtf
from acestep_torch.lora.manager import load_adapter_file
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.serving.training_service import TrainingService
from acestep_torch.training.preprocess import preprocess_samples
from acestep_torch.utils import tfevents as ttf
from acestep_torch.utils.audio import save_wav
from torch_parity import np_tree, port_cfg, tiny_dit_cfg, tiny_vae_cfg

GEOM = dict(frame_bucket=8, min_frames=8)
CONFIG = {"rank": 2, "max_steps": 2, "batch_size": 1, "checkpoint_every": 0,
          "log_every": 1, "adapter_name": "api_adapter"}


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


@pytest.fixture(scope="module")
def tensors(handlers, tmp_path_factory):
    _, th = handlers
    root = tmp_path_factory.mktemp("tensors")
    rng = np.random.default_rng(0)
    samples = []
    for i in range(3):
        path = str(root / f"s{i}.wav")
        save_wav(path, (0.1 * rng.standard_normal((8 * 40, 2))).astype(
            np.float32))
        samples.append({"audio_path": path, "caption": f"s{i}",
                        "lyrics": "[inst]"})
    out = str(root / "tensors")
    list(preprocess_samples(th, samples, out))
    return out


def _run(svc, tensors, out_dir, **extra):
    svc.start(dataset_dir=tensors, config=dict(CONFIG, output_dir=out_dir,
                                               **extra))
    deadline = time.time() + 300
    while time.time() < deadline:
        st = svc.status()
        if st["status"] in ("completed", "failed", "stopped"):
            return st
        time.sleep(0.1)
    raise TimeoutError(st)


def test_status_and_metrics_keys_equal_jax(handlers, tensors, tmp_path):
    jh, th = handlers
    got = _run(TrainingService(th), tensors, str(tmp_path / "t"))
    want = _run(JService(jh), tensors, str(tmp_path / "j"))
    assert got["status"] == want["status"] == "completed", (got, want)
    assert set(got) == set(want)
    assert got["step"] == want["step"] == 2
    assert [set(e) for e in got["events"]] == [set(e) for e in want["events"]]
    assert [e["step"] for e in got["events"]] == \
        [e["step"] for e in want["events"]]
    assert np.isfinite(got["loss"])
    tm = TrainingService(th).metrics(output_dir=str(tmp_path / "t"))
    jm = JService(jh).metrics(output_dir=str(tmp_path / "j"))
    assert set(tm) == set(jm) and tm["steps"] == jm["steps"]
    # the trained adapter: in the handler's LoRA runtime, and on disk in
    # the JAX layout with its targets and stacked factors
    assert th.lora.status()["active_adapter"] == "api_adapter"
    adapter = load_adapter_file(str(tmp_path / "t" / "api_adapter.npz"))
    assert adapter["meta"]["rank"] == 2
    assert len(adapter["weights"]) == 11
    with np.load(str(tmp_path / "j" / "api_adapter.npz")) as z:
        jkeys = set(z.files)
    with np.load(str(tmp_path / "t" / "api_adapter.npz")) as z:
        assert set(z.files) == jkeys


def test_quantized_service_trains_on_dequantized_base(tensors, tmp_path):
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(seed=1, quantization="int8")
    st = _run(TrainingService(th), tensors, str(tmp_path / "q"))
    assert st["status"] == "completed", st
    assert st.get("dequantized_base") is True and st["step"] == 2
    assert np.isfinite(st["loss"])


def test_start_validates_and_rejects_a_second_run(handlers, tensors,
                                                  tmp_path):
    _, th = handlers
    svc = TrainingService(th)
    with pytest.raises(ValueError, match="dataset_dir or manifest_path"):
        svc.start()
    svc.start(dataset_dir=tensors, config=dict(
        CONFIG, max_steps=500, output_dir=str(tmp_path / "long")))
    with pytest.raises(RuntimeError, match="already running"):
        svc.start(dataset_dir=tensors, config={})
    assert svc.stop() == {"status": "stopping"}
    deadline = time.time() + 120
    while svc.status()["status"] not in ("stopped", "completed", "failed"):
        assert time.time() < deadline
        time.sleep(0.1)
    assert svc.status()["status"] == "stopped"


def _records(path):
    """Payloads of a TFRecord file, each record's two CRCs checked."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == \
            ttf._masked_crc(header)
        payload = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == \
            ttf._masked_crc(payload)
        out.append(payload)
        pos += 16 + n
    return out


def test_tfevents_export_reads_back(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    rows = [{"step": s, "loss": 1.0 / (s + 1), "ts": 1000.0 + s}
            for s in range(5)] + [{"step": 5}]
    metrics.write_text("".join(json.dumps(r) + "\n" for r in rows))
    got = ttf.export_metrics_jsonl(str(metrics), str(tmp_path / "t"))
    want = jtf.export_metrics_jsonl(str(metrics), str(tmp_path / "j"))
    assert os.path.basename(got) == os.path.basename(want)
    assert ttf.has_event_files(str(tmp_path / "t"))
    recs = _records(got)
    # the version stamp (with the export's own wall time), then one event
    # per plottable row, byte-equal to the JAX export's
    assert len(recs) == 6 and b"brain.Event:2" in recs[0]
    assert recs[1:] == _records(want)[1:]
    assert ttf.crc32c(b"123456789") == 0xE3069283
