"""Background training service for the REST API.

Port of `TrainingService` in `acestep_tpu/serving/training_service.py`:
the LoRA/LoKr start routes, /v1/training/{stop,status,metrics} and the
tensorboard process. One background thread runs the port's `LoRATrainer`
generator (training/lora.py) on the default DiT handler's model, through
K1 forward and the K2/K3 backward on a CUDA device; progress events land
in a ring buffer served by /v1/training/status; metrics are appended to a
JSONL file, exported to tfevents for tensorboard (utils/tfevents.py).
A quantized DiT trains against its dequantized weights
(ops/quant.dequantized_weights).

The JAX module's `DatasetService` (dataset building, labeling and the
interactive dataset session) is not ported yet: it waits for ROADMAP item
12.3, and the server answers its /v1/dataset/* routes with an error."""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from acestep_torch.serving.jobstore import append_jsonl


class TrainingService:
    def __init__(self, dit_handler):
        self.handler = dit_handler
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        self._state: Dict[str, Any] = {"status": "idle"}
        self._events: deque = deque(maxlen=200)

    # -- control ------------------------------------------------------------

    def start(self, *, dataset_dir: Optional[str] = None,
              manifest_path: Optional[str] = None,
              config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        from acestep_torch.training.lora import LoRATrainingConfig

        if dataset_dir is None and manifest_path is None:
            # validate before the thread exists: the reference API rejects
            # this up front rather than returning 200 and failing async
            raise ValueError("dataset_dir or manifest_path required")
        with self._lock:
            if self._thread and self._thread.is_alive():
                raise RuntimeError("training already running")
            tcfg = LoRATrainingConfig(**(config or {}))
            self._stop_flag.clear()
            self._events.clear()    # status() must not show the previous run
            self._state = {"status": "starting", "step": 0,
                           "max_steps": tcfg.max_steps,
                           "loss": None, "started_at": time.time(),
                           "output_dir": tcfg.output_dir}
            self._thread = threading.Thread(
                target=self._run, args=(tcfg, dataset_dir, manifest_path),
                daemon=True)
            self._thread.start()
        return {"status": "started", "config": tcfg.to_dict()}

    def stop(self) -> Dict[str, Any]:
        self._stop_flag.set()
        return {"status": "stopping"}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            state = dict(self._state)
            state["events"] = list(self._events)[-20:]
            return state

    # -- worker -------------------------------------------------------------

    def _run(self, tcfg, dataset_dir: Optional[str],
             manifest_path: Optional[str]) -> None:
        try:
            from acestep_torch.training.data import (PreprocessedDataset,
                                                     make_batches)
            from acestep_torch.training.lora import LoRATrainer
            from acestep_torch.training.preprocess import \
                preprocess_audio_files

            if dataset_dir is None:
                dataset_dir = os.path.join(tcfg.output_dir, "tensors")
                self._update(status="preprocessing")
                preprocess_audio_files(self.handler, manifest_path,
                                       dataset_dir)

            dataset = PreprocessedDataset(dataset_dir)
            batches = make_batches(
                dataset.train_files, tcfg.batch_size,
                latent_dim=self.handler.cfg.audio_acoustic_hidden_dim)
            base_weights = None
            if getattr(self.handler, "quantization", None):
                # a server running a quantized DiT trains against its
                # dequantized weights (w8a8 included), as the JAX service
                # dequantizes its base tree
                from acestep_torch.ops.quant import dequantized_weights
                base_weights = dequantized_weights(self.handler.model,
                                                   self.handler.dtype)
                self._update(dequantized_base=True)
            trainer = LoRATrainer(self.handler.model, self.handler.cfg, tcfg,
                                  base_weights=base_weights)
            self._update(status="training")
            metrics_path = os.path.join(tcfg.output_dir, "metrics.jsonl")

            def stoppable(source):
                for batch in source:
                    if self._stop_flag.is_set():
                        return
                    yield batch

            for step, loss, message in trainer.train(stoppable(batches)):
                event = {"step": step, "loss": loss,
                         "message": message, "ts": time.time()}
                with self._lock:   # status() list()s the deque under the lock
                    self._state.update(step=step, loss=loss)
                    self._events.append(event)
                append_jsonl(metrics_path, {"step": step, "loss": loss,
                                            "ts": time.time()})
                if self._stop_flag.is_set():
                    break
            # hand the trained adapter to the live LoRA runtime BEFORE the
            # terminal status flips (clients poll status then use the adapter)
            adapter_path = os.path.join(tcfg.output_dir,
                                        f"{tcfg.adapter_name}.npz")
            if os.path.exists(adapter_path) and self.handler.lora is not None:
                self.handler.lora.load(adapter_path,
                                       adapter_name=tcfg.adapter_name)
                self._update(adapter_loaded=tcfg.adapter_name)
            self._update(status="stopped" if self._stop_flag.is_set()
                         else "completed", finished_at=time.time())
        except Exception as e:
            self._update(status="failed", error=str(e))

    def _update(self, **kw) -> None:
        with self._lock:
            self._state.update(kw)

    # -- metrics + tensorboard (reference api_server.py:557-622) -------------

    def metrics(self, output_dir: Optional[str] = None,
                max_points: int = 500) -> Dict[str, Any]:
        """Parsed loss curve from the run's metrics.jsonl (the
        tensorboard-equivalent artifact), downsampled for plotting."""
        import json

        output_dir = output_dir or self._state.get("output_dir")
        if not output_dir:
            return {"steps": [], "loss": [], "points": 0}
        path = os.path.join(output_dir, "metrics.jsonl")
        steps, losses = [], []
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("loss") is not None:
                        steps.append(rec.get("step", len(steps)))
                        losses.append(float(rec["loss"]))
        except OSError:
            return {"steps": [], "loss": [], "points": 0}
        n = len(steps)
        if n > max_points:          # stride-downsample, keep the last point
            stride = -(-n // max_points)
            idx = list(range(0, n, stride))
            if idx[-1] != n - 1:
                idx.append(n - 1)
            steps = [steps[i] for i in idx]
            losses = [losses[i] for i in idx]
        return {"steps": steps, "loss": losses, "points": n,
                "output_dir": output_dir}

    def tensorboard_start(self, logdir: Optional[str] = None,
                          port: int = 6006) -> Dict[str, Any]:
        """Launch a TensorBoard subprocess (reference _start_tensorboard).

        The trainer itself logs to metrics.jsonl, not tfevents, so before
        launching we export the run's JSONL into real tfevents under the
        logdir (utils/tfevents.py) — otherwise the dashboard would be
        permanently empty. The JSONL metrics endpoint stays the
        always-available fallback."""
        import shutil
        import subprocess
        import sys

        from acestep_torch.utils import tfevents

        logdir = logdir or self._state.get("output_dir")
        if not logdir:
            raise RuntimeError(
                "no training run active and no logdir given; pass logdir "
                "or use /v1/training/metrics for the JSONL loss curve")
        metrics_path = os.path.join(logdir, "metrics.jsonl")
        exported = None
        if self._needs_tfevents_export(logdir, metrics_path):
            exported = tfevents.export_metrics_jsonl(metrics_path, logdir)
        if exported is None and not tfevents.has_event_files(logdir):
            # nothing plottable at all (typo'd/empty logdir): fail with a
            # diagnostic instead of launching a blank dashboard
            raise RuntimeError(
                f"no tfevents and no plottable metrics.jsonl under "
                f"{logdir}; use /v1/training/metrics for the JSONL "
                f"loss curve instead")
        binary = shutil.which("tensorboard")
        if binary is not None:
            cmd = [binary]
        else:
            try:                    # package without the console script
                import tensorboard  # noqa: F401
                cmd = [sys.executable, "-m", "tensorboard.main"]
            except ImportError:
                raise RuntimeError(
                    "tensorboard is not installed; use /v1/training/metrics "
                    "for the JSONL loss curve instead")
        with self._lock:
            proc = getattr(self, "_tb_proc", None)
            if proc is not None and proc.poll() is None:
                return {"status": "already_running", "url": self._tb_url}
        # launch + liveness grace OUTSIDE the lock: holding it through
        # Popen+sleep would stall the training loop's per-step updates and
        # every status poll for seconds
        proc = subprocess.Popen(
            cmd + ["--logdir", logdir, "--port", str(port), "--bind_all"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        time.sleep(3.0)         # catch instant deaths (broken TB install)
        if proc.poll() is not None:
            raise RuntimeError(
                f"tensorboard exited immediately (rc={proc.returncode});"
                " use /v1/training/metrics for the JSONL loss curve"
                " instead")
        lost_race = False
        with self._lock:
            other = getattr(self, "_tb_proc", None)
            if other is not None and other.poll() is None:
                lost_race = True
            else:
                self._tb_proc = proc
                self._tb_url = f"http://localhost:{port}"
        if lost_race:               # terminate + reap OUTSIDE the lock
            proc.terminate()
            try:                    # reap: no zombies on a long-lived server
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 — best-effort reap
                proc.kill()
                proc.wait(timeout=5)
            return {"status": "already_running", "url": self._tb_url}
        return {"status": "started", "url": self._tb_url, "logdir": logdir,
                "exported_events": exported}

    @staticmethod
    def _needs_tfevents_export(logdir: str, metrics_path: str) -> bool:
        """Export when there are no event files yet OR metrics.jsonl has
        newer data than the newest event file (a second run into the same
        output_dir must not leave the dashboard showing the first run)."""
        from acestep_torch.utils import tfevents

        if not os.path.exists(metrics_path):
            return False
        if not tfevents.has_event_files(logdir):
            return True
        newest = 0.0
        for root, _dirs, files in os.walk(logdir):
            for name in files:
                if "tfevents" in name:
                    try:
                        newest = max(newest, os.path.getmtime(
                            os.path.join(root, name)))
                    except OSError:
                        pass
        return os.path.getmtime(metrics_path) > newest

    def tensorboard_stop(self) -> Dict[str, Any]:
        with self._lock:
            proc = getattr(self, "_tb_proc", None)
            self._tb_proc = None
        if proc is None or proc.poll() is not None:
            return {"status": "not_running"}
        proc.terminate()            # terminate + reap OUTSIDE the lock
        try:
            proc.wait(timeout=10)
        except Exception:  # noqa: BLE001 — best-effort reap
            proc.kill()
            proc.wait(timeout=5)
        return {"status": "stopped"}
