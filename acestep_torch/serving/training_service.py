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

`DatasetService` is the port of the JAX module's: the staged dataset build
(training/dataset_builder.py) on a background thread behind
/v1/dataset/{build,status}, and the interactive dataset session
(training/dataset_session.py) behind the other /v1/dataset/* routes. Its
device work (the VAE encode on K4, the DiT tokenizer, the text encoder,
the planner's `understand`) runs on threads of its own, never on the HTTP
thread that asked for it. Each stage that touches the device runs whole
under the server's device lock (its reinit lock), which every other user
of the DiT handler and the planner takes too: a build neither runs beside
a render on the same models nor replays the planner's CUDA graphs while a
worker's job is using them. A job queued meanwhile waits for the stage
to end."""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

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


class DatasetService:
    """Background dataset builds for the studio dataset tab: one
    DatasetBuildPipeline at a time, per-stage progress from its status();
    and the interactive session with its auto_label / preprocess tasks.
    `lock` is held through each stage that calls the handler or the
    planner (the server passes its reinit lock)."""

    def __init__(self, dit_handler, llm_handler=None, lock=None):
        self.handler = dit_handler
        self.llm = llm_handler
        self._device_lock = lock or threading.Lock()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._state: Dict[str, Any] = {"status": "idle"}
        self._pipeline = None
        self.session = None                      # interactive DatasetSession
        self._tasks: Dict[str, Dict[str, Any]] = {}
        self._latest_task: Dict[str, str] = {}

    def start(self, audio_dir: str, out_dir: str, *,
              val_fraction: float = 0.0,
              use_llm_labels: bool = True) -> Dict[str, Any]:
        from acestep_torch.training.dataset_builder import \
            DatasetBuildPipeline

        with self._lock:
            if self._thread and self._thread.is_alive():
                raise RuntimeError("a dataset build is already running")
            if not os.path.isdir(audio_dir):
                raise FileNotFoundError(f"audio_dir not found: {audio_dir}")
            self._pipeline = DatasetBuildPipeline(
                audio_dir, out_dir, self.handler,
                self.llm if use_llm_labels else None,
                val_fraction=val_fraction)
            self._state = {"status": "running", "audio_dir": audio_dir,
                           "out_dir": out_dir, "started_at": time.time()}
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return {"status": "started", "out_dir": out_dir}

    def _run(self) -> None:
        try:
            result = self._pipeline.build(device_lock=self._device_lock)
            with self._lock:
                self._state.update(status="completed", result=result,
                                   finished_at=time.time())
        except Exception as e:
            with self._lock:
                self._state.update(status="failed", error=str(e))

    def status(self) -> Dict[str, Any]:
        with self._lock:
            state = dict(self._state)
        if self._pipeline is not None:
            try:
                state["progress"] = self._pipeline.status()
            except Exception:
                pass
        return state

    # -- interactive session (reference train_api_dataset_service.py) ----
    #
    # scan/load -> edit samples -> auto_label (sync or async task) ->
    # save -> preprocess (sync or async task). One session at a time,
    # like the reference's app.state.dataset_builder.

    def _session_required(self):
        if self.session is None:
            raise RuntimeError(
                "No dataset loaded. Scan or load a dataset first.")
        return self.session

    def scan(self, audio_dir: str, *, dataset_name: str = "my_lora_dataset",
             custom_tag: str = "", tag_position: str = "replace",
             all_instrumental: bool = True) -> Dict[str, Any]:
        from acestep_torch.training.dataset_session import DatasetSession

        session = DatasetSession()
        session.metadata.name = dataset_name
        session.metadata.tag_position = tag_position
        session.metadata.all_instrumental = all_instrumental
        n = session.scan_directory(audio_dir)
        session.set_all_instrumental(all_instrumental)
        if custom_tag:
            session.set_custom_tag(custom_tag, tag_position)
        with self._lock:
            self.session = session
        return {"message": f"Scanned {n} audio files", "num_samples": n,
                "samples": session.serialize_samples()}

    def load_session(self, dataset_path: str) -> Dict[str, Any]:
        from acestep_torch.training.dataset_session import DatasetSession

        session = DatasetSession()
        n = session.load(dataset_path)
        with self._lock:
            self.session = session
        return {"message": f"Loaded {n} samples",
                "dataset_name": session.metadata.name,
                "num_samples": n,
                "labeled_count": session.labeled_count(),
                "samples": session.serialize_samples()}

    def save_session(self, save_path: str, *,
                     dataset_name: Optional[str] = None,
                     custom_tag: Optional[str] = None,
                     tag_position: Optional[str] = None,
                     all_instrumental: Optional[bool] = None,
                     genre_ratio: Optional[int] = None) -> Dict[str, Any]:
        s = self._session_required()
        if dataset_name:
            s.metadata.name = dataset_name
        if tag_position is not None:
            s.metadata.tag_position = tag_position
        if custom_tag is not None:
            s.set_custom_tag(custom_tag, s.metadata.tag_position)
        if all_instrumental is not None:
            s.set_all_instrumental(bool(all_instrumental))
        if genre_ratio is not None:
            s.metadata.genre_ratio = max(0, min(100, int(genre_ratio)))
        path = s.save(save_path)
        return {"message": f"Saved to {path}", "path": path,
                "num_samples": len(s.samples)}

    def samples(self) -> Dict[str, Any]:
        s = self._session_required()
        return {"num_samples": len(s.samples),
                "labeled_count": s.labeled_count(),
                "samples": s.serialize_samples()}

    def sample(self, idx: int) -> Dict[str, Any]:
        s = self._session_required()
        if not 0 <= idx < len(s.samples):
            raise IndexError(f"sample index {idx} out of range")
        return {"index": idx, **s.samples[idx].to_dict()}

    def update_sample(self, idx: int,
                      fields: Dict[str, Any]) -> Dict[str, Any]:
        s = self._session_required()
        updated = s.update_sample(idx, fields)
        return {"message": f"Sample {idx} updated",
                "sample": {"index": idx, **updated.to_dict()}}

    # -- async task registry (auto_label / preprocess) --------------------

    def _task_start(self, kind: str, total: int) -> str:
        import uuid

        task_id = uuid.uuid4().hex[:12]
        with self._lock:
            tasks = self._tasks.setdefault(kind, {})
            tasks[task_id] = {"task_id": task_id, "status": "running",
                              "progress": "Starting...", "current": 0,
                              "total": total, "created_at": time.time(),
                              "updated_at": time.time()}
            self._latest_task[kind] = task_id
        return task_id

    def _task_update(self, kind: str, task_id: str, **fields) -> None:
        with self._lock:
            task = self._tasks.get(kind, {}).get(task_id)
            if task:
                task.update(fields, updated_at=time.time())

    def task_status(self, kind: str,
                    task_id: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            tid = task_id or self._latest_task.get(kind)
            if tid is None:
                return {"task_id": None, "status": "idle", "progress": "",
                        "current": 0, "total": 0}
            task = self._tasks.get(kind, {}).get(tid)
            if task is None:
                if task_id is not None:
                    raise KeyError(f"task {task_id} not found")
                return {"task_id": tid, "status": "idle", "progress": "",
                        "current": 0, "total": 0}
            return dict(task)

    def _progress(self, kind: str, task_id: Optional[str]
                  ) -> Callable[[str], None]:
        """A progress callback that records 'Verb k/n: ...' on the task."""
        def on_progress(msg: str) -> None:
            if task_id:
                cur = 0
                try:
                    cur = int(msg.split()[1].split("/")[0])
                except (IndexError, ValueError):
                    pass
                self._task_update(kind, task_id, progress=msg, current=cur)
        return on_progress

    def _launch(self, kind: str, total: int,
                run: Callable[[Optional[str]], Dict[str, Any]],
                run_async: bool, started: str) -> Dict[str, Any]:
        """Run `run(task_id)` under the device lock on a thread of its
        own (the caller's thread makes no device call). With `run_async`
        it is a task polled through task_status(kind, ...); else no task
        is registered, as in the JAX service, and the call waits for the
        thread and returns its result or raises its error."""
        task_id = self._task_start(kind, total) if run_async else None
        box: Dict[str, Any] = {}

        def worker() -> None:
            try:
                with self._device_lock:
                    result = box["result"] = run(task_id)
                if task_id:
                    done = ({"current": result["num_samples"]}
                            if kind == "preprocess" else {})
                    self._task_update(kind, task_id, status="completed",
                                      progress=result["message"],
                                      result=result, **done)
            except Exception as e:
                box["error"] = e
                if task_id:
                    self._task_update(kind, task_id, status="failed",
                                      error=str(e), progress=f"Failed: {e}")

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        if run_async:
            return {"task_id": task_id, "message": started, "total": total}
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]

    def auto_label(self, *, skip_metas: bool = False,
                   format_lyrics: bool = False,
                   transcribe_lyrics: bool = False,
                   only_unlabeled: bool = False,
                   save_path: Optional[str] = None,
                   run_async: bool = False) -> Dict[str, Any]:
        """Label the session's samples with the in-stack LM (+key-gated
        external transcription). Async mode returns a task_id polled via
        task_status('auto_label', ...)."""
        s = self._session_required()
        if self.handler is None:
            raise RuntimeError("Model not initialized")
        resolved_save = save_path or s.json_path
        kwargs = dict(skip_metas=skip_metas, format_lyrics=format_lyrics,
                      transcribe_lyrics=transcribe_lyrics,
                      only_unlabeled=only_unlabeled)

        def run(task_id: Optional[str]) -> Dict[str, Any]:
            def on_labeled(idx: int, sample, status: str) -> None:
                if task_id:
                    self._task_update(
                        "auto_label", task_id, progress=status,
                        last_updated_index=idx,
                        last_updated_sample=sample.to_dict())
                if resolved_save and "✅" in status:
                    try:
                        s.save(resolved_save)   # incremental persist
                    except OSError:
                        pass

            status = s.label_all(
                self.handler, self.llm,
                progress_callback=self._progress("auto_label", task_id),
                sample_labeled_callback=on_labeled, **kwargs)
            if resolved_save:
                try:
                    s.save(resolved_save)
                except OSError:
                    pass
            return {"message": status,
                    "labeled_count": s.labeled_count(),
                    "samples": s.serialize_samples()}

        return self._launch("auto_label", len(s.samples), run, run_async,
                            "Auto-labeling task started")

    def preprocess(self, output_dir: str, *, skip_existing: bool = False,
                   run_async: bool = False) -> Dict[str, Any]:
        """Session -> training tensors under output_dir."""
        s = self._session_required()
        if self.handler is None:
            raise RuntimeError("Model not initialized")

        def run(task_id: Optional[str]) -> Dict[str, Any]:
            n = s.preprocess(self.handler, output_dir,
                             skip_existing=skip_existing,
                             progress_callback=self._progress("preprocess",
                                                              task_id))
            return {"message": f"Preprocessed {n} samples",
                    "num_samples": n, "output_dir": output_dir}

        return self._launch("preprocess", len(s.samples), run, run_async,
                            "Preprocessing task started")
