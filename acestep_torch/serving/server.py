"""REST job server (stdlib http.server + worker threads).

Port of `acestep_tpu/serving/server.py`, with the same routes, envelope,
status codes, auth, uploads, result cache, cancel and render coalescing.
POST /release_task enqueues a generation job and returns a task_id; POST
/query_result batch-polls results from a TTL cache; plus /health,
/v1/stats, /metrics (also /v1/metrics), /v1/models, /create_random_sample,
/format_input, /v1/lora/*, /v1/training/*, /v1/dataset/*,
/v1/reinitialize, /v1/chat/completions and GET /v1/audio. Responses use
the `{"data", "code", "error", "timestamp", "extra"}` envelope and the
integer status codes (queued/running=0, succeeded=1, failed=2) of the
reference server (acestep/api_server.py).

One process owns the CUDA device; generation runs on worker threads pulled
from one queue, and compatible queued text2music jobs fuse into one
batched render (`_coalesce_key`, inference.generate_music_group). Every
device user takes `AppState.reinit_lock`: weight swaps, renders, each
call into the planner (the worker's analysis, sample and format jobs and
the /create_random_sample and /format_input routes), and the dataset
service's device stages. /metrics makes no CUDA call: it reads the
caching allocator's counters and a device total read once at start-up.
The /v1/dataset/* routes (the staged dataset build and the interactive
dataset session) run their device work on the dataset service's own
threads (serving/training_service.py).
"""

from __future__ import annotations

import glob
import json
import os
import queue
import random
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import torch

from acestep_torch import inference
from acestep_torch.inference import GenerationConfig, GenerationParams
from acestep_torch.serving import openrouter
from acestep_torch.serving.jobstore import (
    RESULT_KEY_PREFIX,
    TASK_TIMEOUT_SECONDS,
    JobStore,
    LocalResultCache,
)
from acestep_torch.serving.schemas import GenerateMusicRequest
from acestep_torch.utils import trace
from acestep_torch.utils.geninfo import build_generation_info
from acestep_torch.utils.path_safety import safe_path


class PathRejected(ValueError):
    """A user-supplied filesystem path escaped the safe root (400)."""


def _user_path(p: Optional[str]) -> Optional[str]:
    """Validate a path arriving over HTTP against the safe root (the
    reference routes every training-module path through
    path_safety.safe_path; here the HTTP body is the trust boundary).
    None/empty passes through — presence checks stay with the route."""
    if not p:
        return p
    try:
        return safe_path(p)
    except ValueError as e:
        raise PathRejected(str(e)) from None

QUEUE_MAXSIZE = 200
INITIAL_AVG_JOB_SECONDS = 30.0
STATUS_MAP = {"queued": 0, "running": 0, "succeeded": 1, "failed": 2}


def wrap_response(data: Any, code: int = 200,
                  error: Optional[str] = None) -> Dict[str, Any]:
    return {"data": data, "code": code, "error": error,
            "timestamp": int(time.time() * 1000), "extra": None}


def _map_status(status: str) -> int:
    return STATUS_MAP.get(status, 2)


def _result_payload(result) -> Dict[str, Any]:
    """A GenerationResult as the job store keeps it: JSON only. The port's
    results also carry each song's audio array and the predicted latents
    (for in-process callers); the store keeps paths, not arrays."""
    extra = {k: v for k, v in result.extra_outputs.items()
             if k != "pred_latents"}
    return {"audios": [{k: v for k, v in a.items() if k != "audio"}
                       for a in result.audios],
            "status_message": result.status_message,
            "extra_outputs": extra, "success": result.success,
            "error": result.error}


def _actual_audio_format(requested: Optional[str], first_path: str) -> str:
    """Label the format that was actually written: AudioSaver falls back
    to its default on unknown formats, so the requested string can lie —
    the delivered file's extension can't. wav/wav32 share an extension,
    so a .wav keeps the requested distinction when plausible."""
    fmt = str(requested or "flac")
    ext = os.path.splitext(first_path)[1].lstrip(".").lower()
    if ext == "wav":
        return fmt if fmt.lower() in ("wav", "wav32") else "wav"
    return ext or fmt


def parse_timesteps(s: Optional[str]) -> Optional[List[float]]:
    if not s or not str(s).strip():
        return None
    try:
        return [float(t.strip()) for t in str(s).split(",") if t.strip()]
    except ValueError:
        return None


def load_examples(examples_dir: str, sample_mode: str = "simple_mode") -> list:
    # "custom_mode" -> text2music examples (ref SIMPLE/CUSTOM dirs,
    # api_server.py:260-262)
    subdir = "simple_mode" if sample_mode == "simple_mode" else "text2music"
    pattern = os.path.join(examples_dir, subdir, "example_*.json")
    out = []
    for path in sorted(glob.glob(pattern)):
        try:
            with open(path, "r", encoding="utf-8") as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            pass
    return out


def request_to_params(req: GenerateMusicRequest) -> GenerationParams:
    """Map the REST request onto the Python-API GenerationParams."""
    seed = -1
    if not req.use_random_seed:
        try:
            seed = int(req.seed)
        except (TypeError, ValueError):
            seed = -1
    return GenerationParams(
        task_type=req.task_type,
        instruction=req.instruction,
        track_name=req.track_name,
        track_classes=req.track_classes,
        reference_audio=req.reference_audio_path,
        src_audio=req.src_audio_path,
        audio_codes=req.audio_codes or "",
        caption=req.prompt,
        lyrics=req.lyrics,
        vocal_language=req.vocal_language or "unknown",
        bpm=req.bpm,
        keyscale=req.key_scale,
        timesignature=req.time_signature,
        duration=float(req.audio_duration) if req.audio_duration else -1.0,
        inference_steps=req.inference_steps,
        seed=seed,
        guidance_scale=req.guidance_scale,
        use_adg=req.use_adg,
        cfg_interval_start=req.cfg_interval_start,
        cfg_interval_end=req.cfg_interval_end,
        shift=req.shift,
        infer_method=req.infer_method,
        timesteps=parse_timesteps(req.timesteps),
        repainting_start=req.repainting_start,
        repainting_end=(-1 if req.repainting_end is None
                        else req.repainting_end),
        audio_cover_strength=req.audio_cover_strength,
        thinking=req.thinking,
        lm_temperature=req.lm_temperature,
        lm_metadata_temperature=req.lm_metadata_temperature,
        lm_codes_temperature=req.lm_codes_temperature,
        lm_repetition_penalty=req.lm_repetition_penalty,
        lm_cfg_scale=req.lm_cfg_scale,
        lm_top_k=req.lm_top_k or 0,
        lm_top_p=req.lm_top_p if req.lm_top_p is not None else 0.9,
        lm_negative_prompt=req.lm_negative_prompt,
        use_cot_caption=req.use_cot_caption,
        use_cot_language=req.use_cot_language,
        use_constrained_decoding=req.constrained_decoding,
    )


def _coalesce_key(req: GenerateMusicRequest):
    """Signature of a render-coalescable request, or None.

    Cross-request co-scheduling scope (reference analog: nano-vllm's
    scheduler batches concurrently queued sequences, engine/scheduler.py:
    33-101): plain text2music renders — the REST default, thinking=False —
    whose *conditioning* may differ per item (caption, lyrics, metadata,
    language, seed) but whose *render shape* is shared: equal pinned
    duration and sampler/output knobs, single song, no audio inputs, no
    code hints, no LRC. Jobs with the same key fuse into one batched DiT
    render (inference.generate_music_group), whose per-step kernel
    launches do not grow with the batch; LM metadata planning stays
    per request. The key is the JAX server's, `lm_backend` included, so
    a request body groups the same on both servers."""
    if (req.thinking or req.task_type != "text2music"
            or req.analysis_only or req.full_analysis_only
            or req.sample_mode or req.sample_query or req.use_format
            or req.want_lrc or req.audio_codes or req.instruction
            or req.reference_audio_path or req.src_audio_path
            or req.reference_audio_b64 or req.src_audio_b64
            or (req.batch_size or 1) != 1
            or not req.audio_duration or req.audio_duration <= 0
            or req.track_name or req.track_classes):
        return None
    return (req.model or "", req.lm_model_path or "", req.lm_backend,
            float(req.audio_duration), int(req.inference_steps),
            req.infer_method, float(req.shift), req.timesteps or "",
            float(req.guidance_scale), bool(req.use_adg),
            float(req.cfg_interval_start), float(req.cfg_interval_end),
            float(req.audio_cover_strength), req.audio_format)


class AppState:
    """Server-wide state: handlers, job plumbing, stats."""

    def __init__(self, dit_handlers: Dict[str, Any], llm_handler: Any,
                 *, output_dir: str = "outputs",
                 persist_dir: Optional[str] = None,
                 examples_dir: Optional[str] = None,
                 api_key: Optional[str] = None,
                 worker_count: int = 1,
                 lazy_init=None) -> None:
        if not dit_handlers:
            raise ValueError("at least one DiT handler is required")
        self.dit_handlers = dict(dit_handlers)
        self.default_model = next(iter(self.dit_handlers))
        self.llm_handler = llm_handler
        # deferred model load (ACESTEP_NO_INIT lazy startup, reference
        # api_server.py:2167): a zero-arg callable run once, on the first
        # request that needs weights, under the reinit lock
        self._lazy_init = lazy_init
        self.output_dir = os.path.abspath(output_dir)
        self.api_key = api_key
        self.job_store = JobStore(persist_dir=persist_dir)
        self.local_cache = LocalResultCache(
            os.path.join(persist_dir, "result_cache.json")
            if persist_dir else None)
        self.job_queue: "queue.Queue" = queue.Queue(maxsize=QUEUE_MAXSIZE)
        self.pending_ids: List[str] = []
        # with tracing on, (monotonic stamp, thread) of each queued job's
        # enqueue by job id (pending_lock), ended by the claim as its
        # serve.queue span
        self.enqueued_at: Dict[str, tuple] = {}
        self.pending_lock = threading.Lock()
        self.stats_lock = threading.Lock()
        # the one device lock: weight swaps, renders, every call into the
        # planner (its generator shares a KV arena, captured graphs and a
        # prefix cache) and the dataset service's device stages
        self.reinit_lock = threading.Lock()
        self.started_at = time.time()
        self.avg_job_seconds = INITIAL_AVG_JOB_SECONDS
        self.completed_jobs = 0
        self.examples_dir = examples_dir
        from acestep_torch.serving.training_service import (
            DatasetService, TrainingService)
        self.training = TrainingService(
            self.dit_handlers[self.default_model])
        self.dataset = DatasetService(
            self.dit_handlers[self.default_model], llm_handler,
            lock=self.reinit_lock)
        # the default handler's device; the device total is read here,
        # once, so /metrics never calls CUDA while a worker renders
        self.device = getattr(self.dit_handlers[self.default_model],
                              "device", None)
        self.device_total_bytes = None
        if getattr(self.device, "type", None) == "cuda":
            self.device_total_bytes = torch.cuda.mem_get_info(
                self.device)[1]
        self.worker_count = max(1, worker_count)
        # cross-request render coalescing: max songs fused into one
        # batched render when compatible jobs are waiting (0/1 disables)
        self.coalesce_max = max(1, int(
            os.environ.get("ACESTEP_COALESCE_MAX", "4")))
        self.coalesced_jobs_total = 0
        self._workers: List[threading.Thread] = []
        self._shutdown = threading.Event()
        # per-request LM swap: initialized handlers keyed by checkpoint path
        self._llm_cache: Dict[str, Any] = {}
        self._llm_lock = threading.Lock()
        self._llm_pending: Dict[str, threading.Event] = {}
        self._llm_inuse: Dict[str, int] = {}
        self.max_cached_llms = 2

    def ensure_initialized(self) -> None:
        """Run the deferred model load exactly once (--no-init /
        ACESTEP_NO_INIT, reference api_server.py:2167): the server binds
        its port instantly and weights load on the first request that
        needs them. Held under the reinit lock so generation, weight
        swaps, and the load itself serialize; a failed load stays armed
        and the next request retries."""
        if self._lazy_init is None:
            return
        with self.reinit_lock:
            if self._lazy_init is not None:
                self._lazy_init()
                self._lazy_init = None

    def _select_llm(self, lm_model_path: Optional[str]):
        """Per-request LM model swap (reference api_server.py:623
        _temporary_llm_model). Instead of re-init + restore around each job
        (which would thrash device memory), initialized handlers live
        in a small LRU keyed by checkpoint path; swapping is a lookup.
        Best-effort like the reference: failures fall back to the default.

        Returns (handler, release) — callers MUST call release() when the
        job finishes so LRU eviction never drops a handler mid-generation.
        Checkpoint download + initialize run OUTSIDE the cache lock (they
        can take minutes); concurrent requests for the same model wait on
        one builder instead of initializing twice."""
        self.ensure_initialized()   # lazy startup: LM loads on first use
        desired = (lm_model_path or "").strip()
        if not desired:
            return self.llm_handler, lambda: None

        def acquire(name):
            self._llm_inuse[name] = self._llm_inuse.get(name, 0) + 1

            def release():
                with self._llm_lock:
                    self._llm_inuse[name] = self._llm_inuse.get(name, 1) - 1
                    if self._llm_inuse[name] <= 0:
                        self._llm_inuse.pop(name, None)
            return release

        while True:
            with self._llm_lock:
                if desired in self._llm_cache:
                    handler = self._llm_cache.pop(desired)
                    self._llm_cache[desired] = handler      # LRU bump
                    return handler, acquire(desired)
                pending = self._llm_pending.get(desired)
                if pending is None:
                    pending = self._llm_pending[desired] = threading.Event()
                    break                                   # we build it
            pending.wait(timeout=900)
            with self._llm_lock:
                if desired in self._llm_cache:
                    handler = self._llm_cache.pop(desired)
                    self._llm_cache[desired] = handler
                    return handler, acquire(desired)
            return self.llm_handler, lambda: None           # build failed

        handler = None
        try:
            if os.path.isdir(desired):
                path = desired
            else:
                from acestep_torch.utils.downloads import ensure_model
                path = ensure_model(desired)
            from acestep_torch.llm.handler import LLMHandler
            handler = LLMHandler(device=self.device)
            handler.initialize(checkpoint_dir=path)
        except Exception:
            handler = None
        with self._llm_lock:
            self._llm_pending.pop(desired, None)
            pending.set()
            if handler is None:
                return self.llm_handler, lambda: None
            self._llm_cache[desired] = handler
            # evict oldest handlers past the cap, but never one a running
            # job still holds (its params would stay alive anyway — skip it
            # so the count stays honest)
            evictable = [k for k in self._llm_cache
                         if k != desired and not self._llm_inuse.get(k)]
            while len(self._llm_cache) > self.max_cached_llms and evictable:
                self._llm_cache.pop(evictable.pop(0))
            return handler, acquire(desired)

    # -- queue workers ------------------------------------------------------

    def start_workers(self) -> None:
        for idx in range(self.worker_count):
            th = threading.Thread(target=self._worker_loop, args=(idx,),
                                  name=f"acestep-worker-{idx}", daemon=True)
            th.start()
            self._workers.append(th)

    def shutdown(self) -> None:
        self._shutdown.set()
        for _ in self._workers:
            try:
                self.job_queue.put_nowait((None, None))
            except queue.Full:
                pass

    def _worker_loop(self, idx: int) -> None:
        while not self._shutdown.is_set():
            job_id, req = self.job_queue.get()
            if job_id is None:
                break
            try:
                if not self._claim_job(job_id, req):
                    continue
                with trace.span("serve.render", [job_id]) as render:
                    group, leftovers = self._drain_compatible(job_id, req)
                    render.requests = [jid for jid, _r in group]
                    render.set(jobs=len(group))
                    if len(group) > 1:
                        try:
                            self._run_job_group(group)
                        except Exception:   # e.g. lazy-init raise: fail
                            tb = traceback.format_exc(limit=10)  # the group
                            for jid2, _r in group:
                                self.job_store.mark_failed(jid2, tb)
                                self._cache_result(jid2)
                    else:
                        self._safe_run_one(job_id, req)
                # drained-but-incompatible job: runs next, FIFO preserved
                for jid2, req2 in leftovers:
                    with trace.span("serve.render", [jid2], jobs=1):
                        self._safe_run_one(jid2, req2)
            finally:
                self.job_queue.task_done()
                self.job_store.cleanup()   # age out finished jobs (24 h)

    def _add_pending(self, job_id: str) -> int:
        """Note a job about to be queued; its position in the queue."""
        with self.pending_lock:
            self.pending_ids.append(job_id)
            if trace.enabled():
                self.enqueued_at[job_id] = (time.monotonic(),
                                            threading.get_ident())
            return len(self.pending_ids)

    def _claim_job(self, job_id: str, req) -> bool:
        """Pending-list bookkeeping + canceled-while-queued check.
        False = the job was resolved while waiting (don't burn a render)."""
        with self.pending_lock:
            if job_id in self.pending_ids:
                self.pending_ids.remove(job_id)
            enqueued = self.enqueued_at.pop(job_id, None)
        rec = self.job_store.get(job_id)
        if rec is not None and rec.status != "queued":
            self._cleanup_request_temp_files(req)
            return False
        if enqueued is not None:
            t0, thread = enqueued
            trace.record("serve.queue", t0, time.monotonic(), [job_id],
                         thread=thread)
        return True

    def _safe_run_one(self, job_id: str, req) -> None:
        try:
            self._run_one_job(job_id, req)
        except Exception:
            self.job_store.mark_failed(job_id,
                                       traceback.format_exc(limit=10))
            self._cache_result(job_id)

    def _drain_compatible(self, job_id: str, req):
        """Opportunistically pull more queued jobs behind `req`.

        Returns (group, leftovers): `group` is the head job plus every
        consecutively queued job with the same coalesce key (fused into
        one batched render); `leftovers` holds at most one drained job
        that broke the run of compatible keys — draining stops there so
        FIFO order is preserved for everything still in the queue.
        task_done() for drained items is accounted here (the head's is
        the worker loop's)."""
        group = [(job_id, req)]
        leftovers = []
        key = _coalesce_key(req) if self.coalesce_max > 1 else None
        if key is None:
            return group, leftovers
        while len(group) < self.coalesce_max:
            try:
                jid2, req2 = self.job_queue.get_nowait()
            except queue.Empty:
                break
            self.job_queue.task_done()
            if jid2 is None:
                # shutdown sentinel: hand it back for a worker to see
                try:
                    self.job_queue.put_nowait((None, None))
                except queue.Full:
                    pass     # _shutdown event still ends every loop
                break
            if not self._claim_job(jid2, req2):
                continue     # canceled while queued
            if _coalesce_key(req2) == key:
                group.append((jid2, req2))
            else:
                leftovers.append((jid2, req2))
                break
        return group, leftovers

    def _run_job_group(self, group) -> None:
        """Run N compatible queued jobs as ONE batched render
        (cross-request co-scheduling; see _coalesce_key)."""
        t0 = time.time()
        self.ensure_initialized()
        head = group[0][1]
        model_name, dit_handler = self._select_handler(head.model)
        llm_handler, release_llm = self._select_llm(
            getattr(head, "lm_model_path", None))
        jobs = []
        for jid, req in group:
            self.job_store.mark_running(jid)
            self._cache_progress(jid, 0.01, "running")
            jobs.append((request_to_params(req), GenerationConfig(
                batch_size=1,
                use_random_seed=req.use_random_seed,
                audio_format=req.audio_format,
                output_dir=self.output_dir,
                allow_lm_batch=req.allow_lm_batch,
                constrained_decoding_debug=req.constrained_decoding_debug,
                want_lrc=False,          # excluded by _coalesce_key
            )))
        try:
            with self.reinit_lock:
                results = inference.generate_music_group(
                    dit_handler, llm_handler, jobs)
        finally:
            release_llm()
        if results and all(not r.success for r in results):
            # the fused render failed as a unit (e.g. batch OOM): retry
            # each job on the plain path so one batch cannot fail N jobs
            trace.count("serve_group_fallbacks")
            for jid, req in group:
                self._safe_run_one(jid, req)
            return
        elapsed = time.time() - t0
        finish = trace.begin("serve.finish")
        for (jid, req), (params, config), result in zip(group, jobs,
                                                        results):
            payload = _result_payload(result)
            payload["dit_model"] = model_name
            payload["lm_model"] = (
                (getattr(req, "lm_model_path", None) or "")
                if llm_handler is not self.llm_handler else "")
            payload["prompt"] = params.caption
            payload["lyrics"] = params.lyrics
            payload["audio_format"] = config.audio_format
            if result.success:
                self.job_store.mark_succeeded(jid, payload)
            else:
                self.job_store.mark_failed(
                    jid, result.error or result.status_message)
            self._cache_result(jid)
        finish.end()
        with self.stats_lock:
            # ETA bookkeeping: a fused render costs elapsed/N per song
            per_job = elapsed / max(1, len(group))
            for _ in group:
                n = self.completed_jobs
                self.avg_job_seconds = (
                    self.avg_job_seconds * n + per_job) / (n + 1)
                self.completed_jobs = n + 1
            self.coalesced_jobs_total += len(group)

    def cancel_task(self, job_id: str) -> Dict[str, Any]:
        """Cancel a QUEUED job (beyond the reference: it has no
        cancellation surface). A running render cannot be interrupted
        mid-flight; finished jobs are left alone.
        The worker skips de-queued ids when they surface."""
        rec = self.job_store.get(job_id)
        if rec is None:
            return {"status": "not_found"}
        if rec.status == "queued":
            with self.pending_lock:
                if job_id in self.pending_ids:
                    self.pending_ids.remove(job_id)
                self.enqueued_at.pop(job_id, None)
            self.job_store.mark_failed(job_id, "canceled by user")
            self._cache_result(job_id)
            return {"status": "canceled"}
        if rec.status == "running":
            return {"status": "running"}     # cannot interrupt the render
        return {"status": rec.status}        # already finished

    def _select_handler(self, model: Optional[str], strict: bool = False):
        if model and model in self.dit_handlers:
            return model, self.dit_handlers[model]
        if model and strict:
            raise KeyError(
                f"unknown model {model!r}; available: "
                f"{sorted(self.dit_handlers)}")
        return self.default_model, self.dit_handlers[self.default_model]

    def _cleanup_request_temp_files(self, req) -> None:
        """Unlink upload/chat temp audio for a job that never reached
        _run_one_job (whose finally block is the normal cleanup path) —
        e.g. rejected with queue.Full. One orphaned file per rejected
        request would otherwise accumulate in the tempdir."""
        import tempfile as _tempfile

        tmpdir = _tempfile.gettempdir()
        for path in (getattr(req, "reference_audio_path", None),
                     getattr(req, "src_audio_path", None)):
            if path and os.path.dirname(path) == tmpdir and \
                    os.path.basename(path).startswith(
                        ("acestep_or_", "acestep_upload_")):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _run_one_job(self, job_id: str, req: GenerateMusicRequest) -> None:
        t0 = time.time()
        self.ensure_initialized()   # lazy startup: weights load on first job
        self.job_store.mark_running(job_id)
        self._cache_progress(job_id, 0.01, "running")

        model_name, dit_handler = self._select_handler(req.model)
        llm_handler, release_llm = self._select_llm(getattr(req, "lm_model_path", None))
        temp_files = []     # cleaned in the OUTER finally: an exception
        # anywhere after upload materialization must not leak the files
        try:
            # chat-adapter uploads (openrouter.base64_to_temp_file) are ours to
            # clean as well — they'd otherwise leak one audio file per request
            import tempfile as _tempfile

            tmpdir = _tempfile.gettempdir()
            for path in (req.reference_audio_path, req.src_audio_path):
                if path and os.path.dirname(path) == tmpdir and \
                        os.path.basename(path).startswith(
                            ("acestep_or_", "acestep_upload_")):
                    temp_files.append(path)
            if req.reference_audio_b64:
                req.reference_audio_path = openrouter.base64_to_temp_file(
                    req.reference_audio_b64, req.upload_audio_format)
                temp_files.append(req.reference_audio_path)
            if req.src_audio_b64:
                req.src_audio_path = openrouter.base64_to_temp_file(
                    req.src_audio_b64, req.upload_audio_format)
                temp_files.append(req.src_audio_path)
            # user-supplied audio paths (NOT our own materialized temp
            # files): the reference passes them through unvalidated
            # (api_server.py:1755), so unconditional jailing would break
            # local-deployment parity — but an operator who pins
            # ACESTEP_SAFE_ROOT gets the same boundary the training
            # routes enforce
            if os.environ.get("ACESTEP_SAFE_ROOT"):
                for attr in ("reference_audio_path", "src_audio_path"):
                    p = getattr(req, attr, None)
                    if not p or p in temp_files:
                        continue
                    try:
                        # server-generated outputs are always fair game
                        # (the studio's send-to-Remix round-trip) — but
                        # through safe_path so its realpath hardening
                        # still rejects symlinks planted in the output dir
                        safe_path(p, base=self.output_dir)
                    except ValueError:
                        safe_path(p)   # raises -> job fails with message
            params = request_to_params(req)
            config = GenerationConfig(
                batch_size=req.batch_size or 1,
                use_random_seed=req.use_random_seed,
                audio_format=req.audio_format,
                output_dir=self.output_dir,
                allow_lm_batch=req.allow_lm_batch,
                constrained_decoding_debug=req.constrained_decoding_debug,
                want_lrc=req.want_lrc,
            )

            if req.full_analysis_only:
                # deep audio understanding (ref api_server.py:1852-1885):
                # src audio -> 5 Hz codes -> LM understand at the fixed
                # analysis temperature 0.3
                try:
                    if req.audio_codes:
                        # pasted codes transcribe directly (the reference
                        # UI's transcribe_audio_codes, llm_actions.py:83)
                        codes = req.audio_codes
                    elif req.src_audio_path:
                        from acestep_torch.utils.audio import load_audio

                        audio = load_audio(req.src_audio_path)
                        # same guard as the generation path:
                        # /v1/reinitialize must not swap DiT weights
                        # mid-encode
                        with self.reinit_lock:
                            codes = dit_handler.audio_to_codes(audio)
                    else:
                        raise ValueError(
                            "analysis requires src audio or audio_codes")
                    with self.reinit_lock:
                        analysis = inference.understand_music(
                            llm_handler, codes, temperature=0.3).to_dict()
                    analysis["audio_codes"] = codes
                    if analysis.get("success"):
                        self.job_store.mark_succeeded(job_id, {
                            "audios": [], "prompt": analysis.get("caption", ""),
                            "lyrics": analysis.get("lyrics", ""),
                            "status_message": "analysis",
                            "extra_outputs": {"analysis": analysis,
                                              "lm_metadata": analysis},
                        })
                    else:
                        self.job_store.mark_failed(
                            job_id, analysis.get("error") or "analysis failed")
                except Exception as e:
                    self.job_store.mark_failed(job_id, str(e))
                self._cache_result(job_id)
                return

            if req.analysis_only:
                # metadata planning over caption/lyrics — NO src audio and
                # no codes phase (ref api_server.py:1887-1899); the facade
                # helper honors the full LM knob surface (pinned metadata,
                # constrained toggle, sampling knobs, request seed)
                with self.reinit_lock:
                    plan = inference.analyze_input(llm_handler, params)
                if plan.get("success"):
                    meta = plan.get("metadata", {})
                    self.job_store.mark_succeeded(job_id, {
                        "audios": [], "prompt": meta.get("caption", ""),
                        # planning doesn't transcribe lyrics: echo back the
                        # client's own lyrics rather than dropping them
                        "lyrics": meta.get("lyrics") or params.lyrics or "",
                        "status_message": "analysis",
                        "extra_outputs": {"analysis": meta,
                                          "lm_metadata": meta},
                    })
                else:
                    self.job_store.mark_failed(
                        job_id, plan.get("error") or "analysis failed")
                self._cache_result(job_id)
                return

            with self.reinit_lock:
                if req.sample_mode or req.sample_query:
                    sample = inference.create_sample(llm_handler,
                                                     req.sample_query)
                    if sample.get("success"):
                        params.caption = sample.get("caption", params.caption)
                        params.lyrics = sample.get("lyrics", params.lyrics)
                elif req.use_format:
                    fmt = inference.format_sample(llm_handler, params.caption,
                                                  params.lyrics)
                    if fmt.get("success"):
                        params.caption = fmt.get("caption", params.caption)
                        params.lyrics = fmt.get("lyrics", params.lyrics)
                result = inference.generate_music(
                    dit_handler, llm_handler, params, config)
            payload = _result_payload(result)
            payload["dit_model"] = model_name
            # report the LM actually used: _select_llm falls back to the
            # default on build/download failure, so echoing the requested
            # path would misreport the swap as successful
            payload["lm_model"] = (
                (getattr(req, "lm_model_path", None) or "")
                if llm_handler is not self.llm_handler else "")
            payload["prompt"] = params.caption
            payload["lyrics"] = params.lyrics
            payload["audio_format"] = config.audio_format
            with trace.span("serve.finish"):
                if result.success:
                    self.job_store.mark_succeeded(job_id, payload)
                else:
                    self.job_store.mark_failed(
                        job_id, result.error or result.status_message)
                self._cache_result(job_id)

            elapsed = time.time() - t0
            with self.stats_lock:
                n = self.completed_jobs
                self.avg_job_seconds = (self.avg_job_seconds * n + elapsed) / (n + 1)
                self.completed_jobs = n + 1
        finally:
            for path in temp_files:     # ref _cleanup_job_temp_files
                try:
                    os.unlink(path)
                except OSError:
                    pass
            release_llm()

    # -- result cache (reference _update_local_cache, :1342-1433) -----------

    def _cache_progress(self, job_id: str, progress: float, stage: str) -> None:
        rec = self.job_store.get(job_id)
        if rec is None:
            return
        entry = {
            "file": "", "wave": "", "status": _map_status("running"),
            "create_time": int(rec.created_at), "env": rec.env,
            "progress": float(progress), "stage": stage,
        }
        if stage != "queued":
            # run-start timestamp survives later progress updates: the
            # running-job timeout must not count queue wait (a long queue
            # would otherwise fail jobs the moment they start)
            prior = self.local_cache.get(f"{RESULT_KEY_PREFIX}{job_id}")
            try:
                prior_entry = json.loads(prior)[0] if prior else {}
            except (ValueError, IndexError, TypeError):
                prior_entry = {}
            entry["run_start_time"] = prior_entry.get(
                "run_start_time") or int(time.time())
        self.local_cache.set(f"{RESULT_KEY_PREFIX}{job_id}", [entry])

    def _cache_result(self, job_id: str) -> None:
        rec = self.job_store.get(job_id)
        if rec is None:
            return
        status_int = _map_status(rec.status)
        if rec.status == "succeeded" and rec.result:
            result = rec.result
            extra = result.get("extra_outputs", {}) or {}
            metas = extra.get("lm_metadata", {}) or {}
            entries = []
            audios = result.get("audios") or [{}]
            # timing summary shipped with every result (reference
            # api_server.py:2028-2056 builds it with _build_generation_info)
            time_costs = extra.get("time_costs") or {}
            first_path = next(
                (a.get("path") for a in audios if a and a.get("path")), "")
            gen_info = build_generation_info(
                time_costs, len([a for a in audios if a]),
                _actual_audio_format(result.get("audio_format"), first_path))
            for audio in audios:
                entry = {
                    "file": audio.get("path") or "",
                    "wave": "",
                    "status": status_int,
                    "create_time": int(rec.created_at),
                    "env": rec.env,
                    "prompt": result.get("prompt", ""),
                    "lyrics": result.get("lyrics", ""),
                    "metas": metas,
                    "generation_info": gen_info,
                    "time_costs": time_costs,
                    "status_message": result.get("status_message", ""),
                    "seed_value": str(audio.get("seed", "")),
                    "lm_model": result.get("lm_model", ""),
                    "dit_model": result.get("dit_model", ""),
                    "progress": 1.0,
                    "stage": "succeeded",
                    # reproducibility sidecar (served via /v1/audio like
                    # the audio itself; re-import with the studio's
                    # "Load params" or any client)
                    "params_file": audio.get("params_path", ""),
                }
                for extra_key in ("lrc", "alignment_score", "lrc_error"):
                    if extra_key in audio:
                        entry[extra_key] = audio[extra_key]
                entries.append(entry)
        else:
            entries = [{
                "file": "", "wave": "", "status": status_int,
                "create_time": int(rec.created_at), "env": rec.env,
                "progress": rec.progress,
                "stage": "failed" if rec.status == "failed" else rec.stage,
                "error": rec.error or "",
            }]
        self.local_cache.set(f"{RESULT_KEY_PREFIX}{job_id}", entries)

    # -- auth ---------------------------------------------------------------

    def check_auth(self, body: Optional[dict],
                   authorization: Optional[str]) -> bool:
        if self.api_key is None:
            return True
        token = (body or {}).get("ai_token")
        if token:
            return token == self.api_key
        if authorization:
            if authorization.startswith("Bearer "):
                authorization = authorization[7:]
            return authorization == self.api_key
        return False


class _Handler(BaseHTTPRequestHandler):
    """Routes requests to AppState. One instance per request (threaded)."""

    state: AppState  # injected by create_server
    protocol_version = "HTTP/1.1"

    # quiet default logging
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -- plumbing -----------------------------------------------------------

    # multipart file field -> request path field (the reference's upload
    # channel, api_server.py:1149-1171 + docs/en/API.md "Method B"; an
    # uploaded file overrides the corresponding *_path parameter)
    _UPLOAD_FIELDS = {
        "reference_audio": "reference_audio_path",
        "ref_audio": "reference_audio_path",
        "src_audio": "src_audio_path",
        "ctx_audio": "src_audio_path",
    }

    def _json_body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            return {}
        raw = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or "").lower()
        if "json" in ctype or raw[:1] in (b"{", b"["):
            try:
                return json.loads(raw.decode("utf-8"))
            except ValueError:
                return {}
        if "x-www-form-urlencoded" in ctype:
            return {k: v[0] for k, v in parse_qs(raw.decode("utf-8")).items()}
        if "multipart/form-data" in ctype:
            return self._multipart_body(raw)
        return {}

    def _multipart_body(self, raw: bytes) -> Dict[str, Any]:
        """Parse multipart/form-data: form fields become request values
        (schemas.from_dict coerces the strings), file fields are saved to
        temp files and mapped onto reference/src audio paths."""
        import email.parser
        import email.policy
        import tempfile

        header = ("Content-Type: " + self.headers.get("Content-Type", "")
                  + "\r\nMIME-Version: 1.0\r\n\r\n").encode("utf-8")
        msg = email.parser.BytesParser(
            policy=email.policy.HTTP).parsebytes(header + raw)
        if not msg.is_multipart():
            return {}
        fields: Dict[str, Any] = {}
        files: Dict[str, str] = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if not name:
                continue
            payload = part.get_payload(decode=True) or b""
            filename = part.get_filename()
            if filename and name in self._UPLOAD_FIELDS:
                suffix = os.path.splitext(filename)[1] or ".wav"
                fd, path = tempfile.mkstemp(suffix=suffix,
                                            prefix="acestep_upload_")
                with os.fdopen(fd, "wb") as f:
                    f.write(payload)
                files[self._UPLOAD_FIELDS[name]] = path
            elif not filename:
                fields[name] = payload.decode("utf-8", "replace")
        fields.update(files)      # uploads override any *_path form field
        return fields

    def _send_json(self, payload: Any, status: int = 200) -> None:
        body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _unauthorized(self) -> None:
        self._send_json(wrap_response(None, code=401, error="Unauthorized"),
                        status=401)

    # -- dispatch -----------------------------------------------------------

    def _traced(self, method: str, fn) -> None:
        """One `serve.http` span around a request's handling."""
        with trace.span("serve.http", method=method,
                        route=urlparse(self.path).path):
            fn()

    def do_GET(self) -> None:  # noqa: N802
        self._traced("GET", self._get)

    def do_POST(self) -> None:  # noqa: N802
        self._traced("POST", self._post)

    def do_PUT(self) -> None:  # noqa: N802
        self._traced("PUT", self._put)

    def _get(self) -> None:
        url = urlparse(self.path)
        route = url.path.rstrip("/") or "/"
        # /health and the studio page stay open; everything else (audio
        # downloads, stats, lora/training state) is API-key gated like
        # POST. GET also accepts ?ai_token= — <audio src> elements cannot
        # attach an Authorization header.
        qs_token = (parse_qs(url.query).get("ai_token") or [None])[0]
        if route not in ("/health", "/", "/studio") and \
                not self.state.check_auth(
                    {"ai_token": qs_token} if qs_token else None,
                    self.headers.get("Authorization")):
            self._unauthorized()
            return
        try:
            if route == "/health":
                self._send_json(wrap_response({
                    "status": "ok",
                    "service": "ACE-Step PyTorch API",
                    "version": "1.5",
                }))
            elif route == "/v1/stats":
                self._get_stats()
            elif route in ("/metrics", "/v1/metrics"):
                self._get_metrics()
            elif route == "/v1/models":
                self._get_models()
            elif route == "/v1/models/discover":
                # scan a checkpoint root for trainable models + adapter
                # dumps (reference Side-Step model_discovery.py; feeds
                # CLI --pick and UI dropdowns)
                from acestep_torch.training.discovery import (fuzzy_search,
                                                              scan_adapters,
                                                              scan_models)

                qs = parse_qs(url.query)
                root = (qs.get("root") or ["checkpoints"])[0]
                try:
                    root = safe_path(root)
                except ValueError as e:
                    self._send_json(wrap_response(None, 400, str(e)), 400)
                    return
                models = scan_models(root)
                q = (qs.get("q") or [""])[0]
                if q:
                    models = fuzzy_search(q, models)
                self._send_json(wrap_response({
                    "models": [m.to_dict() for m in models],
                    "adapters": scan_adapters(root),
                }))
            elif route == "/v1/lora/status":
                self._lora_status()
            elif route == "/v1/audio":
                self._get_audio(url)
            elif route == "/v1/chat/models":
                self._send_json(openrouter.models_payload(self.state))
            elif route == "/v1/training/status":
                self._send_json(wrap_response(self.state.training.status()))
            elif route == "/v1/training/metrics":
                qs = parse_qs(url.query)
                self._send_json(wrap_response(self.state.training.metrics(
                    output_dir=(qs.get("output_dir") or [None])[0])))
            elif route == "/v1/dataset/status":
                self._send_json(wrap_response(self.state.dataset.status()))
            elif route == "/v1/dataset/samples":
                self._dataset_call(self.state.dataset.samples)
            elif route.startswith("/v1/dataset/sample/"):
                idx = route.rsplit("/", 1)[-1]
                if not idx.lstrip("-").isdigit():
                    self._send_json(wrap_response(None, 400,
                                                  "bad sample index"), 400)
                else:
                    self._dataset_call(self.state.dataset.sample, int(idx))
            elif route == "/v1/dataset/auto_label_status" or \
                    route.startswith("/v1/dataset/auto_label_status/"):
                tid = (route.rsplit("/", 1)[-1]
                       if route != "/v1/dataset/auto_label_status" else None)
                self._dataset_call(self.state.dataset.task_status,
                                   "auto_label", tid)
            elif route == "/v1/dataset/preprocess_status" or \
                    route.startswith("/v1/dataset/preprocess_status/"):
                tid = (route.rsplit("/", 1)[-1]
                       if route != "/v1/dataset/preprocess_status" else None)
                self._dataset_call(self.state.dataset.task_status,
                                   "preprocess", tid)
            elif route in ("/", "/studio"):
                self._serve_studio()
            else:
                self._send_json(wrap_response(None, 404, "Not found"), 404)
        except Exception as e:
            self._send_json(wrap_response(None, 500, str(e)), 500)

    def _post(self) -> None:
        route = urlparse(self.path).path.rstrip("/")
        body = self._json_body()
        if not self.state.check_auth(body, self.headers.get("Authorization")):
            self._unauthorized()
            return
        try:
            if route == "/release_task":
                self._release_task(body)
            elif route == "/query_result":
                self._query_result(body)
            elif route == "/v1/cancel_task":
                self._send_json(wrap_response(
                    self.state.cancel_task(str(body.get("task_id", "")))))
            elif route == "/create_random_sample":
                self._create_random_sample(body)
            elif route == "/format_input":
                self._format_input(body)
            elif route == "/lrc_to_vtt":
                self._lrc_to_vtt(body)
            elif route == "/v1/lora/load":
                self._lora_load(body)
            elif route == "/v1/lora/unload":
                self._lora_unload(body)
            elif route == "/v1/lora/toggle":
                self._lora_toggle(body)
            elif route == "/v1/lora/scale":
                self._lora_scale(body)
            elif route == "/v1/reinitialize":
                self._reinitialize(body)
            elif route == "/v1/chat/completions":
                self._chat_completions(body)
            elif route in ("/v1/training/start", "/v1/training/start_lora",
                           "/v1/training/start_lokr"):
                self.state.ensure_initialized()   # trainer needs weights
                config = dict(body.get("config") or {})
                preset = body.get("preset")
                if preset:
                    from acestep_torch.training.presets import PRESETS
                    base = dict(PRESETS.get(preset, {}))
                    base.update(config)
                    config = base
                if route.endswith("lokr"):
                    config.setdefault("kind", "lokr")
                if config.get("output_dir"):
                    config["output_dir"] = _user_path(config["output_dir"])
                try:
                    out = self.state.training.start(
                        dataset_dir=_user_path(body.get("dataset_dir")),
                        manifest_path=_user_path(body.get("manifest_path")),
                        config=config)
                    self._send_json(wrap_response(out))
                except ValueError as e:
                    self._send_json(wrap_response(None, 400, str(e)), 400)
                except RuntimeError as e:
                    self._send_json(wrap_response(None, 409, str(e)), 409)
            elif route == "/v1/training/stop":
                self._send_json(wrap_response(self.state.training.stop()))
            elif route == "/v1/training/tensorboard/start":
                try:
                    out = self.state.training.tensorboard_start(
                        logdir=_user_path(body.get("logdir")),
                        port=int(body.get("port", 6006)))
                    self._send_json(wrap_response(out))
                except RuntimeError as e:
                    self._send_json(wrap_response(None, 503, str(e)), 503)
            elif route == "/v1/training/tensorboard/stop":
                self._send_json(wrap_response(
                    self.state.training.tensorboard_stop()))
            elif route == "/v1/dataset/build":
                self.state.ensure_initialized()   # builder encodes audio
                try:
                    out = self.state.dataset.start(
                        _user_path(body.get("audio_dir", "")),
                        _user_path(body.get("out_dir") or os.path.join(
                            body.get("audio_dir", ""), "_dataset")),
                        val_fraction=float(body.get("val_fraction", 0.0)),
                        use_llm_labels=bool(body.get("use_llm_labels", True)))
                    self._send_json(wrap_response(out))
                except FileNotFoundError as e:
                    self._send_json(wrap_response(None, 404, str(e)), 404)
                except RuntimeError as e:
                    self._send_json(wrap_response(None, 409, str(e)), 409)
            elif route == "/v1/dataset/scan":
                self.state.ensure_initialized()   # labeling encodes audio
                self._dataset_call(
                    self.state.dataset.scan,
                    _user_path(body.get("audio_dir", "")),
                    dataset_name=str(body.get("dataset_name",
                                              "my_lora_dataset")),
                    custom_tag=str(body.get("custom_tag", "")),
                    tag_position=str(body.get("tag_position", "replace")),
                    all_instrumental=bool(body.get("all_instrumental",
                                                   True)))
            elif route == "/v1/dataset/load":
                self._dataset_call(self.state.dataset.load_session,
                                   _user_path(body.get("dataset_path", "")))
            elif route == "/v1/dataset/save":
                self._dataset_call(
                    self.state.dataset.save_session,
                    _user_path(body.get("save_path", "")),
                    dataset_name=body.get("dataset_name"),
                    custom_tag=body.get("custom_tag"),
                    tag_position=body.get("tag_position"),
                    all_instrumental=body.get("all_instrumental"),
                    genre_ratio=body.get("genre_ratio"))
            elif route in ("/v1/dataset/auto_label",
                           "/v1/dataset/auto_label_async"):
                self.state.ensure_initialized()
                self._dataset_call(
                    self.state.dataset.auto_label,
                    skip_metas=bool(body.get("skip_metas", False)),
                    format_lyrics=bool(body.get("format_lyrics", False)),
                    transcribe_lyrics=bool(body.get("transcribe_lyrics",
                                                    False)),
                    only_unlabeled=bool(body.get("only_unlabeled", False)),
                    save_path=(_user_path(body["save_path"])
                               if body.get("save_path") else None),
                    run_async=route.endswith("_async"))
            elif route in ("/v1/dataset/preprocess",
                           "/v1/dataset/preprocess_async"):
                self.state.ensure_initialized()
                self._dataset_call(
                    self.state.dataset.preprocess,
                    _user_path(body.get("output_dir", "")),
                    skip_existing=bool(body.get("skip_existing", False)),
                    run_async=route.endswith("_async"))
            elif route.startswith("/v1/dataset/sample/"):
                # POST alias for clients that cannot send PUT
                self._dataset_update_sample(route, body)
            elif route == "/v1/training/load_tensor_info":
                self._tensor_info(body)
            elif route == "/v1/training/export":
                self._training_export(body)
            else:
                self._send_json(wrap_response(None, 404, "Not found"), 404)
        except PathRejected as e:
            self._send_json(wrap_response(None, 400, str(e)), 400)
        except Exception as e:
            self._send_json(wrap_response(None, 500, str(e)), 500)

    def _put(self) -> None:
        """PUT /v1/dataset/sample/{idx} — edit one sample (reference
        train_api_dataset_service.py:854)."""
        route = urlparse(self.path).path.rstrip("/")
        body = self._json_body()
        if not self.state.check_auth(body, self.headers.get("Authorization")):
            self._unauthorized()
            return
        try:
            if route.startswith("/v1/dataset/sample/"):
                self._dataset_update_sample(route, body)
            else:
                self._send_json(wrap_response(None, 404, "Not found"), 404)
        except Exception as e:
            self._send_json(wrap_response(None, 500, str(e)), 500)

    # -- dataset session helpers ---------------------------------------------

    def _dataset_call(self, fn, *args, **kwargs) -> None:
        """Shared error mapping for the interactive dataset routes: missing
        session/model -> 400, unknown index/task -> 404."""
        try:
            self._send_json(wrap_response(fn(*args, **kwargs)))
        except FileNotFoundError as e:
            self._send_json(wrap_response(None, 404, str(e)), 404)
        except (IndexError, KeyError) as e:
            self._send_json(wrap_response(None, 404, str(e)), 404)
        except RuntimeError as e:
            self._send_json(wrap_response(None, 400, str(e)), 400)

    def _dataset_update_sample(self, route: str,
                               body: Dict[str, Any]) -> None:
        idx = route.rsplit("/", 1)[-1]
        if not idx.lstrip("-").isdigit():
            self._send_json(wrap_response(None, 400, "bad sample index"),
                            400)
            return
        self._dataset_call(self.state.dataset.update_sample, int(idx), body)

    # -- endpoints ----------------------------------------------------------

    def _release_task(self, body: Dict[str, Any]) -> None:
        req = GenerateMusicRequest.from_dict(body)
        state = self.state
        try:
            state._select_handler(req.model, strict=True)
        except KeyError as e:
            self._send_json(wrap_response(None, 400, str(e)), 400)
            return
        rec = state.job_store.create()
        position = state._add_pending(rec.job_id)
        state._cache_progress(rec.job_id, 0.0, "queued")
        try:
            state.job_queue.put_nowait((rec.job_id, req))
        except queue.Full:
            state.job_store.mark_failed(rec.job_id, "queue full")
            state._cache_result(rec.job_id)   # overwrite the 'queued' entry
            with state.pending_lock:
                state.pending_ids.remove(rec.job_id)
                state.enqueued_at.pop(rec.job_id, None)
            state._cleanup_request_temp_files(req)
            self._send_json(wrap_response(None, 503, "Queue full"), 503)
            return
        self._send_json(wrap_response({
            "task_id": rec.job_id,
            "status": "queued",
            "queue_position": position,
        }))

    def _query_result(self, body: Dict[str, Any]) -> None:
        raw = body.get("task_id_list", "[]")
        if isinstance(raw, list):
            task_ids = raw
        else:
            try:
                task_ids = json.loads(raw)
            except (TypeError, ValueError):
                task_ids = []
        now = time.time()
        data_list = []
        for task_id in task_ids:
            payload = self.state.local_cache.get(
                f"{RESULT_KEY_PREFIX}{task_id}")
            if payload is None:
                rec = self.state.job_store.get(task_id)
                if rec is None:
                    data_list.append({"task_id": task_id, "result": "[]",
                                      "status": 2})
                    continue
                self.state._cache_result(task_id)
                payload = self.state.local_cache.get(
                    f"{RESULT_KEY_PREFIX}{task_id}") or "[]"
            try:
                entries = json.loads(payload)
            except ValueError:
                entries = []
            status = entries[0].get("status", 2) if entries else 2
            stage = entries[0].get("stage", "") if entries else ""
            # timeout applies to RUNNING jobs only, measured from RUN
            # start — queue wait is not a failure, and counting it would
            # fail long-queued jobs the moment they start (then flip
            # 2 -> 1 on success, breaking terminal-status expectations)
            run_start = (entries[0].get("run_start_time")
                         or entries[0].get("create_time", 0)) if entries else 0
            if status == 0 and stage == "running" \
                    and (now - run_start) > TASK_TIMEOUT_SECONDS:
                status = 2
            data_list.append({"task_id": task_id, "result": payload,
                              "status": status})
        self._send_json(wrap_response(data_list))

    def _get_stats(self) -> None:
        state = self.state
        with state.stats_lock:
            avg = state.avg_job_seconds
            coalesced = state.coalesced_jobs_total
        self._send_json(wrap_response({
            "jobs": state.job_store.get_stats(),
            "queue_size": state.job_queue.qsize(),
            "queue_maxsize": QUEUE_MAXSIZE,
            "avg_job_seconds": avg,
            "coalesced_jobs_total": coalesced,
        }))

    def _get_metrics(self) -> None:
        """Prometheus text exposition (beyond the reference, which stops
        at the JSON /v1/stats): job counts by status, queue depth, rolling
        average job wall, uptime, the program's counters (renders, songs,
        DiT steps, the VAE's out-of-memory step-downs, fused renders
        retried job by job, the planner's decode steps, graph captures and
        replays and CoT and code tokens, coalesced jobs, seconds by render
        stage), and
        on a CUDA device the caching allocator's allocated and reserved
        bytes and the device total — enough for standard
        alerting/dashboards with zero deps."""
        state = self.state
        with state.stats_lock:
            avg = state.avg_job_seconds
            completed = state.completed_jobs
            coalesced = state.coalesced_jobs_total
        stats = state.job_store.get_stats()
        lines = [
            "# HELP acestep_jobs Jobs by status in the retention window.",
            "# TYPE acestep_jobs gauge",
        ]
        for status in ("queued", "running", "succeeded", "failed"):
            lines.append(
                f'acestep_jobs{{status="{status}"}} {stats.get(status, 0)}')
        lines += [
            "# TYPE acestep_queue_depth gauge",
            f"acestep_queue_depth {state.job_queue.qsize()}",
            "# TYPE acestep_queue_capacity gauge",
            f"acestep_queue_capacity {QUEUE_MAXSIZE}",
            "# TYPE acestep_avg_job_seconds gauge",
            f"acestep_avg_job_seconds {avg:.3f}",
            "# TYPE acestep_jobs_completed_total counter",
            f"acestep_jobs_completed_total {completed}",
            "# TYPE acestep_uptime_seconds counter",
            f"acestep_uptime_seconds {time.time() - state.started_at:.0f}",
        ]
        counts = dict(trace.counters, coalesced_jobs=coalesced)
        for name, value in counts.items():
            lines += [f"# TYPE acestep_{name}_total counter",
                      f"acestep_{name}_total {value}"]
        lines.append("# TYPE acestep_stage_seconds_total counter")
        for stage, seconds in sorted(trace.stage_seconds.items()):
            lines.append(f'acestep_stage_seconds_total{{stage="{stage}"}} '
                         f"{seconds:.6f}")
        if state.device_total_bytes is not None:
            # the caching allocator's own counters: no CUDA call, so a
            # poll cannot disturb a worker's render or graph capture
            lines += [
                "# TYPE acestep_hbm_bytes_in_use gauge",
                "acestep_hbm_bytes_in_use "
                f"{torch.cuda.memory_allocated(state.device)}",
                "# TYPE acestep_hbm_bytes_reserved gauge",
                "acestep_hbm_bytes_reserved "
                f"{torch.cuda.memory_reserved(state.device)}",
                "# TYPE acestep_hbm_bytes_limit gauge",
                f"acestep_hbm_bytes_limit {state.device_total_bytes}"]
        body = ("\n".join(lines) + "\n").encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _get_models(self) -> None:
        models = [{"name": name, "is_default": name == self.state.default_model}
                  for name in self.state.dit_handlers]
        self._send_json(wrap_response({
            "models": models,
            "default_model": self.state.default_model,
        }))

    def _create_random_sample(self, body: Dict[str, Any]) -> None:
        sample_mode = body.get("sample_mode", "simple_mode")
        examples = (load_examples(self.state.examples_dir, sample_mode)
                    if self.state.examples_dir else [])
        if examples:
            self._send_json(wrap_response(random.choice(examples)))
            return
        self.state.ensure_initialized()   # lazy startup: LM on first use
        with self.state.reinit_lock:
            sample = inference.create_sample(self.state.llm_handler,
                                             body.get("query", ""))
        if sample.get("success"):
            self._send_json(wrap_response(sample))
        else:
            self._send_json(wrap_response(None, 503,
                                          sample.get("error", "no examples")),
                            503)

    def _format_input(self, body: Dict[str, Any]) -> None:
        self.state.ensure_initialized()   # lazy startup: LM on first use
        with self.state.reinit_lock:
            out = inference.format_sample(
                self.state.llm_handler,
                body.get("caption", body.get("prompt", "")),
                body.get("lyrics", ""))
        code = 200 if out.get("success") else 500
        self._send_json(wrap_response(out, code, out.get("error")), code)

    def _lrc_to_vtt(self, body: Dict[str, Any]) -> None:
        """LRC text -> WebVTT cues for the studio's synced-lyrics track
        (reference results UI lrc_utils.py:131-185: parse, 2 s merge,
        VTT file for the player's subtitle track). Stateless — the studio
        posts the LRC it already holds plus the audio duration."""
        from acestep_torch.utils.lrc import lrc_to_vtt, parse_lrc_to_subtitles
        try:
            # duration may be LM metadata ("180", "180s", 180.0, garbage)
            duration = float(str(body.get("duration")).rstrip("s"))
        except (TypeError, ValueError):
            duration = None
        lrc = body.get("lrc", "")
        self._send_json(wrap_response(
            {"vtt": lrc_to_vtt(lrc, duration),
             "cues": parse_lrc_to_subtitles(lrc, duration)}, 200, None), 200)

    # -- LoRA (delegates to the default DiT handler's LoRA service) ---------

    def _lora_service(self):
        self.state.ensure_initialized()
        handler = self.state.dit_handlers[self.state.default_model]
        service = getattr(handler, "lora", None)
        if service is None:
            raise RuntimeError("LoRA service not available on this handler")
        return service

    def _lora_load(self, body: Dict[str, Any]) -> None:
        path = _user_path(body["lora_path"])   # validate before service lookup
        service = self._lora_service()
        info = service.load(path, adapter_name=body.get("adapter_name"))
        self._send_json(wrap_response(info))

    def _lora_unload(self, body: Dict[str, Any]) -> None:
        service = self._lora_service()
        info = service.unload(body.get("adapter_name"))
        self._send_json(wrap_response(info))

    def _lora_toggle(self, body: Dict[str, Any]) -> None:
        service = self._lora_service()
        info = service.toggle(bool(body.get("use_lora", True)))
        self._send_json(wrap_response(info))

    def _lora_scale(self, body: Dict[str, Any]) -> None:
        service = self._lora_service()
        info = service.set_scale(float(body["scale"]),
                                 adapter_name=body.get("adapter_name"))
        self._send_json(wrap_response(info))

    def _lora_status(self) -> None:
        try:
            service = self._lora_service()
        except RuntimeError as e:
            self._send_json(wrap_response(None, 503, str(e)), 503)
            return
        self._send_json(wrap_response(service.status()))

    def _reinitialize(self, body: Dict[str, Any]) -> None:
        handler = self.state.dit_handlers[self.state.default_model]
        if not hasattr(handler, "initialize_service"):
            self._send_json(wrap_response(None, 503, "not supported"), 503)
            return
        ckpt = body.get("checkpoint_dir") or getattr(
            handler, "checkpoint_dir", None)
        if body.get("checkpoint_dir") is None and ckpt is None and \
                not body.get("allow_random_init"):
            # no dir given and none remembered: refuse rather than silently
            # replace served weights with random init
            self._send_json(wrap_response(
                None, 400, "checkpoint_dir required (or allow_random_init)"),
                400)
            return
        # flush any pending lazy startup load first: it covers every model
        # (other DiT variants, the LM), not just the handler reinit targets
        self.state.ensure_initialized()
        with self.state.reinit_lock:    # don't swap weights mid-generation
            handler.initialize_service(
                checkpoint_dir=ckpt,
                quantization=(body.get("quantization")
                              or getattr(handler, "quantization", None)))
        self._send_json(wrap_response(handler.get_service_status()))

    # -- OpenRouter chat (ref openrouter_adapter.py) ------------------------

    def _chat_completions(self, body: Dict[str, Any]) -> None:
        state = self.state
        req = openrouter.chat_to_request(body)
        model_name, _ = state._select_handler(req.model)
        model_id = openrouter.model_id_for(model_name)
        rec = state.job_store.create()
        state._add_pending(rec.job_id)
        try:
            state.job_queue.put_nowait((rec.job_id, req))
        except queue.Full:
            state.job_store.mark_failed(rec.job_id, "queue full")
            with state.pending_lock:
                if rec.job_id in state.pending_ids:
                    state.pending_ids.remove(rec.job_id)
                state.enqueued_at.pop(rec.job_id, None)
            state._cleanup_request_temp_files(req)
            self._send_json({"error": {"message": "Queue full",
                                       "code": 503}}, 503)
            return

        if body.get("stream"):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for data in openrouter.sse_chunks(state, rec.job_id, model_id,
                                              req.audio_format):
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.write(b"0\r\n\r\n")
            return

        deadline = time.time() + openrouter.GENERATION_TIMEOUT
        while time.time() < deadline:
            current = state.job_store.get(rec.job_id)
            if current and current.status in ("succeeded", "failed"):
                break
            time.sleep(0.05)
        current = state.job_store.get(rec.job_id)
        if current is None or current.status != "succeeded":
            error = (current.error if current else None) or "Generation failed"
            self._send_json({"error": {"message": error, "code": 500}}, 500)
            return
        self._send_json(openrouter.build_completion(
            current, model_id, req.audio_format))

    def _tensor_info(self, body: Dict[str, Any]) -> None:
        """Stats for a preprocessed tensor dir (ref /v1/training/load_tensor_info)."""
        import numpy as np

        tensor_dir = _user_path(
            body.get("dataset_dir") or body.get("tensor_dir", ""))
        try:
            from acestep_torch.training.data import PreprocessedDataset

            ds = PreprocessedDataset(tensor_dir)
        except FileNotFoundError as e:
            self._send_json(wrap_response(None, 404, str(e)), 404)
            return
        frames = []
        for path in ds.files[:50]:
            with np.load(path) as data:
                frames.append(int(data["hidden_states"].shape[0]))
        self._send_json(wrap_response({
            "num_samples": len(ds.files),
            "frames_min": min(frames) if frames else 0,
            "frames_max": max(frames) if frames else 0,
            "total_seconds": round(sum(frames) / 25.0, 1),
        }))

    def _training_export(self, body: Dict[str, Any]) -> None:
        """Report the exported adapter artifact for a finished run."""
        status = self.state.training.status()
        output_dir = (_user_path(body.get("output_dir"))
                      or status.get("output_dir"))
        if not output_dir or not os.path.isdir(output_dir):
            self._send_json(wrap_response(None, 404, "no training output"), 404)
            return
        adapters = [os.path.join(output_dir, f)
                    for f in sorted(os.listdir(output_dir))
                    if f.endswith(".npz")]
        self._send_json(wrap_response({
            "output_dir": output_dir,
            "adapters": adapters,
            "status": status.get("status"),
        }))

    def _serve_studio(self) -> None:
        """Serve the bundled single-page studio UI (ref ui/studio.html)."""
        path = os.path.join(os.path.dirname(__file__), "studio.html")
        try:
            with open(path, "rb") as f:
                body = f.read()
        except OSError:
            self._send_json(wrap_response(None, 404, "studio UI missing"), 404)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _get_audio(self, url) -> None:
        qs = parse_qs(url.query)
        path = (qs.get("path") or [""])[0]
        full = os.path.abspath(path)
        # only serve from the configured output dir (path traversal guard)
        if not full.startswith(self.state.output_dir + os.sep):
            self._send_json(wrap_response(None, 403, "Forbidden"), 403)
            return
        if not os.path.isfile(full):
            self._send_json(wrap_response(None, 404, "Not found"), 404)
            return
        ext = os.path.splitext(full)[1].lstrip(".").lower()
        ctype = {"wav": "audio/wav", "flac": "audio/flac",
                 "mp3": "audio/mpeg", "ogg": "audio/ogg",
                 "opus": "audio/opus", "aac": "audio/aac",
                 "m4a": "audio/mp4",
                 # reproducibility sidecar written next to each audio
                 "json": "application/json"}.get(
                     ext, "application/octet-stream")
        size = os.path.getsize(full)
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(size))
        self.end_headers()
        with open(full, "rb") as f:
            while True:
                chunk = f.read(1 << 16)
                if not chunk:
                    break
                self.wfile.write(chunk)


def create_server(state: AppState, host: str = "127.0.0.1",
                  port: int = 8019) -> ThreadingHTTPServer:
    """Build the HTTP server bound to `state` and start its workers."""
    handler_cls = type("BoundHandler", (_Handler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler_cls)
    state.start_workers()
    return server


def _env_bool(name: str, default: bool = False) -> bool:
    """Reference api_server.py _env_bool: true/1/yes/on (case-insensitive)."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw in ("1", "true", "yes", "on")


def _resolve_lm_env(value: Optional[str]):
    """Map ACESTEP_LM_MODEL_PATH onto (--lm-checkpoint-dir, --lm-size).

    The reference accepts a model name like 'acestep-5Hz-lm-1.7B' or a
    path here (api_server.py:1528, 2349). A directory resolves as an
    explicit checkpoint; anything else is scanned for a size token and
    falls back to tier-auto selection."""
    value = (value or "").strip()
    if not value:
        return None, None
    if os.path.isdir(value):
        return value, None
    import re

    m = re.search(r"(0\.6|1\.7|4)\s*B", value, re.IGNORECASE)
    return None, (m.group(1) + "B" if m else "auto")


def build_parser():
    """The JAX server's flags, plus `--device` and `--tiny`."""
    import argparse

    parser = argparse.ArgumentParser(description="ACE-Step PyTorch API server")
    parser.add_argument("--host",
                        default=os.environ.get("SERVER_NAME", "0.0.0.0"))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("PORT", "8019")))
    parser.add_argument("--checkpoint-dir",
                        default=os.environ.get("ACESTEP_CONFIG_PATH"))
    # multi-model: up to three DiT variants (reference ACESTEP_CONFIG_PATH2/3);
    # the request field `model` selects one
    parser.add_argument("--checkpoint-dir2",
                        default=os.environ.get("ACESTEP_CONFIG_PATH2"))
    parser.add_argument("--checkpoint-dir3",
                        default=os.environ.get("ACESTEP_CONFIG_PATH3"))
    parser.add_argument("--lm-checkpoint-dir", default=None)
    parser.add_argument("--lm-size", default=None,
                        choices=["auto", "0.6B", "1.7B", "4B"],
                        help="start the LM planner by tier policy: 'auto' "
                             "picks the tier's size (16 GB -> 4B-w8a8) and "
                             "downgrades on out-of-memory; checkpoints are "
                             "looked up under --lm-checkpoint-root, seeded "
                             "weights without one")
    parser.add_argument("--lm-checkpoint-root", default=None,
                        help="directory holding acestep-5Hz-lm-{size} dirs "
                             "for --lm-size")
    parser.add_argument("--lm-quantization", default=None,
                        choices=["int8", "fp8", "w8a8", "int4"],
                        help="quantize LM trunk weights (w8a8 also halves "
                             "per-step decode weight reads; int4 = "
                             "group-wise 4-bit weight-only)")
    parser.add_argument("--lm-kv-quant", default="auto",
                        choices=["auto", "on", "off"],
                        help="int8 KV cache for the LM planner; 'auto' = on "
                             "when the weight mode is w8a8")
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--persist-dir", default=".cache/acestep_torch/api")
    parser.add_argument("--examples-dir", default="examples")
    parser.add_argument("--api-key", default=os.environ.get("ACESTEP_API_KEY"))
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--warmup", default="10,30,60",
                        help="comma-separated durations to render once "
                             "before serving ('' disables)")
    parser.add_argument("--quantization", default=None,
                        choices=[None, "int8"])
    parser.add_argument("--mesh", default=os.environ.get("ACESTEP_MESH"),
                        help="multi-device DiT mesh as 'DPxTP' (e.g. '4x2') "
                             "or a device count for pure data parallel: one "
                             "process per device, this one rank 0 "
                             "(torch.distributed, nccl on cards, gloo with "
                             "--device cpu); default one device (env: "
                             "ACESTEP_MESH)")
    parser.add_argument("--lm-tensor-parallel", type=int,
                        default=int(os.environ.get("ACESTEP_LM_TP", "1")),
                        help="tensor-parallel degree for the LM planner "
                             "(nano-vllm's tensor_parallel_size); it takes "
                             "the first ranks of --mesh's processes when "
                             "both are given")
    parser.add_argument("--no-init", action="store_true",
                        default=_env_bool("ACESTEP_NO_INIT"),
                        help="bind the port immediately and load models "
                             "lazily on the first request that needs them "
                             "(env: ACESTEP_NO_INIT); warmup is skipped")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' "
                             "runs the plain versions of the kernels in "
                             "float32)")
    parser.add_argument("--tiny", action="store_true",
                        help="miniature DiT and VAE with seeded weights "
                             "(tests)")
    return parser


def load_planner(args, dtype, device):
    """The LM planner the parsed server `args` ask for (`--lm-checkpoint-
    dir`, or `--lm-size` through the tier's downgrade ladder, with
    `--lm-quantization`, `--lm-kv-quant` and `--lm-tensor-parallel`), or
    None when they ask for none."""
    from acestep_torch.llm.handler import LLMHandler

    kvq = {"auto": None, "on": True, "off": False}[args.lm_kv_quant]
    if args.lm_checkpoint_dir:
        llm = LLMHandler(dtype=dtype, device=device)
        llm.initialize(checkpoint_dir=args.lm_checkpoint_dir,
                       quantization=args.lm_quantization,
                       tensor_parallel=args.lm_tensor_parallel,
                       kv_quant=kvq)
        return llm
    if not args.lm_size:
        return None
    llm = LLMHandler(dtype=dtype, device=device)
    info = llm.initialize_auto(
        size=args.lm_size,
        checkpoint_root=args.lm_checkpoint_root,
        quantization=args.lm_quantization,
        tensor_parallel=args.lm_tensor_parallel,
        kv_quant=kvq)
    print(f"[acestep_torch] LM planner: {info['size']}"
          f" quant={info['quantization']}"
          f"{' (downgraded)' if info['downgraded'] else ''}")
    return llm


def main(argv: Optional[List[str]] = None) -> None:
    """CLI launcher: initialize real handlers and serve forever. Runs on
    the CUDA device unless `--device cpu`; without a CUDA device and
    without that flag it raises."""
    from acestep_torch.parallel import parse_mesh_spec
    from acestep_torch.pipeline.handler import AceStepHandler, resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    mesh_spec = parse_mesh_spec(args.mesh)

    # ACESTEP_LM_MODEL_PATH supplies the LM when no CLI flag does
    if not args.lm_checkpoint_dir and not args.lm_size:
        env_dir, env_size = _resolve_lm_env(
            os.environ.get("ACESTEP_LM_MODEL_PATH"))
        args.lm_checkpoint_dir = env_dir
        args.lm_size = env_size

    # ACESTEP_INIT_LLM: auto (tier + local-checkpoint detection decides),
    # true (force enable), false (force disable)
    init_llm = os.environ.get("ACESTEP_INIT_LLM", "").strip().lower()
    if init_llm in ("false", "0", "no", "off"):
        if args.lm_checkpoint_dir or args.lm_size:
            print("[acestep_torch] ACESTEP_INIT_LLM=false: LM planner "
                  "disabled (overriding LM flags)")
        args.lm_checkpoint_dir = args.lm_size = None
    elif init_llm in ("true", "1", "yes", "on"):
        if not args.lm_checkpoint_dir and not args.lm_size:
            args.lm_size = "auto"    # force enable at the tier's size
    lm_auto_probe = (init_llm not in ("true", "1", "yes", "on",
                                      "false", "0", "no", "off")
                     and not args.lm_checkpoint_dir and not args.lm_size)

    def maybe_auto_lm():
        """INIT_LLM=auto: enable only when the tier budgets an LM AND its
        checkpoint is already local (never block startup on a multi-GB
        download the operator didn't ask for)."""
        if not lm_auto_probe:
            return
        from acestep_torch.runtime_config import get_global_config
        from acestep_torch.utils.downloads import resolve_local

        tier = get_global_config()
        if tier.lm_size and resolve_local(
                f"acestep-5Hz-lm-{tier.lm_size}", args.lm_checkpoint_root):
            args.lm_size = "auto"
            print(f"[acestep_torch] LM planner auto-enabled "
                  f"({tier.lm_size} found locally; set "
                  "ACESTEP_INIT_LLM=false to disable)")

    from acestep_torch.config import DiTConfig, VAEConfig

    def variant_config(ckpt):
        """Resolve model_version from the checkpoint (config.json or dir
        name) so base/sft variants get the right sampler family."""
        version = "turbo"
        if ckpt:
            explicit = None
            cfg_path = os.path.join(ckpt, "config.json")
            if os.path.exists(cfg_path):
                try:
                    with open(cfg_path) as f:
                        explicit = json.load(f).get("model_version")
                except (OSError, ValueError):
                    pass
            if explicit:
                version = explicit
            else:  # name heuristic only when config.json doesn't say
                name = os.path.basename(ckpt.rstrip("/")).lower()
                for v in ("base", "sft"):
                    if v in name.split("-"):
                        version = v
        if args.tiny:
            return DiTConfig.tiny(model_version=version)
        return DiTConfig(model_version=version)

    def make_handler(ckpt):
        if args.tiny:
            # the tiny VAE emits latents at the tiny DiT's acoustic dim
            return AceStepHandler(variant_config(ckpt),
                                  VAEConfig.tiny(decoder_input_channels=64),
                                  dtype=dtype, frame_bucket=25,
                                  min_frames=25, refer_frames=10,
                                  device=device)
        return AceStepHandler(dit_config=variant_config(ckpt), dtype=dtype,
                              device=device)

    # handler objects are cheap to construct (no weights); initialization
    # is factored out so --no-init can defer it to the first request
    handlers = {}
    ckpts = {}
    for idx, ckpt in enumerate([args.checkpoint_dir, args.checkpoint_dir2,
                                args.checkpoint_dir3]):
        if idx > 0 and not ckpt:
            continue
        name = (os.path.basename(ckpt.rstrip("/")) if ckpt
                else "acestep-v15-turbo")
        while name in handlers:      # basename collision: disambiguate
            name += "+"
        handlers[name] = make_handler(ckpt)
        ckpts[name] = ckpt

    state = AppState(handlers, None,
                     output_dir=args.output_dir,
                     persist_dir=args.persist_dir,
                     examples_dir=args.examples_dir,
                     api_key=args.api_key,
                     worker_count=args.workers)

    def load_models():
        maybe_auto_lm()
        shared_vae = None
        shared_embedder = None
        for name, dit in handlers.items():
            dit.initialize_service(checkpoint_dir=ckpts[name],
                                   quantization=args.quantization,
                                   vae_params=shared_vae,
                                   text_embedder=shared_embedder)
            shared_vae = dit.vae             # one VAE across variants
            shared_embedder = dit.text_embedder
            if mesh_spec:
                dit.enable_mesh(dp=mesh_spec[0], tp=mesh_spec[1])
        if mesh_spec:
            print(f"[acestep_torch] mesh enabled: dp={mesh_spec[0]} x "
                  f"tp={mesh_spec[1]} over {mesh_spec[0] * mesh_spec[1]} "
                  "devices")
        if args.warmup and not args.no_init:   # lazy startup skips warmup
            durations = [float(d) for d in args.warmup.split(",") if d]
            print(f"[acestep_torch] warming {durations} x {list(handlers)}...")
            for name, dit in handlers.items():
                print(f"[acestep_torch] warmup {name}: "
                      f"{dit.warmup(durations)}")
        llm = load_planner(args, dtype, device)
        state.llm_handler = llm
        state.dataset.llm = llm      # the builder labels with the planner

    if args.no_init:
        state._lazy_init = load_models
        print("[acestep_torch] --no-init: models load on first request")
    else:
        load_models()
    server = create_server(state, args.host, args.port)
    print(f"[acestep_torch] serving on http://{args.host}:{args.port}",
          flush=True)

    # SIGTERM (container/orchestrator stop) drains like Ctrl-C: stop
    # accepting, let state.shutdown() signal the workers, exit cleanly
    import signal as _signal

    def _term(_signum, _frame):
        raise KeyboardInterrupt

    try:
        _signal.signal(_signal.SIGTERM, _term)
    except ValueError:
        pass                      # not the main thread (embedded use)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[acestep_torch] shutting down...")
    finally:
        state.shutdown()
        server.server_close()
        # stop the mesh's follower processes
        for dit in handlers.values():
            dit.release_mesh()
        if state.llm_handler is not None:
            state.llm_handler.release()


if __name__ == "__main__":
    main()
