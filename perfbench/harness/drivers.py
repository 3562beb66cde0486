"""The two ways a cell drives the program, chosen by the traffic mix's
`driver`:

- `rest`: the REST server (`serving.server.create_server(AppState(...))`)
  in this process on a local port, fed by a child process (`loadgen.py`,
  standard library only) that posts /release_task, on the mix's schedule
  in an open loop or from the mix's `clients` in a closed one, and polls
  /query_result. Each request is timed from when it was due (open loop)
  or sent (closed loop) until the client saw its result.
- `facade`: `inference.generate_music`, one client in a closed loop,
  sending its next request when the last one came back. Each request is
  timed from its send.

Each takes the handlers a system built (`program.Handlers`: the DiT
handler and the planner or None), keeps the program's songs only until
their sizes are read, and returns one record per request with the
program's own spans and counters beside it. The system warms every shape
the mix uses before the window.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict, List

LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loadgen.py")


def _record(req: dict, **kw) -> dict:
    rec = {"seed": req["seed"], "caption": req["caption"],
           "lyrics": req["lyrics"], "duration_s": float(req["duration_s"]),
           "language": req.get("vocal_language", "en"),
           "steps": int(req["inference_steps"]), "shift": float(req["shift"]),
           "start": None, "done": None, "ok": False, "error": None,
           "time_costs": {}, "coalesced": 1, "file": None, "bytes": None}
    rec.update(kw)
    return rec


class Rest:
    """The REST server and its clients."""

    def __init__(self, handlers, mix: dict, out_dir: str):
        from acestep_torch.serving.server import AppState, create_server

        self.mix = mix
        self.state = AppState({"turbo": handlers.dit}, handlers.llm,
                              output_dir=out_dir)
        self.httpd = create_server(self.state, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._serve = threading.Thread(target=self.httpd.serve_forever,
                                       kwargs={"poll_interval": 0.05},
                                       daemon=True)
        self._serve.start()

    @staticmethod
    def body(req: dict) -> dict:
        keys = ("batch_size", "inference_steps", "shift", "audio_format",
                "thinking", "vocal_language")
        b = {k: req[k] for k in keys if k in req}
        b.update(prompt=req["caption"], lyrics=req["lyrics"],
                 audio_duration=req["duration_s"], use_random_seed=False,
                 seed=req["seed"])
        return b

    def warm_http(self, req: dict, timeout: float = 120.0) -> None:
        """One request through the HTTP routes, waited for."""
        def post(path, body):
            r = urllib.request.Request(self.url + path,
                                       data=json.dumps(body).encode(),
                                       headers={"Content-Type":
                                                "application/json"})
            with urllib.request.urlopen(r, timeout=30) as f:
                return json.loads(f.read())["data"]

        task = post("/release_task", self.body(req))["task_id"]
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            got = post("/query_result", {"task_id_list": json.dumps([task])})
            if got[0]["status"] in (1, 2):
                return
            time.sleep(0.01)
        raise RuntimeError("the warm-up request did not finish")

    def window(self, reqs: List[dict], w0: float, seconds: float,
               late_s: float) -> List[dict]:
        coalesced_before = self.state.coalesced_jobs_total
        spec = {"url": self.url, "start": w0, "stop": w0 + seconds,
                "poll_s": self.mix["poll_s"], "deadline": w0 + seconds + late_s,
                "clients": self.mix.get("clients", 0),
                "requests": [{"offset_s": r.get("offset_s"),
                              "body": self.body(r)} for r in reqs]}
        child = subprocess.Popen([sys.executable, LOADGEN],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 text=True)
        try:
            out, _ = child.communicate(json.dumps(spec),
                                       timeout=seconds + late_s + 60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        got = json.loads(out.strip().splitlines()[-1])
        if got["ran_out"]:
            raise RuntimeError("the closed loop ran out of requests")
        results = got["results"]
        self.coalesced = self.state.coalesced_jobs_total - coalesced_before
        records = []
        for req, res in zip(reqs, results):     # sent in the requests' order
            rec = _record(req, start=res["due"], sent=res["sent"],
                          done=res["done"], error=res["error"],
                          task_id=res["task_id"])
            job = (self.state.job_store.get(res["task_id"])
                   if res["task_id"] else None)
            if job is not None:
                rec["job"] = {"created_at": job.created_at,
                              "started_at": job.started_at,
                              "finished_at": job.finished_at}
                result = job.result or {}
                extra = result.get("extra_outputs") or {}
                rec["time_costs"] = dict(extra.get("time_costs") or {})
                rec["coalesced"] = int(extra.get("coalesced_jobs") or 1)
                audios = result.get("audios") or []
                if audios:
                    rec["file"] = audios[0].get("path")
            rec["ok"] = (res["status"] == 1 and job is not None
                         and job.status == "succeeded")
            if not rec["ok"] and rec["error"] is None:
                rec["error"] = (job.error if job is not None else
                                "no result before the deadline")
            records.append(rec)
        return records

    def close(self) -> None:
        self.state.shutdown()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._serve.join(timeout=10)
        for th in self.state._workers:
            th.join(timeout=30)


class Facade:
    """`inference.generate_music` in a closed loop of one client."""

    def __init__(self, handlers, mix: dict, out_dir: str):
        self.handlers, self.out_dir = handlers, out_dir

    def params(self, req: dict):
        from acestep_torch.inference import GenerationConfig, GenerationParams

        p = GenerationParams(
            caption=req["caption"], lyrics=req["lyrics"],
            vocal_language=req.get("vocal_language", "en"),
            duration=float(req["duration_s"]),
            inference_steps=int(req["inference_steps"]), shift=float(req["shift"]),
            seed=int(req["seed"]), thinking=bool(req.get("thinking", False)))
        c = GenerationConfig(batch_size=1, use_random_seed=False,
                             audio_format=req["audio_format"],
                             output_dir=self.out_dir)
        return p, c

    def one(self, req: dict):
        from acestep_torch.inference import generate_music

        return generate_music(self.handlers.dit, self.handlers.llm,
                              *self.params(req))

    def window(self, reqs: List[dict], w0: float, seconds: float,
               late_s: float) -> List[dict]:
        records = []
        time.sleep(max(0.0, w0 - time.monotonic()))
        for req in reqs:
            t = time.monotonic()
            if t >= w0 + seconds:
                break
            res = self.one(req)
            rec = _record(req, start=t, sent=t, done=time.monotonic(),
                          ok=bool(res.success), error=res.error)
            if res.success:
                rec["time_costs"] = dict(res.extra_outputs.get("time_costs") or {})
                rec["file"] = res.audios[0].get("path") if res.audios else None
            records.append(rec)
        else:
            raise RuntimeError("the closed loop ran out of requests")
        return records

    def close(self) -> None:
        pass


DRIVERS: Dict[str, type] = {"rest": Rest, "facade": Facade}
