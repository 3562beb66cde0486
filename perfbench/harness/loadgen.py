"""Load generator for the REST server, run as a child process so that the
server's process keeps its interpreter lock to itself.

Standard library only. Reads one JSON object on stdin:
  {"url": "http://127.0.0.1:PORT", "start": <time.monotonic() of the
   window's start>, "stop": <monotonic time after which nothing more is
   sent>, "poll_s": 0.01, "deadline": <monotonic time after which it stops
   waiting>, "clients": N, "requests": [{"offset_s": s, "body": {...}}]}

With "clients" 0 the loop is open: each body goes to POST /release_task
at start + offset_s. With "clients" N > 0 it is closed: N clients each
send a request at the start and the next one as soon as the last came
back, taking the bodies in order, until `stop`. Every poll_s one POST
/query_result asks after every outstanding task. Prints one JSON line:
{"results": [{"due", "sent", "done", "status", "task_id", "file",
"error"}, ...], "ran_out": <a closed loop used every body before stop>}
for the requests sent, in the order they were taken. A
closed loop's request is due when it is sent. Times are time.monotonic()
readings, the clock the parent reads too.
"""

import json
import sys
import threading
import time
import urllib.request


def post(url, body, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class Client:
    def __init__(self, spec):
        self.url = spec["url"]
        self.reqs = spec["requests"]
        self.results = []
        self.outstanding = {}
        self.lock = threading.Lock()

    def send(self, i, due):
        """POST request i; a refusal is a failed request."""
        res = {"due": due, "sent": time.monotonic(), "done": None,
               "status": None, "task_id": None, "file": None, "error": None}
        with self.lock:
            self.results.append(res)
        try:
            data = post(self.url + "/release_task", self.reqs[i]["body"])["data"]
            with self.lock:
                res["task_id"] = data["task_id"]
                self.outstanding[data["task_id"]] = res
        except Exception as e:  # refused or unreachable
            res["error"] = f"release_task: {e!r}"
            res["done"] = time.monotonic()
            res["status"] = 2
        return res

    def poll(self):
        """One /query_result over every outstanding task -> the results
        that finished."""
        with self.lock:
            ids = list(self.outstanding)
        if not ids:
            return []
        try:
            entries = post(self.url + "/query_result",
                           {"task_id_list": json.dumps(ids)})["data"]
        except Exception:
            return []
        t = time.monotonic()
        done = []
        for e in entries:
            if e["status"] not in (1, 2):
                continue
            with self.lock:
                res = self.outstanding.pop(e["task_id"], None)
            if res is None:
                continue
            res["done"], res["status"] = t, e["status"]
            items = json.loads(e["result"]) if e.get("result") else []
            if items:
                res["file"] = items[0].get("file")
                res["error"] = items[0].get("error") or None
            done.append(res)
        return done


def open_loop(c, spec):
    start, poll_s = spec["start"], spec["poll_s"]
    sending_done = threading.Event()

    def sender():
        for i, r in enumerate(c.reqs):
            due = start + r["offset_s"]
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            c.send(i, due)
        sending_done.set()

    th = threading.Thread(target=sender, daemon=True)
    th.start()
    while time.monotonic() < spec["deadline"]:
        with c.lock:
            idle = not c.outstanding
        if idle and sending_done.is_set():
            break
        c.poll()
        time.sleep(poll_s)
    th.join(timeout=5)


def closed_loop(c, spec):
    """-> whether a client was free before `stop` with no body left."""
    nxt, ran_out = 0, False

    def send_next():
        # a refused request frees its client at once: the next goes out
        nonlocal nxt, ran_out
        while time.monotonic() < spec["stop"]:
            if nxt >= len(c.reqs):
                ran_out = True
                return
            nxt += 1
            res = c.send(nxt - 1, None)
            res["due"] = res["sent"]
            if res["status"] is None:
                return

    time.sleep(max(0.0, spec["start"] - time.monotonic()))
    for _ in range(spec["clients"]):
        send_next()
    while time.monotonic() < spec["deadline"]:
        for _res in c.poll():
            send_next()
        with c.lock:
            idle = not c.outstanding
        if idle and (ran_out or time.monotonic() >= spec["stop"]):
            break
        time.sleep(spec["poll_s"])
    return ran_out


def main():
    spec = json.loads(sys.stdin.read())
    c = Client(spec)
    ran_out = False
    if spec.get("clients", 0) > 0:
        ran_out = closed_loop(c, spec)
    else:
        open_loop(c, spec)
    print(json.dumps({"results": c.results, "ran_out": ran_out}), flush=True)


if __name__ == "__main__":
    main()
