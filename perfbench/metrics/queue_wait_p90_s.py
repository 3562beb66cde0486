"""90th percentile over the window's completed REST jobs of the job
store's started_at - created_at: the wait in the server's queue (s)."""

from harness import measure


def read(run):
    waits = [r["job"]["started_at"] - r["job"]["created_at"] for r in run.ok
             if r.get("job") and r["job"]["started_at"] is not None]
    return measure.percentile(waits, 90)
