"""The share of the window's planner decode steps that the port ran as
CUDA graph replays (%): the change in its `lm_graph_replays` counter over
the change in `lm_decode_steps`."""


def read(run):
    c = run.counters
    if not c or not c.get("lm_decode_steps"):
        return None
    return 100.0 * c.get("lm_graph_replays", 0) / c["lm_decode_steps"]
