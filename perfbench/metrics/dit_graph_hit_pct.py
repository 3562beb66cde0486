"""The share of the window's sampler steps that the port ran as CUDA
graph replays (%): the change in its `dit_graph_replays` counter over
the change in `dit_steps`, both read at the window's open and close."""


def read(run):
    c = run.counters
    if not c or not c.get("dit_steps"):
        return None
    return 100.0 * c.get("dit_graph_replays", 0) / c["dit_steps"]
