"""The server's coalesced_jobs_total over the window, as a share of the
jobs completed in it (%): how many songs were rendered in a fused group."""


def read(run):
    if run.coalesced is None or not run.ok:
        return None
    return 100.0 * run.coalesced / len(run.ok)
