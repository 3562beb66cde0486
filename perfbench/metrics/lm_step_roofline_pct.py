"""The planner's codes-phase decode step against its memory roofline in
the traced sub-window (%): the bytes each step enqueued in the stretch
must read (harness/lm_counts.step_bytes: the trunk's bf16 weights, the
audio-code head window, the fed embeddings and every row's K/V at its
mean length over its `lm.codes` span), summed, over the card's memory
bandwidth, over the card's busy time inside the `lm.codes` spans in the
stretch (the kernels those steps launched, sampling included). Steps are
the port's `lm.step` spans, counted where they open: the card runs a few
steps behind the host, as many at the stretch's start as at its end."""

from harness import counts, lm_counts, spans


def read(run):
    got, traced = spans.program_spans(run), spans.stretch_and_gaps(run)
    peak = counts.peak(run.card)
    if not got or traced is None or peak is None:
        return None
    (lo, hi), gaps = traced
    lm = run.conf["lm"]
    codes = {s["id"]: s for s in got if s["name"] == "lm.codes"
             and s["attrs"].get("steps")}
    bound = 0.0
    for s in got:
        c = codes.get(s["parent"])
        if s["name"] != "lm.step" or c is None or not lo <= s["start"] < hi:
            continue
        a = c["attrs"]
        kv = a["kv_tokens"] + a["rows"] * (a["steps"] - 1) / 2
        bound += lm_counts.step_bytes(lm, a["rows"], kv,
                                      a["window"]) / peak["bytes_per_s"]
    inside = spans.intersect(spans.merge((c["start"], c["end"])
                                         for c in codes.values()),
                             [(lo, hi)])
    busy = spans.total(inside) - spans.total(
        spans.intersect(spans.merge(gaps), inside))
    return 100.0 * bound / busy if bound > 0 and busy > 0 else None
