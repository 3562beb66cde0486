"""The one traffic generator: a mix file's parameters and a run's seed ->
the requests of the run.

Every seed gets the same work. An open loop sends round(rate x seconds)
requests whose gaps are the quantiles of the exponential distribution of
that rate (a Poisson process's gaps, evenly spread over its law), in one
order shuffled by the mix's own `arrival_seed`: every run offers the same
arrivals, and the run's seed changes what is asked. Captions and lyrics are words
drawn by the seed, cut to a byte length drawn from the mix's range, so
every request's prompts fall in the same length buckets. Request seeds are
distinct draws below 2^31.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

WORDS = (
    "amber echo velvet neon river midnight golden static ocean thunder "
    "glass ember hollow silver drift fever orbit lantern violet canyon "
    "whisper electric crystal shadow harbor bloom rust satellite prairie "
    "sunrise winter signal copper meadow storm paper mirror garden tide "
    "dusk engine feather marble comet pulse valley ribbon cathedral haze"
).split()
STYLES = (
    "synthwave lofi ambient funk jazz techno folk rock disco soul house "
    "trap orchestral acoustic dreampop garage reggae blues metal"
).split()


def _text(rng: random.Random, lo: int, hi: int, words=WORDS) -> str:
    n = rng.randint(lo, hi)
    out = ""
    while len(out) < n:
        out += rng.choice(words) + " "
    return out[:n].strip() or words[0]


def _lyrics(rng: random.Random, lo: int, hi: int) -> str:
    n = rng.randint(lo, hi)
    lines = ["[verse]"]
    while sum(len(x) + 1 for x in lines) < n:
        lines.append(" ".join(rng.choice(WORDS) for _ in range(rng.randint(3, 7))))
        if len(lines) % 5 == 0:
            lines.append("[chorus]")
    return "\n".join(lines)[:n]


def arrivals(rate: float, seconds: float, rng: random.Random) -> List[float]:
    """Offsets (s) of an open loop's sends inside the window."""
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng.shuffle(gaps)
    t, out = 0.0, []
    for g in gaps:
        out.append(t)
        t += g
    return out


def requests(mix: dict, seed: int, seconds: float, count: int = 0) -> List[Dict]:
    """The run's requests: each a dict of the mix's fixed `request` fields
    plus `caption`, `lyrics`, `seed` and, in an open loop, `offset_s`.
    A closed loop has no schedule: `count` requests are drawn (enough for
    any window the loop can fill)."""
    rng = random.Random(int(seed))
    text = mix["text"]
    if mix["loop"] == "open":
        offsets = arrivals(mix["rate_per_s"], seconds,
                           random.Random(mix["arrival_seed"]))
    else:
        offsets = [None] * count
    seeds = rng.sample(range(1, 1 << 31), len(offsets))
    out = []
    for off, s in zip(offsets, seeds):
        style = rng.choice(STYLES)
        caption = style + ", " + _text(rng, *text["caption_bytes"])
        req = dict(mix["request"], caption=caption,
                   lyrics=_lyrics(rng, *text["lyric_bytes"]), seed=s)
        if off is not None:
            req["offset_s"] = off
        out.append(req)
    return out
