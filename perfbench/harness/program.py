"""What every system under test shares: the handlers a system module
(`perfbench/systems/`) builds, the loading of seeded weights into a module
built on the meta device, and the benchmark's own spans and captures
around the calls into the handler's layers.

Everything here reaches the program through its public modules
(`acestep_torch.*`); what it records lives in a `Recorder` the run owns.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple

import torch


class Handlers(NamedTuple):
    """The program a system builds: `dit`, the `AceStepHandler` every
    render goes through, and `llm`, its `LLMHandler` or None."""
    dit: Any
    llm: Any = None


def tuples(d: dict) -> dict:
    """A configuration group with its lists as tuples, as the port's
    config dataclasses take them."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def load_module(module, tensors: Dict[str, torch.Tensor]):
    """`tensors` into `module` (built on the meta device) by state-dict
    name: every name the module has, no other, each of its shape."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tensors.items()}
    if want != got:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        bad = sorted(k for k in set(want) & set(got) if want[k] != got[k])[:5]
        raise ValueError(f"checkpoint layout differs from the module: "
                         f"missing {missing}, extra {extra}, shape {bad}")
    module.load_state_dict(tensors, strict=True, assign=True)
    return module.requires_grad_(False)


class Recorder:
    """Spans (name, host start, host end, thread) around the calls into the
    program's layers, the songs each render produced (by seed) and the
    seeds of each render, in order; with the kernel launchers wrapped
    (`install(kernels=True)`, traced runs only), while `logging_kernels`
    is set, every K1 and K4 launch: (host time just before it, shape)."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.songs: Dict[int, tuple] = {}
        self.renders: List[tuple] = []
        self.k1_calls: List[tuple] = []
        self.k4_calls: List[tuple] = []
        self.logging_kernels = False
        self._lock = threading.Lock()
        self._kernel_lock = threading.Lock()
        self._undo: List[tuple] = []

    def span(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.append((name, t0, t1, threading.get_ident()))

    def _patch(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def install(self, kernels: bool = False) -> None:
        """Wrap the handler's render, diffusion and decode, the saver and,
        with `kernels`, the two kernels' launchers."""
        from acestep_torch.ops import flash_attention as fa
        from acestep_torch.ops import snake_conv as sc
        from acestep_torch.pipeline.handler import AceStepHandler
        from acestep_torch.utils.audio import AudioSaver

        rec = self

        def timed(name):
            def make(orig):
                def wrapper(*a, **kw):
                    t0 = time.monotonic()
                    try:
                        return orig(*a, **kw)
                    finally:
                        rec.span(name, t0, time.monotonic())
                return wrapper
            return make

        def render(orig):
            def wrapper(self_, *a, **kw):
                res = orig(self_, *a, **kw)
                with rec._lock:
                    rec.renders.append(tuple(int(s) for s in res.seeds))
                    for i, s in enumerate(res.seeds):
                        path = res.audio_paths[i] if res.audio_paths else None
                        rec.songs[int(s)] = (res.audios[i], res.pred_latents[i],
                                             path)
                return res
            return wrapper

        def launcher(calls, shape_of):
            # under the lock, a call is logged exactly when the port's
            # counter counts it inside the logging stretch
            def make(orig):
                def wrapper(*a):
                    with rec._kernel_lock:
                        if not rec.logging_kernels:
                            return orig(*a)
                        calls.append((time.monotonic(), shape_of(*a)))
                        return orig(*a)
                return wrapper
            return make

        def k1_shape(q, k, v, window=None):
            return (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    k.shape[2], q.shape[3], window)

        def k4_shape(units, x):
            return tuple(x.shape)

        self._patch(AceStepHandler, "generate_music", render)
        self._patch(AceStepHandler, "_generate_latents", timed("diffusion"))
        self._patch(AceStepHandler, "decode_latents", timed("vae"))
        self._patch(AudioSaver, "save_audio", timed("save"))
        if not kernels:
            return
        self._patch(fa, "flash_attention_cuda",
                    launcher(self.k1_calls, k1_shape))
        self._patch(sc, "res_unit_stack_cuda",
                    launcher(self.k4_calls, k4_shape))

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


def set_kernel_logging(rec: "Recorder", on: bool) -> Dict[str, int]:
    """Turn the launch log on or off; the port's launch counters at that
    instant (no launch is in flight while they are read)."""
    with rec._kernel_lock:
        rec.logging_kernels = on
        return kernel_launches()


def kernel_launches() -> Dict[str, int]:
    """The port's own launch counters of K1 and K4."""
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc

    return {"k1": fa.launches, "k4": sc.launches}


class PortTrace:
    """The port's own span tracer and counters (`acestep_torch.utils.
    trace`) over a traced run's window: `open()` empties the ring, notes
    the counters and turns the tracer on; `close()` turns it off and
    returns the spans the ring holds, how many of them it dropped (a full
    ring drops its oldest), and each counter's change. Without the
    tracer in the program there is nothing to read."""

    def __init__(self):
        try:
            from acestep_torch.utils import trace
        except ImportError:
            trace = None
        self.trace = trace
        self._counters: Dict[str, int] = {}
        self._first_id = 0

    def open(self) -> None:
        t = self.trace
        if t is None:
            return
        t.drain()
        self._counters = dict(t.counters)
        self._first_id = next(t._ids)    # span ids count up as spans open
        t.enable()

    def close(self) -> tuple:
        """(spans, dropped, counters' change) since `open()`."""
        t = self.trace
        if t is None:
            return None, 0, None
        t.disable()
        opened = next(t._ids) - self._first_id - 1
        spans = t.drain()
        dropped = opened - len(spans) if len(spans) >= t.RING_SIZE else 0
        counters = {k: v - self._counters.get(k, 0)
                    for k, v in t.counters.items()}
        return spans, max(0, dropped), counters


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release() -> None:
    """Collect what the program left behind and give its memory back."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

