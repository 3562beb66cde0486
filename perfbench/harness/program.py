"""The system under test: the port's handler built from a configuration
file and seeded weights, and the benchmark's own spans and captures
around the calls into its layers.

Everything here reaches the program through its public modules
(`acestep_torch.*`); what it records lives in a `Recorder` the run owns.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import torch

from harness import weights
from reference import dit as ref_dit
from reference import vae as ref_vae

def _tuples(d: dict) -> dict:
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


def build_handler(conf: dict, seed: int, device, dtype=None):
    """An initialised `AceStepHandler` serving the configuration `conf`
    with the weights of run `seed`, drawn on `device`."""
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.models.dit import AceStepDiT
    from acestep_torch.models.vae import OobleckVAE
    from acestep_torch.pipeline.handler import AceStepHandler

    dtype = dtype or getattr(torch, conf["dtype"])
    cfg = DiTConfig(**_tuples(conf["dit"]))
    vcfg = VAEConfig(**_tuples(conf["vae"]))
    dit = load_module(AceStepDiT(cfg, device="meta", dtype=dtype),
                      weights.draw(ref_dit.param_shapes(conf["dit"]), seed,
                                   "dit", device, dtype))
    vae = load_module(OobleckVAE(vcfg, device="meta", dtype=dtype),
                      weights.draw(ref_vae.param_shapes(conf["vae"]), seed,
                                   "vae", device, dtype))
    handler = AceStepHandler(cfg, vcfg, dtype=dtype, device=device)
    handler.initialize_service(params=dit, vae_params=vae)
    return handler


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


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release() -> None:
    """Collect what the program left behind and give its memory back."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

