"""The DiT decoder step replayed as CUDA graphs between its eager cores.

`dit_decoder` (models/dit.py) runs a step as segments. Called as the
samplers call it, with the trajectory's cross K/V, it hands the step to
`replay_step`, which runs the same segments as CUDA graphs instead,
captured once per key, wherever `engages` holds, and keeps eager the two
cores where per-call addresses enter:

- the self-attention kernel (K1, `ops.flash_attention.flash_attention`),
  launched as before, so each launch is counted and traced on its own;
- the cross-attention core over the trajectory's K/V (`ops.basic._sdpa`),
  whose addresses change with every render.

A step is then the inputs copied into static buffers, the first segment
(timestep embeddings, `proj_in`, layer 0's attention inputs), and for
each layer K1, segment B (o_proj and residual, the cross-attention's
query), the cross-attention core and segment C (its o_proj, the MLP, and
the next layer's attention inputs, or `norm_out` and `proj_out` after the
last layer): 2 n_layers + 1 replays, each core's output copied into the
static buffer the next segment reads.

The key is the config, the inputs' shapes and dtypes and the data
pointers of every decoder tensor: an adapter's merged weights
(`lora/adapters.call_with_weights`) are other pointers, so they get graphs
of their own and no replay reads stale weights. The first step of a key
runs eagerly (its result is `dit_decoder`'s), gives each buffer the
strides the eager step gave it, so a replay's kernels see the layouts
the eager ones saw, and captures the key: where the host binds the step,
the replays of the same render's later steps repay the capture. The graphs of all keys share one memory pool and
one arena of static buffers, sized to the largest key seen: steps use
them one at a time, under a lock that sends a second caller down the
eager path, and each step waits on the device for the last one's end
(`DecoderGraphs.done`), whatever stream either ran on. A replayed step
returns a copy of its output buffer, so no later step overwrites a
result. A key the arena cannot hold grows it, and the keys of the same
weights are captured again at once; at most MAX_KEYS keys are kept,
least recently used first out.
"""

from __future__ import annotations

import collections
import functools
import threading
import weakref
from typing import Dict, NamedTuple, Optional

import torch

from acestep_torch.config import DiTConfig
from acestep_torch.models.dit import (
    cross_out, decoder_in, decoder_out, decoder_rope, layer_window,
    resolve_attention_impl, self_attn_in, self_attn_out,
)
from acestep_torch.ops.basic import _sdpa
from acestep_torch.ops import flash_attention as fa
from acestep_torch.ops.quant import QuantWeight
from acestep_torch.utils import trace

# keys kept, least recently used out. On an H100 at full width a key's
# graphs hold ~8 MB of device memory outside the caching allocator and
# ~9 MB of host memory, and a key let go costs one capture (~0.1-0.2 s,
# two to three eager steps) when it comes back
MAX_KEYS = 8
ALIGN = 256       # bytes between two buffers' starts in the arena
# buffers whose lives do not overlap share q's bytes: K1 reads a layer's q
# before its output lands in attn, segment B reads attn before it writes
# cq, the cross core reads cq before its output lands in ca, and segment C
# reads ca before it writes the next layer's q
SHARES_Q = ("attn", "cq", "ca")


class _Key(NamedTuple):
    cfg: DiTConfig
    inputs: tuple         # (shape, dtype) of xt, timestep, timestep_r, ctx
    kv_dtype: torch.dtype
    weights: tuple        # data pointers of every decoder tensor


class _Spec(NamedTuple):
    shape: tuple
    stride: tuple
    dtype: torch.dtype


class _Step(NamedTuple):
    """One key's graphs over its views of the arena."""
    bufs: Dict[str, torch.Tensor]
    graphs: list
    rope: tuple           # read by the graphs, held for them
    windows: list         # each layer's band, for its K1 launch


def _segments(p, cfg: DiTConfig, rope, frames: int):
    """The step's segments in replay order, each fn(b) -> {name: tensor}
    over a mapping b of the step's carried tensors."""
    layers = p.layers
    n = len(layers)

    def first(b):
        h, tproj, temb = decoder_in(p, cfg, b["xt"], b["t"], b["t_r"],
                                    b["ctx"])
        q, k, v = self_attn_in(layers[0], cfg, h, tproj, rope)
        return dict(h=h, tproj=tproj, temb=temb, q=q, k=k, v=v)

    def attn_out(i):
        def seg(b):
            h, cq = self_attn_out(layers[i], cfg, b["h"], b["attn"],
                                  b["tproj"])
            return dict(h=h, cq=cq)
        return seg

    def layer_out(i):
        def seg(b):
            h = cross_out(layers[i], cfg, b["h"], b["ca"], b["tproj"])
            if i + 1 == n:
                return dict(out=decoder_out(p, cfg, h, b["temb"], frames))
            q, k, v = self_attn_in(layers[i + 1], cfg, h, b["tproj"], rope)
            return dict(h=h, q=q, k=k, v=v)
        return seg

    return [first] + [seg for i in range(n)
                      for seg in (attn_out(i), layer_out(i))]


def _walk(segs, b, run, put, windows, cross_kv):
    """One step: the segments through `run`, each core between them eager,
    its output handed to `put(name, tensor)`."""
    run(segs[0])
    for i, window in enumerate(windows):
        put("attn", fa.flash_attention(b["q"], b["k"], b["v"],
                                       window=window))
        run(segs[2 * i + 1])
        put("ca", _sdpa(b["cq"], cross_kv[0][i], cross_kv[1][i], None))
        run(segs[2 * i + 2])
    return b["out"]


def _write(seg, bufs: Dict[str, torch.Tensor]) -> None:
    """Run `seg` over the static buffers, into them."""
    for name, t in seg(bufs).items():
        bufs[name].copy_(t)


def _spec(t: torch.Tensor) -> _Spec:
    """A buffer's layout: t's strides, so that a replay's kernels read and
    write it as the eager step's did (a reduction's order follows the
    layout); contiguous where t repeats an element (an expanded
    timestep)."""
    stride = t.stride()
    if any(st == 0 and n > 1 for n, st in zip(t.shape, stride)):
        stride = torch.empty(t.shape, device="meta").stride()
    return _Spec(tuple(t.shape), tuple(stride), t.dtype)


def _nbytes(spec: _Spec) -> int:
    """The bytes from a buffer's first element to its last, rounded up to
    ALIGN (a slice's strides span more than its elements)."""
    span = 1 + sum((n - 1) * st for n, st in zip(spec.shape, spec.stride))
    if 0 in spec.shape:
        span = 0
    return -(-span * spec.dtype.itemsize // ALIGN) * ALIGN


def _layout(specs: Dict[str, _Spec]):
    """({name: byte offset in the arena}, bytes in all)."""
    slot = {name: "q" if name in SHARES_Q else name for name in specs}
    size: Dict[str, int] = {}
    for name, s in specs.items():
        size[slot[name]] = max(size.get(slot[name], 0), _nbytes(s))
    start, off = {}, 0
    for name, n in size.items():
        start[name] = off
        off += n
    return {name: start[slot[name]] for name in specs}, off


class DecoderGraphs:
    """The captured steps of one decoder (`graphs_of`). Its modules are
    listed once, at the first step: a model is quantized
    (`ops.quant.quantize_module_`) before it renders."""

    def __init__(self, p):
        mods = list(p.modules())
        # the slots call_with_weights swaps tensors in and out of
        self.slots = [d for m in mods for d in (m._parameters, m._buffers)
                      if d]
        self.quant = [m._buffers for m in mods if isinstance(m, QuantWeight)]
        self.lock = threading.Lock()
        self.steps: "collections.OrderedDict[_Key, tuple]" = \
            collections.OrderedDict()
        self.arena: Optional[torch.Tensor] = None
        self.pool = self.stream = None
        # recorded where a step ends: the next step's stream waits on it
        # before it writes the arena or replays a graph
        self.done: Optional[torch.cuda.Event] = None

    def quantized(self) -> bool:
        """Whether a weight is computed from its codes (no merged weight
        swapped into its slot)."""
        return any(b["weight"] is None for b in self.quant)

    def weights(self) -> tuple:
        return tuple(t.data_ptr() for d in self.slots for t in d.values()
                     if t is not None)

    # ------------------------------------------------------------ a step

    def run(self, model, cfg: DiTConfig, xt, timestep, timestep_r,
            context_latents, cross_kv) -> torch.Tensor:
        cuda = xt.device.type == "cuda"
        if cuda and self.done is not None:
            torch.cuda.current_stream(xt.device).wait_event(self.done)
        out = self._step(model, cfg, xt, timestep, timestep_r,
                         context_latents, cross_kv)
        if cuda:
            if self.done is None:
                self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(xt.device))
        return out

    def _step(self, model, cfg: DiTConfig, xt, timestep, timestep_r,
              context_latents, cross_kv) -> torch.Tensor:
        inputs = (xt, timestep, timestep_r, context_latents)
        key = _Key(cfg, tuple((tuple(x.shape), x.dtype) for x in inputs),
                   cross_kv[1].dtype, self.weights())
        hit = self.steps.get(key)
        if hit is not None and hit[1] is not None:
            self.steps.move_to_end(key)
            trace.count("dit_graph_replays")
            step = hit[1]
            b = step.bufs
            for name, x in zip(("xt", "t", "t_r", "ctx"), inputs):
                b[name].copy_(x)
            return _walk(step.graphs, b, lambda g: g.replay(),
                         lambda name, x: b[name].copy_(x), step.windows,
                         cross_kv).clone()
        with trace.span("dit.capture", rows=xt.shape[0],
                        frames=xt.shape[1]):
            # the eager step: this call's result, and each buffer's layout
            b = dict(zip(("xt", "t", "t_r", "ctx"), inputs))
            rope = decoder_rope(cfg, -(-xt.shape[1] // cfg.patch_size),
                                xt.dtype, xt.device)
            windows = [layer_window(cfg, i)
                       for i in range(len(model.decoder.layers))]
            out = _walk(_segments(model.decoder, cfg, rope, xt.shape[1]), b,
                        lambda seg: b.update(seg(b)), b.__setitem__, windows,
                        cross_kv)
            specs = {name: _spec(t) for name, t in b.items()}
            # the cross core takes its query to float32 first (`_sdpa`):
            # segment B's copy into a float32 buffer makes that cast
            specs["cq"] = specs["cq"]._replace(dtype=torch.float32)
            self._add(model, key, specs, xt.device)
        return out

    # ------------------------------------------------------- capturing

    def _add(self, model, key: _Key, specs: Dict[str, _Spec],
             device: torch.device) -> None:
        need = _layout(specs)[1]
        self.steps[key] = (specs, None)
        if self.arena is None or self.arena.numel() < need:
            grown = need if self.arena is None \
                else max(need, 2 * self.arena.numel())
            # every graph reads the old arena: drop them, then capture the
            # keys of these weights again over the new one, in a new pool
            # (a pool whose graphs are all gone takes no new capture)
            self._sync(device)
            self.steps = collections.OrderedDict(
                (k, (s, None)) for k, (s, _g) in self.steps.items()
                if k.weights == key.weights and k.cfg == key.cfg)
            self.arena = self.pool = None
            self.arena = torch.empty(grown, dtype=torch.uint8, device=device)
        for k, (s, step) in list(self.steps.items()):
            if step is None:
                self.steps[k] = (s, self._capture_step(model, k.cfg, s))
                trace.count("dit_graph_captures")
        if len(self.steps) > MAX_KEYS:
            self._sync(device)
            while len(self.steps) > MAX_KEYS:
                self.steps.popitem(last=False)

    def _capture_step(self, model, cfg: DiTConfig,
                      specs: Dict[str, _Spec]) -> _Step:
        offsets, _ = _layout(specs)
        bufs = {name: self.arena[offsets[name]:offsets[name] + _nbytes(s)]
                .view(s.dtype).as_strided(s.shape, s.stride)
                for name, s in specs.items()}
        h = specs["h"]
        rope = decoder_rope(cfg, h.shape[1], h.dtype, self.arena.device)
        segs = _segments(model.decoder, cfg, rope, specs["xt"].shape[1])
        graphs = [self._capture(functools.partial(_write, seg, bufs))
                  for seg in segs]
        return _Step(bufs, graphs, rope,
                     [layer_window(cfg, i) for i in range(len(segs) // 2)])

    def _capture(self, body):
        """`body()` as a CUDA graph in the shared pool, after one warm run
        on the capturing stream."""
        dev = self.arena.device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            body()
            graph = torch.cuda.CUDAGraph()
            # thread-local: in the REST server other threads (HTTP
            # handlers, a planner) may call CUDA while the worker captures
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        current.wait_stream(self.stream)
        return graph

    @staticmethod
    def _sync(device: torch.device) -> None:
        """Wait for every replay in flight before its graphs or arena go."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)


_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_graphs_lock = threading.Lock()


def graphs_of(model) -> DecoderGraphs:
    """The captured steps of `model`'s decoder, made on first use; they go
    with the model."""
    p = model.decoder
    with _graphs_lock:
        g = _graphs.get(p)
        if g is None:
            g = _graphs[p] = DecoderGraphs(p)
        return g


def engages(model, cfg: DiTConfig, device: torch.device) -> bool:
    """Whether a step of `model` on `device` runs as graphs: on a CUDA
    device, with no gradient to track (training and `remat` stay eager),
    through the flash kernel, with no tensor-parallel group (collectives
    stay eager) and no weight computed from its quantized codes."""
    if device.type != "cuda" or torch.is_grad_enabled() \
            or resolve_attention_impl(cfg) != "flash":
        return False
    lp = model.decoder.layers[0]
    if "tp_group" in lp.self_attn.o_proj.__dict__ \
            or "tp_group" in lp.mlp.down.__dict__:
        return False
    return not graphs_of(model).quantized()


def replay_step(model, cfg: DiTConfig, xt: torch.Tensor,
                timestep: torch.Tensor, timestep_r: torch.Tensor,
                context_latents: torch.Tensor, cross_kv
                ) -> Optional[torch.Tensor]:
    """`dit_decoder`'s step with `cross_kv` as graph replays, or None where
    `engages` does not hold or another thread holds the graphs."""
    if not engages(model, cfg, xt.device):
        return None
    graphs = graphs_of(model)
    if not graphs.lock.acquire(blocking=False):
        return None
    try:
        return graphs.run(model, cfg, xt, timestep, timestep_r,
                          context_latents, cross_kv)
    finally:
        graphs.lock.release()
