"""Device mesh over `torch.distributed`: data (dp) and tensor (tp)
parallelism, and the rules that shard the DiT and the planner LM.

Port of `acestep_tpu/parallel/mesh.py`. A JAX mesh is one process that
drives every device through GSPMD; a torch mesh is one process per device,
driven the way nano-vllm (the upstream reference's tensor parallelism)
drives its ranks:

- rank 0 is the caller's process (the server, the CLI, a facade user) on
  `devices[0]`; it keeps its whole handler, so whatever runs outside the
  mesh runs there as it does without one;
- `make_mesh` spawns the other ranks with the `spawn` start method. They
  meet rank 0 in a `torch.distributed.FileStore` in a temporary directory
  (no TCP port), and every wait is bounded by `timeout` (process-group
  init and every collective inside a command). Followers are daemons:
  they loop on the commands rank 0 broadcasts on a gloo command group (a
  module-level function and its arguments, run on every rank of the
  mesh), and exit on a stop command or when rank 0's process is gone. The
  wait for the next command is the one wait without the bound (an idle
  server sends none for hours); a thread of each follower that watches
  rank 0's process ends it;
- every command, its collectives included, runs whole under one lock held
  by the world, so two threads of rank 0 (the server's render worker and a
  planner user) never interleave their collectives;
- each command's reply carries every rank's status and kernel launch
  counts; a rank that raised makes rank 0 raise `MeshError` with its
  traceback (`MeshOutOfMemoryError`, also a `torch.cuda.OutOfMemoryError`,
  when every failed rank ran out of device memory), and the world is then
  down (its collectives may have been left unmatched): its meshes raise
  from then on, and the next `make_mesh` starts a new world on the same
  devices (the handlers make their meshes again on their next call);
- one world per process: the first `make_mesh` fixes its size, devices
  and backend; a later one takes the first n ranks of it, or raises when
  it needs more ranks or names other devices or another backend. (In JAX
  the DiT mesh and the LM mesh are independent device sets.)

Defaults: devices `cuda:0..n-1` and the `nccl` backend; CPU devices take
`gloo`. A device list that repeats a card (several ranks on one GPU) needs
`backend="gloo"`: NCCL refuses two ranks on one device, and the backend is
never switched silently.

Sharding rules (the counterparts of `_linear_spec`, `dit_param_pspecs`,
`lm_param_pspecs` and `sanitize_pspecs`), keyed on module names:
column-parallel `q_proj` / `k_proj` / `v_proj` / `gate` / `up` split their
output features (torch dim 0 of an (out, in) weight), row-parallel
`o_proj` / `down` split their input features (dim 1) and all-reduce their
product over the tp group (`ops/basic.linear`). A torch rank cannot split a
head, so heads are the unit: q splits by query heads, k and v by KV heads,
and when there are fewer KV heads than ranks each rank holds the KV head
its query heads read (vLLM's rule). Each rank builds its modules from a
local config (heads / tp, KV heads / tp or 1, intermediate / tp), so the
forwards' reshapes do not change. A family whose dims do not divide runs
replicated. Quantized weights (`ops/quant.QuantWeight`) split their codes
and scales like the float weight; a row-parallel per-channel scale stays
whole, and an int4 weight splits its packed codes and group scales on a
group boundary (`in / tp` a multiple of `INT4_GROUP`, else the family runs
replicated). The LM's `embed_tokens` and w8a8 `head_q` split along the
vocabulary when it divides.
"""

from __future__ import annotations

import atexit
import copy
import dataclasses
import datetime
import itertools
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

_COL_KEYS = ("q_proj", "k_proj", "v_proj", "gate", "up")
# seconds a world waits at most: process-group init and each collective
# inside a command
TIMEOUT_S = 60.0
# a follower's wait for its next command (the parent watch ends it sooner
# when rank 0 is gone)
IDLE_S = 365 * 24 * 3600.0
# module name -> the range of features it splits
_RANGE = {"q_proj": "q", "o_proj": "q", "k_proj": "kv", "v_proj": "kv",
          "gate": "ff", "up": "ff", "down": "ff"}


def parse_mesh_spec(spec) -> Optional[tuple]:
    """Operator mesh spec -> (dp, tp) or None.

    Accepts 'DPxTP' ('4x2'), a bare integer ('8' = pure data parallel),
    or ''/None/'1'/'1x1' (no mesh): `--mesh` on the server and the CLI,
    and the ACESTEP_MESH environment variable."""
    if spec is None:
        return None
    s = str(spec).strip().lower().replace("*", "x")
    if not s:
        return None
    try:
        if "x" in s:
            dp_s, tp_s = s.split("x", 1)
            dp, tp = int(dp_s), int(tp_s)
        else:
            dp, tp = int(s), 1
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: expected 'DPxTP' (e.g. '4x2') or a "
            "device count (e.g. '8')") from None
    if dp < 1 or tp < 1:
        raise ValueError(f"bad mesh spec {spec!r}: dp/tp must be >= 1")
    if dp * tp == 1:
        return None
    return dp, tp


# ==================================================================
# Sharding rules
# ==================================================================


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one model splits over `tp` ranks. `heads` / `mlp` say whether
    the attention and MLP families split (False: replicated); `vocab` is
    the LM's vocabulary when its embedding table and w8a8 head split
    along it, else 0."""
    tp: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate: int
    heads: bool
    mlp: bool
    vocab: int = 0

    @property
    def local_heads(self) -> Tuple[int, int]:
        if not self.heads:
            return self.num_heads, self.num_kv_heads
        return (self.num_heads // self.tp,
                max(1, self.num_kv_heads // self.tp))

    def local_config(self, cfg):
        """`cfg` with the head counts and intermediate size of one rank."""
        hq, hkv = self.local_heads
        return dataclasses.replace(
            cfg, num_attention_heads=hq, num_key_value_heads=hkv,
            intermediate_size=(self.intermediate // self.tp if self.mlp
                               else self.intermediate))

    def ranges(self, tp_rank: int) -> Dict[str, Tuple[int, int]]:
        """Feature ranges of rank `tp_rank`: q (query heads' features, also
        o_proj's input), kv, ff (the intermediate) and vocab rows."""
        D, r, out = self.head_dim, tp_rank, {}
        if self.heads:
            hq, hkv = self.local_heads
            kv0 = r * hq // (self.num_heads // self.num_kv_heads)
            out["q"] = (r * hq * D, (r + 1) * hq * D)
            out["kv"] = (kv0 * D, (kv0 + hkv) * D)
        if self.mlp:
            n = self.intermediate // self.tp
            out["ff"] = (r * n, (r + 1) * n)
        if self.vocab:
            n = self.vocab // self.tp
            out["vocab"] = (r * n, (r + 1) * n)
        return out


def _heads_divide(hq: int, hkv: int, tp: int) -> bool:
    return hq % tp == 0 and hq % hkv == 0 and (hkv % tp == 0
                                              or tp % hkv == 0)


def _int4_rows_split(model: nn.Module, key: str, n_in: int, tp: int) -> bool:
    """False when an int4 weight of row-parallel `key` modules cannot split
    its in-features on a group boundary."""
    from acestep_torch.ops.quant import INT4_GROUP, QuantWeight

    for name, m in model.named_modules():
        if (name.rpartition(".")[2] == key and isinstance(m, QuantWeight)
                and m.codes.dtype == torch.uint8
                and (n_in // tp) % INT4_GROUP):
            return False
    return True


def make_plan(model: nn.Module, cfg, tp: int, *, vocab: int = 0
              ) -> ShardPlan:
    """The plan of a DiT (`vocab` 0) or an LM (`vocab` its vocabulary)
    with config `cfg` over tp ranks; a family whose dims do not divide is
    replicated (`sanitize_pspecs`)."""
    hq, hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    inter = cfg.intermediate_size
    heads = tp > 1 and _heads_divide(hq, hkv, tp) and _int4_rows_split(
        model, "o_proj", hq * D, tp)
    mlp = tp > 1 and inter % tp == 0 and _int4_rows_split(
        model, "down", inter, tp)
    return ShardPlan(tp=tp, num_heads=hq, num_kv_heads=hkv, head_dim=D,
                     intermediate=inter, heads=heads, mlp=mlp,
                     vocab=vocab if tp > 1 and vocab % tp == 0 else 0)


def _split(plan: ShardPlan, rng: Dict[str, Tuple[int, int]], name: str,
           int4: bool) -> Optional[Tuple[int, int, int]]:
    """(dim, start, end) of tensor `name` that one rank holds, or None when
    it holds the whole tensor."""
    from acestep_torch.ops.quant import INT4_GROUP

    parts = name.split(".")
    leaf = parts[-1]
    if plan.vocab and (name == "embed_tokens" or parts[0] == "head_q"):
        return (0, *rng["vocab"])
    if len(parts) < 2 or rng.get(_RANGE.get(parts[-2], "")) is None:
        return None
    lo, hi = rng[_RANGE[parts[-2]]]
    if parts[-2] in _COL_KEYS:
        return 0, lo, hi
    if leaf == "weight":
        return 1, lo, hi
    if leaf == "codes":
        return (1, lo // 2, hi // 2) if int4 else (1, lo, hi)
    if leaf == "scale" and int4:
        return 1, lo // INT4_GROUP, hi // INT4_GROUP
    return None       # a per-channel scale and a bias stay whole


def _named_tensors(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """Every parameter and buffer, in one fixed order on every rank."""
    return list(model.named_parameters()) + list(model.named_buffers())


def _int4_names(model: nn.Module) -> set:
    from acestep_torch.ops.quant import QuantWeight

    return {f"{n}.{leaf}" for n, m in model.named_modules()
            if isinstance(m, QuantWeight) and m.codes.dtype == torch.uint8
            for leaf in ("codes", "scale")}


def shard_dims(model: nn.Module, plan: ShardPlan) -> Dict[str, Optional[int]]:
    """{tensor name: the dim split over tp, or None when replicated}: the
    torch counterpart of a PartitionSpec tree after `sanitize_pspecs`."""
    rng, int4 = plan.ranges(0), _int4_names(model)
    out = {}
    for name, t in _named_tensors(model):
        s = _split(plan, rng, name, name in int4)
        out[name] = None if s is None else s[0]
    return out


def dit_param_pspecs(model: nn.Module, cfg, tp: int):
    """The shard dim of every DiT tensor over tp ranks (`shard_dims`)."""
    return shard_dims(model, make_plan(model, cfg, tp))


def lm_param_pspecs(model: nn.Module, cfg, tp: int):
    """The shard dim of every LM tensor over tp ranks: the DiT's rules plus
    `embed_tokens` and `head_q` along the vocabulary."""
    return shard_dims(model, make_plan(model, cfg, tp, vocab=cfg.vocab_size))


def shard_tensors(model: nn.Module, plan: ShardPlan, tp_rank: int
                  ) -> Dict[str, torch.Tensor]:
    """{name: the part of the tensor rank `tp_rank` holds}, a contiguous
    copy where it is a slice, the tensor itself where it is whole."""
    rng, int4 = plan.ranges(tp_rank), _int4_names(model)
    out = {}
    for name, t in _named_tensors(model):
        s = _split(plan, rng, name, name in int4)
        out[name] = t if s is None else \
            t.narrow(s[0], s[1], s[2] - s[1]).contiguous()
    return out


def slice_weights(weights: Dict[str, torch.Tensor], plan: ShardPlan,
                  tp_rank: int) -> Dict[str, torch.Tensor]:
    """Float weights by parameter name (`LoraManager.effective_weights`)
    cut to what rank `tp_rank` holds."""
    rng = plan.ranges(tp_rank)
    out = {}
    for name, w in weights.items():
        s = _split(plan, rng, name, False)
        out[name] = w if s is None else \
            w.narrow(s[0], s[1], s[2] - s[1]).contiguous()
    return out


def _rebuild(model: nn.Module, tensors: Dict[str, torch.Tensor],
             trainable: bool = False) -> nn.Module:
    """A copy of `model`'s module tree holding `tensors` (by name) in
    place of its own; its parameters require gradients when `trainable`."""
    memo: Dict[int, Any] = {}
    for name, t in _named_tensors(model):
        new = tensors[name]
        memo[id(t)] = (nn.Parameter(new, requires_grad=trainable)
                       if isinstance(t, nn.Parameter) else new)
    return copy.deepcopy(model, memo)


def unshard_tensors(parts: Sequence[Dict[str, torch.Tensor]],
                    plan: ShardPlan, shapes: Dict[str, Tuple[int, ...]]
                    ) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_tensors` for float tensors: {name: the whole
    tensor of shape `shapes[name]`} from `parts[r]`, the tensors tp rank r
    holds (a replicated tensor is taken from rank 0; KV rows that several
    ranks hold are written once per rank, the same values)."""
    out = {}
    for name, first in parts[0].items():
        s = _split(plan, plan.ranges(0), name, False)
        if s is None:
            out[name] = first
            continue
        full = first.new_empty(shapes[name])
        for r, part in enumerate(parts):
            dim, lo, hi = _split(plan, plan.ranges(r), name, False)
            full.narrow(dim, lo, hi - lo).copy_(part[name])
        out[name] = full
    return out


# how a gradient is summed over tp (`grad_rules`)
SPLIT, WHOLE, HEADS, KV_ROWS = "split", "whole", "heads", "kv_rows"


def grad_rules(model: nn.Module, plan: ShardPlan) -> Dict[str, str]:
    """{parameter name: how its gradient is summed over the tp group},
    beside `shard_dims`. A tensor split over tp (SPLIT) holds its whole
    gradient on every rank, as does a replicated tensor outside the tp
    regions (WHOLE): the row-parallel exit's gradient is the identity and
    the column-parallel entry sums its input's gradient
    (`ops/basic.enter_region`). A replicated tensor applied to the rank's
    own heads only (the per-head `q_norm` / `k_norm` scales, HEADS) has a
    partial gradient, summed over tp. With fewer KV heads than ranks the
    `k_proj` / `v_proj` rows of one KV head sit on several ranks, each
    with the gradient of its own query heads (KV_ROWS), summed over the
    ranks that hold that head. Every gradient is also summed over dp."""
    shared_kv = plan.heads and plan.num_kv_heads < plan.tp
    rules = {}
    for name, dim in shard_dims(model, plan).items():
        parts = name.split(".")
        owner = parts[-2] if len(parts) > 1 else ""
        if plan.heads and owner in ("q_norm", "k_norm"):
            rules[name] = HEADS
        elif shared_kv and owner in ("k_proj", "v_proj"):
            rules[name] = KV_ROWS
        else:
            rules[name] = WHOLE if dim is None else SPLIT
    return {n: rules[n] for n, _ in model.named_parameters()}


# elements of one dp all-reduce bucket (gloo pays a host round trip a
# call; a bucket is copied through host memory whole)
BUCKET_ELEMS = 1 << 26


class GradSync:
    """One rank's gradient reduction over its mesh: the tp sums of
    `grad_rules` in one flat all-reduce, then every gradient summed over
    dp in buckets of at most BUCKET_ELEMS; and the global norm of
    gradients split over tp. `rules` (`grad_rules` of the unsharded model,
    made once on rank 0) are in the order of the rank's parameters, the
    order the gradients come."""

    def __init__(self, ctx, rules: Dict[str, str], plan: ShardPlan):
        self.ctx = ctx
        self.rules = list(rules.values())
        self.kv = plan.ranges(ctx.tp_rank).get("kv")
        self.kv_rows = plan.num_kv_heads * plan.head_dim
        # a KV head's rows sit on tp / num_kv_heads ranks
        self.copies = (max(1, plan.tp // plan.num_kv_heads)
                       if plan.heads else 1)

    def reduce_(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum `grads` (in the rules' order, every one present) in
        place."""
        import torch.distributed as dist

        ctx = self.ctx
        if ctx.tp > 1:
            items = [(g, rule) for g, rule in zip(grads, self.rules)
                     if rule in (HEADS, KV_ROWS)]
            if items:
                offs, size = [], 0
                lo = self.kv[0] if self.kv else 0
                for g, rule in items:
                    if rule == KV_ROWS:
                        width = g[0].numel()
                        offs.append(size + lo * width)
                        size += self.kv_rows * width
                    else:
                        offs.append(size)
                        size += g.numel()
                flat = items[0][0].new_zeros(size)
                for (g, _), off in zip(items, offs):
                    flat[off:off + g.numel()] = g.reshape(-1)
                dist.all_reduce(flat, group=ctx.tp_group)
                for (g, _), off in zip(items, offs):
                    g.copy_(flat[off:off + g.numel()].view_as(g))
        if ctx.dp > 1:
            bucket: List[torch.Tensor] = []
            size = 0
            for g in list(grads) + [None]:
                if bucket and (g is None or g.dtype != bucket[0].dtype
                               or size + g.numel() > BUCKET_ELEMS):
                    flat = torch.cat([b.reshape(-1) for b in bucket])
                    dist.all_reduce(flat, group=ctx.dp_group)
                    off = 0
                    for b in bucket:
                        b.copy_(flat[off:off + b.numel()].view_as(b))
                        off += b.numel()
                    bucket, size = [], 0
                if g is not None:
                    bucket.append(g)
                    size += g.numel()

    def global_norm(self, norms: torch.Tensor) -> torch.Tensor:
        """The global norm from each gradient's fp32 norm on this rank:
        split tensors' squares summed over tp (a KV head's rows counted
        once across the ranks that hold it), the others counted once."""
        import torch.distributed as dist

        if self.ctx.tp == 1:
            return torch.linalg.vector_norm(norms)
        w_split = torch.tensor(
            [1.0 if r == SPLIT else 1.0 / self.copies if r == KV_ROWS
             else 0.0 for r in self.rules], device=norms.device)
        sq = norms.square()
        split = (sq * w_split).sum()
        dist.all_reduce(split, group=self.ctx.tp_group)
        return (split + (sq * (w_split == 0)).sum()).sqrt()


def attach_groups(model: nn.Module, plan: ShardPlan, tp_rank: int,
                  group) -> None:
    """Mark a shard's row-parallel modules with the tp group their
    products all-reduce over (`ops/basic.linear`), and an LM's vocabulary
    split (`models/lm`)."""
    for name, m in model.named_modules():
        key = name.rpartition(".")[2]
        if key == "o_proj" and plan.heads or key == "down" and plan.mlp:
            m.tp_group = group
    if plan.vocab:
        model.tp_vocab = (*plan.ranges(tp_rank)["vocab"], group)


# ==================================================================
# Processes
# ==================================================================


class MeshError(RuntimeError):
    """A rank failed a mesh command, or the mesh is down."""


class MeshOutOfMemoryError(MeshError, torch.cuda.OutOfMemoryError):
    """Every rank that failed a mesh command ran out of device memory, so
    an out-of-memory ladder takes it as its own."""


def _launch_counts() -> List[int]:
    """This process's kernel launch counters: K1, K2, K3, K4."""
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc

    return [fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv,
            sc.launches]


KERNELS = ("K1", "K2", "K3", "K4")


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def _init(rank: int, size: int, store_path: str, backend: str,
          timeout: float, device: torch.device):
    """Join the world; returns the gloo command group (the command
    broadcast only, IDLE_S), the gloo control group (the replies, bounded
    by `timeout`) and this rank's per-process state. A first all-reduce on
    the default group brings the backend up on every rank."""
    import torch.distributed as dist

    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=_timeout(timeout))
    commands = dist.new_group(backend="gloo", timeout=_timeout(IDLE_S))
    control = dist.new_group(backend="gloo", timeout=_timeout(timeout))
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != size:
        raise MeshError(f"rank {rank}: the first all-reduce gave "
                        f"{probe.item()}, not {size}")
    local = SimpleNamespace(rank=rank, size=size, device=device,
                            backend=backend, meshes={})
    return commands, control, local


def _follower_main(rank: int, size: int, store_path: str, device: str,
                   backend: str, timeout: float, parent: int) -> None:
    """A follower's life: join the world, run commands until told to stop;
    exit when rank 0's process is gone."""
    import torch.distributed as dist

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    code = 0
    try:
        commands, control, local = _init(rank, size, store_path, backend,
                                         timeout, dev)
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=commands)
            if box[0] is None:
                break
            _execute(local, control, box[0], None)
    except BaseException:
        # rank 0 gone or a wait timed out: say why, then leave
        traceback.print_exc()
        code = 1
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def _execute(local, control, command, root):
    """Run one command on this rank and exchange the replies (each rank's
    failure flag and kernel launches). Returns (this rank's result, the
    replies); on rank 0 raises MeshError with the tracebacks when any rank
    failed."""
    import torch.distributed as dist

    fn, mesh_id, args = command
    before = _launch_counts()
    out, err, text = None, None, None
    ctx = local.meshes.get(mesh_id) if mesh_id is not None else local
    if ctx is not None:
        try:
            out = fn(ctx, root, *args)
        except Exception as e:           # carried to rank 0 in the reply
            err, text = e, traceback.format_exc()
    # status: 0 done, 1 failed, 2 out of device memory
    flag = 0 if err is None else \
        2 if isinstance(err, torch.cuda.OutOfMemoryError) else 1
    status = torch.tensor([flag] + [
        a - b for a, b in zip(_launch_counts(), before)], dtype=torch.long)
    replies = [torch.zeros_like(status) for _ in range(local.size)]
    dist.all_gather(replies, status, group=control)
    failed = [r for r, s in enumerate(replies) if int(s[0])]
    if failed:
        texts = [None] * local.size if local.rank == 0 else None
        dist.gather_object(text, texts, dst=0, group=control)
        if local.rank == 0:
            oom = all(int(replies[r][0]) == 2 for r in failed)
            detail = "\n".join(f"rank {r}: {texts[r]}" for r in failed)
            raise (MeshOutOfMemoryError if oom else MeshError)(
                f"mesh command {fn.__name__} failed on ranks {failed}:\n"
                f"{detail}") from err
    return out, replies


class _World:
    """The process's torch.distributed world: rank 0 here, the followers
    spawned. Owned by `make_mesh`; stopped when its last mesh closes or
    the process exits."""

    def __init__(self, devices: List[torch.device], backend: str,
                 timeout: float):
        self.size = len(devices)
        self.devices = devices
        self.backend = backend
        self.timeout = timeout
        self.lock = threading.Lock()
        self.down: Optional[str] = None
        self.users = 0
        self.mesh_ids = itertools.count()
        self.launches = [[0] * len(KERNELS) for _ in range(self.size)]
        # every follower waits for a command (False once a command broke
        # off on rank 0 without its replies)
        self.in_step = True
        self.stopped = False
        self._dir = tempfile.mkdtemp(prefix="acestep-mesh-")
        store_path = os.path.join(self._dir, "store")
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(
            target=_follower_main, daemon=True, name=f"acestep-rank-{r}",
            args=(r, self.size, store_path, str(devices[r]), backend,
                  timeout, os.getpid()))
            for r in range(1, self.size)]
        for p in self.procs:
            p.start()
        try:
            self.commands, self.control, self.local = _init(
                0, self.size, store_path, backend, timeout, devices[0])
        except BaseException:
            self._reap()
            raise

    def run(self, fn: Callable, mesh_id, args: tuple, root=None):
        """`fn(ctx, root, *args)` on every rank of mesh `mesh_id` (every
        rank when None); returns rank 0's result."""
        with self.lock:
            return self._run_locked(fn, mesh_id, args, root)

    def _run_locked(self, fn, mesh_id, args, root=None):
        import torch.distributed as dist

        if self.down:
            raise MeshError(f"the mesh is down: {self.down}")
        try:
            dist.broadcast_object_list([(fn, mesh_id, args)], src=0,
                                       group=self.commands)
            out, replies = _execute(self.local, self.control,
                                    (fn, mesh_id, args), root)
        except MeshError as e:
            # every rank replied, so the followers wait for a command again
            # (a stop command reaches them)
            self.down = str(e).partition("\n")[0]
            raise
        except BaseException as e:
            self.down = f"{type(e).__name__} in {fn.__name__}"
            self.in_step = False
            raise
        for r, s in enumerate(replies):
            for k in range(len(KERNELS)):
                self.launches[r][k] += int(s[1 + k])
        return out

    def _reap(self):
        deadline = time.monotonic() + 10
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(self._dir, ignore_errors=True)

    def stop(self):
        """Stop the followers (a stop command, then kill what is left) and
        leave the process group."""
        import torch.distributed as dist

        if self.stopped:
            return
        self.stopped = True
        # a command still running keeps the lock: its followers are killed
        got = self.lock.acquire(timeout=self.timeout)
        try:
            if got and self.in_step:
                dist.broadcast_object_list([None], src=0,
                                           group=self.commands)
        except Exception:                  # the followers are killed below
            pass
        finally:
            self.down = self.down or "stopped"
            if got:
                self.lock.release()
        self._reap()
        if dist.is_initialized():
            dist.destroy_process_group()


_WORLD: Optional[_World] = None
_WORLD_LOCK = threading.Lock()


def _stop_world() -> None:
    global _WORLD
    with _WORLD_LOCK:
        world, _WORLD = _WORLD, None
    if world is not None:
        world.stop()


atexit.register(_stop_world)


def _make_groups(local, root, mesh_id: int, dp: int, tp: int,
                 timeout: float):
    """Every rank of the world creates the mesh's tp and dp groups, in one
    order; each member keeps its own."""
    import torch.distributed as dist

    timeout = _timeout(timeout)
    rank = local.rank
    n = dp * tp
    tp_group = dp_group = None
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)],
                               timeout=timeout)
            if d == rank // tp:
                tp_group = g
    if dp > 1:
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)],
                               timeout=timeout)
            if rank < n and t == rank % tp:
                dp_group = g
    # every rank of the mesh: per-rank replies (`Mesh.gather`)
    group = dist.new_group(list(range(n)), backend="gloo", timeout=timeout)
    if rank < n:
        local.meshes[mesh_id] = SimpleNamespace(
            rank=rank, device=local.device, backend=local.backend, dp=dp,
            tp=tp, dp_rank=rank // tp, tp_rank=rank % tp, tp_group=tp_group,
            dp_group=dp_group, group=group, objects={})


def _drop_mesh(local, root, mesh_id: int):
    local.meshes.pop(mesh_id, None)


class Mesh:
    """A dp x tp mesh over the first dp * tp ranks of the process's world.
    Rank (d, t) is world rank d * tp + t (JAX's row-major device grid)."""

    def __init__(self, world: _World, dp: int, tp: int):
        self.world = world
        self.dp, self.tp = dp, tp
        self.size = dp * tp
        self.devices = world.devices[: self.size]
        self.backend = world.backend
        self.id = next(world.mesh_ids)
        world.run(_make_groups, None, (self.id, dp, tp, world.timeout))
        self.local = world.local.meshes[self.id]
        self.closed = False

    def call(self, fn: Callable, *args, root=None):
        """`fn(ctx, root, *args)` on every rank of the mesh, `ctx` being the
        rank's coordinates, groups and `objects` store; `root` reaches
        rank 0 only (followers get None). Returns rank 0's result."""
        if self.closed:
            raise MeshError("the mesh is closed")
        return self.world.run(fn, self.id, args, root=root)

    @property
    def down(self) -> bool:
        """True once a command failed or the world stopped: the mesh
        raises from then on, and its user makes a new one."""
        return self.world.down is not None

    def launches(self) -> Dict[str, List[int]]:
        """Kernel launches per rank inside this world's commands."""
        return {k: [counts[i] for counts in self.world.launches]
                for i, k in enumerate(KERNELS)}

    def gather(self, fn: Callable, *args) -> list:
        """[`fn(*args)` on each rank of the mesh], in rank order: a
        per-rank reading such as a rank's peak device memory."""
        return self.call(_gather_values, fn, args)

    def describe(self) -> List[str]:
        return [f"rank {r}: {d} (dp {r // self.tp}, tp {r % self.tp}, "
                f"{self.backend})" for r, d in enumerate(self.devices)]

    # ---- weights

    def install(self, key: str, model: nn.Module, plan: ShardPlan,
                trainable: bool = False) -> nn.Module:
        """Give every rank its shard of `model` (rank 0's own cut here, the
        others' sent from it) under `objects[key]`; returns rank 0's (the
        model itself when tp is 1). A `trainable` shard's parameters
        require gradients on every rank."""
        own = model if plan.tp == 1 else _rebuild(
            model, shard_tensors(model, plan, 0), trainable)
        skeleton = _rebuild(model, {
            n: torch.empty_like(t, device="meta")
            for n, t in _named_tensors(own)})
        return self.call(_install, key, skeleton, plan, trainable,
                         root=(model, own))

    def send_weights(self, key: str, weights: Dict[str, torch.Tensor],
                     plan: ShardPlan) -> None:
        """Every rank's cut of float `weights` (by parameter name) into
        `objects[key + '/weights']` ({} clears it)."""
        spec = [(n, tuple(w.shape), w.dtype)
                for n, w in slice_weights(weights, plan, 0).items()]
        self.call(_weights, key, spec, plan, root=weights)

    def close(self) -> None:
        """Drop this mesh on every rank; the last mesh of the world stops
        it."""
        global _WORLD
        if self.closed:
            return
        self.closed = True
        world = self.world
        if not world.down:
            try:
                world.run(_drop_mesh, None, (self.id,))
            except MeshError:
                pass                 # a down world is stopped below
        with _WORLD_LOCK:
            world.users -= 1
            last = world.users <= 0
            if last and _WORLD is world:
                _WORLD = None
        if last:
            world.stop()


def _wire(ctx) -> torch.device:
    """Where the backend moves bytes from: host memory under gloo, the
    rank's card under nccl."""
    return torch.device("cpu") if ctx.backend == "gloo" else ctx.device


def _send(ctx, t: torch.Tensor, dst: int) -> None:
    import torch.distributed as dist

    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    dist.send(b.to(_wire(ctx)), dst)


def _recv(ctx, t: torch.Tensor, src: int = 0) -> None:
    """Into contiguous `t`, wherever it lives."""
    import torch.distributed as dist

    b = t.reshape(-1).view(torch.uint8)
    wire = _wire(ctx)
    if b.device.type == wire.type:
        dist.recv(b, src)
    else:
        buf = torch.empty(b.shape, dtype=torch.uint8, device=wire)
        dist.recv(buf, src)
        b.copy_(buf)


def _gather_values(ctx, root, fn: Callable, args: tuple):
    import torch.distributed as dist

    out = [None] * (ctx.dp * ctx.tp) if ctx.rank == 0 else None
    dist.gather_object(fn(*args), out, dst=0, group=ctx.group)
    return out


def gather_state(ctx, tensors: Dict[str, torch.Tensor], plan: ShardPlan,
                 shapes: Dict[str, Tuple[int, ...]]
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """Inside a command on every rank: the tp ranks of dp block 0 send
    the split tensors among their named float `tensors` (the same names
    on every rank) to rank 0, which joins them into the unsharded layout
    (`shapes`), on the host: {name: whole tensor} on rank 0, None on the
    others. dp blocks hold equal copies, so the others send nothing."""
    if ctx.dp_rank != 0:
        return None
    split = [n for n in tensors
             if _split(plan, plan.ranges(0), n, False) is not None]
    if ctx.tp_rank != 0:
        for name in split:
            _send(ctx, tensors[name], 0)
        return None
    parts = [{n: t.detach().cpu() for n, t in tensors.items()}]
    for r in range(1, ctx.tp):
        part = {}
        for name in split:
            dim, lo, hi = _split(plan, plan.ranges(r), name, False)
            shape = list(shapes[name])
            shape[dim] = hi - lo
            part[name] = torch.empty(shape, dtype=tensors[name].dtype)
            _recv(ctx, part[name], r)
        parts.append(part)
    return unshard_tensors(parts, plan, shapes)


def scatter_state(ctx, whole: Optional[Dict[str, torch.Tensor]],
                  targets: Dict[str, torch.Tensor], plan: ShardPlan) -> None:
    """Inside a command on every rank, the inverse of `gather_state`:
    rank 0 holds the unsharded float tensors `whole`; each rank's
    `targets` (the same names on every rank, its own shapes) are filled
    with its cut of them."""
    with torch.no_grad():
        if ctx.rank == 0:
            for r in range(1, ctx.dp * ctx.tp):
                cut = slice_weights({n: whole[n] for n in targets}, plan,
                                    r % ctx.tp)
                for name in targets:
                    _send(ctx, cut[name], r)
            own = slice_weights({n: whole[n] for n in targets}, plan, 0)
            for name, t in targets.items():
                t.copy_(own[name])
        else:
            for t in targets.values():
                _recv(ctx, t)


def scatter_rows(ctx, blocks: Optional[Sequence[Dict[str, torch.Tensor]]],
                 specs: Sequence[Sequence[Tuple[str, tuple, torch.dtype]]]
                 ) -> Dict[str, torch.Tensor]:
    """Inside a command on every rank: rank 0 holds `blocks[d]`, the
    tensors of dp block d's rows, and sends each rank its block's (point
    to point: a rank receives only its own rows); `specs[d]` names the
    tensors of block d, their shapes and dtypes. Returns this rank's."""
    if ctx.rank == 0:
        for r in range(1, ctx.dp * ctx.tp):
            block = blocks[r // ctx.tp]
            for name, shape, _ in specs[r // ctx.tp]:
                if math.prod(shape):
                    _send(ctx, block[name], r)
        return dict(blocks[0])
    rows = {}
    for name, shape, dtype in specs[ctx.dp_rank]:
        rows[name] = torch.empty(shape, dtype=dtype, device=ctx.device)
        if math.prod(shape):
            _recv(ctx, rows[name])
    return rows


def _install(ctx, root, key: str, skeleton: nn.Module, plan: ShardPlan,
             trainable: bool = False):
    if ctx.rank == 0:
        model, shard = root
        for r in range(1, ctx.dp * ctx.tp):
            cut = (dict(_named_tensors(model)) if plan.tp == 1
                   else shard_tensors(model, plan, r % plan.tp))
            for name, _ in _named_tensors(skeleton):
                _send(ctx, cut[name], r)
    else:
        shard = skeleton.to_empty(device=ctx.device)
        for _, t in _named_tensors(shard):
            _recv(ctx, t)
        shard.requires_grad_(trainable)
    attach_groups(shard, plan, ctx.tp_rank, ctx.tp_group)
    ctx.objects[key] = shard
    return shard


def _weights(ctx, root, key: str, spec, plan: ShardPlan):
    if ctx.rank == 0:
        weights = slice_weights(root, plan, 0)
        for r in range(1, ctx.dp * ctx.tp):
            cut = slice_weights(root, plan, r % plan.tp)
            for name, _, _ in spec:
                _send(ctx, cut[name], r)
    else:
        weights = {}
        for name, shape, dtype in spec:
            weights[name] = torch.empty(shape, dtype=dtype,
                                        device=ctx.device)
            _recv(ctx, weights[name])
    ctx.objects[key + "/weights"] = weights


def gather_rows(ctx, x: torch.Tensor, rows: int) -> Optional[torch.Tensor]:
    """The dp ranks' row blocks of x (each `x.shape[0]` rows, in dp
    order) joined on rank 0's dp group: (rows, ...) on its members, None
    on the other tp ranks' groups. An all-reduce of zero-padded blocks,
    which every backend takes and which adds nothing to any value."""
    import torch.distributed as dist

    if ctx.dp == 1:
        return x
    if ctx.tp_rank != 0:
        return None
    n = x.shape[0]
    full = x.new_zeros((rows,) + tuple(x.shape[1:]))
    full[ctx.dp_rank * n:(ctx.dp_rank + 1) * n] = x
    dist.all_reduce(full, group=ctx.dp_group)
    return full


def _indexed(device) -> torch.device:
    """A device with its index ('cuda' is the current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _check_nccl(devices: List[torch.device]) -> None:
    if (any(d.type != "cuda" for d in devices)
            or len({str(d) for d in devices}) < len(devices)):
        raise ValueError(
            f"nccl needs one distinct CUDA device per rank, got "
            f"{[str(d) for d in devices]}; ranks that share a card run with "
            "backend='gloo'")


def default_devices() -> List[torch.device]:
    """cuda:0..n-1 of the visible cards."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_devices(device) -> List[torch.device]:
    """The devices a handler on `device` makes its mesh over: the
    process's world's when one exists (its rank 0 must be `device`), else
    `device` and then the other visible cards; a CPU device gives one CPU
    rank per core."""
    device = _indexed(device)
    world = _WORLD
    if world is not None:
        if world.devices[0] != device:
            raise ValueError(
                f"this process's world has rank 0 on {world.devices[0]}, "
                f"not on {device} (one world per process)")
        return list(world.devices)
    if device.type == "cpu":
        return [device] * (os.cpu_count() or 1)
    return [device] + [d for d in default_devices() if d != device]


def _check_world(world: _World, dp: int, tp: int, devices, backend) -> None:
    """Raise unless the world can hold a dp x tp mesh on `devices` (its
    first dp * tp) with `backend`, where they are given."""
    n = dp * tp
    if n > world.size:
        raise ValueError(
            f"mesh dp={dp} x tp={tp} needs {n} ranks, but this process's "
            f"world has {world.size} (one world per process: the first mesh "
            "fixes its size)")
    if backend is not None and backend != world.backend:
        raise ValueError(
            f"mesh backend {backend!r}, but this process's world runs "
            f"{world.backend!r} (one world per process)")
    if devices is not None:
        want = [_indexed(d) for d in devices][:n]
        if want != world.devices[:n]:
            raise ValueError(
                f"mesh devices {[str(d) for d in want]}, but this process's "
                f"world's first {n} ranks are on "
                f"{[str(d) for d in world.devices[:n]]} (one world per "
                "process)")


def make_mesh(dp: int = 1, tp: int = 1,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """A dp x tp mesh. The first call in a process starts the world over
    `devices[:dp * tp]` (default: every visible card) with `backend`
    (default: nccl for CUDA devices, gloo for CPU ones), TIMEOUT_S on
    every wait inside a command; later calls take its first dp * tp ranks,
    and raise when they name other devices or another backend. A world
    that is down is stopped here and started again on its devices and
    backend.
    The followers start with `spawn`, which imports the caller's main
    module again in each: a script that makes a mesh does so under an
    `if __name__ == "__main__":` guard."""
    global _WORLD
    n = dp * tp
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh dp={dp} x tp={tp}: both must be >= 1")
    if devices is not None and backend == "nccl":
        _check_nccl([_indexed(d) for d in devices][:n])
    with _WORLD_LOCK:
        world = _WORLD
        if world is not None:
            _check_world(world, dp, tp, devices, backend)
            if world.down:
                # its meshes raise from now on; a new world takes its place
                _WORLD = None
                world.stop()
                world = _WORLD = _World(world.devices, world.backend,
                                        TIMEOUT_S)
        else:
            devices = [_indexed(d) for d in (
                devices if devices is not None else default_devices())]
            if n > len(devices):
                raise ValueError(f"mesh dp={dp} x tp={tp} needs {n} "
                                 f"devices, have {len(devices)}")
            devices = devices[:n]
            if backend is None:
                backend = "nccl" if devices[0].type == "cuda" else "gloo"
            if backend == "nccl":
                _check_nccl(devices)
            world = _WORLD = _World(devices, backend, TIMEOUT_S)
        world.users += 1
    try:
        return Mesh(world, dp, tp)
    except BaseException:
        with _WORLD_LOCK:
            world.users -= 1
        raise
