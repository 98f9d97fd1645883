"""The multi-process runtime of the port; port of
`tokenizers_tpu.parallel.runtime` on `torch.distributed`.

Each rank is one process driving one card.  This module owns

  * process bootstrap: `initialize()` wraps `init_process_group`, from
    explicit arguments or from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`).  It is idempotent and
    returns False in a single process with neither (the normal library
    case, never an error).  The backend is NCCL on the card and gloo on
    the CPU; an explicit `backend` wins, and NCCL is never switched to
    gloo behind the caller's back: two ranks on one card raise;
  * mesh construction: `build_mesh(("data",))` is a 1-D
    `DeviceMesh` over every rank, `build_mesh(("hosts", "data"))` a 2-D
    one whose outer axis has one slot per node (`LOCAL_WORLD_SIZE` ranks
    a node), degenerate within one node, as JAX's `build_mesh`;
  * a process-global default mesh: `set_default_mesh()` /
    `get_default_mesh()`, also set by ``TOKENIZERS_TPU_MESH=data`` or
    ``TOKENIZERS_TPU_MESH=hosts,data`` as in the JAX package.  The
    engines shard `encode_batch_fast` and `encode_batch_arrays` over a
    default mesh of more than one rank with no change at the call site;
  * the collectives every sharded module uses, over the process group
    of a mesh (`mesh_group`): an integer sum (`all_sum`, exact in any
    order), a gather of equal shapes in rank order (`gather_equal`), a
    gather of differing shapes concatenated in rank order (`gather_cat`)
    and a rank-order fold of f64 vectors (`fold_f64`: gathered, then
    summed rank 0 first, so every rank holds the same bits run after
    run).  They use only `all_reduce` and `all_gather`, which gloo also
    takes on CUDA tensors;
  * `spawn(fn, n)`: n ranks in processes started by the spawn method
    (a process with CUDA or torch threads up must not fork), meeting at a
    file store in a temporary directory, each joined with a timeout, so a
    hung rank fails its caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV_MESH = "TOKENIZERS_TPU_MESH"
TIMEOUT_S = 60.0  # a collective that waits longer than this raises

_lock = threading.Lock()
_default_mesh = None
_env_mesh_tried = False
_device_type = "cpu"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Join (or start) the process group; idempotent.

    With no arguments it reads torchrun's environment; without that it
    returns False (a single process, nothing to join).  `device` is the
    card unless the caller asks for "cpu" (`pick_device`); on the card
    the rank takes card `local_rank`.  `backend` defaults to "nccl" on
    the card and "gloo" on the CPU.  NCCL takes one card a rank: a local
    rank past the last card raises (pass backend="gloo" to share one)."""
    global _device_type
    with _lock:
        if dist.is_initialized():
            return True
        if init_method is None and world_size is None and _env_int("WORLD_SIZE") is None:
            return False
        from .. import pick_device

        world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
        rank = _env_int("RANK") if rank is None else rank
        if world_size is None or rank is None:
            raise ValueError("initialize: world_size and rank are needed (or RANK and "
                             "WORLD_SIZE in the environment)")
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK")
            local_rank = rank if local_rank is None else local_rank
        dev = pick_device(device)
        backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            if backend == "nccl" and local_rank >= cards:
                raise RuntimeError(
                    f"NCCL needs a card of its own for each rank: local rank {local_rank} "
                    f"with {cards} card(s) on this node; pass backend='gloo' to run several "
                    f"ranks on one card")
            torch.cuda.set_device(local_rank % cards)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _device_type = dev.type
        return True


def shutdown() -> None:
    """Leave the process group and forget the default mesh."""
    global _default_mesh, _env_mesh_tried
    with _lock:
        _default_mesh = None
        _env_mesh_tried = False
        if dist.is_initialized():
            dist.destroy_process_group()


def is_multi_process() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def build_mesh(axes: Sequence[str] = ("data",)):
    """A `DeviceMesh` over every rank of the process group.

    `("data",)`: 1-D, the encode and training default.  `("hosts",
    "data")`: 2-D, one outer slot per node (`LOCAL_WORLD_SIZE` ranks a
    node), the inner axis the ranks of a node; one node gives an outer
    axis of 1.  Rows shard over both axes."""
    axes = tuple(axes)
    if (len(axes) not in (1, 2) or len(set(axes)) != len(axes)
            or not all(isinstance(a, str) and a for a in axes)):
        raise ValueError(f"unsupported mesh axes {axes!r}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call initialize() first")
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if len(axes) == 1:
        shape: Tuple[int, ...] = (world,)
    else:
        local = _env_int("LOCAL_WORLD_SIZE") or world
        nodes = world // local if world % local == 0 else 1
        shape = (nodes, world // nodes)
    return DeviceMesh(_device_type, torch.arange(world).reshape(shape), mesh_dim_names=axes)


def set_default_mesh(mesh) -> None:
    """Install a process-global default mesh (None clears it); the engines
    shard batch encodes over it when it has more than one rank."""
    global _default_mesh, _env_mesh_tried
    _default_mesh = mesh
    _env_mesh_tried = True  # an explicit call beats the variable


def get_default_mesh():
    """The default mesh: the one set, else one built from
    $TOKENIZERS_TPU_MESH on first use (joining torchrun's group when the
    variable is set and no group is up yet), else None."""
    global _default_mesh, _env_mesh_tried
    if _default_mesh is None and not _env_mesh_tried:
        _env_mesh_tried = True
        spec = os.environ.get(ENV_MESH)
        if spec and (dist.is_initialized() or initialize()):
            axes = tuple(a.strip() for a in spec.split(",") if a.strip())
            _default_mesh = build_mesh(axes or ("data",))
    return _default_mesh


def sharded_mesh():
    """The default mesh when it has more than one rank, else None."""
    mesh = get_default_mesh()
    return mesh if mesh is not None and mesh.size() > 1 else None


# --------------------------------------------------------------------------
# collectives over a mesh's ranks
# --------------------------------------------------------------------------


def mesh_group(mesh) -> Tuple[object, int, int]:
    """(process group, this rank's index in it, its size) of `mesh`: the
    rows of a sharded batch split over the mesh's ranks in this order.  A
    2-D mesh must span every rank (its group is then the world's)."""
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    elif mesh.size() == dist.get_world_size():
        group = dist.group.WORLD
    else:
        raise ValueError("a 2-D mesh must span every rank of the process group")
    return group, dist.get_rank(group), mesh.size()


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Integer (or exact) sum over the group, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_equal(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (all of one shape), in rank order."""
    t = t.contiguous()
    src = t.view(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.view(torch.bool) for p in parts] if t.dtype == torch.bool else parts


def gather_cat(t: torch.Tensor, group, fill=0) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order; the
    shapes may differ (each is padded with `fill` to the gathered maximum
    for the exchange, and the other dims of the result are the maximum,
    padded with `fill`)."""
    shape = torch.tensor(list(t.shape), dtype=torch.int64, device=t.device)
    shapes = torch.stack(gather_equal(shape, group)).tolist()
    top = [max(s[d] for s in shapes) for d in range(t.dim())]
    padded = torch.full(top, fill, dtype=t.dtype, device=t.device)
    padded[tuple(slice(0, n) for n in t.shape)] = t
    parts = gather_equal(padded, group)
    return torch.cat([p[:s[0]] for p, s in zip(parts, shapes)])


def fold_f64(v: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `v`, folded in rank order (rank 0 first):
    the same bits on every rank, run after run."""
    parts = gather_equal(v, group)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


# --------------------------------------------------------------------------
# ranks in processes
# --------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, init_method: str, backend, device, args,
               out_path: str) -> None:
    ok, res = False, None
    if device is not None and torch.device(device).type == "cpu":
        # ranks sharing the host run one thread each: on a loaded host a
        # rank's threads spin in every small op's parallel region, and the
        # dense BPE loop ran 30x slower with 4 threads a rank than with 1
        torch.set_num_threads(1)
    try:
        initialize(init_method, world, rank, local_rank=rank, backend=backend, device=device)
        res = fn(rank, world, *args)
        ok = True
    except BaseException:  # reported to the parent, then this rank fails
        res = traceback.format_exc()
    finally:
        shutdown()
    with open(out_path, "wb") as f:
        pickle.dump((ok, res), f)
    if not ok:
        raise SystemExit(1)


def spawn(fn: Callable, nprocs: int, args: tuple = (), backend: Optional[str] = None,
          device=None, timeout_s: float = 300.0) -> list:
    """Run `fn(rank, world, *args)` in `nprocs` spawned ranks of one
    process group and return their results in rank order.  `fn` must be
    importable by name (a module-level function), its results picklable.
    Ranks that fail raise here with their tracebacks; ranks still running
    after `timeout_s` are killed and TimeoutError is raised."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tt_ranks_") as d:
        init = "file://" + os.path.join(d, "store")
        outs = [os.path.join(d, f"rank{r}.pkl") for r in range(nprocs)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, init, backend, device, args, outs[r]))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if hung:
            raise TimeoutError(f"ranks {hung} of {nprocs} did not finish within {timeout_s} s")
        results, failed = [], []
        for r, (p, path) in enumerate(zip(procs, outs)):
            if not os.path.exists(path):
                failed.append(f"rank {r} of {nprocs} died (exit code {p.exitcode})")
                continue
            with open(path, "rb") as f:
                ok, res = pickle.load(f)
            if ok:
                results.append(res)
            else:
                failed.append(f"rank {r} of {nprocs} failed:\n{res}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return results
