"""Several processes, one program: bring-up and the moves between ranks.

Counterpart of ``ramba_tpu/parallel/distributed.py``.  The port is
multi-controller SPMD, as the reference is: every process (rank) runs the
same program, ``initialize`` forms the group over
``torch.distributed``, and the mesh's positions are ranks
(``parallel/mesh.py``), each holding its own block of every array.  The
collectives the reference leaves to GSPMD are explicit here, and live in
this module: all-gather, all-reduce, barrier and the batched send/recv of
a halo exchange.

The transport is chosen once, at ``initialize``, from the devices the
ranks compute on (:func:`choose_backend`):

* every rank on a card of its own: NCCL, tensors moved on the cards;
* every rank on the CPU: gloo;
* two or more ranks on one card: gloo, every tensor that crosses ranks
  staged through pinned host buffers (``comm_stats["host_staged_bytes"]``).
  NCCL refuses this topology, and ``initialize(backend="nccl")`` on it
  raises.

Every tensor crosses as raw bytes (a ``uint8`` view), so any dtype
(bfloat16, complex, bool) moves bit for bit.  The group's timeout is
``RAMBA_INIT_TIMEOUT_S`` (seconds), so a rank that never arrives makes
the others raise instead of waiting forever; the elastic deadlines of the
reference (``resilience/elastic.py``) come with ROADMAP A.8 part three.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ramba_tpu_torch import common

_group = None            # the torch.distributed default group, once formed
_backend: Optional[str] = None
_staged = False          # cross-rank tensors go through host memory
_reason = ""
_rank_devices: list = []  # per rank: (host, device string)


def _timeout_s() -> Optional[float]:
    """``RAMBA_INIT_TIMEOUT_S`` as seconds (None when unset, malformed or
    not positive: torch's default then applies)."""
    raw = os.environ.get("RAMBA_INIT_TIMEOUT_S")
    try:
        t = float(raw) if raw else 0.0
    except ValueError:
        t = 0.0
    return t if t > 0 else None


def choose_backend(devices: Sequence[tuple], requested: Optional[str] = None):
    """``(backend, staged, reason)`` for ranks whose devices are
    ``devices`` (per rank, ``(host, device string)``).  A pure function of
    its arguments: the same on every rank."""
    kinds = {torch.device(d).type for _h, d in devices}
    n = len(devices)
    if kinds == {"cpu"}:
        if requested not in (None, "gloo"):
            raise ValueError(f"backend {requested!r} for ranks on the CPU: "
                             "only gloo moves CPU tensors")
        return "gloo", False, f"{n} ranks on the CPU"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks on mixed device kinds {sorted(kinds)}: "
                         "every rank computes on a card, or every rank on "
                         "the CPU")
    per_card: dict = {}
    for h, d in devices:
        per_card[(h, str(torch.device(d)))] = \
            per_card.get((h, str(torch.device(d))), 0) + 1
    shared = max(per_card.values())
    if shared > 1:
        if requested == "nccl":
            raise ValueError(
                f"NCCL refuses two ranks on one card, and {shared} ranks "
                "share one here; use one process per card, or gloo")
        return "gloo", True, (f"{n} ranks on {len(per_card)} card(s), up to "
                              f"{shared} on one: NCCL refuses two ranks on "
                              "one card, so gloo through pinned host "
                              "buffers")
    if requested == "gloo":
        return "gloo", True, (f"{n} ranks, one per card, gloo asked for: "
                              "tensors staged through pinned host buffers")
    return "nccl", False, f"{n} ranks, one per card: NCCL"


def _make_store(address: str, world: int, rank: int, timeout):
    """The rendezvous store: ``tcp://host:port`` (rank 0 serves it) or
    ``file:///path`` (the CPU tests: no port to race for)."""
    if address.startswith("file://"):
        return torch.distributed.FileStore(address[len("file://"):], world)
    hostport = address[len("tcp://"):] if address.startswith("tcp://") \
        else address
    host, _, port = hostport.rpartition(":")
    return torch.distributed.TCPStore(host or "localhost", int(port), world,
                                      rank == 0, timeout=timeout)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, **kwargs) -> None:
    """Form the process group (reference: ``jax.distributed.initialize``).

    ``coordinator_address`` is ``tcp://host:port`` or ``file:///path``;
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK`` (the environment ``torchrun`` sets), the address to
    ``MASTER_ADDR``/``MASTER_PORT``.  With no coordinator this is a no-op
    (one process).  The ranks publish their devices through the store,
    the transport is chosen from them (:func:`choose_backend`), then the
    group forms.  The connect runs under the ``init_connect`` retry site;
    the outcome lands in the health stream either way."""
    global _group, _backend, _staged, _reason, _rank_devices
    if _group is not None:
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator_address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside a world of {world}")
    from ramba_tpu_torch.observe import events as _events
    from ramba_tpu_torch.observe import health as _health
    from ramba_tpu_torch.resilience import coherence as _coherence
    from ramba_tpu_torch.resilience import faults as _faults
    from ramba_tpu_torch.resilience import retry as _retry

    common.set_local_rank(int(env.get("LOCAL_RANK", rank)))
    if common.device().type == "cuda":
        # this process's card is the current one: NCCL and torch.cuda's
        # synchronize and events default to it
        torch.cuda.set_device(common.device())
    t_s = _timeout_s()
    timeout = datetime.timedelta(seconds=t_s or 1800)
    t0 = time.perf_counter()
    chosen = {}

    def connect():
        _faults.check("init_connect")
        store = _make_store(coordinator_address, world, rank, timeout)
        dev = str(common.device())
        store.set(f"ramba/device/{rank}", f"{socket.gethostname()}|{dev}")
        keys = [f"ramba/device/{r}" for r in range(world)]
        store.wait(keys, timeout)
        devices = [tuple(store.get(k).decode().split("|", 1)) for k in keys]
        chosen["backend"] = choose_backend(devices, backend)
        chosen["devices"] = devices
        torch.distributed.init_process_group(
            backend=chosen["backend"][0],
            store=torch.distributed.PrefixStore("ramba/pg", store),
            rank=rank, world_size=world, timeout=timeout, **kwargs)

    def cleanup():
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    try:
        _retry.call("init_connect", connect, on_retry=cleanup)
    except Exception as e:
        _health.record(outcome="error", error=repr(e),
                       source="distributed_init",
                       init_seconds=time.perf_counter() - t0,
                       cause=repr(e.__cause__)
                       if e.__cause__ is not None else None)
        raise
    _group = torch.distributed.group.WORLD
    _backend, _staged, _reason = chosen["backend"]
    _rank_devices = chosen["devices"]
    _events.invalidate_rank()
    _coherence.invalidate()
    from ramba_tpu_torch.parallel import mesh as _mesh

    _mesh.reset_default()
    _health.record(outcome="ok", source="distributed_init",
                   init_seconds=time.perf_counter() - t0,
                   process_count=world, process_index=rank,
                   backend=_backend, host_staged=_staged, reason=_reason,
                   group_timeout_s=timeout.total_seconds())


def backend() -> Optional[str]:
    """The transport chosen at ``initialize`` (None: one process)."""
    return _backend


def backend_reason() -> str:
    """Why that transport (empty for one process)."""
    return _reason


def rank_devices() -> list:
    """Per rank, ``(host, device string)``, as published at bring-up."""
    return list(_rank_devices)


def shutdown() -> None:
    global _group, _backend, _staged, _reason, _rank_devices
    if _group is not None:
        torch.distributed.destroy_process_group()
        _group, _backend, _staged, _reason, _rank_devices = \
            None, None, False, "", []
        from ramba_tpu_torch.observe import events as _events
        from ramba_tpu_torch.parallel import mesh as _mesh
        from ramba_tpu_torch.resilience import coherence as _coherence

        _events.invalidate_rank()
        _coherence.invalidate()
        _mesh.reset_default()


def process_index() -> int:
    return torch.distributed.get_rank() if _group is not None else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _group is not None else 1


def in_driver() -> bool:
    """True on rank 0 (reference: ``in_driver()`` gates driver-only code
    in SPMD mode)."""
    return process_index() == 0


def local_devices() -> list:
    """The devices this process computes on: one."""
    return [common.device()]


def global_mesh(shape: Optional[tuple] = None, axis_names=None):
    """A mesh over every rank, in rank order (``shape`` defaults to the
    default mesh's balanced factors of the world)."""
    from ramba_tpu_torch.parallel import mesh as _mesh

    n = process_count()
    if shape is None:
        shape = tuple(f for f in _mesh.balanced_factors(
            n, max(1, min(common.mesh_ndim, 3))) if f > 1) or (1,)
    return _mesh.rank_mesh(tuple(shape), axis_names, range(n))


def note_transfer(kind: str, nbytes: int) -> None:
    """Account one cross-process transfer (kind: "allgather",
    "broadcast", ...) in the registry and in ``parallel.comm_stats``."""
    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.observe import registry as _registry

    _registry.inc(f"distributed.{kind}_count")
    if nbytes:
        _registry.inc(f"distributed.{kind}_bytes", int(nbytes))
    parallel.note_transfer(kind, nbytes)


# ---------------------------------------------------------------------------
# the moves (every rank calls them in the same order)
# ---------------------------------------------------------------------------


def _wire_device() -> torch.device:
    """Where tensors cross ranks: the card under NCCL, the host under
    gloo."""
    return common.device() if _backend == "nccl" else torch.device("cpu")


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor where the transport reads
    them (pinned host memory when staged, counted)."""
    from ramba_tpu_torch import parallel

    b = t.detach().contiguous().reshape(-1)
    b = b.view(torch.uint8) if b.numel() else \
        torch.empty(0, dtype=torch.uint8, device=b.device)
    wire = _wire_device()
    if b.device == wire:
        return b
    out = torch.empty(b.numel(), dtype=torch.uint8, device=wire,
                      pin_memory=b.device.type == "cuda")
    out.copy_(b)
    parallel.note_transfer("host_staged", b.numel())
    return out


def _from_wire(b: torch.Tensor, shape, dtype, dev) -> torch.Tensor:
    from ramba_tpu_torch import parallel

    if b.device != dev:
        parallel.note_transfer("host_staged", b.numel())
        b = b.to(dev, non_blocking=False)
    return b.view(dtype).reshape(tuple(shape))


def _empty_wire(nbytes: int) -> torch.Tensor:
    wire = _wire_device()
    return torch.empty(int(nbytes), dtype=torch.uint8, device=wire,
                       pin_memory=wire.type == "cpu"
                       and common.device().type == "cuda")


def all_gather(t: torch.Tensor, shapes: Sequence[tuple]) -> list:
    """Every rank's tensor, in rank order; ``shapes[r]`` is rank ``r``'s
    shape (known everywhere from the layout), the dtype is ``t``'s."""
    item = t.element_size()
    sizes = [int(np.prod(s, dtype=np.int64)) * item for s in shapes]
    width = max(max(sizes), 1)
    mine = _to_wire(t)
    if mine.numel() < width:
        pad = torch.zeros(width, dtype=torch.uint8, device=mine.device)
        pad[:mine.numel()] = mine
        mine = pad
    outs = [_empty_wire(width) for _ in shapes]
    torch.distributed.all_gather(outs, mine)
    note_transfer("allgather", width * len(shapes))
    dev = t.device
    return [_from_wire(o[:n], s, t.dtype, dev)
            for o, n, s in zip(outs, sizes, shapes)]


def all_gather_small(t: torch.Tensor) -> list:
    """``all_gather`` of a tensor of the same shape on every rank."""
    return all_gather(t, [tuple(t.shape)] * process_count())


def all_reduce_int(value: int, op: str = "max") -> int:
    """One integer reduced over the ranks (``max``, ``min`` or ``sum``)."""
    ops = {"max": torch.distributed.ReduceOp.MAX,
           "min": torch.distributed.ReduceOp.MIN,
           "sum": torch.distributed.ReduceOp.SUM}
    t = torch.tensor([int(value)], dtype=torch.int64, device=_wire_device())
    torch.distributed.all_reduce(t, op=ops[op])
    return int(t.item())


def barrier(tag: str = "") -> None:
    """Cross-rank sync point (no-op for one process), bounded by the
    group's timeout."""
    if process_count() > 1:
        all_reduce_int(0)


def exchange(sends: Sequence[tuple], recvs: Sequence[tuple]) -> list:
    """One round of point-to-point moves: ``sends`` are ``(tensor, dst)``,
    ``recvs`` are ``(shape, dtype, src)``; every transfer is posted at
    once (``isend``/``irecv``), then all are waited on.  Messages between
    one pair of ranks pair up in the order they are listed.  Returns the
    received tensors on this rank's device, in ``recvs`` order."""
    from ramba_tpu_torch import parallel

    reqs = []
    keep = []
    pair_tag: dict = {}
    for t, dst in sends:
        w = _to_wire(t)
        keep.append(w)
        tag = pair_tag.setdefault(("s", dst), 0)
        pair_tag[("s", dst)] = tag + 1
        reqs.append(torch.distributed.isend(w, int(dst), tag=tag))
        parallel.note_transfer("send", w.numel())
    bufs = []
    for shape, dtype, src in recvs:
        n = int(np.prod(shape, dtype=np.int64)) * \
            torch.empty((), dtype=dtype).element_size()
        b = _empty_wire(n)
        tag = pair_tag.setdefault(("r", src), 0)
        pair_tag[("r", src)] = tag + 1
        reqs.append(torch.distributed.irecv(b, int(src), tag=tag))
        bufs.append((b, shape, dtype))
        parallel.note_transfer("recv", n)
    for r in reqs:
        r.wait()
    dev = common.device()
    return [_from_wire(b, s, d, dev) for b, s, d in bufs]
