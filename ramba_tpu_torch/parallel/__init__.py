"""Meshes of shards, the ranks of several processes, and the moves
between them.

``mesh`` (grids, specs, the partition solver), ``shardview`` (index math
over layouts), ``constraints`` (co-partitioning) and ``distributed``
(bring-up, collectives, send/recv) are the counterparts of
``ramba_tpu/parallel``.  In one process every position of a mesh holds
the same device, so a sharded array is one tensor whose shards are views
into it; on a mesh of ranks each rank holds its own block.  Every move
that copies is counted here (bytes and count in :data:`comm_stats`, like
the reference's ``note_transfer``), never silently:

* ``shard_assemble``: per-shard results written into one tensor (one
  process: the sharded stencil's outputs, ``spmd``'s ``set_local``
  blocks);
* ``send``/``recv``: slabs between ranks (``distributed.exchange``:
  halo exchanges);
* ``allgather``: every rank's block to every rank (a gathered program,
  ``asarray``, a fold's partials, a scan's totals);
* ``host_staged``: bytes through pinned host buffers where ranks share a
  card (gloo).
"""

from __future__ import annotations

from ramba_tpu_torch.observe import registry as _registry

comm_stats: dict = {"shard_assemble_bytes": 0, "shard_assemble_count": 0,
                    "send_bytes": 0, "recv_bytes": 0, "allgather_bytes": 0,
                    "host_staged_bytes": 0}


def note_transfer(direction: str, nbytes: int) -> None:
    with _registry.lock:
        comm_stats[f"{direction}_bytes"] = (
            comm_stats.get(f"{direction}_bytes", 0) + int(nbytes))
        comm_stats[f"{direction}_count"] = (
            comm_stats.get(f"{direction}_count", 0) + 1)


def transport(block, src: int, dst: int):
    """Move ``block`` (a tensor or port array held by shard ``src``) to
    shard ``dst`` of a one-process mesh.  Both shards read the same
    device: the receiver takes the sender's block in place, and the copy
    happens where it is written into the receiver's buffer.  Between the
    ranks of a mesh of ranks, slabs move by send/recv in one batch per
    exchange round (``distributed.exchange``)."""
    return block
