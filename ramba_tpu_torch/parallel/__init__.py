"""Meshes of shards in one process, and the moves between shards.

``mesh`` (grids, specs, the partition solver), ``shardview`` (index math
over layouts) and ``constraints`` (co-partitioning) are the counterparts
of ``ramba_tpu/parallel``.  Every position of a mesh holds the same device,
so a sharded array is one tensor whose shards are views into it: the
generic lowering reads it whole at no cost.  Two moves copy, and both are
counted here (bytes and count in :data:`comm_stats`, like the reference's
``note_transfer``), never silently:

* ``shard_assemble``: per-shard results written into one tensor (the
  sharded stencil's outputs, ``spmd``'s ``set_local`` blocks);
* a halo slab from one shard to a neighbour goes through
  :func:`transport`.
"""

from __future__ import annotations

from ramba_tpu_torch.observe import registry as _registry

comm_stats: dict = {"shard_assemble_bytes": 0, "shard_assemble_count": 0}


def note_transfer(direction: str, nbytes: int) -> None:
    with _registry.lock:
        comm_stats[f"{direction}_bytes"] = (
            comm_stats.get(f"{direction}_bytes", 0) + int(nbytes))
        comm_stats[f"{direction}_count"] = (
            comm_stats.get(f"{direction}_count", 0) + 1)


def transport(block, src: int, dst: int):
    """Move ``block`` (a tensor or port array held by shard ``src``) to
    shard ``dst``.  In one process both shards read the same device: the
    receiver takes the sender's block in place, and the copy happens where
    it is written into the receiver's buffer.  The multi-process slice
    replaces this function with a send/recv pair."""
    return block
