"""The host half of ``cook_tpu/parallel/mesh.py``: the mesh's axis names
and the boot-time cross-check between the write plane's ``PartitionMap``
and the controller shards' pool layout, which the node runs when its
``partitions`` section sets ``shards`` or ``shard_pools``.  Plain
Python: it imports neither JAX nor torch.

The device half (``pool_mesh``, ``multislice_pool_mesh``,
``pool_sharding``), the sharded pool cycle and the shard controllers
(``sched/shard``) are ROADMAP.md queue 1, item 9.
"""

from __future__ import annotations

from typing import Dict, List, Optional

POOL_AXIS = "pool"
DCN_AXIS = "dcn"


class ShardAlignmentError(ValueError):
    """The PartitionMap's pool groups and the mesh pool-shard layout
    disagree: a pool's write-plane partition and its resident-buffer
    shard would be owned by DIFFERENT controller processes (double-owned
    or orphaned resident state).  Raised at daemon boot — a config
    error, never a silent split-brain."""


def shard_of_partition(partition: int, count: int, n_shards: int) -> int:
    """Which controller shard owns write-plane ``partition``: partitions
    map onto shards in contiguous blocks, so a shard's pools are also a
    contiguous block of the pool-stacked [P, ...] mesh arrays — the same
    slice ``parallel.mesh.pool_sharding`` commits to that shard's
    devices.  ``count`` must divide evenly into ``n_shards`` blocks."""
    if n_shards < 1:
        raise ShardAlignmentError(f"shards must be >= 1, got {n_shards}")
    if count % n_shards != 0:
        raise ShardAlignmentError(
            f"{count} write-plane partitions do not divide over "
            f"{n_shards} controller shards; partition blocks must be "
            "equal so every shard's resident slice has one owner")
    if not 0 <= partition < count:
        raise ShardAlignmentError(
            f"partition {partition} out of range [0, {count})")
    return partition // (count // n_shards)


def shard_of_pool(pmap, pool: str, n_shards: int) -> int:
    """Controller shard owning ``pool``: its PartitionMap partition's
    contiguous block (``pmap`` is a state.partition.PartitionMap)."""
    return shard_of_partition(pmap.partition_of(pool), pmap.count, n_shards)


def validate_shard_alignment(pmap, n_shards: int,
                             declared: Optional[Dict[str, int]] = None
                             ) -> Dict[int, List[str]]:
    """Boot-time cross-check: the PartitionMap's
    pool groups and the mesh ``pool_sharding`` layout must be the SAME
    partition.  ``declared`` is the operator's explicit pool -> mesh
    shard table (config ``partitions.shard_pools``); every declared pool
    must land on the shard its write-plane partition routes to, and
    every declared shard index must exist.  Returns the validated
    shard -> sorted pool names layout (explicit pools only; hash-routed
    pools follow their partition block by construction).  Raises
    :class:`ShardAlignmentError` with the offending pool on mismatch —
    a mismatched declaration would silently double-own or orphan the
    pool's resident buffers."""
    layout: Dict[int, List[str]] = {s: [] for s in range(n_shards)}
    for pool in sorted(getattr(pmap, "pools", {}) or {}):
        layout[shard_of_pool(pmap, pool, n_shards)].append(pool)
    for pool, shard in sorted((declared or {}).items()):
        if not 0 <= int(shard) < n_shards:
            raise ShardAlignmentError(
                f"shard_pools[{pool!r}] = {shard} but only shards "
                f"[0, {n_shards}) exist")
        owner = shard_of_pool(pmap, pool, n_shards)
        if int(shard) != owner:
            raise ShardAlignmentError(
                f"pool {pool!r} is declared on mesh shard {shard} but "
                f"its write-plane partition {pmap.partition_of(pool)} "
                f"belongs to controller shard {owner}: the partition "
                "map and the mesh pool_sharding layout must agree "
                "(one partition = one process = one mesh shard)")
        if pool not in layout[owner]:
            layout[owner].append(pool)
            layout[owner].sort()
    return layout
