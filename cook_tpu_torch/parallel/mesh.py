"""``cook_tpu/parallel/mesh.py``: the pool mesh and the boot-time
cross-check between the write plane's ``PartitionMap`` and the
controller shards' pool layout.

The host half (the axis names, ``shard_of_partition``,
``validate_shard_alignment``, which the node runs when its
``partitions`` section sets ``shards`` or ``shard_pools``) is plain
Python and imports no torch.

The device half: a :class:`PoolMesh` is an ordered array of
``torch.device`` slots with the reference's axis names, ``("pool",)``
or ``("dcn", "pool")``.  One process drives every slot, as JAX's
``shard_map`` does; nothing here is ``torch.distributed``.  A mesh may
name one device more than once (8 slots of ``cpu`` stand in for the
reference's 8-device CPU mesh, and a host with one card runs 2 or 4
slots of ``cuda:0``); on a host with as many cards as slots each slot
takes its own card.  :func:`pool_sharding` is the slot -> contiguous
pool-block layout of the ``[P, ...]`` pool-stacked arrays, which the
resident buffers and the sharded cycle (``parallel/sharded.
make_pool_cycle``) share.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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


# ------------------------------------------------------------- device half
class PoolMesh:
    """An ordered array of device slots with named axes: ``("pool",)``
    (shape ``(n,)``) or ``("dcn", "pool")`` (shape ``(slices,
    per_slice)``).  Pools shard over every axis in row-major slot order,
    the order of the reference's tiled ``all_gather``."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 shape: Optional[Tuple[int, ...]] = None):
        import torch
        self.devices: List["torch.device"] = [torch.device(d)
                                              for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None \
            else (len(self.devices),)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} for axes "
                             f"{self.axis_names}")
        n = 1
        for d in self.shape:
            n *= d
        if n != len(self.devices) or n < 1:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"PoolMesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self.shape})")


def _slots(n: int, device) -> List:
    """``n`` slots over the devices of ``device``'s type: an explicit
    index pins every slot to that device; otherwise the first ``n``
    devices, or, with fewer devices than slots, contiguous runs of slots
    on each."""
    from .. import resolve_device
    import torch
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n}")
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * n
    count = torch.cuda.device_count()
    idx = [i if n <= count else i * count // n for i in range(n)]
    return [torch.device("cuda", i) for i in idx]


def _device_count(device) -> int:
    from .. import resolve_device
    import torch
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.device_count()
    return 1


def pool_mesh(n_devices: Optional[int] = None, device="cuda") -> PoolMesh:
    """1-D mesh over the pool axis: ``n_devices`` slots (default: one a
    device of ``device``'s type)."""
    n = _device_count(device) if n_devices is None else int(n_devices)
    return PoolMesh(_slots(n, device), (POOL_AXIS,))


def multislice_pool_mesh(n_slices: int,
                         devices_per_slice: Optional[int] = None,
                         device="cuda") -> PoolMesh:
    """2-D ``("dcn", "pool")`` mesh for multi-slice topologies: pools
    shard over both axes (each slice owns an independent pool block), so
    the only cross-slice traffic is the reconciliation's small gathers."""
    if devices_per_slice is None:
        count = _device_count(device)
        if count % n_slices != 0:
            raise ValueError(
                f"{count} devices not divisible into {n_slices} "
                "slices; pass devices_per_slice explicitly")
        devices_per_slice = count // n_slices
    n = n_slices * devices_per_slice
    return PoolMesh(_slots(n, device), (DCN_AXIS, POOL_AXIS),
                    (n_slices, devices_per_slice))


class PoolSharding(NamedTuple):
    """The slot -> contiguous pool-block layout of ``[P, ...]``
    pool-stacked arrays over a mesh: slot ``k`` owns pools
    ``[k * P / n, (k + 1) * P / n)`` on ``mesh.devices[k]``.  ``P`` must
    divide over the slots (the drivers pad their pool axis to a multiple
    of ``mesh.size``)."""

    mesh: PoolMesh

    def blocks(self, P: int) -> List[slice]:
        n = self.mesh.size
        if P % n:
            raise ValueError(f"{P} pools do not divide over a "
                             f"{n}-slot mesh")
        k = P // n
        return [slice(i * k, (i + 1) * k) for i in range(n)]

    def shard(self, t) -> List:
        """``t``'s pool blocks, each on its slot's device (u16 tensors
        move as their int16 bit pattern)."""
        import torch
        out = []
        for b, d in zip(self.blocks(t.shape[0]), self.mesh.devices):
            part = t[b]
            if part.dtype == torch.uint16:
                part = part.view(torch.int16).to(d).view(torch.uint16)
            out.append(part.to(d).contiguous())
        return out


def pool_sharding(mesh: PoolMesh) -> PoolSharding:
    """The owner-local placement of the resident ``[P, T]`` buffers and
    of the sharded cycle's pool blocks: each slot owns its own
    contiguous block."""
    return PoolSharding(mesh)
