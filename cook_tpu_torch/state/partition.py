"""The port's part of ``cook_tpu/state/partition.py``: ``substores`` alone,
the idiom the monitor sweep, the saturation layer and the admission
controller iterate the write plane's shards with.  The partitioned write
plane itself (``PartitionedStore``, ``PartitionMap``, the summary
exchange and the partitioned read view) stays in ROADMAP queue 1,
item 11; until then every store of the port is one shard."""

from __future__ import annotations

from typing import List

from .store import Store


def substores(store) -> List[Store]:
    """The physical shards behind ``store``: the partition list of a
    :class:`PartitionedStore`, else the store itself — the one idiom
    for call sites that iterate raw entity tables under the store lock
    (they must take each partition's lock in turn, never nested)."""
    return list(getattr(store, "partitions", None) or [store])
