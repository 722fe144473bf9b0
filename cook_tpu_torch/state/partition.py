"""The port's part of ``cook_tpu/state/partition.py``: ``substores``, the
idiom the monitor sweep, the saturation layer and the admission
controller iterate the write plane's shards with, and the commit-token
parsers the follower read view reads tokens with.  The partitioned write
plane itself (``PartitionedStore``, ``PartitionMap``, the summary
exchange and the partitioned read view) stays in ROADMAP queue 1,
item 11c; until then every store of the port is one shard."""

from __future__ import annotations

from typing import List, Optional, Tuple

from .store import Store


def substores(store) -> List[Store]:
    """The physical shards behind ``store``: the partition list of a
    :class:`PartitionedStore`, else the store itself — the one idiom
    for call sites that iterate raw entity tables under the store lock
    (they must take each partition's lock in turn, never nested)."""
    return list(getattr(store, "partitions", None) or [store])


# --------------------------------------------------------------- tokens
def parse_token_entry(entry: str) -> Tuple[Optional[int], Optional[int],
                                           int]:
    """One commit-token entry → ``(partition, epoch, offset)``.
    Accepted forms: ``p<P>:<epoch>:<offset>``, ``p<P>:<offset>``,
    ``<epoch>:<offset>``, ``<offset>`` (partition/epoch None when
    absent).  Raises ValueError on garbage."""
    part: Optional[int] = None
    if entry.startswith("p"):
        head, sep, rest = entry.partition(":")
        if not sep:
            raise ValueError(f"malformed token entry {entry!r}")
        part = int(head[1:])
        entry = rest
    if ":" in entry:
        ep, _, off = entry.partition(":")
        return part, int(ep), int(off)
    return part, None, int(entry)


def parse_token_vector(token: str) -> List[Tuple[Optional[int],
                                                 Optional[int], int]]:
    """A comma-joined commit-token vector → entry triples.  A legacy
    single token parses to a one-entry list with partition None."""
    return [parse_token_entry(e.strip())
            for e in token.split(",") if e.strip()]
