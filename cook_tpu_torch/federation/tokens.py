"""The port's copy of ``cook_tpu/federation/tokens.py``: cell-qualified
commit tokens.

The partitioned write plane made the commit token a VECTOR of
per-partition entries (``p<P>:<epoch>:<offset>``, comma-joined) that
clients merge latest-per-partition.  Federation prefixes each entry with the id of
the cell whose journal minted it — ``cellA/p0:3:128`` — so one session
token can carry read-your-writes positions against MANY sovereign
journals at once:

- the router qualifies ``X-Cook-Commit-Offset`` response headers with
  the cell that answered the write (multi-cell deployments only; a
  single-cell front door passes tokens through verbatim, which is what
  keeps it wire-identical to a direct cell connection);
- the client merges entries latest-per-``(cell, partition)``
  (:meth:`cook_tpu_torch.client.JobClient._merge_commit_token`);
- on a read, the router strips the vector down to the entries minted
  by the TARGET cell (prefix removed — cells never see cell ids; their
  wait gates speak the intra-cell grammar unchanged) and reports the
  entries it could NOT enforce via ``X-Cook-Federation-Stale-Cells``
  (honest bounded-stale degrade, never a faked read-your-writes).

Entries stay string-opaque end to end, exactly like the partition
vector before them: nothing here parses epochs or offsets.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

#: separator between the cell id and the intra-cell token entry.  "/"
#: cannot appear in an intra-cell entry (digits, ":", leading "p") nor
#: in a validated cell id, so the split is unambiguous.
CELL_SEP = "/"


def split_entry(entry: str) -> Tuple[Optional[str], str]:
    """``cellA/p0:3:128`` → ``("cellA", "p0:3:128")``; an unqualified
    entry returns ``(None, entry)`` unchanged."""
    cell, sep, rest = entry.partition(CELL_SEP)
    if sep and cell and rest:
        return cell, rest
    return None, entry


def qualify_token(cell: str, token: str) -> str:
    """Prefix every entry of a cell-minted token vector with the cell
    id.  Entries that already carry a cell prefix are left alone (a
    router in front of another router must not double-qualify)."""
    out: List[str] = []
    for e in (p.strip() for p in token.split(",")):
        if not e:
            continue
        got, _ = split_entry(e)
        out.append(e if got is not None else f"{cell}{CELL_SEP}{e}")
    return ",".join(out)


def cells_in_token(token: str) -> Set[str]:
    """The set of cell ids a token vector names (unqualified entries
    contribute nothing)."""
    cells: Set[str] = set()
    for e in (p.strip() for p in token.split(",")):
        if e:
            cell, _ = split_entry(e)
            if cell is not None:
                cells.add(cell)
    return cells


def strip_for_cell(token: str, cell: str) -> Tuple[Optional[str],
                                                   Set[str]]:
    """Reduce a (possibly mixed) token vector to what the TARGET cell
    can enforce.

    Returns ``(cell_token, other_cells)``: ``cell_token`` is the
    comma-joined vector of this cell's entries with their prefixes
    stripped plus any unqualified entries passed through verbatim
    (``None`` when nothing remains — the read proceeds ungated);
    ``other_cells`` names every OTHER cell the vector mentions, which
    the caller reports as the unenforced remainder."""
    keep: List[str] = []
    others: Set[str] = set()
    for e in (p.strip() for p in token.split(",")):
        if not e:
            continue
        got, rest = split_entry(e)
        if got is None:
            keep.append(e)
        elif got == cell:
            keep.append(rest)
        else:
            others.add(got)
    return (",".join(keep) if keep else None), others


def merge_token(tokens: Dict[str, str], cell: str, token: str) -> None:
    """Fold one cell-minted token into a per-``(cell, partition)``
    latest-wins map (the router's view of its own recent writes; the
    client keeps its own copy via ``_merge_commit_token``)."""
    for e in (p.strip() for p in token.split(",")):
        if not e:
            continue
        got, rest = split_entry(e)
        key_cell = got if got is not None else cell
        part = rest.partition(":")[0] if rest.startswith("p") \
            and ":" in rest else ""
        tokens[f"{key_cell}{CELL_SEP}{part}"] = rest


def joined(tokens: Dict[str, str]) -> str:
    """The session-token form of a per-(cell, partition) map: each
    entry re-qualified with its cell and sorted for determinism."""
    out = []
    for key in sorted(tokens):
        cell = key.split(CELL_SEP, 1)[0]
        out.append(f"{cell}{CELL_SEP}{tokens[key]}")
    return ",".join(out)
