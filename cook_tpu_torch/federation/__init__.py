"""The port's copy of ``cook_tpu/federation/``: multi-cell federation,
a thin front-door tier over N autonomous cook_tpu_torch cells.

The front door touches a device in one place only: the goodput route
mode's replays (``router.FederationRouter(config, device=...)``), which
match through kernel K5 on the router's device.  In the default
``"load"`` mode it touches none and boots without a card.

The design is Hydra's (NSDI'19): cells stay sovereign — each keeps its
own store, journal, election, scheduler — and what crosses the cell
boundary is *bounded summaries*, never job state.  The pieces:

``tokens``
    cell-qualified commit tokens: the ``(partition, epoch, offset)``
    vector entries prefixed with a cell id so read-your-writes survives
    a multi-cell front door (``cellA/p0:3:128``).
``cells``
    CellSpec/CellHandle — one cell's address, capacity tier, locality
    attributes, a breaker-guarded raw HTTP transport, and the cached
    health/saturation snapshot the router scores with.
``summary``
    FederatedUserSummaries — the staleness-bounded UserSummaryExchange
    pattern lifted one level: per-user pending/running/resource tables
    fetched from every serving cell, merged with the oldest table's age
    backdating the whole view, ``SummaryStalenessError`` at the bound.
``router``
    FederationRouter — routes whole submission batches (gangs never
    split; the owning-cluster rule generalized) by locality, load,
    saturation and capacity tier; enforces the GLOBAL per-user pending
    cap and dominant-share ceiling off the federated summaries; keeps
    the bounded commit ledger that makes full-cell-outage re-route
    lossless for committed work.
``rest``
    FederationServer — the stateless front door (the ``federation``
    daemon role): single-cell deployments proxy wire-identically to a
    direct cell connection; multi-cell deployments qualify commit
    tokens, gate reads against the right cell, and degrade cross-cell
    reads honestly (bounded-stale headers, never faked).
"""

from .tokens import (  # noqa: F401
    CELL_SEP,
    cells_in_token,
    qualify_token,
    split_entry,
    strip_for_cell,
)
from .cells import CellHandle, CellSpec, CellUnreachable  # noqa: F401
from .summary import FederatedUserSummaries  # noqa: F401
from .router import FederationRouter, RouteRejected  # noqa: F401
from .rest import FederationServer, build_federation_node  # noqa: F401
