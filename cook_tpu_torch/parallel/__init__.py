"""The pool mesh (``mesh``: the slots, the pool-block layout and the
controller shards' alignment check) and the pool cycle over it
(``sharded``: one device's plain cycle, and ``make_pool_cycle`` over a
mesh).  The exports are the reference's."""
from .mesh import POOL_AXIS, pool_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    PoolCycleInputs,
    PoolCycleResult,
    make_pool_cycle,
)
