"""The port's scheduling cycle: the scheduler (``scheduler``:
``Scheduler``, its cycle surface), the production driver (``fused``:
``FusedCycleDriver`` and the wire staging) and its pipelined form
(``pipeline``), the split cycle's ranker (``ranker``) and matcher
(``matcher``, with the device dispatch), the rebalancer (``rebalancer``),
the monitor (``monitor``), the leader electors (``election``), the
goodput optimizer (``optimizer``), the sharded controller processes
(``shard``, imported on use: ``python -m cook_tpu_torch.sched.shard``),
and the host copies of the constraint compiler (``constraints``), the
elastic-gang plane (``elastic``) and the heartbeat tracker
(``heartbeat``).  The exports are the reference's."""

from .constraints import (  # noqa: F401
    ConstraintContext,
    build_constraint_mask,
    validate_group_placement,
)
from .matcher import MatchCycleResult, Matcher  # noqa: F401
from .monitor import Monitor  # noqa: F401
from .election import FileLeaderElector, LeaseLeaderElector  # noqa: F401
from .ranker import RankedQueue, Ranker, build_user_tasks  # noqa: F401
from .optimizer import (  # noqa: F401
    DummyHostFeed,
    DummyOptimizer,
    HostFeed,
    HostInfo,
    Optimizer,
    OptimizerConfig,
    OptimizerCycler,
    optimizer_cycle,
)
from .rebalancer import PreemptionDecision, Rebalancer  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
