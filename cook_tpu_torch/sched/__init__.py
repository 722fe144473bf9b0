"""The port's scheduling cycle: the scheduler (``scheduler``:
``Scheduler``, its cycle surface), the production driver (``fused``:
``FusedCycleDriver`` and the wire staging) and its pipelined form
(``pipeline``), the split cycle's ranker (``ranker``) and matcher
(``matcher``, with the device dispatch), the rebalancer (``rebalancer``),
and the host copies of the constraint compiler (``constraints``), the
elastic-gang plane (``elastic``) and the heartbeat tracker
(``heartbeat``)."""

from .matcher import MatchCycleResult, Matcher  # noqa: F401
from .ranker import RankedQueue, Ranker  # noqa: F401
from .rebalancer import PreemptionDecision, Rebalancer  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
