"""The port's copy of ``cook_tpu/state``: the entity schema, the
transactional ``Store`` and its columnar index, the partitioned write
plane (``partition.PartitionedStore`` over one ``Store`` a partition),
and the HA plane the node uses (``replication``, ``read_replica``,
``repair``)."""

from .schema import (  # noqa: F401
    Application,
    Checkpoint,
    CheckpointMode,
    Constraint,
    DruMode,
    Group,
    GroupPlacementType,
    Instance,
    InstanceStatus,
    Job,
    JobState,
    Pool,
    QuotaEntry,
    Reason,
    Reasons,
    Resources,
    RESOURCE_DIMS,
    SchedulerKind,
    ShareEntry,
    below_quota,
    add_usage,
    job_usage,
    new_uuid,
    now_ms,
    to_json,
)
from .store import (AbortTransaction, ReplicationIndeterminate,  # noqa: F401
                    ReplicationTimeout, StaleEpochError, Store, TxEvent)
from .partition import (GLOBAL_POOL, PartitionedReadView,  # noqa: F401
                        PartitionedStore, PartitionMap,
                        PartitionRoutingError, UserSummaryExchange,
                        parse_token_vector, substores)
from .index import ColumnarIndex  # noqa: F401
from . import machines  # noqa: F401
