"""The port's copy of ``cook_tpu/cluster``'s base, fake and remote
backends.  The Kubernetes backend is not copied (ROADMAP queue 1, item
11b)."""

from .base import ComputeCluster, LaunchSpec, Offer, ReadWriteLock  # noqa: F401
from .fake import FakeCluster, FakeHost  # noqa: F401
from .remote import (  # noqa: F401
    AgentConnection,
    LocalAgentProcess,
    RemoteComputeCluster,
)
