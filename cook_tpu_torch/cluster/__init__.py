"""The port's copy of ``cook_tpu/cluster``: the base, fake and remote
backends here, the Kubernetes backend in ``cluster.k8s`` (imported on
its own, as the reference's is)."""

from .base import ComputeCluster, LaunchSpec, Offer, ReadWriteLock  # noqa: F401
from .fake import FakeCluster, FakeHost  # noqa: F401
from .remote import (  # noqa: F401
    AgentConnection,
    LocalAgentProcess,
    RemoteComputeCluster,
)
