"""The port's copy of ``cook_tpu/cluster``'s base and fake backends.
The remote and Kubernetes backends are not copied (ROADMAP queue 1,
item 11)."""

from .base import ComputeCluster, LaunchSpec, Offer, ReadWriteLock  # noqa: F401
from .fake import FakeCluster, FakeHost  # noqa: F401
