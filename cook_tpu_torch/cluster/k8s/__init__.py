"""The port's copy of ``cook_tpu/cluster/k8s``: the Kubernetes backend,
its fake and mock apiservers, and the lease adapter."""

from .compute_cluster import KubernetesCluster  # noqa: F401
from .controller import (  # noqa: F401
    CookExpected,
    PodController,
    PodState,
    synthesize_pod_state,
)
from .fake_api import FakeKubernetesApi, FakeNode, FakePod, WatchEvent  # noqa: F401
