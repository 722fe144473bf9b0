"""The port's simulator (``cook_tpu/sim``): the trace replay, the
workload generator and the overload replay over the port's
``Scheduler``; ``python -m cook_tpu_torch.sim`` runs it."""

from .simulator import (  # noqa: F401
    SimResult,
    Simulator,
    generate_example_hosts,
    generate_example_trace,
    load_hosts,
    load_trace,
)
