"""The port's copy of ``cook_tpu/ecosystem/`` (over the port's
``cook_tpu_torch.client``; host code, no device).

Ecosystem integrations: run third-party distributed frameworks on
cook_tpu_torch (reference: dask/docs/design.md — CookCluster API for Dask;
spark/ — patches running Spark executors as Cook jobs).

The building block is :class:`ServiceFarm` — a manager for N long-running
service jobs (scale up/down, status, teardown) over the REST client —
which the Dask backend (:mod:`cook_tpu_torch.ecosystem.dask_backend`) and the
Spark standalone deployment (:mod:`cook_tpu_torch.ecosystem.spark`) drive.
"""

from .service_farm import ServiceFarm  # noqa: F401
from .dask_backend import CookCluster  # noqa: F401
from .spark import SparkOnCook  # noqa: F401
