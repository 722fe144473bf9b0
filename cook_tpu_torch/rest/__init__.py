"""The port's REST plane (``cook_tpu/rest``): the API over the port's
``Scheduler`` (``api``), its authenticators (``auth``), the request
observer (``instrument``) and the instance statistics (``task_stats``)."""

from .api import ApiError, ApiServer, CookApi  # noqa: F401
