"""The port's copy of ``cook_tpu/agent/__init__.py``: the task executor
and the sandbox file server."""

from .executor import (  # noqa: F401
    DEFAULT_PROGRESS_REGEX,
    ProgressWatcher,
    TaskExecutor,
    rest_progress_publisher,
)
from .file_server import SandboxFileServer  # noqa: F401
