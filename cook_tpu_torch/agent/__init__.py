"""The port's agent package: the sandbox file server alone.  The task
executor (``cook_tpu/agent/executor.py``) is still to be ported
(ROADMAP.md, queue 1, item 11)."""

from .file_server import SandboxFileServer  # noqa: F401
