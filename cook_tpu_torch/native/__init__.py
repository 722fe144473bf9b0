"""The port's native (C++) host components: the sharded status watch
queue (``watch_queue``), built with g++ from ``native/watch_queue.cpp``."""

from .watch_queue import (  # noqa: F401
    PyWatchQueue,
    ShardedWatchQueue,
    make_watch_queue,
    native_available,
)
