"""The pool cycle over P pools on one device (``sharded``) and the mesh's
host helpers (``mesh``)."""
