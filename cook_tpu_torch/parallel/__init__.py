"""The pool cycle over P pools on one device (``sharded``)."""
