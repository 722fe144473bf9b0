"""Wire flag bits of the compact pool-cycle wire (one byte per task) and
their packer — the part of ``cook_tpu/ops/delta.py`` the cycle needs.
The resident-buffer delta scatter comes in a later slice."""

from __future__ import annotations

import numpy as np

FLAG_PENDING = 1
FLAG_VALID = 2
FLAG_ENQUEUE_OK = 4
FLAG_LAUNCH_OK = 8
FLAG_USER_FIRST = 16   # first row of a user segment


def pack_flags(pending: np.ndarray, valid: np.ndarray,
               is_first: np.ndarray, enqueue_ok=None,
               launch_ok=None) -> np.ndarray:
    """The wire flags byte.  ``enqueue_ok``/``launch_ok`` default to
    all-accept when omitted."""
    flags = (pending.astype(np.uint8) * FLAG_PENDING
             + valid.astype(np.uint8) * FLAG_VALID
             + is_first.astype(np.uint8) * FLAG_USER_FIRST)
    if enqueue_ok is not None:
        flags += enqueue_ok.astype(np.uint8) * FLAG_ENQUEUE_OK
    if launch_ok is not None:
        flags += launch_ok.astype(np.uint8) * FLAG_LAUNCH_OK
    return flags
