"""cook_tpu_torch: the PyTorch + CUDA port of cook_tpu's scheduling cycle.

The JAX package ``cook_tpu`` is the reference; this package computes the
same decisions with PyTorch tensors and, on an NVIDIA Hopper card, with
hand-written CUDA stage kernels (``ops/csrc``).  It imports neither JAX
nor ``cook_tpu``.

Every public entry point takes ``device`` (default ``"cuda"``).  Without
a card the default raises; callers that want the CPU ask for it.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a card is
    an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cook_tpu_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
