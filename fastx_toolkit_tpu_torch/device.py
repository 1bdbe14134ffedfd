"""Device resolution: the port's only knob.

``FASTX_TORCH_DEVICE`` (default ``cuda``) names the torch device the CLI
runs on; it is the counterpart of the reference's ``JAX_PLATFORMS``.  A
requested CUDA device that is absent is an error: the port never carries
on on the CPU by itself.
"""

from __future__ import annotations

import os

import torch

ENV_DEVICE = "FASTX_TORCH_DEVICE"


def resolve_device(name: str | None = None) -> torch.device:
    """``name`` (or ``$FASTX_TORCH_DEVICE``, default ``cuda``) as a
    ``torch.device``; raises RuntimeError when CUDA is asked for and no
    CUDA device is available."""
    if name is None:
        name = os.environ.get(ENV_DEVICE) or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available (set %s=cpu to "
            "run the plain PyTorch path)" % (name, ENV_DEVICE))
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError("unsupported device %r (cuda or cpu)" % name)
    return dev
