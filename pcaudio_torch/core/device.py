"""The device an entry point runs on.

Entry points default to ``"cuda"``.  Asking for the card where there is none
is an error, never a quiet run on the CPU; the CPU is used only when the
caller names it, and never by what only times the card (the probes).
"""
from __future__ import annotations

import torch


def resolve_device(device, cuda_only: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it is a
    CUDA device and no card is present, or, with ``cuda_only``, when it is
    not a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        hint = "" if cuda_only else ": pass device='cpu' to run on the CPU"
        raise RuntimeError(f"no CUDA device for device={str(device)!r}{hint}")
    if cuda_only and device.type != "cuda":
        raise RuntimeError(f"device={str(device)!r} is not a CUDA device; this "
                           f"times an NVIDIA GPU and has no CPU mode")
    return device
