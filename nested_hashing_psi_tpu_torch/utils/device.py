"""The device a party, a rank or a tool computes on, and its synchronise."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for ``device``: the CPU or a CUDA device, which must exist
    (no CPU fallback); any other device type is refused."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: the port runs on cpu or cuda only")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available: it needs "
                           "a GPU (device cpu runs the plain PyTorch versions)")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a torch.device or its name)
    when it is a card; no-op otherwise."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
