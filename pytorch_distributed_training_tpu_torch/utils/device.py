"""The device an entry point runs on (no JAX counterpart: JAX picks its
backend itself)."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist (never a quiet
    fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for but torch.cuda.is_available() is "
            f"false (pass device='cpu' to run the plain CPU path)"
        )
    return dev
