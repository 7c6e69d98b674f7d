"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a
card that default raises instead of quietly running on the CPU: a run that
meant to measure the GPU must not silently measure the host. Callers that
want the plain versions on the host (the CPU tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a host without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the "
            "host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
