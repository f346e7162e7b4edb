"""Where the port runs unless the caller names a device: the CUDA card."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA card.  Raises when there is none: the CPU is taken
    only when asked for (device="cpu", or `--device cpu` on the CLI)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card found: the engine runs on the card unless asked "
            "for the CPU; pass device=\"cpu\" (CLI: --device cpu)")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or the default device for None."""
    return default_device() if device is None else torch.device(device)
