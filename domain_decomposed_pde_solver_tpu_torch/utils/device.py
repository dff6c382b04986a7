"""Explicit device resolution: the port keeps no global device state."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return the ``torch.device`` the caller asked for.

    ``None`` means the card, ``cuda:0``: the port runs on the GPU unless the
    caller asks for the CPU (``"cpu"``).  A CUDA device that is not present
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
