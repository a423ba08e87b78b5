"""Device helpers.  Every entry point of the port takes its device as an
argument; these helpers validate it and never choose one themselves."""

from __future__ import annotations

import torch


def as_device(device) -> torch.device:
    """Normalize `device` (str or torch.device) and refuse what the port
    cannot run on: a CUDA device when CUDA is unavailable (no silent
    CPU fallback), or any device type other than cuda/cpu."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(device: torch.device) -> str:
    """Human-readable device name for logs and result records."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)
