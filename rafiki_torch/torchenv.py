"""Device resolution for the port: the counterpart of ``jaxenv``.

Every entry point takes an explicit ``device=`` and defaults to CUDA.
The CPU is used only when the caller asks for it (the tests do). When no
card is present and the caller did not ask for the CPU, resolution
raises: the port never quietly carries on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. ``"cpu"`` is honoured as asked. A CUDA
    device without a card raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(device: Optional[torch.device] = None) -> None:
    """Wait for the card's queued work (a no-op on the CPU): what the
    reference's jitted sync probe measured with a device round trip."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)
