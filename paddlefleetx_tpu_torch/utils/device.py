"""Device selection for the port's entry points.

The port runs on the card. An entry point that is given no device
takes ``cuda`` and raises when there is none; the CPU is used only
when the caller asks for it by name (the tests do). Nothing here
falls back quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    Args:
        device (str): ``None`` (the card), ``"cuda"``, ``"cuda:N"`` or
            ``"cpu"``.

    Returns:
        torch.device for the request.

    Raises:
        RuntimeError: a CUDA device was asked for (or implied by
            ``None``) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU "
            "unless device='cpu' is passed explicitly")
    return dev
