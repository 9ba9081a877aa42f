"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a missing card is an error, never a silent move
to the CPU (a CPU render of a 1024^2 x 128 rpp frame takes minutes and
would pass for a slow GPU).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None = "cuda") as a torch.device; raises when it names
    CUDA and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
