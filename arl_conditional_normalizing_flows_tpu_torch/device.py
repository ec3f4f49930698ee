"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card. Without a card, ``None`` raises instead of
    carrying on quietly on the CPU: a CPU run must be asked for with
    ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
