"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is
no silent fallback: with no card and no explicit ``device="cpu"`` they
raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda`` (raises without a card); otherwise the given one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available")
    return dev
