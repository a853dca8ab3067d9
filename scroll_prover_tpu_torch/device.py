"""Device selection for the port's entry points.

Entry points run on the card (`cuda`) unless the caller passes
`device="cpu"`. Without a card and without that explicit request they
raise: nothing drifts to the CPU on its own. Below the entry points, work
follows the tensors it is given — a CUDA tensor goes through the hand-written
kernels, a CPU tensor through their plain PyTorch versions.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
