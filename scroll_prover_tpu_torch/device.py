"""Device selection for the port's entry points.

Entry points run on the card (`cuda`) unless the caller passes
`device="cpu"`. Without a card and without that explicit request they
raise: nothing drifts to the CPU on its own. Below the entry points, work
follows the tensors it is given — a CUDA tensor goes through the hand-written
kernels, a CPU tensor through their plain PyTorch versions.
"""
from __future__ import annotations

import os
import warnings

import torch

_allocator_set = False


def _expandable_segments() -> None:
    """Let the caching allocator grow its segments in place, once per
    process: a k = 23 prove allocates and frees blocks of 0.5-11 GiB beside
    tensors of every size, and with fixed segments the allocator held 12 GiB
    in pieces where a 4 GiB block no longer fit. A PYTORCH_CUDA_ALLOC_CONF
    that the caller set stays as it is."""
    global _allocator_set
    if _allocator_set:
        return
    _allocator_set = True
    if os.environ.get("PYTORCH_CUDA_ALLOC_CONF"):
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        _expandable_segments()
    return dev
