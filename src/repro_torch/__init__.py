"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (configs, data, kernels, models,
streaming) and imports neither JAX nor ``repro``: what it needs of the
reference's framework-free host code it keeps as its own copy. Entry
points take an explicit ``device`` that defaults to ``"cuda"``; asking for
the card where there is none raises instead of falling back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return dev
