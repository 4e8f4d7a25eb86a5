"""Carry the reference's param tree into the port.

``params_from_jax`` takes the host copy of a ``repro`` param tree, as
``jax.tree.map(np.asarray, transformer.init(...))`` gives it — nested
dicts of numpy arrays with the reference's keys and the stacked layer dim
leading — and returns the same tree as tensors in ``cfg.torch_dtype`` on
``device``. The layouts are the same, so nothing is transposed. It takes
numpy arrays only and so imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def params_from_jax(host_params: dict, cfg: ArchConfig, device="cuda"):
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        # via float32: numpy has no bfloat16 torch understands; a copy, so
        # the port never writes into the caller's arrays
        return torch.tensor(np.asarray(x, dtype=np.float32),
                            dtype=cfg.torch_dtype, device=dev)

    return conv(host_params)
