"""Dispatch over the hand-written kernels + the kernel-mode toggle.

The model layer routes its paged decode attention through
``decode_attention_paged`` / ``window_attention_paged`` below, which
honour the mode:

  REPRO_TORCH_KERNELS=auto   CUDA kernel on CUDA tensors, plain torch on
                             CPU tensors (the default)
  REPRO_TORCH_KERNELS=cuda   always the CUDA kernel; raises on CPU tensors
  REPRO_TORCH_KERNELS=torch  always the plain torch path

Set it through the env var or ``set_kernel_mode()``; the toggle reads
its own variable, never the reference's ``KERNEL_MODE``. A kernel that
fails to build or launch raises: nothing falls back to the plain path.
A logit softcap takes the plain path, as in the reference (the kernel has
none).
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import paged_decode_attention as PDA

KERNEL_MODES = ("auto", "cuda", "torch")
ENV_VAR = "REPRO_TORCH_KERNELS"
_kernel_mode = None                     # None -> read the env var


def set_kernel_mode(mode: str | None) -> None:
    """Override the dispatch mode (None -> back to the env var)."""
    global _kernel_mode
    if mode is not None and mode not in KERNEL_MODES:
        raise ValueError(f"kernel mode {mode!r} not in {KERNEL_MODES}")
    _kernel_mode = mode


def kernel_mode() -> str:
    """The configured mode (may be "auto")."""
    if _kernel_mode is not None:
        return _kernel_mode
    env = os.environ.get(ENV_VAR, "auto")
    if env not in KERNEL_MODES:
        raise ValueError(f"{ENV_VAR}={env!r} not in {KERNEL_MODES}")
    return env


def resolved_mode(x: torch.Tensor) -> str:
    """The implementation for tensors like ``x``: "cuda" or "torch"."""
    mode = kernel_mode()
    if mode == "auto":
        return "cuda" if x.is_cuda else "torch"
    if mode == "cuda" and not x.is_cuda:
        raise RuntimeError(f"{ENV_VAR}=cuda but the tensors are on "
                           f"{x.device}")
    return mode


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {"paged_decode_attention": PDA.launches}


def reset_launch_counts() -> None:
    PDA.reset_launches()


def _gather(pool, pages, kv_bucket, page_size):
    B = pages.shape[0]
    pid = pages[:, :kv_bucket // page_size].long()          # (B, npg)
    return pool[pid].reshape(B, kv_bucket, *pool.shape[2:])


def decode_attention_paged(q, k_pool, v_pool, pages, lengths, *, kv_bucket,
                           page_size, window=None, chunk=None, softcap=0.0):
    """Decode attention for the paged layout.

    q: (B,1,Hq,dh); pools: (n_pages, page_size, Hkv, dh); pages: (B,P)
    int32 physical-page table; lengths: (B,) int32 live entries per row.
    ``kv_bucket`` (a multiple of page_size) bounds how many logical entries
    the plain path gathers; the kernel reads the pages straight from the
    pool and stops at each row's length."""
    if resolved_mode(q) == "cuda" and not softcap:
        return PDA.paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool, pages, lengths,
            window=window, chunk=chunk)[:, None]
    from repro_torch.models.attention import decode_attention
    kb = _gather(k_pool, pages, kv_bucket, page_size)
    vb = _gather(v_pool, pages, kv_bucket, page_size)
    return decode_attention(q, kb, vb, pos=lengths - 1, window=window,
                            chunk=chunk, softcap=softcap)


def window_attention_paged(q, k_pool, v_pool, pages, pos, *, kv_bucket,
                           page_size, window=None, chunk=None, softcap=0.0):
    """W-token decode-window attention for the paged layout.

    q: (B,W,Hq,dh), W consecutive new positions per row whose KV the
    caller already wrote into the pool at pos..pos+W-1; pos: (B,) each
    row's first new position. The kernel path is W calls of the 1-token
    kernel (offset w attends through pos+w); the plain path is one page
    gather + blockwise attention with per-offset causal masking."""
    if resolved_mode(q) == "cuda" and not softcap:
        W = q.shape[1]
        outs = [PDA.paged_decode_attention(
                    q[:, w].contiguous(), k_pool, v_pool, pages,
                    (pos + w + 1).to(torch.int32), window=window, chunk=chunk)
                for w in range(W)]
        return torch.stack(outs, dim=1)
    from repro_torch.models.attention import blockwise_attention
    B, W = q.shape[:2]
    kb = _gather(k_pool, pages, kv_bucket, page_size)
    vb = _gather(v_pool, pages, kv_bucket, page_size)
    q_pos = pos[:, None] + torch.arange(W, dtype=torch.int32,
                                        device=q.device)[None, :]
    kv_pos = torch.arange(kv_bucket, dtype=torch.int32,
                          device=q.device)[None, :].expand(B, kv_bucket)
    return blockwise_attention(q, kb, vb, causal=True, window=window,
                               chunk=chunk, q_positions=q_pos,
                               kv_positions=kv_pos, softcap=softcap)
