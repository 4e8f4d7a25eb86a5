"""Serving helpers over the model: the port's copy of the serving half of
``repro.models.model_api`` (bucketing, the paged cache, prefill scatter
and the fused decode loop).

The reference builds pure functions for ``jit`` with donated buffers; here
the cache's pools are persistent tensors updated in place. The dense slot
slab (``init_slab_cache`` / ``scatter_prefill``) and ``decode_window``
wait for their slices (ROADMAP A6, A7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def supports_slots(cfg: ArchConfig) -> bool:
    """True when the family's decode cache is a pure KV pool whose rows are
    independent requests (the dense transformer, in this port so far)."""
    return cfg.family == "dense" and cfg.moe is None


def pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= n, clamped to [lo, hi]. Padding shapes to
    these buckets bounds the number of distinct kernel shapes to O(log)."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(max(b, lo), hi)


def bucket_ladder(lo: int, hi: int):
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


def init_paged_cache(cfg: ArchConfig, rows: int, n_pages: int,
                     page_size: int, device="cuda"):
    """Paged decode cache: a shared physical pool of ``n_pages`` KV pages
    of ``page_size`` entries per layer ((L, n_pages, page_size, kvh, dh)),
    plus a per-row position vector for ``rows`` slots. Which pages a row
    owns lives host-side (the runtime's page table / allocator); physical
    page 0 is reserved as the null page."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros(rows, dtype=torch.int32, device=dev),
            "dense": {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
                      "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}}


def scatter_prefill_paged(cfg: ArchConfig, slab, prefill_cache, slot_idx,
                          seq_len, page_rows, page_size: int):
    """Split a prefilled (B, seq_len) KV cache into page-size chunks and
    write them in place into the pool pages named by ``page_rows``
    ((B, ceil(seq_len/page)) int), stamping positions for rows
    ``slot_idx``. Pad rows aim all their chunks at the null page (0);
    colliding writes there are never read. Returns ``slab``."""
    npg = page_rows.shape[1]
    flat = page_rows.reshape(-1).long()
    for nm in ("k", "v"):
        src = prefill_cache["dense"][nm]           # (L, B, S, kvh, dh)
        L, B, S = src.shape[:3]
        src = F.pad(src, (0, 0, 0, 0, 0, npg * page_size - S))
        src = src.reshape(L, B * npg, page_size, *src.shape[3:])
        dst = slab["dense"][nm]
        dst[:, flat] = src.to(dst.dtype)
    slab["pos"][slot_idx.long()] = seq_len
    return slab


@torch.no_grad()
def fused_decode(params, tok, cache, active, remaining, cfg: ArchConfig,
                 steps: int, pages, kv_bucket):
    """``steps`` greedy decode steps in one loop with no host sync (the
    reference fuses them into one ``lax.scan``). Rows where ``active`` is
    False are frozen: their position does not advance and their token does
    not change, so finished requests stop paying for rides they do not
    take. The page table is constant across the block — the host
    pre-allocates pages covering every row's position through the final
    step — and ``kv_bucket`` must cover max(pos) + steps.

    tok: (S, 1) int32; active: (S,) bool; remaining: (S,) int32.
    Returns (tok, cache, active, remaining, tokens (steps, S))."""
    toks = []
    for _ in range(steps):
        pos0 = cache["pos"]
        logits, cache = transformer.decode_step(params, tok, cache, cfg,
                                                pages=pages,
                                                kv_bucket=kv_bucket)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tok = torch.where(active[:, None], nxt, tok)
        cache["pos"] = torch.where(active, cache["pos"], pos0)
        remaining = remaining - active.to(torch.int32)
        active = active & (remaining > 0)
        toks.append(nxt[:, 0])
    return tok, cache, active, remaining, torch.stack(toks)
