"""GQA attention in plain PyTorch: the port's copy of
``repro.models.attention``.

``blockwise_attention`` is the flash recurrence over KV blocks (prefill
and the W-token window path); ``decode_attention`` is the single-query
path over a dense cache, which the plain paged path feeds with gathered
pages. The reference's runtime block skipping (``block_skip``) waits for
the dense-slab slice (ROADMAP A6).

Mask model (all paths share it):
  allowed(qpos, kpos) = [kpos <= qpos if causal]
                      & [qpos - kpos < window if window]
                      & [qpos // chunk == kpos // chunk if chunk]
                      & [kpos < kv_len]
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
BLOCK_KV = 1024               # KV entries per block of the flash recurrence


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _mask(qpos, kpos, *, causal, window, chunk, kv_len):
    # qpos: (..., Sq, 1), kpos: (..., 1, Sk) int
    ok = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                    dtype=torch.bool, device=qpos.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= (qpos - kpos) < window
    if chunk is not None:
        ok &= _floordiv(qpos, chunk) == _floordiv(kpos, chunk)
    if kv_len is not None:
        ok &= kpos < kv_len
    return ok


def blockwise_attention(q, k, v, *, causal=True, window=None, chunk=None,
                        q_positions=None, kv_positions=None, softcap=0.0):
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh). Returns (B, Sq, Hq, dh).

    Streams KV in blocks with a running (max, denom, acc) softmax in
    float32 — the flash-attention recurrence, as a Python loop over
    blocks."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=dev)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(Sk, dtype=torch.int32, device=dev)[None, :]
    q_positions = q_positions.long()
    kv_positions = kv_positions.long().expand(B, Sk)

    qg = (q * dh ** -0.5).reshape(B, Sq, Hkv, G, dh).float()
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, dh), dtype=torch.float32, device=dev)
    qp = q_positions[:, :, None, None, None]
    for start in range(0, Sk, BLOCK_KV):
        kj = k[:, start:start + BLOCK_KV].float()
        vj = v[:, start:start + BLOCK_KV].float()
        posj = kv_positions[:, start:start + BLOCK_KV]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kj)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = _mask(qp, posj[:, None, None, None, :], causal=causal,
                   window=window, chunk=chunk, kv_len=Sk)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, pos, window=None, chunk=None,
                     softcap=0.0):
    """Single-token decode. q: (B, 1, Hq, dh); caches: (B, Smax, Hkv, dh)
    whose slot index is the absolute position; pos: scalar or (B,)
    current position (the cache holds pos+1 valid entries, the new
    token's KV already written at its slot). The reference's ring-aware
    ``kv_positions`` comes with the dense slab (ROADMAP A6)."""
    B, _, Hq, dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    dev = q.device
    pos = torch.as_tensor(pos, device=dev).long()
    qpos = pos.expand(B)[:, None]                                    # (B, 1)
    kv_positions = torch.arange(Smax, device=dev)[None, :].expand(B, Smax)

    # products of the storage dtype accumulate in float32, as the
    # reference's preferred_element_type=float32
    qg = (q * dh ** -0.5).reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    ok = _mask(qpos[:, :, None], kv_positions[:, None, :], causal=True,
               window=window, chunk=chunk,
               kv_len=(qpos + 1)[:, :, None])                     # (B, 1, Smax)
    s = torch.where(ok[:, :, None, :], s, NEG_INF)                 # (B,Hkv,G,Smax)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, dh).to(q.dtype)
