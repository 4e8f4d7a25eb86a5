"""Plain PyTorch oracles (naive, materialised softmax) for the attention
kernels: the port's counterparts of ``repro.kernels.ref``'s
``attention_ref`` and ``decode_attention_ref``. Scores and softmax run in
float32 whatever the input dtype; the result comes back in q's dtype."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, chunk=None,
                  kv_len=None, softcap=0.0):
    """q: (B,Hq,Sq,dh); k,v: (B,Hkv,Sk,dh). Naive materialized softmax."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kg = k.repeat_interleave(G, dim=1).float()
    vg = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kg) * (dh ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= (qpos - kpos) < window
    if chunk is not None:
        ok &= torch.div(qpos, chunk, rounding_mode="floor") == \
            torch.div(kpos, chunk, rounding_mode="floor")
    if kv_len is not None:
        ok &= kpos < kv_len
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vg).to(q.dtype)


def decode_attention_ref(q, k, v, *, lengths, window=None, chunk=None):
    """q: (B,Hq,dh); k,v: (B,Skmax,Hkv,dh); lengths: (B,) valid cache length.
    Query position = lengths - 1."""
    B, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kg = k.repeat_interleave(G, dim=2).float()
    vg = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kg) * (dh ** -0.5)
    lengths = lengths.to(torch.int64)
    qpos = (lengths - 1)[:, None, None]
    kpos = torch.arange(Sk, device=q.device)[None, None, :]
    ok = kpos < lengths[:, None, None]
    if window is not None:
        ok &= (qpos - kpos) < window
    if chunk is not None:
        ok &= torch.div(qpos, chunk, rounding_mode="floor") == \
            torch.div(kpos, chunk, rounding_mode="floor")
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vg).to(q.dtype)
