"""Decoder-only dense transformer: the port's copy of
``repro.models.transformer`` for serving (``init``, ``prefill`` and the
paged ``decode_step``).

Params are a plain dict with the reference's keys; per-layer weights are
stacked with the layer dim leading ("dense_layers"), so the reference's
param tree carries over unchanged (``models.convert.params_from_jax``).
Layers run as a Python loop over that dim. ``decode_step`` writes the new
token's KV into the pool in place (the reference's functional ``.at[]``
update plus buffer donation). MoE layers and the dense slab layout wait
for their slices (ROADMAP A11, A6).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as OPS
from repro_torch.models import layers as L
from repro_torch.models.attention import blockwise_attention


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.moe is not None or cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  "yet (ROADMAP A11, A12)")


# ------------------------------------------------------------------ params

def init(cfg: ArchConfig, device="cuda", generator=None, seed: int = 0):
    """Random params in ``cfg.torch_dtype`` made on ``device`` from
    ``generator`` (or a fresh one seeded with ``seed``)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    d, dt, n = cfg.d_model, cfg.torch_dtype, cfg.n_layers
    kw = dict(dtype=dt, device=dev)
    params = {
        "embed": L.ninit((cfg.vocab, d), generator=generator, scale=1.0, **kw),
        "final_norm": L.oinit((d,), **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.ninit((d, cfg.vocab), generator=generator, **kw)
    blk = {
        "ln1": L.oinit((n, d), **kw),
        "wq": L.ninit((n, d, cfg.q_dim), generator=generator, **kw),
        "wk": L.ninit((n, d, cfg.kv_dim), generator=generator, **kw),
        "wv": L.ninit((n, d, cfg.kv_dim), generator=generator, **kw),
        "wo": L.ninit((n, cfg.q_dim, d), generator=generator, **kw),
        "ln2": L.oinit((n, d), **kw),
    }
    if cfg.qkv_bias:
        blk["bq"] = L.zinit((n, cfg.q_dim), **kw)
        blk["bk"] = L.zinit((n, cfg.kv_dim), **kw)
        blk["bv"] = L.zinit((n, cfg.kv_dim), **kw)
    blk.update(L.init_mlp(d, cfg.d_ff, cfg.mlp, generator=generator,
                          stacked=(n,), **kw))
    params["dense_layers"] = blk
    return params


def _layers(stacked):
    """Per-layer views of the stacked weights."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: w[i] for k, w in stacked.items()} for i in range(n)]


def _lm_head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ------------------------------------------------------------ prefill/decode

def _qkv(h, blk, cfg, positions):
    """Projections + bias + RoPE. h: (B, S, d) -> q (B,S,Hq,dh), k, v
    (B,S,Hkv,dh)."""
    B, S = h.shape[:2]
    q = h @ blk["wq"].to(h.dtype)
    k = h @ blk["wk"].to(h.dtype)
    v = h @ blk["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + blk["bq"].to(h.dtype)
        k = k + blk["bk"].to(h.dtype)
        v = v + blk["bv"].to(h.dtype)
    q = L.apply_rope(q.reshape(B, S, cfg.n_heads, cfg.head_dim), positions,
                     cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim), positions,
                     cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)


def _ffn(x, blk, cfg):
    h2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(h2, blk["w_up"], blk["w_down"], cfg.mlp)


def _logits(params, x, cfg):
    xl = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return xl @ _lm_head(params, cfg).to(xl.dtype)


@torch.no_grad()
def prefill(params, tokens, cfg: ArchConfig):
    """Full-sequence prefill. tokens: (B, S) int. Returns (last_logits
    (B,V), cache {"dense": {"k","v": (L,B,S,Hkv,dh)}, "pos"})."""
    _dense_only(cfg)
    B, S = tokens.shape
    x = L.embed_lookup(params["embed"], tokens).to(cfg.torch_dtype)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    ks, vs = [], []
    for blk in _layers(params["dense_layers"]):
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, blk, cfg, positions)
        out = blockwise_attention(
            q, k, v, causal=True, window=cfg.sliding_window,
            chunk=cfg.attn_chunk, q_positions=positions,
            kv_positions=positions, softcap=cfg.logit_softcap)
        x = x + out.reshape(B, S, cfg.q_dim) @ blk["wo"].to(h.dtype)
        x = _ffn(x, blk, cfg)
        ks.append(k)
        vs.append(v)
    logits = _logits(params, x[:, -1:], cfg)[:, 0]
    cache = {"dense": {"k": torch.stack(ks), "v": torch.stack(vs)},
             "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    return logits, cache


@torch.no_grad()
def decode_step(params, token, cache, cfg: ArchConfig, *, pages, kv_bucket):
    """One decode step over the paged cache. token: (B, 1) int.

    ``cache["pos"]`` is a (B,) vector (or scalar) of per-row positions;
    ``cache["dense"]["k"|"v"]`` are pools of fixed-size KV pages
    ((L, n_pages, page_size, Hkv, dh)) and ``pages`` ((B, P) int32) is
    the physical-page table. The new token's KV is written in place into
    each row's current page; attention reads the row's pages through
    ``kernels.ops`` (the CUDA kernel, or a gather of the first
    ``kv_bucket`` logical entries on the plain path). Physical page 0 is
    the null page: pad and retired rows point there, and what they write
    there is never read. Returns (logits (B,V), cache) with the same pool
    tensors and ``pos`` advanced by one."""
    _dense_only(cfg)
    B = token.shape[0]
    pos = cache["pos"]
    pos_b = pos.to(torch.int32).expand(B).contiguous()            # (B,)
    x = L.embed_lookup(params["embed"], token[:, 0])[:, None, :].to(
        cfg.torch_dtype)
    positions = pos_b[:, None]                                    # (B, 1)
    pages = pages.to(torch.int32)
    kc, vc = cache["dense"]["k"], cache["dense"]["v"]
    page_size = kc.shape[2]
    lp = (pos_b // page_size).long()                 # logical page
    off = (pos_b % page_size).long()                 # offset within it
    phys = pages.gather(1, lp[:, None])[:, 0].long()
    lengths = pos_b + 1
    for i, blk in enumerate(_layers(params["dense_layers"])):
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, blk, cfg, positions)
        k_l, v_l = kc[i], vc[i]
        k_l[phys, off] = k[:, 0].to(k_l.dtype)
        v_l[phys, off] = v[:, 0].to(v_l.dtype)
        out = OPS.decode_attention_paged(
            q, k_l, v_l, pages, lengths, kv_bucket=kv_bucket,
            page_size=page_size, window=cfg.sliding_window,
            chunk=cfg.attn_chunk, softcap=cfg.logit_softcap)
        x = x + out.reshape(B, 1, cfg.q_dim) @ blk["wo"].to(h.dtype)
        x = _ffn(x, blk, cfg)
    logits = _logits(params, x, cfg)[:, 0]
    return logits, {"pos": pos + 1, "dense": {"k": kc, "v": vc}}
