"""Shared model building blocks: the port's copy of ``repro.models.layers``
for the dense transformer (plain functions on tensors)."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- init utils

def ninit(shape, dtype, device, generator, scale=None):
    """Truncated-normal (+-2 sigma) init with 1/sqrt(fan_in) default scale,
    drawn directly in ``dtype`` on ``device`` (no float32 staging copy of
    multi-GB stacked weights)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def zinit(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def oinit(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


# ------------------------------------------------------------------- norms

def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE

@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim/2,) float32 inverse frequencies, computed once per
    (head_dim, theta, device) on the host and copied over: a scalar made
    on the card each call would be a blocking host-to-device copy, twice
    per layer per step."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return freqs.to(device)


def apply_rope(x, positions, theta: float):
    """Split-half RoPE. x: (..., S, H, dh); positions: broadcastable to
    (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., None].float() * freqs           # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- MLP

def mlp_apply(x, w_up, w_down, kind: str):
    """SwiGLU MLP. w_up: (d, 2f) holding [gate | up]; w_down: (f, d)."""
    if kind != "swiglu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet "
                                  "(qwen2-7b uses swiglu)")
    h = x @ w_up.to(x.dtype)
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down.to(x.dtype)


def mlp_up_width(d_ff: int, kind: str) -> int:
    return 2 * d_ff if kind in ("swiglu", "geglu") else d_ff


def init_mlp(d_model, d_ff, kind, dtype, device, generator, stacked=()):
    up = stacked + (d_model, mlp_up_width(d_ff, kind))
    down = stacked + (d_ff, d_model)
    return {"w_up": ninit(up, dtype, device, generator),
            "w_down": ninit(down, dtype, device, generator)}


# ---------------------------------------------------------------- embedding

def embed_lookup(embed, tokens):
    return embed[tokens.long()]
