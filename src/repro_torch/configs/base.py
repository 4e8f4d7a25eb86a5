"""Architecture configuration: the port's copy of ``repro.configs.base``.

Every architecture is a frozen ``ArchConfig``; ``get_config`` maps an
``--arch <id>`` string to its factory, and ``reduced()`` produces the
family-preserving small config the CPU tests use. The fields are the
reference's, so a reduced config here equals the reference's field for
field; ``torch_dtype`` takes the place of the reference's ``jdtype``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_k_dense: int = 0  # deepseek: first layer(s) stay dense
    dispatch: str = "local"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    d_inner: int = 0          # inner width of the SSM branch
    dt_rank: int = 0


@dataclass(frozen=True)
class XLSTMConfig:
    group_size: int = 8       # layers per super-block: (group_size-1) mLSTM + 1 sLSTM
    proj_factor_m: float = 2.0
    proj_factor_s: float = 4.0 / 3.0
    conv_width: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 0
    enc_seq: int = 1500       # whisper audio frames after conv frontend (stubbed)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mlp: str = "swiglu"       # swiglu | geglu | relu2 | none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # attention locality: per-layer window override. None => full causal.
    sliding_window: Optional[int] = None
    global_every: int = 0     # if >0 with sliding_window: every k-th layer is global
    attn_chunk: Optional[int] = None   # llama4 iRoPE-style chunked attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[str] = None     # audio | vision (stubbed embeddings)
    frontend_seq: int = 0
    n_meta_tokens: int = 0             # hymba learnable meta tokens
    dtype: str = "bfloat16"
    subquadratic: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1)) or 1),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            frontend_seq=16 if self.frontend_seq else 0,
            n_meta_tokens=4 if self.n_meta_tokens else 0,
            dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = replace(
                self.moe,
                n_routed=4,
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_ff_expert=32 if self.moe.d_ff_expert else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
            )
        if self.ssm is not None:
            changes["ssm"] = replace(self.ssm, state_dim=8, d_inner=128, dt_rank=8)
        if self.xlstm is not None:
            changes["xlstm"] = replace(self.xlstm, group_size=2)
            changes["n_layers"] = 4  # 2 groups of (1 mLSTM + 1 sLSTM)
        if self.encdec is not None:
            changes["encdec"] = replace(self.encdec, n_enc_layers=2, enc_seq=16)
        if self.sliding_window is not None:
            changes["sliding_window"] = 8
        if self.attn_chunk is not None:
            changes["attn_chunk"] = 16
        return replace(self, **changes)


# the architectures this port serves so far; the rest join with their slice
_MODULES = ("qwen2_7b",)

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        for mod in _MODULES:
            importlib.import_module(f"repro_torch.configs.{mod}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
