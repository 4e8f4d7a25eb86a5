"""Paged single-token decode attention: CUDA kernel wrapper + plain version.

Replaces ``repro/kernels/paged_decode_attention.py::
paged_decode_attention_kernel`` (Pallas, TPU). The KV cache is a shared
pool of fixed-size pages per layer ((n_pages, page_size, Hkv, dh)); row b's
logical page j is physical page ``pages[b, j]``, and page 0 is the null
page that pad and retired rows point at. The kernel itself is
``csrc/paged_decode_attention.cu`` (sm_90a); its header says what bounds
it (the live pages' bytes) and how its design reads each page once for
all G query heads of a kv head.

``paged_decode_attention`` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; there is no fallback from one to the
other. ``launches`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256           # 32 lanes x 8 elements per lane in the kernel
_SMEM_LIMIT = 48 * 1024       # static launch limit: no opt-in attribute set

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def paged_decode_attention_plain(q, k_pool, v_pool, pages, lengths, *,
                                 window=None, chunk=None):
    """Gather-then-softmax over every page of the table, in float32.

    q: (B,Hq,dh); pools: (n_pages, ps, Hkv, dh); pages: (B,P) int;
    lengths: (B,) -> (B,Hq,dh) in q's dtype. Normalises by max(l, 1e-30)
    as the kernel does, so a row of length 0 yields zeros."""
    B, Hq, dh = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    P = pages.shape[1]
    G = Hq // Hkv
    idx = pages.long()
    kb = k_pool[idx].reshape(B, P * ps, Hkv, dh).float()
    vb = v_pool[idx].reshape(B, P * ps, Hkv, dh).float()
    qg = q.float().reshape(B, Hkv, G, dh) * dh ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kb)
    lengths = lengths.long()
    qpos = (lengths - 1)[:, None]
    kpos = torch.arange(P * ps, device=q.device)[None, :]
    ok = kpos < lengths[:, None]
    if window is not None:
        ok &= (qpos - kpos) < window
    if chunk is not None:
        ok &= torch.div(qpos, chunk, rounding_mode="floor") == \
            torch.div(kpos, chunk, rounding_mode="floor")
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * ok
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vb) / l.clamp_min(1e-30)
    return out.reshape(B, Hq, dh).to(q.dtype)


def _check(q, k_pool, v_pool, pages, lengths, window, chunk):
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("pages", pages), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q, k_pool and v_pool must share one dtype")
    if pages.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("pages and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or pages.dim() != 2:
        raise ValueError("want q (B,Hq,dh), pools (n,ps,Hkv,dh), pages (B,P)")
    B, Hq, dh = q.shape
    n, ps, Hkv, dh_k = k_pool.shape
    if v_pool.shape != k_pool.shape or dh_k != dh:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= 32:
        raise ValueError(f"Hq={Hq} must be 1..32 times Hkv={Hkv}")
    if pages.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError("pages (B,P) and lengths (B,) must match q's batch")
    if dh > _MAX_HEAD_DIM or (dh * q.element_size()) % 16:
        raise ValueError(f"head_dim {dh} must be <= {_MAX_HEAD_DIM} and a "
                         "multiple of 16 bytes")
    if 2 * ps * dh * q.element_size() > _SMEM_LIMIT:
        raise ValueError(f"page of {ps}x{dh} exceeds the kernel's shared "
                         "memory")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, val in (("window", window), ("chunk", chunk)):
        if val is not None and val <= 0:
            raise ValueError(f"{name} must be positive or None, got {val}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The launcher from the shared library, built on first use."""
    from repro_torch.kernels import _build
    fn = _build.load("paged_decode_attention").paged_decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch(q, k_pool, v_pool, pages, lengths, window, chunk):
    global launches
    fn = _kernel()
    B, Hq, dh = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), pages.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), B, Hkv, Hq // Hkv, dh, ps, pages.shape[1],
                 window or 0, chunk or 0, dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, pages, lengths, *,
                           window=None, chunk=None):
    """q: (B,Hq,dh); pools: (n_pages, page_size, Hkv, dh); pages: (B,P)
    int32 physical-page table (entry 0 = the null page, only reachable
    past each row's length); lengths: (B,) int32 live entries per row ->
    (B,Hq,dh). CUDA tensors launch the sm_90a kernel (float32 or
    bfloat16, checked and raising on anything else); CPU tensors run the
    plain version."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pool, v_pool, pages,
                                            lengths, window=window,
                                            chunk=chunk)
    _check(q, k_pool, v_pool, pages, lengths, window, chunk)
    return _launch(q, k_pool, v_pool, pages, lengths, window, chunk)
