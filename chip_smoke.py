#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on any failure:

1. the card: refuse to run without CUDA; print the card's name and power
   limit as ``nvidia-smi`` gives them;
2. build the sm_90a paged decode-attention kernel from ``src/repro_torch/
   csrc`` and print the build seconds;
3. hold the kernel against its plain PyTorch version at qwen2-7b's
   attention shapes (Hq=28, Hkv=4, dh=128, page 16) in bf16 and f32, with
   window/chunk variants and null-page table entries, and the W=4 window
   path; time kernel and plain version with CUDA events at the serving
   path's shapes, L2 flushed before every launch;
4. build full-width qwen2-7b in bf16 on the card from a seeded generator
   and serve a seeded request mix through ``DecodeRuntime`` (paged pool),
   checking every request's token count, the allocator books after every
   step, the bucketing bound and that the kernel ran;
5. one full-width paged decode step under the kernel and under the plain
   path on the same cache: logits must agree within a bf16 tolerance;
6. reduced qwen2-7b in f32 on the card: greedy tokens with the kernel and
   with the plain path must be identical.

Prints one JSON object per phase, the kernel table line, and as its last
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the
JAX package.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNEL_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
# bf16 logits after 28 layers: the two paths round attention outputs to
# bf16 at different elements, and the residual stream carries it on
LOGIT_REL_TOL = 5e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card():
    check(torch.cuda.is_available(), "torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in full f32
    torch.backends.cudnn.allow_tf32 = False


def paged_inputs(gen, dtype, lengths, *, G=7, Hkv=4, dh=128, ps=16, P=9):
    """Pools with one distinct random page per live logical page of every
    row, and the null page 0 past each length."""
    dev = "cuda"
    B = len(lengths)
    n_pages = B * P + 1
    q = torch.randn(B, Hkv * G, dh, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, ps, Hkv, dh, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pages, ps, Hkv, dh, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)[:B * P] + 1
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = torch.arange(P, device=dev)[None, :] < (lengths[:, None] + ps - 1) // ps
    pages = torch.where(live, perm.reshape(B, P), 0).to(torch.int32)
    return q, kp, vp, pages.contiguous(), lengths


def time_cold(fn, iters=50):
    """Mean ms per call by CUDA events, the L2 cache flushed before each
    call as the serving path finds it (weights stream between layers)."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_phase(PDA, ops):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    lengths = [1, 16, 17, 144, 33, 64, 100, 129]      # B=8, P=9, ps=16
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = KERNEL_TOL[dtype]
        for window, chunk in ((None, None), (32, None), (None, 64),
                              (48, 64)):
            args = paged_inputs(gen, dtype, lengths)
            got = PDA.paged_decode_attention(*args, window=window,
                                             chunk=chunk)
            want = PDA.paged_decode_attention_plain(*args, window=window,
                                                    chunk=chunk)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            errs[f"{str(dtype)[6:]} window={window} chunk={chunk}"] = err
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=rtol)
        # W=4 window path: 4 kernel calls vs the plain gather + blockwise
        q, kp, vp, pages, lens = paged_inputs(gen, dtype, lengths)
        qw = torch.randn(len(lengths), 4, *q.shape[1:], generator=gen,
                         device="cuda").to(dtype)
        pos = (lens - 4).clamp_min(0)
        outs = {}
        try:
            for mode in ("cuda", "torch"):
                ops.set_kernel_mode(mode)
                outs[mode] = ops.window_attention_paged(
                    qw, kp, vp, pages, pos, kv_bucket=144, page_size=16)
        finally:
            ops.set_kernel_mode(None)
        torch.cuda.synchronize()
        errs[f"{str(dtype)[6:]} window_attention_paged W=4"] = \
            (outs["cuda"].float() - outs["torch"].float()).abs().max().item()
        torch.testing.assert_close(outs["cuda"].float(),
                                   outs["torch"].float(), atol=atol, rtol=rtol)
    emit(phase="kernel_check", tol={str(k)[6:]: v for k, v in
                                    KERNEL_TOL.items()}, max_abs_err=errs)

    # timing at the serving path's shapes: 9 rows (8 slots + the overflow
    # row), 9 pages per row, bf16
    rng = np.random.default_rng(1)
    lens = [int(x) for x in rng.integers(9, 130, 8)] + [1]
    args = paged_inputs(gen, torch.bfloat16, lens)
    q = args[0]
    ms = time_cold(lambda: PDA.paged_decode_attention(*args))
    plain_ms = time_cold(lambda: PDA.paged_decode_attention_plain(*args))
    got = PDA.paged_decode_attention(*args)
    want = PDA.paged_decode_attention_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    # least time: read q, the live K/V entries, the table and lengths once,
    # write the output once; 4 flops per (query head, live key, dim)
    live = sum(lens)
    Hq, dh = q.shape[1], q.shape[2]
    Hkv = args[1].shape[2]
    e = q.element_size()
    nbytes = (2 * q.numel() * e + 2 * live * Hkv * dh * e
              + args[3].numel() * 4 + args[4].numel() * 4)
    flops = 4 * Hq * dh * live
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    timing = dict(lengths=lens, ms=ms, plain_ms=plain_ms,
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                  bytes=nbytes, flops=flops, max_abs_err=err)
    emit(phase="kernel_timing", **timing)
    return timing


def serve_phase(cfg, params, RT, ops, RequestSource, n_requests=24):
    rc = RT.RuntimeConfig(paged=True, max_batch=8, page_size=16)
    kernels = RT.TorchRuntimeKernels(cfg, rc, device="cuda")
    rt = RT.DecodeRuntime(kernels, params)
    src = RequestSource(seed=0, prompt_range=(8, 64), max_new_range=(8, 64))
    reqs, now = [], 0.0
    while len(reqs) < n_requests:
        reqs += src.arrivals(now, 1.0, 8.0)
        now += 1.0
    reqs = reqs[:n_requests]
    check(all(rt.fits(r) for r in reqs), "a request does not fit the pool")
    rt.submit(reqs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = []
    while rt.inflight:
        done += rt.step()
        used = sum(len(s.pages) for s in rt.slots if s.busy)
        check(rt.alloc.used_pages == used, "allocator disagrees with slots")
        check(rt.alloc.used_pages + rt.alloc.free_pages
              == rt.alloc.pool_pages, "allocator books do not balance")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["paged_decode_attention"]
    check(sorted(f.req.rid for f in done) == sorted(r.rid for r in reqs),
          "not every request was served exactly once")
    check(all(f.tokens == f.req.max_new for f in done),
          "a request got other than max_new tokens")
    check(rt.alloc.used_pages == 0 and not rt.page_table.any(),
          "pages still held after the last request")
    n_traces = sum(kernels.trace_counts.values())
    check(n_traces <= kernels.max_traces, "bucketing bound exceeded")
    check(launches > 0, "the paged kernel never ran on the serving path")
    check(launches % cfg.n_layers == 0, "launches not one per layer per step")
    tokens = sum(r.max_new for r in reqs)
    res = dict(requests=len(reqs), tokens=tokens, seconds=wall,
               tokens_per_s=tokens / wall, decode_blocks=rt.steps_dispatched,
               kernel_launches=launches,
               decode_steps=launches // cfg.n_layers,
               launches_per_step=cfg.n_layers,
               traces=kernels.trace_counts, max_traces=kernels.max_traces,
               pages_hwm=rt.pages_hwm, pool_pages=rt.alloc.pool_pages,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(phase="serve", **res)
    return rt, reqs, res


def logits_phase(cfg, params, rt, T, ops, Request):
    """One decode step under each path on clones of one live cache; the
    step's wall time (host clock, synchronised) under each path too."""
    reqs = [Request(1000 + i, 0.0, 8 + 7 * i, 40) for i in range(8)]
    rt.submit(reqs)
    rt._admit_some()                 # prefill + fused tails: a live cache
    pages = rt._device_pages()
    kvb = rt._kv_bucket(1)

    def step():
        cache = {"pos": rt.cache["pos"].clone(),
                 "dense": {k: v.clone() for k, v in rt.cache["dense"].items()}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = T.decode_step(params, rt.tok.clone(), cache, cfg,
                               pages=pages, kv_bucket=kvb)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    logits, step_ms = {}, {}
    try:
        for mode in ("cuda", "torch"):
            ops.set_kernel_mode(mode)
            logits[mode], _ = step()
            step_ms[mode] = sum(step()[1] for _ in range(3)) / 3
    finally:
        ops.set_kernel_mode(None)
    a, b = logits["cuda"].float(), logits["torch"].float()
    check(bool(torch.isfinite(a).all()), "non-finite logits")
    check(tuple(a.shape) == (rt.kernels.rcfg.max_batch + 1, cfg.vocab),
          f"logits shape {tuple(a.shape)}")
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    rows = [i for i, s in enumerate(rt.slots) if s.busy]
    agree = int((a[rows].argmax(-1) == b[rows].argmax(-1)).sum())
    res = dict(max_abs_diff=diff, max_abs_logit=scale,
               rel_tol=LOGIT_REL_TOL, argmax_agree=f"{agree}/{len(rows)}",
               live_rows=len(rows), kv_bucket=kvb, step_ms=step_ms)
    emit(phase="decode_logits", **res)
    check(diff <= LOGIT_REL_TOL * scale, f"logits differ by {diff:.4g}, "
          f"above {LOGIT_REL_TOL} x {scale:.4g}")
    rt.drain()
    return res


def reduced_phase(get_config, T, RT, ops, Request):
    """Reduced qwen2-7b in f32 on the card: identical greedy tokens with
    the kernel and with the plain path."""
    cfg = get_config("qwen2-7b").reduced()
    params = T.init(cfg, device="cuda", seed=0)
    rc = RT.RuntimeConfig(paged=True, max_batch=4, page_size=16,
                          admit_tail=0)
    logs = {}
    try:
        for mode in ("cuda", "torch"):
            ops.set_kernel_mode(mode)
            rt = RT.DecodeRuntime(RT.TorchRuntimeKernels(cfg, rc), params,
                                  record_tokens=True)
            rt.submit([Request(i, 0.0, 5 + 6 * i, 3 + 5 * i)
                       for i in range(1, 9)])
            rt.pump()
            logs[mode] = rt.token_log
    finally:
        ops.set_kernel_mode(None)
    check(logs["cuda"] == logs["torch"], "reduced-model greedy tokens "
          "differ between the kernel and the plain path")
    emit(phase="reduced_tokens", requests=len(logs["cuda"]),
         tokens=sum(len(v) for v in logs["cuda"].values()), identical=True)


def main():
    card()
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import Request, RequestSource
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import paged_decode_attention as PDA
    from repro_torch.models import transformer as T
    from repro_torch.streaming import runtime as RT

    t0 = time.perf_counter()
    _build.load("paged_decode_attention")
    emit(phase="build", seconds=time.perf_counter() - t0)

    timing = kernel_phase(PDA, ops)

    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    params = T.init(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    emit(phase="init", arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         seconds=time.perf_counter() - t0,
         param_gb=sum(p.numel() * p.element_size() for blk in
                      (params, params["dense_layers"]) for p in blk.values()
                      if torch.is_tensor(p)) / 1e9)
    rt, _, serve = serve_phase(cfg, params, RT, ops, RequestSource)
    logits_phase(cfg, params, rt, T, ops, Request)
    del rt, params
    torch.cuda.empty_cache()
    reduced_phase(get_config, T, RT, ops, Request)

    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_decode_attention.py:73",
        "launches": serve["kernel_launches"],
        "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
