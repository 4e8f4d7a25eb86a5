"""Continuous-batching decode runtime over the paged KV pool: the port's
copy of ``repro.streaming.runtime``.

The host logic (page allocator, slot table, admission grouping, fused
decode blocks, harvest, checkpoint state) is the reference's, copied so
the port imports nothing of ``repro``. What differs is the device side:

- ``TorchRuntimeKernels`` takes the place of ``RuntimeKernels``. Its
  admission and decode functions update the persistent device buffers
  (KV pools, tok/active/remaining, positions) in place where the
  reference jits pure functions with donated buffers. They are keyed by
  the same bucket keys, and ``trace_counts`` counts the distinct keys
  built, so the bucketing contract (``max_traces``) reads the same.
- The first tokens and decoded tokens come back as host numpy arrays.
- The page table goes to the device only when the host table changed.

This slice serves the paged layout (``paged=True``) with ``admit_tail``
0 or 4. The dense slab, the prefix cache and speculative decode raise
``NotImplementedError`` naming the ROADMAP item that brings them.
Observability hooks (``tracer``, ``metrics``, ``profiler``) are
duck-typed and ``None`` by default.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import Request
from repro_torch.models import model_api as MA
from repro_torch.models import transformer


def requests_from_state(state) -> List[Request]:
    """Decode a checkpointed slot table back into Request objects."""
    rids = np.asarray(state.get("inflight_rid", ()))
    if rids.size == 0:
        return []
    arrival = np.asarray(state["inflight_arrival"])
    plen = np.asarray(state["inflight_plen"])
    rem = np.asarray(state["inflight_remaining"])
    grp = np.asarray(state.get("inflight_group", np.zeros(rids.size)))
    pfx = np.asarray(state.get("inflight_pfxlen", np.zeros(rids.size)))
    ddl = np.asarray(state.get("inflight_deadline", np.zeros(rids.size)))
    pri = np.asarray(state.get("inflight_priority",
                               np.full(rids.size, 10)))
    trc = np.asarray(state.get("inflight_trace", np.zeros(rids.size)))
    return [Request(int(rids[i]), float(arrival[i]), int(plen[i]),
                    int(rem[i]), prefix_group=int(grp[i]),
                    prefix_len=int(pfx[i]), deadline=float(ddl[i]),
                    priority=int(pri[i]), trace_id=int(trc[i]))
            for i in range(rids.size)]


@dataclass(frozen=True)
class RuntimeConfig:
    """Static shape policy — one kernels cache entry per distinct value.
    Fields and defaults are the reference's (see its docstring); this
    slice runs ``paged=True`` only."""
    max_batch: int = 8            # slots in the slab
    min_prompt_bucket: int = 8
    max_prompt_bucket: int = 64
    max_new_cap: int = 64         # capacity headroom for generation
    decode_block: int = 16        # max fused steps per dispatch
    admit_tail: int = 4           # decode steps fused into each admission
    paged: bool = False           # paged KV pool vs dense per-slot slab
    page_size: int = 16           # KV entries per physical page
    pool_pages: int = 0           # pool size; 0 -> max_batch * pages_per_slot
    block_skip: int = 32          # dense-slab block skipping (ROADMAP A6)
    prefix_cache: bool = False    # prefix-sharing CoW (ROADMAP A7)
    spec_decode: int = 0          # speculative decode depth (ROADMAP A8)
    pending_cap: int = 0          # bounded pending queue (0 = unbounded)

    @property
    def capacity(self) -> int:
        return self.max_prompt_bucket + self.max_new_cap + 1 + self.spec_decode

    @property
    def pages_per_slot(self) -> int:
        return -(-self.capacity // self.page_size)

    @property
    def n_pool_pages(self) -> int:
        return self.pool_pages or self.max_batch * self.pages_per_slot

    @property
    def prompt_buckets(self) -> Tuple[int, ...]:
        return MA.bucket_ladder(self.min_prompt_bucket, self.max_prompt_bucket)

    @property
    def batch_buckets(self) -> Tuple[int, ...]:
        return MA.bucket_ladder(1, self.max_batch)

    @property
    def block_ladder(self) -> Tuple[int, ...]:
        return MA.bucket_ladder(min(4, self.decode_block), self.decode_block)

    @property
    def kv_ladder(self) -> Tuple[int, ...]:
        # page-granular logical KV-read buckets (a row at depth 33 reads 48)
        return tuple(self.page_size * (p + 1)
                     for p in range(self.pages_per_slot))

    def page_footprint(self, plen_bucket: int, max_new: int) -> int:
        """Physical pages a request owns for its whole life: prompt bucket
        + generation + the frozen-row write slot (mirrors capacity's +1)
        + speculative-draft overshoot when spec_decode is on."""
        return -(-(plen_bucket + max_new + 1 + self.spec_decode)
                 // self.page_size)

    def fits(self, req: Request) -> bool:
        if req.prompt_len > self.max_prompt_bucket:
            return False
        plen = MA.pow2_bucket(req.prompt_len, self.min_prompt_bucket,
                              self.max_prompt_bucket)
        if plen + req.max_new + 1 + self.spec_decode > self.capacity:
            return False
        return (not self.paged
                or self.page_footprint(plen, req.max_new) <= self.n_pool_pages)


class PageAllocator:
    """Reference-counted free list over the physical KV page pool (the
    prefix cache, ROADMAP A7, brings sharing). Page 0 is reserved as the
    null page: pad rows, retired slots and frozen rows write there;
    nothing reads it.

    Invariants: page 0 is never handed out; used + free == pool size at
    every step; ``alloc`` is all-or-nothing.
    """

    def __init__(self, pool_pages: int):
        self.pool_pages = pool_pages
        # LIFO: freshly freed pages are reused first (warm in cache)
        self._free = list(range(pool_pages, 0, -1))
        # refcount[p]: holders of physical page p (0 = on the free list)
        self.refcount = np.zeros(pool_pages + 1, np.int32)

    @property
    def n_pages(self) -> int:          # physical pool incl. the null page
        return self.pool_pages + 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.pool_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self.refcount[out] = 1
        return out

    def free(self, pages) -> List[int]:
        """Drop one reference per page; pages whose count hits zero return
        to the free list. Returns the pages actually released."""
        released = []
        for p in pages:
            assert self.refcount[p] > 0, f"double free of page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                released.append(p)
        return released


def _commit(out, tok, cache, active, remaining) -> None:
    """Copy ``fused_decode``'s results into the persistent buffers (the
    pools were already written in place)."""
    t, c, a, r, _ = out
    tok.copy_(t)
    cache["pos"].copy_(c["pos"])
    active.copy_(a)
    remaining.copy_(r)


class TorchRuntimeKernels:
    """Admission + fused-decode functions keyed by bucket, over persistent
    device buffers updated in place.

    ``trace_counts`` counts the distinct keys built (the reference counts
    jit traces), so the bucketing contract ("O(#buckets) distinct shapes
    under any request mix") stays a plain integer assertion."""

    def __init__(self, cfg: ArchConfig, rcfg: RuntimeConfig, device="cuda"):
        if not MA.supports_slots(cfg):
            raise ValueError(f"family {cfg.family!r} has no slot-slab decode")
        if not rcfg.paged:
            raise NotImplementedError("the dense slot slab (paged=False) is "
                                      "not ported yet (ROADMAP A6)")
        if rcfg.prefix_cache:
            raise NotImplementedError("prefix_cache is not ported yet "
                                      "(ROADMAP A7)")
        if rcfg.spec_decode:
            raise NotImplementedError("spec_decode is not ported yet "
                                      "(ROADMAP A8)")
        self.cfg, self.rcfg = cfg, rcfg
        self.device = resolve_device(device)
        self.trace_counts = {"admit": 0, "decode": 0}
        self._admit = {}                 # (batch_bucket, len_bucket, kvb) -> fn
        self._decode = {}                # (fused steps, kvb) -> fn

    @property
    def max_traces(self) -> int:
        """Bucketing contract of the paged layout: admissions per (batch,
        prompt) bucket — times the kv-read buckets when a fused tail rides
        along — plus decode blocks per (steps, kv-read) bucket."""
        n_kv = len(self.rcfg.kv_ladder)
        n_admit = len(self.rcfg.batch_buckets) * len(self.rcfg.prompt_buckets)
        if self.rcfg.admit_tail:
            n_admit *= n_kv
        return n_admit + len(self.rcfg.block_ladder) * n_kv

    def put(self, x) -> torch.Tensor:
        """A copy of host array ``x`` on the serving device (a copy, so a
        later host write to ``x`` never reaches a tensor in use)."""
        return torch.tensor(x, device=self.device)

    def admit_fn(self, bb: int, lb: int, kvb: int = 0):
        key = (bb, lb, kvb)
        if key in self._admit:
            return self._admit[key]
        self.trace_counts["admit"] += 1
        cfg, rcfg = self.cfg, self.rcfg
        tail = rcfg.admit_tail

        @torch.no_grad()
        def admit(params, tokens, cache, tok, active, remaining, slot_idx,
                  max_new, pages, prompt_pages):
            """Prefill ``tokens`` ((bb, lb) numpy) into rows ``slot_idx``
            and, with a fused tail, run ``admit_tail`` decode steps of the
            whole slab. Updates the buffers in place; returns the first
            greedy tokens as a (bb,) numpy array."""
            tokens, slot_idx, max_new, prompt_pages = (
                self.put(a) for a in (tokens, slot_idx, max_new,
                                      prompt_pages))
            slot_idx = slot_idx.long()
            logits, pcache = transformer.prefill(params, tokens, cfg)
            MA.scatter_prefill_paged(cfg, cache, pcache, slot_idx,
                                     tokens.shape[1], prompt_pages,
                                     rcfg.page_size)
            first = torch.argmax(logits, -1).to(torch.int32)
            # pad rows (batch bucket > group size) target the overflow row
            # with max_new = 0: they go inert after one masked step
            tok[slot_idx] = first[:, None]
            active[slot_idx] = max_new > 0
            remaining[slot_idx] = max_new
            if tail and kvb:
                _commit(MA.fused_decode(
                    params, tok, cache, active, remaining, cfg,
                    steps=tail, pages=pages, kv_bucket=kvb),
                    tok, cache, active, remaining)
            return first.cpu().numpy()

        self._admit[key] = admit
        return admit

    def decode_fn(self, steps: int, kvb: int):
        key = (steps, kvb)
        if key in self._decode:
            return self._decode[key]
        self.trace_counts["decode"] += 1
        cfg = self.cfg

        @torch.no_grad()
        def block(params, tok, cache, active, remaining, pages):
            """``steps`` fused greedy steps of the whole slab, in place;
            returns the tokens as a (steps, rows) numpy array."""
            out = MA.fused_decode(params, tok, cache, active, remaining,
                                  cfg, steps=steps, pages=pages,
                                  kv_bucket=kvb)
            _commit(out, tok, cache, active, remaining)
            return out[4].cpu().numpy()

        self._decode[key] = block
        return block


@dataclass
class _Slot:
    req: Optional[Request] = None
    remaining: int = 0
    lb: int = 0                       # prompt-length bucket at admission
    pages: Tuple[int, ...] = ()       # physical pages referenced

    @property
    def busy(self) -> bool:
        return self.req is not None

    @property
    def pos(self) -> int:
        """Current cache depth (host mirror of the device pos vector)."""
        return self.lb + (self.req.max_new - self.remaining)


@dataclass
class Finished:
    req: Request
    tokens: int                       # generated this runtime (<= req.max_new)


@dataclass
class DecodeRuntime:
    """Per-replica serving state: the paged pool + a host-side slot table."""
    kernels: TorchRuntimeKernels
    params: dict
    pending: List[Request] = field(default_factory=list)
    slots: List[_Slot] = field(default_factory=list)
    # request content store: rid -> prompt tokens (length-bucket shaped);
    # checkpointed with the slot table so restored rids replay exactly
    content: Dict[int, np.ndarray] = field(default_factory=dict)
    steps_dispatched: int = 0         # fused blocks run (for perf telemetry)
    record_tokens: bool = False       # keep per-request token ids (tests)
    token_log: Dict[int, list] = field(default_factory=dict)
    token_log_cap: int = 0
    token_log_dropped: Dict[int, int] = field(default_factory=dict)
    # observability hooks (None = disabled): ``name`` is the replica
    # identity stamped on spans; ``sim_now`` mirrors the engine clock
    name: str = ""
    tracer: object = None
    metrics: object = None            # per-pod registry (TTFT histogram)
    profiler: object = None           # tick profiler (pump phase timing)
    sim_now: float = 0.0

    def __post_init__(self):
        rcfg = self.kernels.rcfg
        if self.record_tokens and rcfg.admit_tail:
            raise ValueError("record_tokens needs admit_tail=0 (tail-step "
                             "token ids never leave the admission dispatch)")
        self.slots = [_Slot() for _ in range(rcfg.max_batch)]
        # one extra overflow row: admissions pad their batch up to a
        # power-of-two bucket and aim the pad rows here
        rows = rcfg.max_batch + 1
        self.alloc = PageAllocator(rcfg.n_pool_pages)
        # host-owned page table: row -> physical pages (0 = null). Freed
        # rows are re-pointed at the null page before their pages can be
        # re-granted, so a frozen row's idempotent KV write can never
        # corrupt a successor request's page.
        self.page_table = np.zeros((rows, rcfg.pages_per_slot), np.int32)
        self.pages_hwm = 0                  # pool high-water (telemetry)
        self._pages_dev = None              # device copy of the page table
        self._pages_dirty = True
        dev = self.kernels.device
        self.cache = MA.init_paged_cache(self.kernels.cfg, rows,
                                         self.alloc.n_pages, rcfg.page_size,
                                         device=dev)
        self.tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
        self.active = torch.zeros((rows,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((rows,), dtype=torch.int32, device=dev)

    def _device_pages(self) -> torch.Tensor:
        """Device copy of the page table, refreshed only when the host
        table mutated (admission/retirement)."""
        if self._pages_dirty:
            self._pages_dev = self.kernels.put(self.page_table)
            self._pages_dirty = False
        return self._pages_dev

    def _kv_bucket(self, steps: int, incoming=()) -> int:
        """Smallest kv-read bucket covering every live row's cache depth at
        the end of a ``steps``-deep fused block (``incoming`` rows are
        (lb, max_new) pairs about to be admitted at depth lb)."""
        need = 1
        for s in self.slots:
            if s.busy:
                need = max(need, s.pos + min(steps, s.remaining))
        for lb, max_new in incoming:
            need = max(need, lb + min(steps, max_new))
        ladder = self.kernels.rcfg.kv_ladder
        return next((b for b in ladder if b >= need), ladder[-1])

    # -------------------------------------------------------------- intake
    def submit(self, requests: List[Request],
               force: bool = False) -> List[Request]:
        """Enqueue requests; returns the overflow rejected by the bounded
        pending queue. ``force=True`` bypasses the cap (restored work)."""
        cap = self.kernels.rcfg.pending_cap
        if force or cap <= 0:
            self.pending.extend(requests)
            return []
        room = max(cap - len(self.pending), 0)
        self.pending.extend(requests[:room])
        return list(requests[room:])

    def fits(self, req: Request) -> bool:
        return self.kernels.rcfg.fits(req)

    def _log_tokens(self, rid: int, toks: list) -> None:
        """Append to the per-rid greedy log, trimming the oldest entries
        past ``token_log_cap`` and counting the drop."""
        log = self.token_log.setdefault(rid, [])
        log.extend(toks)
        cap = self.token_log_cap
        if cap and len(log) > cap:
            drop = len(log) - cap
            del log[:drop]
            self.token_log_dropped[rid] = \
                self.token_log_dropped.get(rid, 0) + drop

    @property
    def inflight(self) -> int:
        return sum(s.busy for s in self.slots) + len(self.pending)

    # ---------------------------------------------------------- admission
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.busy]

    def _admit_some(self) -> List[Finished]:
        """Admit pending requests into free slots: group by (prompt-length
        bucket, depth bucket), largest group first, one padded prefill per
        group. Hysteresis: while decode is mid-stream, wait until a couple
        of slots are free rather than paying one prefill per freed slot."""
        if not self.pending:
            return []
        rcfg = self.kernels.rcfg
        free = self._free_slots()
        busy = rcfg.max_batch - len(free)
        if busy and len(free) < min(len(self.pending),
                                    max(2, rcfg.max_batch // 2)):
            return []
        done: List[Finished] = []
        while free and self.pending:
            groups: Dict[tuple, List[Request]] = {}
            for r in self.pending:
                lb = MA.pow2_bucket(r.prompt_len, rcfg.min_prompt_bucket,
                                    rcfg.max_prompt_bucket)
                db = MA.pow2_bucket(max(r.max_new, 1), 1, rcfg.max_new_cap)
                groups.setdefault((lb, db), []).append(r)
            (lb, _), group = max(groups.items(), key=lambda kv: len(kv[1]))
            # within the depth bucket, longest-first keeps fused blocks tight
            group = sorted(group, key=lambda r: -r.max_new)[:len(free)]
            # all-or-nothing page grant per request; a request the pool
            # cannot hold right now stays pending until a retirement
            grants: Dict[int, List[int]] = {}
            for r in group:
                pgs = self.alloc.alloc(rcfg.page_footprint(lb, r.max_new))
                if pgs is None:
                    break
                grants[id(r)] = pgs
            group = group[:len(grants)]
            if not group:
                break
            self.pages_hwm = max(self.pages_hwm, self.alloc.used_pages)
            taken = set(id(r) for r in group)
            self.pending = [r for r in self.pending if id(r) not in taken]
            take, free = free[:len(group)], free[len(group):]
            done.extend(self._admit_batch(group, take, lb, grants))
        return done

    def _prompt_tokens(self, r: Request, lb: int) -> np.ndarray:
        """Content-store lookup: a request's prompt tokens are minted once,
        deterministic in (rid, length bucket), and replayed verbatim on
        every later admission, including after a checkpoint/restore. A
        request with a prefix identity gets its group's common tokens up
        front (salted with ``hash(("prefix", group))`` as in the reference,
        so they match the reference only within one process)."""
        tok = self.content.get(r.rid)
        if tok is None or tok.shape[0] != lb:
            rng = np.random.default_rng(hash((r.rid, lb)) % (2 ** 31))
            tok = rng.integers(0, self.kernels.cfg.vocab, lb).astype(np.int32)
            pfx = min(r.prefix_len, lb) if r.prefix_group else 0
            if pfx:
                grng = np.random.default_rng(
                    hash(("prefix", r.prefix_group)) % (2 ** 31))
                tok[:pfx] = grng.integers(0, self.kernels.cfg.vocab, pfx)
            self.content[r.rid] = tok
        return tok

    def _note_admission(self, reqs: List[Request], lb: int) -> None:
        """Observability tail of an admission wave: per-rid ``admit``
        spans, one ``prefill`` span and the TTFT histogram."""
        if self.metrics is not None:
            h = self.metrics.histogram("ersap_ttft_s")
            for r in reqs:
                h.observe(max(self.sim_now - r.arrival, 0.0))
        if self.tracer is None:
            return
        for r in reqs:
            self.tracer.span("admit", self.sim_now, rid=r.rid, kind="miss",
                             replica=self.name, lb=lb)
        self.tracer.span("prefill", self.sim_now, replica=self.name,
                         lb=lb, rids=tuple(r.rid for r in reqs))

    def _admit_batch(self, reqs: List[Request], slot_idx: List[int],
                     lb: int, grants: Dict[int, List[int]]) -> List[Finished]:
        rcfg = self.kernels.rcfg
        bb = MA.pow2_bucket(len(reqs), 1, rcfg.max_batch)
        n_pad = bb - len(reqs)
        # synthetic workload: the prompt is per-request noise from the
        # content store; pad rows land in the overflow row
        tokens = np.stack([self._prompt_tokens(r, lb) for r in reqs]
                          + [np.zeros(lb, np.int32)] * n_pad)
        max_new = np.asarray([r.max_new for r in reqs] + [0] * n_pad,
                             np.int32)
        idx = np.asarray(list(slot_idx) + [rcfg.max_batch] * n_pad, np.int32)
        # publish the grants in the page table (pad rows -> null page)
        npg_prompt = -(-lb // rcfg.page_size)
        prompt_pages = np.zeros((bb, npg_prompt), np.int32)
        for j, (r, i) in enumerate(zip(reqs, slot_idx)):
            pgs = grants[id(r)]
            self.page_table[i] = 0
            self.page_table[i, :len(pgs)] = pgs
            prompt_pages[j] = pgs[:npg_prompt]
        self._pages_dirty = True
        kvb = self._kv_bucket(rcfg.admit_tail,
                              incoming=[(lb, int(r.max_new)) for r in reqs])
        fn = self.kernels.admit_fn(bb, lb, kvb if rcfg.admit_tail else 0)
        first = fn(self.params, tokens, self.cache, self.tok, self.active,
                   self.remaining, idx, max_new, self._device_pages(),
                   prompt_pages)
        for j, (r, i) in enumerate(zip(reqs, slot_idx)):
            self.slots[i] = _Slot(req=r, remaining=int(r.max_new), lb=lb,
                                  pages=tuple(grants[id(r)]))
            if self.record_tokens:               # first token (prefill argmax)
                self._log_tokens(r.rid, [int(first[j])])
        self._note_admission(reqs, lb)
        # the fused tail advanced every live row (old and new) tail steps
        return self._harvest(rcfg.admit_tail)

    # -------------------------------------------------------------- decode
    def _retire_slot(self, i: int) -> None:
        """Free slot ``i``: its pages go back to the pool and its
        page-table row re-points at the null page, so the retired row's
        frozen KV write can never land in a re-granted page."""
        s = self.slots[i]
        if s.pages:
            self.page_table[i] = 0
            self._pages_dirty = True
            self.alloc.free(s.pages)
        self.slots[i] = _Slot()

    def _harvest(self, steps: int) -> List[Finished]:
        t0 = time.perf_counter() if self.profiler is not None else 0.0
        done = []
        for i, s in enumerate(self.slots):
            if not s.busy:
                continue
            s.remaining -= min(steps, s.remaining)
            if s.remaining == 0:
                done.append(Finished(s.req, s.req.max_new))
                self._retire_slot(i)
                # content store follows the live request set
                self.content.pop(s.req.rid, None)
        if self.profiler is not None:
            self.profiler.add("pump.retire", time.perf_counter() - t0)
        return done

    def _decode_block(self) -> List[Finished]:
        rcfg = self.kernels.rcfg
        maxrem = max((s.remaining for s in self.slots if s.busy), default=0)
        steps = next((b for b in rcfg.block_ladder if b >= maxrem),
                     rcfg.decode_block)
        fn = self.kernels.decode_fn(steps, self._kv_bucket(steps))
        before = {i: s.remaining for i, s in enumerate(self.slots) if s.busy}
        if self.tracer is not None:
            self.tracer.span("decode", self.sim_now, replica=self.name,
                             steps=steps,
                             rids=tuple(self.slots[i].req.rid
                                        for i in before))
        toks = fn(self.params, self.tok, self.cache, self.active, self.remaining,
                  self._device_pages())
        self.steps_dispatched += 1
        if self.record_tokens:
            for i, rem in before.items():
                s = self.slots[i]
                self._log_tokens(s.req.rid,
                                 [int(t) for t in toks[:min(steps, rem), i]])
        return self._harvest(steps)

    def pump(self) -> List[Finished]:
        """Run to quiescence: admit -> fused block -> harvest -> admit ...
        Finished slots free mid-stream; arrivals join the very next block."""
        done = self._timed_admit()
        while any(s.busy for s in self.slots) or self.pending:
            if any(s.busy for s in self.slots):
                done.extend(self._timed_decode())
            done.extend(self._timed_admit())
        return done

    def step(self) -> List[Finished]:
        """One admission + one fused block (partial progress — lets callers
        interleave checkpoints or new arrivals between blocks)."""
        done = self._timed_admit()
        if not any(s.busy for s in self.slots):
            return done
        done.extend(self._timed_decode())
        done.extend(self._timed_admit())
        return done

    def _timed_admit(self) -> List[Finished]:
        if self.profiler is None:
            return self._admit_some()
        t0 = time.perf_counter()
        out = self._admit_some()
        self.profiler.add("pump.admit", time.perf_counter() - t0)
        return out

    def _timed_decode(self) -> List[Finished]:
        if self.profiler is None:
            return self._decode_block()
        t0 = time.perf_counter()
        out = self._decode_block()
        self.profiler.add("pump.decode", time.perf_counter() - t0)
        return out

    # --------------------------------------------------------- checkpoint
    def state(self) -> Dict[str, np.ndarray]:
        """Slot table + pending queue as flat numpy arrays. Restoration
        re-prefills — KV is derivable state; the request ledger and the
        content store (exact prompt tokens) are not, so both ship.
        Physical page ids are replica-local and deliberately absent."""
        live = [(s.req.rid, s.req.arrival, s.req.prompt_len, s.remaining,
                 s.req.prefix_group, s.req.prefix_len,
                 s.req.deadline, s.req.priority, s.req.trace_id)
                for s in self.slots if s.busy and s.remaining > 0]
        live += [(r.rid, r.arrival, r.prompt_len, r.max_new,
                  r.prefix_group, r.prefix_len, r.deadline, r.priority,
                  r.trace_id)
                 for r in self.pending]
        arr = np.asarray(live, np.float64).reshape(-1, 9)
        rids = arr[:, 0].astype(np.int64)
        toks = [self.content.get(int(rid), np.zeros(0, np.int32))
                for rid in rids]
        width = max((t.shape[0] for t in toks), default=0)
        content = np.zeros((len(toks), width), np.int32)
        for i, t in enumerate(toks):
            content[i, :t.shape[0]] = t
        return {
            "inflight_rid": rids,
            "inflight_arrival": arr[:, 1],
            "inflight_plen": arr[:, 2].astype(np.int64),
            "inflight_remaining": arr[:, 3].astype(np.int64),
            "inflight_group": arr[:, 4].astype(np.int64),
            "inflight_pfxlen": arr[:, 5].astype(np.int64),
            "inflight_deadline": arr[:, 6],
            "inflight_priority": arr[:, 7].astype(np.int64),
            "inflight_trace": arr[:, 8].astype(np.int64),
            "content_len": np.asarray([t.shape[0] for t in toks], np.int64),
            "content_tokens": content,
        }

    def restore(self, state: Dict[str, np.ndarray]):
        """Re-enqueue checkpointed in-flight requests, adopting their
        content rows so restored rids replay their exact prompt tokens."""
        rids = np.asarray(state.get("inflight_rid", ()))
        lens = np.asarray(state.get("content_len", ()))
        toks = np.asarray(state.get("content_tokens", ()))
        for i in range(min(rids.size, lens.size)):
            if lens[i] > 0:
                self.content[int(rids[i])] = \
                    toks[i, :int(lens[i])].astype(np.int32)
        self.pending.extend(requests_from_state(state))

    def drain(self) -> List[Request]:
        """Give back every in-flight request (runtime retirement path).
        The content store empties with it."""
        out = list(self.pending)
        self.pending = []
        for i, s in enumerate(self.slots):
            if s.busy:
                out.append(Request(s.req.rid, s.req.arrival,
                                   s.req.prompt_len, s.remaining,
                                   prefix_group=s.req.prefix_group,
                                   prefix_len=s.req.prefix_len,
                                   deadline=s.req.deadline,
                                   priority=s.req.priority,
                                   trace_id=s.req.trace_id))
                self._retire_slot(i)
        self.content.clear()
        return out
