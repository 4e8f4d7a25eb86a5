"""Serving traffic: the port's copy of ``repro.data.pipeline``'s
``Request`` and ``RequestSource`` (framework-free, so copied verbatim).

``RequestSource`` generates Poisson request arrivals feeding a serving
runtime's queue (the paper's stream sender). The training dataset waits
for the training slice of the port."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    max_new: int
    # shared-prefix identity: requests with the same (prefix_group > 0,
    # prefix_len > 0) mint identical first ``prefix_len`` prompt tokens —
    # the multi-tenant system-prompt / few-shot-template traffic shape the
    # prefix cache exploits. 0/0 keeps fully independent prompts.
    prefix_group: int = 0
    prefix_len: int = 0
    # overload protection: absolute completion deadline (sim seconds;
    # 0.0 = none). The engine sheds a request whose deadline has passed
    # while it queued *before* it burns prefill compute.
    deadline: float = 0.0
    # QoS tier of the issuing tenant (PriorityClass.value — batch=0,
    # standard=10, latency-critical=100). Brownout sheds low tiers first.
    priority: int = 10
    # trace context stamped at the RequestSource (== rid for sourced
    # traffic; 0 = untraced). Rides checkpoints so a restored request's
    # spans keep chaining to the same trace across fault incarnations.
    trace_id: int = 0


@dataclass
class RequestSource:
    """Poisson arrivals at rate lam(t) — the stream sender of paper §6.

    ``prompt_range`` / ``max_new_range`` (inclusive) randomize per-request
    shapes — the workload that punishes shape-keyed jit caches and rewards
    the serving runtime's bucketed compilation. Defaults keep the seed's
    fixed-shape stream."""
    seed: int = 0
    rid: int = 0
    prompt_range: tuple = None        # e.g. (8, 48)
    max_new_range: tuple = None       # e.g. (2, 16)
    # shared-prefix traffic shaping: with probability ``prefix_share`` a
    # request joins one of ``prefix_groups`` template groups and its first
    # ``prefix_len`` tokens are the group's common prefix
    prefix_share: float = 0.0
    prefix_len: int = 0
    prefix_groups: int = 1
    # overload shaping: ttl > 0 stamps every request with an absolute
    # deadline = arrival + ttl. ``surge`` multiplies the instantaneous
    # arrival rate (the flash-crowd seam chaos `surge:` faults drive).
    # ``tiers`` is an optional ((priority, weight), ...) mix; empty keeps
    # every request at the standard tier (priority 10).
    ttl: float = 0.0
    surge: float = 1.0
    tiers: tuple = ()
    # optional observability hook: when set, every minted request gets an
    # ``enqueue`` span and every deferral a ``defer`` span.
    tracer: object = None

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        # backpressure backlog: (not_before, Request) pairs re-released by
        # ``arrivals``. Deferral never touches the RNG, so retried traffic
        # does not perturb the deterministic arrival stream.
        self._deferred = []
        self.deferred_total = 0

    def defer(self, requests, not_before: float) -> None:
        """Park rejected requests for client-side retry at ``not_before``."""
        for req in requests:
            self._deferred.append((float(not_before), req))
            if self.tracer is not None:
                self.tracer.span("defer", not_before, rid=req.rid)
        self.deferred_total += len(requests)

    def _take_deferred(self, now: float):
        due = [r for t, r in self._deferred if t <= now]
        self._deferred = [(t, r) for t, r in self._deferred if t > now]
        return due

    def _tier(self) -> int:
        if not self.tiers:
            return 10
        total = sum(w for _, w in self.tiers)
        u = self.rng.random() * total
        acc = 0.0
        for prio, w in self.tiers:
            acc += w
            if u < acc:
                return int(prio)
        return int(self.tiers[-1][0])

    def arrivals(self, now: float, dt: float, lam: float, prompt_len=32,
                 max_new=16):
        out = self._take_deferred(now)
        n = self.rng.poisson(lam * max(self.surge, 0.0) * dt)
        for _ in range(n):
            self.rid += 1
            plen = prompt_len if self.prompt_range is None else \
                int(self.rng.integers(self.prompt_range[0],
                                      self.prompt_range[1] + 1))
            mnew = max_new if self.max_new_range is None else \
                int(self.rng.integers(self.max_new_range[0],
                                      self.max_new_range[1] + 1))
            grp, pfx = 0, 0
            if (self.prefix_share > 0 and self.prefix_len > 0
                    and self.rng.random() < self.prefix_share):
                grp = 1 + int(self.rng.integers(self.prefix_groups))
                pfx = min(self.prefix_len, plen)
            arrival = now + self.rng.uniform(0, dt)
            ddl = arrival + self.ttl if self.ttl > 0 else 0.0
            prio = self._tier()
            out.append(Request(self.rid, arrival, plen, mnew,
                               prefix_group=grp, prefix_len=pfx,
                               deadline=ddl, priority=prio,
                               trace_id=self.rid))
            if self.tracer is not None:
                self.tracer.span("enqueue", arrival, rid=self.rid,
                                 prompt_len=plen, max_new=mnew,
                                 priority=prio, deadline=ddl)
        return out
