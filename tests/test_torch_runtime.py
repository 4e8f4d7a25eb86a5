"""Port serving runtime against the reference's paged ``DecodeRuntime`` on
reduced qwen2-7b with the same params: identical greedy tokens, matching
allocator books and trace tallies, the drain -> state() -> restore round
trip, the fused admission tail (admit_tail=4), pool-exhaustion
backpressure, and the options this slice does not port raising with the
ROADMAP item that brings them.

Greedy tokens must be identical. Should an argmax near-tie ever split
them (the packages order f32 sums differently), the failure message
gives the top-2 logit margin at the first differing token."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.core.elastic import ElasticServing  # noqa: E402
from repro.data.pipeline import Request as JRequest  # noqa: E402
from repro.streaming import runtime as JR  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.pipeline import Request  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.streaming import runtime as R  # noqa: E402

from test_torch_model import perturbed_host_params  # noqa: E402

SHAPES = [(5, 2), (12, 9), (8, 14), (20, 5), (33, 11), (9, 1), (17, 16),
          (6, 7)]                        # (prompt_len, max_new) per rid 1..8


@pytest.fixture(scope="module")
def both():
    jcfg = jax_config("qwen2-7b").reduced()
    cfg = get_config("qwen2-7b").reduced()
    host = perturbed_host_params(jcfg, seed=1)
    serving = ElasticServing(jcfg, tp=1).build(1, host_params=host)
    return serving, cfg, params_from_jax(host, cfg, device="cpu")


def paged(**kw):
    base = dict(max_batch=4, paged=True, page_size=16, admit_tail=0)
    base.update(kw)
    return base


def jax_rt(serving, rc, **kw):
    """The reference runtime, with its page-table upload made a copy.

    Its ``_device_pages`` uploads with ``jnp.asarray``, which on the CPU
    aliases the host numpy table; dispatch is asynchronous, so a
    retirement that zeroes a row right after an admission or decode
    dispatch can reach that dispatch before it runs (ROADMAP C1). Untimed
    runs (``record_tokens``) sync before the host writes and never see it;
    the fused admission tail does. The copy removes the race and nothing
    else."""
    rt = JR.DecodeRuntime(serving.runtime_kernels(JR.RuntimeConfig(**rc)),
                          serving.params, gen=serving.build_gen, **kw)

    def device_pages():
        if rt._pages_dirty:
            rt._pages_dev = jnp.array(rt.page_table)       # a copy
            rt._pages_dirty = False
        return rt._pages_dev

    rt._device_pages = device_pages
    return rt


def torch_rt(both, rc, **kw):
    _, cfg, params = both
    return R.DecodeRuntime(R.TorchRuntimeKernels(cfg, R.RuntimeConfig(**rc),
                                                 device="cpu"), params, **kw)


def requests(cls, shapes=SHAPES):
    return [cls(i, 0.0, prompt_len=p, max_new=m)
            for i, (p, m) in enumerate(shapes, 1)]


def top2_margin(both, rt, rid, got):
    """Top-2 logit margin of the port's model at the first token where
    ``got`` differs: prefill over prompt + the agreed tokens."""
    _, cfg, params = both
    lb = R.MA.pow2_bucket(SHAPES[rid - 1][0], 8, 64)
    prompt = rt._prompt_tokens(Request(rid, 0.0, SHAPES[rid - 1][0], 1), lb)
    seq = np.concatenate([prompt, np.asarray(got, np.int32)])[None]
    logits, _ = T.prefill(params, torch.from_numpy(seq), cfg)
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def assert_same_tokens(both, rt, got_log, want_log):
    assert sorted(got_log) == sorted(want_log)
    for rid, want in want_log.items():
        got = got_log[rid]
        if got != want:
            n = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            margin = top2_margin(both, rt, rid, want[:n])
            pytest.fail(f"rid {rid}: first differing token at {n} "
                        f"({got[n]} vs reference {want[n]}); top-2 logit "
                        f"margin there {margin:.3g}")


def books(rt):
    return (rt.alloc.used_pages, rt.alloc.free_pages, rt.pages_hwm,
            rt.steps_dispatched, int(rt.page_table.any()))


def assert_same_device_state(rt, ref):
    """Positions, tokens and every pool page but the null page (which
    takes colliding pad writes in either order and is never read)."""
    np.testing.assert_array_equal(rt.cache["pos"].numpy(),
                                  np.asarray(ref.cache["pos"]))
    np.testing.assert_array_equal(rt.tok.numpy(), np.asarray(ref.tok))
    for nm in ("k", "v"):
        np.testing.assert_allclose(rt.cache["dense"][nm][:, 1:].numpy(),
                                   np.asarray(ref.cache["dense"][nm])[:, 1:],
                                   atol=2e-4, rtol=2e-4)


def test_greedy_tokens_and_books_match_reference(both):
    serving = both[0]
    rc = paged()
    ref = jax_rt(serving, rc, record_tokens=True)
    ref.submit(requests(JRequest))
    ref_done = ref.pump()
    rt = torch_rt(both, rc, record_tokens=True)
    rt.submit(requests(Request))
    done = rt.pump()
    assert sorted((f.req.rid, f.tokens) for f in done) == \
        sorted((f.req.rid, f.tokens) for f in ref_done)
    assert all(f.tokens == f.req.max_new for f in done)
    assert all(len(rt.token_log[f.req.rid]) == f.req.max_new + 1
               for f in done)            # prefill argmax + max_new
    assert_same_tokens(both, rt, rt.token_log, ref.token_log)
    assert_same_device_state(rt, ref)
    assert books(rt) == books(ref)
    assert rt.alloc.used_pages == 0
    assert rt.alloc.used_pages + rt.alloc.free_pages == rt.alloc.pool_pages
    assert rt.kernels.trace_counts["admit"] == ref.kernels.trace_counts["admit"]
    assert rt.kernels.trace_counts["decode"] == \
        ref.kernels.trace_counts["decode"]
    assert rt.kernels.max_traces == ref.kernels.max_traces


def test_state_restore_roundtrip_matches_reference(both):
    """Mid-stream state() equals the reference's; a successor restored
    from it replays the reference's tokens and balances its books."""
    serving = both[0]
    rc = paged(max_batch=2, decode_block=4)
    shapes = [(8, 2), (8, 10), (12, 6)]
    ref = jax_rt(serving, rc, record_tokens=True)
    ref.submit(requests(JRequest, shapes))
    ref.pump()

    states = []
    for make, cls in ((lambda: jax_rt(serving, rc, record_tokens=True),
                       JRequest),
                      (lambda: torch_rt(both, rc, record_tokens=True),
                       Request)):
        rt = make()
        rt.submit(requests(cls, shapes))
        rt._admit_some()
        rt._decode_block()              # rid 1 done, rid 2 mid-generation
        assert rt.alloc.used_pages == sum(len(s.pages) for s in rt.slots
                                          if s.busy) > 0
        states.append(rt.state())
        rt.drain()
        assert rt.alloc.used_pages == 0 and not rt.page_table.any()
    jstate, tstate = states
    assert sorted(jstate) == sorted(tstate)
    for key in jstate:
        np.testing.assert_array_equal(tstate[key], jstate[key], err_msg=key)

    rt2 = torch_rt(both, rc, record_tokens=True)
    rt2.restore({k: np.asarray(v) for k, v in tstate.items()})
    done = rt2.pump()
    assert sorted(f.req.rid for f in done) == [2, 3]
    assert rt2.alloc.used_pages == 0
    for rid in (2, 3):
        got = rt2.token_log[rid]
        assert got == ref.token_log[rid][:len(got)]
    assert len(rt2.token_log[2]) == 7   # 1 prefill argmax + 6 remaining


def test_admit_tail_runtime_matches_reference(both):
    """admit_tail=4: admission and four decode steps of the whole slab in
    one dispatch. Served counts, dispatches, books and trace tallies match
    the reference, within the bucketing bound."""
    serving = both[0]
    rc = paged(admit_tail=4)
    ref = jax_rt(serving, rc)
    ref.submit(requests(JRequest))
    ref_done = ref.pump()
    rt = torch_rt(both, rc)
    rt.submit(requests(Request))
    done = rt.pump()
    assert sorted((f.req.rid, f.tokens) for f in done) == \
        sorted((f.req.rid, f.tokens) for f in ref_done)
    assert_same_device_state(rt, ref)   # the tail's tokens stay on device
    assert books(rt) == books(ref)
    assert rt.kernels.trace_counts == {
        k: ref.kernels.trace_counts[k] for k in ("admit", "decode")}
    assert sum(rt.kernels.trace_counts.values()) <= rt.kernels.max_traces
    assert rt.kernels.max_traces == ref.kernels.max_traces


def test_pool_exhaustion_blocks_admission_until_retirement(both):
    rc = paged(pool_pages=6, max_prompt_bucket=16, max_new_cap=32)
    rt = torch_rt(both, rc)
    reqs = [Request(i, 0.0, prompt_len=10, max_new=12) for i in range(1, 9)]
    assert all(rt.fits(r) for r in reqs)
    rt.submit(reqs)
    done = rt.pump()
    assert sorted(f.req.rid for f in done) == list(range(1, 9))
    assert all(f.tokens == f.req.max_new for f in done)
    assert rt.pages_hwm <= 6
    assert rt.alloc.used_pages == 0 and rt.alloc.free_pages == 6
    assert not rt.page_table.any()


def test_page_allocator_matches_reference():
    ops = [("alloc", 2), ("alloc", 3), ("alloc", 2), ("free", 0),
           ("alloc", 3), ("free", 1), ("alloc", 1)]
    out = []
    for cls in (JR.PageAllocator, R.PageAllocator):
        a, held, log = cls(6), [], []
        for op, n in ops:
            if op == "alloc":
                g = a.alloc(n)
                log.append(g)
                if g is not None:
                    held.append(g)
            else:
                log.append(a.free(held.pop(n)))
            log.append((a.used_pages, a.free_pages))
        out.append(log)
    assert out[0] == out[1]


@pytest.mark.parametrize("kw,item", [(dict(paged=False), "A6"),
                                     (dict(prefix_cache=True), "A7"),
                                     (dict(spec_decode=3), "A8")])
def test_unported_options_raise_with_roadmap_item(both, kw, item):
    rc = paged(**kw)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        torch_rt(both, rc)


def test_runtime_config_matches_reference():
    for kw in (dict(), paged(), paged(admit_tail=4, pool_pages=20)):
        a, b = JR.RuntimeConfig(**kw), R.RuntimeConfig(**kw)
        for name in ("capacity", "pages_per_slot", "n_pool_pages",
                     "prompt_buckets", "batch_buckets", "block_ladder",
                     "kv_ladder"):
            assert getattr(a, name) == getattr(b, name), name
        for p, m in SHAPES + [(70, 4), (64, 64)]:
            assert a.fits(JRequest(1, 0.0, p, m)) == b.fits(Request(1, 0.0, p, m))
