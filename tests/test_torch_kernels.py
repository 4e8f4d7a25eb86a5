"""Port kernels against the reference: the plain version of the paged
decode-attention kernel vs the JAX Pallas kernel (interpret mode) and vs
``repro.kernels.ref`` on gathered pages, the port's oracles vs the
reference's, and the ops-layer dispatch (mode toggle, window path). The
CUDA kernel itself is held against its plain version on the card in
tests/test_torch_cuda.py.

Inputs come from numpy seeds and go to both packages as numpy arrays.
f32 tolerance 2e-5, as in tests/test_kernels.py: both sides run the same
f32 arithmetic in a different summation order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention_kernel)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PDA  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def paged_case(seed, *, G, Hkv=1, dh=16, ps=8, P=4, lengths=None):
    """Pools with a distinct random page per live logical page of every
    row; table entries past a row's length point at the null page 0."""
    rng = np.random.default_rng(seed)
    if lengths is None:   # 1, a page boundary, ps+1, mid, full
        lengths = [1, ps, ps + 1, (P * ps) // 2 + 3, P * ps]
    lengths = np.asarray(lengths, np.int32)
    B = lengths.size
    n_pages = B * P + 1
    q = rng.standard_normal((B, Hkv * G, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Hkv, dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages)).reshape(B, P)
    live = np.arange(P)[None, :] < -(-lengths[:, None] // ps)
    pages = np.where(live, perm, 0).astype(np.int32)
    return q, kp, vp, pages, lengths


def t(x):
    return torch.from_numpy(np.asarray(x))


def gathered(pool, pages):
    B, P = pages.shape
    return pool[pages].reshape(B, P * pool.shape[1], *pool.shape[2:])


@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("window,chunk", [(None, None), (5, None),
                                          (None, 8), (6, 8)])
def test_plain_paged_matches_pallas_and_ref(G, window, chunk):
    q, kp, vp, pages, lengths = paged_case(G * 10 + (window or 0), G=G)
    out = PDA.paged_decode_attention(t(q), t(kp), t(vp), t(pages),
                                     t(lengths), window=window, chunk=chunk)
    pallas = paged_decode_attention_kernel(q, kp, vp, pages, lengths,
                                           window=window, chunk=chunk,
                                           interpret=True)
    ref = R.decode_attention_ref(q, gathered(kp, pages), gathered(vp, pages),
                                 lengths=lengths, window=window, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plain_paged_two_kv_heads_and_null_page_rows():
    """Hkv=2 with G=4 (the reduced-qwen2 grouping doubled), plus rows whose
    whole table is the null page: their output ignores what page 0 holds."""
    q, kp, vp, pages, lengths = paged_case(7, G=4, Hkv=2,
                                           lengths=[1, 3, 16, 17, 30, 32])
    pages[1] = 0                      # a length-3 row living on page 0
    out = PDA.paged_decode_attention(t(q), t(kp), t(vp), t(pages),
                                     t(lengths))
    pallas = paged_decode_attention_kernel(q, kp, vp, pages, lengths,
                                           interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)


def test_plain_paged_length_zero_is_zeros():
    q, kp, vp, pages, lengths = paged_case(3, G=4, lengths=[0, 5])
    out = PDA.paged_decode_attention(t(q), t(kp), t(vp), t(pages),
                                     t(lengths))
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    assert out[1].abs().sum() > 0


def test_oracles_match_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 12, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    for kw in (dict(), dict(window=4), dict(chunk=5), dict(kv_len=9),
               dict(causal=False, softcap=3.0)):
        np.testing.assert_allclose(
            TR.attention_ref(t(q), t(k), t(v), **kw).numpy(),
            np.asarray(R.attention_ref(q, k, v, **kw)), **TOL)
    qd = q[:, :, 0]
    kd, vd = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    lens = np.asarray([5, 12], np.int32)
    for kw in (dict(), dict(window=3), dict(chunk=4)):
        np.testing.assert_allclose(
            TR.decode_attention_ref(t(qd), t(kd), t(vd), lengths=t(lens),
                                    **kw).numpy(),
            np.asarray(R.decode_attention_ref(qd, kd, vd, lengths=lens,
                                              **kw)), **TOL)


def test_ops_decode_attention_paged_matches_reference_ops():
    """The port's plain ops path (page gather over kv_bucket + decode
    attention) vs the reference's ops in jnp and Pallas (interpret)."""
    q, kp, vp, pages, lengths = paged_case(5, G=4)
    q4 = q[:, None]
    got = tops.decode_attention_paged(t(q4), t(kp), t(vp), t(pages),
                                      t(lengths), kv_bucket=32, page_size=8)
    outs = {}
    try:
        for mode in ("jnp", "pallas"):
            jops.set_kernel_mode(mode)
            outs[mode] = np.asarray(jops.decode_attention_paged(
                jnp.asarray(q4), kp, vp, jnp.asarray(pages),
                jnp.asarray(lengths), kv_bucket=32, page_size=8))
    finally:
        jops.set_kernel_mode(None)
    for mode, ref in outs.items():
        np.testing.assert_allclose(got.numpy(), ref, **TOL, err_msg=mode)


@pytest.mark.parametrize("window", [None, 5])
def test_window_attention_paged_w4_matches_reference(window):
    """W=4 window attention: the port's plain path and the kernel route
    (W calls of the 1-token kernel; its plain version here) vs the
    reference's jnp and Pallas (interpret) paths."""
    W = 4
    q, kp, vp, pages, lengths = paged_case(11, G=4)
    rng = np.random.default_rng(12)
    qw = rng.standard_normal((q.shape[0], W, q.shape[1], q.shape[2])
                             ).astype(np.float32)
    pos = np.maximum(lengths - W, 0).astype(np.int32)
    got = tops.window_attention_paged(t(qw), t(kp), t(vp), t(pages), t(pos),
                                      kv_bucket=32, page_size=8,
                                      window=window)
    per_offset = torch.stack([PDA.paged_decode_attention(
        t(qw[:, w]), t(kp), t(vp), t(pages), t(pos + w + 1), window=window)
        for w in range(W)], dim=1)
    outs = {}
    try:
        for mode in ("jnp", "pallas"):
            jops.set_kernel_mode(mode)
            outs[mode] = np.asarray(jops.window_attention_paged(
                jnp.asarray(qw), kp, vp, jnp.asarray(pages),
                jnp.asarray(pos), kv_bucket=32, page_size=8, window=window))
    finally:
        jops.set_kernel_mode(None)
    for mode, ref in outs.items():
        np.testing.assert_allclose(got.numpy(), ref, **TOL, err_msg=mode)
        np.testing.assert_allclose(per_offset.numpy(), ref, **TOL,
                                   err_msg=mode)


def test_kernel_mode_toggle(monkeypatch):
    x = torch.zeros(1)
    monkeypatch.delenv(tops.ENV_VAR, raising=False)
    # the reference's toggle is not the port's
    monkeypatch.setenv("KERNEL_MODE", "pallas")
    assert tops.kernel_mode() == "auto"
    assert tops.resolved_mode(x) == "torch"       # auto on a CPU tensor
    monkeypatch.setenv(tops.ENV_VAR, "torch")
    assert tops.resolved_mode(x) == "torch"
    monkeypatch.setenv(tops.ENV_VAR, "cuda")
    with pytest.raises(RuntimeError):             # cuda on a CPU tensor
        tops.resolved_mode(x)
    monkeypatch.setenv(tops.ENV_VAR, "pallas")
    with pytest.raises(ValueError):
        tops.kernel_mode()
    try:
        tops.set_kernel_mode("torch")             # beats the env var
        assert tops.kernel_mode() == "torch"
        with pytest.raises(ValueError):
            tops.set_kernel_mode("jnp")
    finally:
        tops.set_kernel_mode(None)


def test_cpu_calls_do_not_count_as_launches():
    q, kp, vp, pages, lengths = paged_case(2, G=4)
    before = tops.launch_counts()["paged_decode_attention"]
    PDA.paged_decode_attention(t(q), t(kp), t(vp), t(pages), t(lengths))
    assert tops.launch_counts()["paged_decode_attention"] == before


def test_wrapper_checks_reject_bad_inputs():
    q, kp, vp, pages, lengths = (t(a) for a in paged_case(2, G=4))
    ok = (q, kp, vp, pages, lengths)
    PDA._check(*ok, None, None)
    bad = [
        ((q.double(), kp, vp, pages, lengths, None, None), TypeError),
        ((q, kp, vp, pages.long(), lengths, None, None), TypeError),
        ((q, kp.transpose(1, 2), vp, pages, lengths, None, None), ValueError),
        ((q[:2], kp, vp, pages, lengths, None, None), ValueError),
        ((q, kp, vp, pages, lengths[:2], None, None), ValueError),
        ((q, kp, vp, pages, lengths, 0, None), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            PDA._check(*args)
