"""The sm_90a paged decode-attention kernel vs its plain PyTorch version,
on the card. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.) Tolerances: f32 2e-5
(the same f32 arithmetic in another summation order); bf16 1e-2 (both
round the f32 result to bf16, so they differ by at most an ulp or two)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PDA  # noqa: E402

TOLS = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def paged_case(seed, dtype, *, G, Hkv=4, dh=128, ps=16, P=9):
    """qwen2-7b's head shape; rows at length 1, a page boundary, ps+1,
    mid and full, with the null page 0 past each length."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([1, ps, ps + 1, (P * ps) // 2 + 3, P * ps], np.int32)
    B = lengths.size
    n_pages = B * P + 1
    q = rng.standard_normal((B, Hkv * G, dh))
    kp = rng.standard_normal((n_pages, ps, Hkv, dh))
    vp = rng.standard_normal((n_pages, ps, Hkv, dh))
    perm = rng.permutation(np.arange(1, n_pages)).reshape(B, P)
    live = np.arange(P)[None, :] < -(-lengths[:, None] // ps)
    pages = np.where(live, perm, 0).astype(np.int32)
    dev = torch.device("cuda")
    return ([torch.tensor(a, dtype=dtype, device=dev) for a in (q, kp, vp)]
            + [torch.tensor(pages, device=dev),
               torch.tensor(lengths, device=dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("window,chunk", [(None, None), (20, None),
                                          (None, 16), (40, 32)])
def test_kernel_matches_plain(cuda, dtype, G, window, chunk):
    args = paged_case(G, dtype, G=G)
    before = PDA.launches
    got = PDA.paged_decode_attention(*args, window=window, chunk=chunk)
    want = PDA.paged_decode_attention_plain(*args, window=window,
                                            chunk=chunk)
    torch.cuda.synchronize()
    assert PDA.launches == before + 1
    tol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernel_reduced_head_shape(cuda):
    """Reduced qwen2-7b's shape: dh=16, G=4, one kv head, f32."""
    args = paged_case(3, torch.float32, G=4, Hkv=1, dh=16, ps=16, P=4)
    got = PDA.paged_decode_attention(*args)
    want = PDA.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_window_path_through_the_kernel(cuda):
    """W=4 window attention: four kernel calls vs the plain gather +
    blockwise path."""
    q, kp, vp, pages, lengths = paged_case(5, torch.float32, G=7)
    qw = torch.randn(q.shape[0], 4, *q.shape[1:], device=cuda)
    pos = (lengths - 4).clamp_min(0)
    outs = {}
    try:
        for mode in ("cuda", "torch"):
            ops.set_kernel_mode(mode)
            outs[mode] = ops.window_attention_paged(
                qw, kp, vp, pages, pos, kv_bucket=144, page_size=16)
    finally:
        ops.set_kernel_mode(None)
    torch.cuda.synchronize()
    torch.testing.assert_close(outs["cuda"], outs["torch"], atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, kp, vp, pages, lengths = paged_case(1, torch.float32, G=7)
    with pytest.raises(TypeError):
        PDA.paged_decode_attention(q.half(), kp.half(), vp.half(), pages,
                                   lengths)
    with pytest.raises(ValueError):
        PDA.paged_decode_attention(q, kp, vp, pages.cpu(), lengths)
    with pytest.raises(TypeError):
        PDA.paged_decode_attention(q, kp, vp, pages.long(), lengths)
