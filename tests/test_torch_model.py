"""Port model against the reference on reduced qwen2-7b (2 layers, d=64,
Hq=4, Hkv=1, dh=16, float32): prefill logits and KV, one paged decode
step's logits and the KV it writes into the pool, the prefill scatter
into pages and the fused decode loop — with the reference's params
carried across by ``params_from_jax``.

``transformer.init`` zero-fills the QKV biases and sets the norm weights
to one, which would leave those paths untested, so they get seeded noise
first. Tolerance 2e-4 (f32, as tests/test_kernels.py uses for model-level
parity): the packages order their f32 matmul sums differently."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model_api as JMA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model_api as MA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
PS, ROWS, N_PAGES = 8, 3, 10


def perturbed_host_params(cfg, seed=0):
    """The reference's init, with biases and norm weights made non-trivial."""
    host = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)
    blk = host["dense_layers"]
    for k in ("bq", "bk", "bv"):
        blk[k] = rng.normal(0, 0.5, blk[k].shape).astype(np.float32)
    for k in ("ln1", "ln2"):
        blk[k] = (1 + rng.normal(0, 0.2, blk[k].shape)).astype(np.float32)
    host["final_norm"] = (1 + rng.normal(0, 0.2, host["final_norm"].shape)
                          ).astype(np.float32)
    return host


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen2-7b").reduced()
    cfg = get_config("qwen2-7b").reduced()
    host = perturbed_host_params(jcfg)
    return jcfg, cfg, host, params_from_jax(host, cfg, device="cpu")


def paged_state(cfg, seed=3):
    """A pool holding random KV, a page table and per-row positions: row 0
    at depth 9 over pages [1, 2], row 1 at depth 4 on page 3, row 2 a pad
    row on the null page."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, N_PAGES, PS, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    pages = np.zeros((ROWS, 3), np.int32)
    pages[0, :2] = [1, 2]
    pages[1, :1] = [3]
    pos = np.asarray([9, 4, 0], np.int32)
    tok = np.asarray([[7], [11], [0]], np.int32)
    return k, v, pages, pos, tok


def jax_cache(k, v, pos):
    return {"pos": jnp.asarray(pos), "dense": {"k": jnp.asarray(k),
                                               "v": jnp.asarray(v)}}


def torch_cache(k, v, pos):
    return {"pos": torch.from_numpy(pos.copy()),
            "dense": {"k": torch.from_numpy(k.copy()),
                      "v": torch.from_numpy(v.copy())}}


def test_reduced_config_matches_reference(models):
    jcfg, cfg, _, _ = models
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.torch_dtype == torch.float32
    full = get_config("qwen2-7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert full.torch_dtype == torch.bfloat16 and full.qkv_bias


def test_params_from_jax_keeps_the_tree(models):
    _, cfg, host, params = models
    flat_j = jax.tree_util.tree_flatten_with_path(host)[0]
    for path, arr in flat_j:
        node = params
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == arr.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), arr)
    own = T.init(cfg, device="cpu", seed=0)
    assert jax.tree.map(lambda a: a.shape, host) == \
        {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
             if isinstance(v, dict) else tuple(v.shape))
         for k, v in own.items()}


def test_prefill_matches_reference(models):
    jcfg, cfg, host, params = models
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (3, 12),
                                               dtype=np.int32)
    jl, jc = JT.prefill(host, jnp.asarray(tokens), jcfg)
    tl, tc = T.prefill(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for nm in ("k", "v"):
        np.testing.assert_allclose(tc["dense"][nm].numpy(),
                                   np.asarray(jc["dense"][nm]), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 12


@pytest.mark.parametrize("mode", ["jnp", "pallas"])
def test_paged_decode_step_matches_reference(models, mode):
    """Logits and the pools after the in-place KV write, vs the
    reference's paged decode step under both of its kernel modes."""
    jcfg, cfg, host, params = models
    k, v, pages, pos, tok = paged_state(cfg)
    try:
        jops.set_kernel_mode(mode)
        jl, jc = JT.decode_step(host, jnp.asarray(tok), jax_cache(k, v, pos),
                                jcfg, pages=jnp.asarray(pages), kv_bucket=16)
    finally:
        jops.set_kernel_mode(None)
    tc = torch_cache(k, v, pos)
    tl, tc2 = T.decode_step(params, torch.from_numpy(tok), tc, cfg,
                            pages=torch.from_numpy(pages), kv_bucket=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for nm in ("k", "v"):
        np.testing.assert_allclose(tc2["dense"][nm].numpy(),
                                   np.asarray(jc["dense"][nm]), **TOL)
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc["pos"]))
    # the write went in place into the caller's pool, at row 0's slot 9
    assert tc2["dense"]["k"] is tc["dense"]["k"]
    assert not np.allclose(tc["dense"]["k"][:, 2, 1].numpy(), k[:, 2, 1])


def test_scatter_prefill_paged_matches_reference(models):
    jcfg, cfg, host, params = models
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12),
                                               dtype=np.int32)
    k, v, _, pos, _ = paged_state(cfg)
    page_rows = np.asarray([[4, 5], [0, 0]], np.int32)     # row 1: a pad row
    slot_idx = np.asarray([1, 2], np.int32)
    _, jpc = JT.prefill(host, jnp.asarray(tokens), jcfg)
    jout = JMA.scatter_prefill_paged(jcfg, jax_cache(k, v, pos), jpc,
                                     jnp.asarray(slot_idx), 12,
                                     jnp.asarray(page_rows), PS)
    _, tpc = T.prefill(params, torch.from_numpy(tokens), cfg)
    tout = MA.scatter_prefill_paged(cfg, torch_cache(k, v, pos), tpc,
                                    torch.from_numpy(slot_idx), 12,
                                    torch.from_numpy(page_rows), PS)
    np.testing.assert_array_equal(tout["pos"].numpy(), np.asarray(jout["pos"]))
    for nm in ("k", "v"):
        got, want = tout["dense"][nm].numpy(), np.asarray(jout["dense"][nm])
        # page 0 takes colliding pad writes in either order: never read
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], **TOL)


def test_fused_decode_matches_reference(models):
    """Four fused greedy steps with a frozen row and a row that finishes
    mid-block: tokens, active/remaining, positions and pools."""
    jcfg, cfg, host, params = models
    k, v, pages, pos, tok = paged_state(cfg)
    active = np.asarray([True, True, False])
    remaining = np.asarray([4, 2, 0], np.int32)
    jout = JMA.fused_decode(host, jnp.asarray(tok), jax_cache(k, v, pos),
                            jnp.asarray(active), jnp.asarray(remaining),
                            jcfg, steps=4, pages=jnp.asarray(pages),
                            kv_bucket=16)
    tout = MA.fused_decode(params, torch.from_numpy(tok),
                           torch_cache(k, v, pos), torch.from_numpy(active),
                           torch.from_numpy(remaining), cfg, steps=4,
                           pages=torch.from_numpy(pages), kv_bucket=16)
    for i in (0, 2, 3, 4):                       # tok, active, remaining, toks
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    np.testing.assert_array_equal(tout[1]["pos"].numpy(),
                                  np.asarray(jout[1]["pos"]))
    for nm in ("k", "v"):
        np.testing.assert_allclose(tout[1]["dense"][nm][:, 1:].numpy(),
                                   np.asarray(jout[1]["dense"][nm])[:, 1:],
                                   **TOL)


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request succeeds")
    cfg = get_config("qwen2-7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init(cfg)                               # default device is cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        MA.init_paged_cache(cfg, 2, 4, 8)
