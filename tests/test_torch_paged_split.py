"""The paged-decode kernel's split-K arithmetic, on the CPU.

The CUDA kernel (`paged_attention/paged_decode.cu`) cuts each row's page
columns into splits, computes fp32 partials (m, l, acc) per split and
merges them.  `ref.paged_decode_split_ref` does the same in plain
PyTorch; these tests hold it to the JAX package's oracle
(`paged_attention/ref.py:paged_decode_ref`) and to its Pallas kernel in
interpret mode, on seeded layouts as serving produces them, and pin the
host's choice of splits (`ops.split_pages`).  The kernel itself is held
to the plain versions on the card by `tests/test_torch_cuda.py`.

Tolerances: fp32 1e-6 (the merge only reorders fp32 sums).  With a bf16
arena, 2e-2 as on the card: the split version rounds its probabilities
to bf16 relative to its split's maximum, the oracle relative to the
row's, and the oracle rounds rotated keys to the arena dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_decode_mha as jax_paged_mha
from repro.kernels.paged_attention.ref import paged_decode_ref as jax_paged_ref
from repro_torch.kernels.paged_attention.ops import (
    BLOCKS_PER_SM,
    H100_SMS,
    MAX_SPLITS,
    split_pages,
)
from repro_torch.kernels.paged_attention.ref import paged_decode_ref, paged_decode_split_ref
from repro_torch.serving.kv_pool import page_views

F32_TOL = 1e-6
BF16_TOL = 2e-2
BIG = 10 ** 6      # pages per split beyond any Pmax: one split


def _layout(rng, n_pages, page, lens):
    """Per-row slot tables as serving produces them (random, never
    page-aligned slots) plus one freshly claimed slot for the new token."""
    lens = np.asarray(lens, np.int64)
    tables = np.zeros((len(lens), max(int(lens.max()), 1)), np.int64)
    new_pages, new_slots = np.zeros(len(lens), np.int64), np.zeros(len(lens), np.int64)
    for i, ln in enumerate(lens):
        slots = rng.choice(np.arange(page, n_pages * page), int(ln) + 1, replace=False)
        tables[i, :ln] = slots[:-1]
        new_pages[i], new_slots[i] = divmod(int(slots[-1]), page)
    return tables, lens, new_pages, new_slots


def _case(seed, lens=None, pad_pages_to=4):
    rng = np.random.default_rng(seed)
    page = int(rng.choice([1, 4, 16]))
    n_pages = int(rng.integers(24, 48))
    L, Hkv, G = int(rng.integers(1, 3)), int(rng.choice([1, 2])), int(rng.choice([1, 2, 4]))
    D = int(rng.choice([8, 16, 32]))
    if lens is None:
        lens = rng.integers(0, min(n_pages * page - page - 1, 60), int(rng.integers(1, 5)))
    pg, sp = page_views(*_layout(rng, n_pages, page, lens), page, pad_pages_to=pad_pages_to)
    arena = lambda: rng.normal(size=(n_pages, page, L, Hkv, D)).astype(np.float32)
    ak, av = arena(), arena()
    q = rng.normal(size=(len(lens), G * Hkv, D)).astype(np.float32)
    return q, ak, av, pg, sp, L


def _torch(q, ak, av, pg, sp, dtype=torch.float32):
    t = torch.from_numpy
    return t(q), t(ak).to(dtype), t(av).to(dtype), t(pg), t(sp)


def _jax(q, ak, av, pg, sp, dtype=jnp.float32):
    return (jnp.asarray(q), jnp.asarray(ak).astype(dtype), jnp.asarray(av).astype(dtype),
            jnp.asarray(pg), jnp.asarray(sp))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("pps", [1, 2, 3, BIG])
@pytest.mark.parametrize("seed", range(6))
def test_split_ref_matches_jax_oracle(seed, pps):
    q, ak, av, pg, sp, L = _case(seed)
    for layer in range(L):
        got = paged_decode_split_ref(*_torch(q, ak, av, pg, sp), layer=layer,
                                     rope_theta=1e4, pages_per_split=pps)
        want = jax_paged_ref(*_jax(q, ak, av, pg, sp), layer=layer, rope_theta=1e4)
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("pps", [1, 2, 3, BIG])
def test_split_ref_matches_pallas_interpret(pps):
    q, ak, av, pg, sp, L = _case(11)
    want = jax_paged_mha(*_jax(q, ak, av, pg, sp), layer=L - 1, rope_theta=1e4,
                         interpret=True)
    got = paged_decode_split_ref(*_torch(q, ak, av, pg, sp), layer=L - 1, rope_theta=1e4,
                                 pages_per_split=pps)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_splits_of_pad_pages_contribute_nothing(pps):
    """Pad columns (scratch page 0, all -1) fill whole splits: they leave m =
    NEG_INF, l = 0, acc = 0, so the output equals the unpadded one (up to
    the order of fp32 sums, which the longer axes may change)."""
    lens = [5, 0, 17]
    q, ak, av, pg, sp, L = _case(21, lens=lens, pad_pages_to=4)
    _, _, _, pg_pad, sp_pad, _ = _case(21, lens=lens, pad_pages_to=32)
    assert pg_pad.shape[1] - pg.shape[1] >= 3 * pps and (sp_pad[:, pg.shape[1]:] == -1).all()
    base = paged_decode_split_ref(*_torch(q, ak, av, pg, sp), layer=0, rope_theta=1e4,
                                  pages_per_split=pps)
    padded = paged_decode_split_ref(*_torch(q, ak, av, pg_pad, sp_pad), layer=0,
                                    rope_theta=1e4, pages_per_split=pps)
    want = jax_paged_ref(*_jax(q, ak, av, pg_pad, sp_pad), layer=0, rope_theta=1e4)
    _close(padded, base.numpy(), F32_TOL)
    _close(padded, want, F32_TOL)


@pytest.mark.parametrize("pps", [1, 2, BIG])
def test_rows_with_only_the_new_token(pps):
    """Rows of length 0: the new token is the one live slot, so the output
    is its value row, whatever the other splits hold."""
    q, ak, av, pg, sp, L = _case(31, lens=[0, 9, 0, 40])
    got = paged_decode_split_ref(*_torch(q, ak, av, pg, sp), layer=0, rope_theta=1e4,
                                 pages_per_split=pps)
    want = jax_paged_ref(*_jax(q, ak, av, pg, sp), layer=0, rope_theta=1e4)
    _close(got, want, F32_TOL)
    hkv = ak.shape[3]
    g = q.shape[1] // hkv
    for row in (0, 2):
        col, slot = map(int, np.argwhere(sp[row] == 0)[0])
        v_new = torch.from_numpy(av[pg[row, col], slot, 0])            # (Hkv, D)
        torch.testing.assert_close(got[row], v_new.repeat_interleave(g, dim=0),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("pps", [1, 3, BIG])
@pytest.mark.parametrize("seed", range(3))
def test_split_ref_bf16_arena(seed, pps):
    q, ak, av, pg, sp, L = _case(40 + seed)
    for qd in (torch.float32, torch.bfloat16):
        tq, tk, tv, tpg, tsp = _torch(q, ak, av, pg, sp, torch.bfloat16)
        tq = tq.to(qd)
        got = paged_decode_split_ref(tq, tk, tv, tpg, tsp, layer=0, rope_theta=1e4,
                                     pages_per_split=pps)
        assert got.dtype == qd
        want = jax_paged_ref(jnp.asarray(tq.float().numpy()).astype(
            jnp.bfloat16 if qd == torch.bfloat16 else jnp.float32),
            *_jax(q, ak, av, pg, sp, jnp.bfloat16)[1:], layer=0, rope_theta=1e4)
        _close(got, want, BF16_TOL)
        # the same inputs through the port's unsplit plain version
        plain = paged_decode_ref(tq, tk, tv, tpg, tsp, layer=0, rope_theta=1e4)
        _close(got, plain.float().numpy(), BF16_TOL)


@pytest.mark.parametrize("n,hkv,pmax,page", [
    (8, 8, 32, 16),       # the served call (Qwen3-8B width, ~460 slots a row)
    (1, 8, 256, 16),      # one ~4,000-token row
    (1, 1, 4, 16), (2, 8, 4, 4), (64, 8, 32, 16), (3, 2, 37, 1), (1, 1, 5000, 1),
    (16, 8, 12, 16), (5, 4, 99, 4), (1, 1, 1, 16)])
def test_split_pages_covers_each_column_once(n, hkv, pmax, page):
    pps, splits = split_pages(n, hkv, pmax, page)
    cover = np.zeros(pmax, np.int64)
    for s in range(splits):
        cover[s * pps: min((s + 1) * pps, pmax)] += 1
    assert (cover == 1).all() and (splits - 1) * pps < pmax
    assert 1 <= splits <= MAX_SPLITS
    blocks = n * hkv * splits
    if (n, hkv, pmax) == (8, 8, 32):
        assert blocks >= 2 * H100_SMS
    assert blocks <= BLOCKS_PER_SM * H100_SMS or splits == 1


def test_split_pages_refuses_what_the_kernel_cannot_stage():
    with pytest.raises(ValueError):
        split_pages(1, 1, 4, 10 ** 5)
    with pytest.raises(ValueError):
        split_pages(1, 1, 10 ** 6, 16)
