"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one (a CUDA
kernel has no CPU mode); this file imports no JAX, so it runs on a GPU
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CPU-side tests (`test_torch_kernels.py`) hold the same plain
versions to the JAX package's oracles."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_gather.ops import PoolGather, assemble_kv
from repro_torch.kernels.block_gather.ref import block_gather_ref
from repro_torch.kernels.embedding_bag.ops import bag_sum
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import _route as _flash_route
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.flash_attention.ref import mha_flash_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_mha
from repro_torch.kernels.paged_attention.ref import paged_decode_ref
from repro_torch.kernels.selective_attention.ops import _route as _selective_route
from repro_torch.kernels.selective_attention.ops import block_liveness, selective_mha
from repro_torch.kernels.selective_attention.ref import selective_mha_ref
from repro_torch.serving.kv_pool import page_views

F32_TOL = 1e-5    # fp32 vs fp32 (TF32 off): summation order only
BF16_TOL = 2e-2   # bf16 outputs: one bf16 rounding, probabilities rounded apart


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _counts(wrapper):
    return wrapper.launches, wrapper.tc_launches, wrapper.small_launches


def _launched(wrapper, route, before):
    """The wrapper launched once more, on the tensor-core route iff
    `route` says "tc" and on the small-head route iff it says "small"."""
    launches, tc, small = before
    assert wrapper.launches == launches + 1
    assert wrapper.tc_launches == tc + (route == "tc")
    assert wrapper.small_launches == small + (route == "small")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(2))
def test_flash_kernel_matches_plain(cuda, seed, dtype, G, D):
    """D 16 runs the small-head route, bf16 with D in {64, 128} the
    tensor-core route, everything else the SIMT kernel; causal and not,
    with and without kv_valid, Sq up to 512 (several 64-row tiles and
    64-key tiles, ragged edges)."""
    rng = np.random.default_rng(seed * 1000 + G * 10 + D)
    B, Hkv = int(rng.integers(1, 4)), int(rng.choice([1, 2, 8]))
    Sq = int(rng.integers(1, 513))
    Skv = Sq if rng.integers(0, 2) else int(rng.integers(Sq, 600))
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, dtype)
    q, k, v = g(B, Sq, Hkv * G, D), g(B, Skv, Hkv, D), g(B, Skv, Hkv, D)
    valid = torch.from_numpy(rng.random((B, Skv)) < 0.8).to(cuda)
    valid[:, 0] = True                                  # >= 1 live key per row
    want_route = ("small" if D <= 32 else
                  "tc" if dtype == torch.bfloat16 and D in (64, 128) else "simt")
    for causal in (True, False):
        for kv_valid in (None, valid):
            route = _flash_route(q, k, v, 1 if kv_valid is None else B)
            assert route == want_route
            before = _counts(mha_flash)
            got = mha_flash(q, k, v, kv_valid=kv_valid, causal=causal)
            _launched(mha_flash, route, before)
            _close(got, mha_flash_ref(q, k, v, kv_valid=kv_valid, causal=causal),
                   F32_TOL if dtype == torch.float32 else BF16_TOL)


def _selective_case(rng, cuda, B, Hkv, G, D, n, R, window, dtypes, kscale=1.0):
    valid = np.zeros((B, n), np.int8)
    r_pos = np.zeros((B, R), np.int64)
    for b in range(B):
        nb = int(rng.integers(R + 1, n + 1))
        valid[b, :nb] = 1
        r_pos[b] = np.sort(rng.choice(nb, R, replace=False))
    hh = valid if window == 0 else (rng.random((B, n)) < 0.2).astype(np.int8)
    g = lambda dt, *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, dt)
    qd, kd, vd = dtypes
    q, k, v = g(qd, B, R, Hkv * G, D), kscale * g(kd, B, n, Hkv, D), g(vd, B, n, Hkv, D)
    qp, hht = torch.from_numpy(r_pos).to(cuda), torch.from_numpy(hh).to(cuda)
    live = block_liveness(r_pos, hh, window=window, q_block=64, kv_block=64)
    return q, qp, k, v, hht, live


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_selective_kernel_matches_plain(cuda, seed, G):
    """fp32 queries run the SIMT kernel; bf16 q and v with bf16 or fp32
    keys the tensor-core route (one mask row per batch row); bf16 with a
    mask row per head (NB = B*Hq, which the G heads of a kv group do not
    share unless G = 1) the SIMT kernel again."""
    rng = np.random.default_rng(seed * 10 + G)
    B, Hkv, D = 2, int(rng.choice([2, 8])), int(rng.choice([64, 128]))
    n = int(rng.choice([128, 448, 512]))
    R = int(rng.choice([r for r in (64, 128, 256) if r < n]))
    window = int(rng.choice([0, 16, 200]))
    bf, f32 = torch.bfloat16, torch.float32
    for dtypes, want_route in (((f32,) * 3, "simt"), ((bf, f32, bf), "tc"),
                               ((bf,) * 3, "tc")):
        q, qp, k, v, hht, live = _selective_case(rng, cuda, B, Hkv, G, D, n, R, window,
                                                 dtypes)
        assert _selective_route(q, k, v, qp.shape[0]) == want_route
        before = _counts(selective_mha)
        got = selective_mha(q, qp, k, v, hht, live=live, window=window)
        _launched(selective_mha, want_route, before)
        _close(got, selective_mha_ref(q, qp, k, v, hht, window=window),
               F32_TOL if dtypes[0] == f32 else BF16_TOL)
    # one mask row per (batch row, query head)
    Hq = Hkv * G
    qp = qp.repeat_interleave(Hq, dim=0)
    hht = hht.repeat_interleave(Hq, dim=0)
    live = block_liveness(qp.cpu().numpy(), hht.cpu().numpy(), window=window,
                          q_block=64, kv_block=64)
    route = _selective_route(q, k, v, qp.shape[0])
    assert route == ("tc" if G == 1 else "simt")
    before = _counts(selective_mha)
    got = selective_mha(q, qp, k, v, hht, live=live, window=window)
    _launched(selective_mha, route, before)
    _close(got, selective_mha_ref(q, qp, k, v, hht, window=window), BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kd", [torch.float32, torch.bfloat16])
def test_selective_kernel_skips_dead_leading_tiles(cuda, kd):
    """No heavy hitter among the first 128 keys and every query past them
    with a short window: the leading key tiles are dead for every query
    tile, which the tensor-core route must drain and skip (it starts
    loading tile 0 before it reads the liveness map)."""
    rng = np.random.default_rng(11)
    B, Hkv, G, D, n, R, window = 2, 2, 4, 128, 448, 64, 16
    hh = (rng.random((B, n)) < 0.3).astype(np.int8)
    hh[:, :128] = 0
    r_pos = np.stack([np.sort(rng.choice(np.arange(200, n), R, replace=False))
                      for _ in range(B)])
    live = block_liveness(r_pos, hh, window=window, q_block=64, kv_block=64)
    assert not live[:, :, :2].any() and live.any()
    g = lambda dt, *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, dt)
    q, k, v = g(torch.bfloat16, B, R, Hkv * G, D), g(kd, B, n, Hkv, D), g(torch.bfloat16, B, n, Hkv, D)
    qp, hht = torch.from_numpy(r_pos).to(cuda), torch.from_numpy(hh).to(cuda)
    before = _counts(selective_mha)
    got = selective_mha(q, qp, k, v, hht, live=live, window=window)
    _launched(selective_mha, "tc", before)
    _close(got, selective_mha_ref(q, qp, k, v, hht, window=window), BF16_TOL)


@pytest.mark.cuda
def test_selective_kernel_keeps_fp32_keys(cuda):
    """The served call's keys are fp32 (the block gather's rotation).  At
    scores of about +-50, rounding them to bf16 moves the plain version's
    output beyond BF16_TOL (so these inputs tell the two apart); the
    tensor-core route, which splits each key into bf16 hi + lo, stays
    within it."""
    rng = np.random.default_rng(7)
    q, qp, k, v, hht, live = _selective_case(
        rng, cuda, 1, 8, 4, 128, 448, 256, 0, (torch.bfloat16, torch.float32, torch.bfloat16),
        kscale=10.0)
    want = selective_mha_ref(q, qp, k, v, hht, window=0)
    s = torch.einsum("brd,bkd->brk", q[0, :, ::4].float().transpose(0, 1),
                     k[0].float().transpose(0, 1)) / 128 ** 0.5
    assert float(s.abs().max()) > 40
    moved = selective_mha_ref(q, qp, k.to(torch.bfloat16).float(), v, hht, window=0)
    assert not torch.allclose(moved.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    assert _selective_route(q, k, v, 1) == "tc"
    before = _counts(selective_mha)
    got = selective_mha(q, qp, k, v, hht, live=live, window=0)
    _launched(selective_mha, "tc", before)
    _close(got, want, BF16_TOL)


# ------------------------------------------- small-head route of B1 and B2
_SMALL_DIMS = [1, 5, 8, 12, 16, 32]   # 1, 5: element (bf16) or word copies; 12: words (bf16)


def _same_twice(fn, want_route, wrapper, tol, want):
    """Two calls on the route `want_route`: each one launch of it, within
    `tol` of `want` and bitwise equal to each other."""
    outs = []
    for _ in range(2):
        before = _counts(wrapper)
        outs.append(fn())
        _launched(wrapper, want_route, before)
    _close(outs[0], want, tol)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", _SMALL_DIMS)
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_small_route_matches_plain(cuda, dtype, G, D):
    """D <= 32 takes the small-head route in any dtype: causal and not,
    kv_valid with one row, a row per batch row and a row per query head
    (rows a group's heads do not share), rows whose keys are all masked
    (the plain version's uniform softmax over every key); a second call
    bitwise equal."""
    rng = np.random.default_rng(100 * G + D)
    B, Hkv = 2, 2
    Hq = Hkv * G
    Sq = int(rng.integers(40, 300))
    Skv = Sq + int(rng.integers(0, 70))
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, dtype)
    q, k, v = g(B, Sq, Hq, D), g(B, Skv, Hkv, D), g(B, Skv, Hkv, D)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for nb in (1, B, B * Hq):
        valid = torch.from_numpy(rng.random((nb, Skv)) < 0.7).to(cuda)
        valid[-1, :3] = False           # the first queries of the last row see no key
        if nb > 1:
            valid[0] = False            # a mask row with no key at all
        for causal in (True, False):
            for kvv in (None, valid) if nb == 1 else (valid,):
                assert _flash_route(q, k, v, nb) == "small"
                _same_twice(lambda: mha_flash(q, k, v, kv_valid=kvv, causal=causal), "small",
                            mha_flash, tol, mha_flash_ref(q, k, v, kv_valid=kvv, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.float32, torch.bfloat16)])
def test_flash_small_route_mixed_dtypes(cuda, dtypes):
    """Mixed q / k / v dtypes at D 16: probabilities rounded to v's dtype,
    the output in q's."""
    rng = np.random.default_rng(5)
    qd, kd, vd = dtypes
    g = lambda dt, *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, dt)
    q, k, v = g(qd, 3, 130, 4, 16), g(kd, 3, 150, 2, 16), g(vd, 3, 150, 2, 16)
    tol = BF16_TOL if torch.bfloat16 in (qd, vd) else F32_TOL
    _same_twice(lambda: mha_flash(q, k, v, causal=True), "small", mha_flash, tol,
                mha_flash_ref(q, k, v, causal=True))


def _small_selective_case(rng, cuda, B, Hkv, G, D, n, R, window, dtypes, nb, pad):
    """Positions inside each batch row's valid keys, the last `pad` rows of
    batch row 0 pad rows (-1); `nb` mask rows: batch row 0's alone (1),
    one per batch row (B) or repeated per query head (B*Hq, with a window
    every other row's heavy-hitter bits cleared, so the rows differ)."""
    q, qp, k, v, hht, _ = _selective_case(rng, cuda, B, Hkv, G, D, n, R, window, dtypes)
    qp = qp.clone()
    if pad:
        qp[0, R - pad:] = -1
    if nb < B:
        qp, hht = qp[:nb], hht[:nb]
    elif nb > B:
        qp = qp.repeat_interleave(nb // B, dim=0)
        hht = hht.repeat_interleave(nb // B, dim=0).clone()
        if window:
            hht[1::2] = 0
    return q, qp, k, v, hht


@pytest.mark.cuda
@pytest.mark.parametrize("D", _SMALL_DIMS)
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_small_route_matches_plain(cuda, dtype, G, D):
    """D <= 32 takes the small-head route: causal over valid keys (window
    0, the served call's mask), a window with heavy hitters, pad rows
    (q_pos = -1: no live key, the plain version's uniform softmax), one
    mask row, one per batch row, one per query head; the engine's 64 x 64
    liveness tiles and odd ones (the route ORs every entry a block
    touches); bf16 with fp32 keys; a second call bitwise equal."""
    rng = np.random.default_rng(200 * G + D)
    B, Hkv = 2, 2
    Hq = Hkv * G
    n = int(rng.choice([130, 448]))
    R = int(rng.choice([r for r in (40, 100, 128) if r < n]))
    kd = torch.float32 if dtype == torch.bfloat16 and D % 2 == 0 else dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for window, nb, blocks in ((0, B, (64, 64)), (16, 1, (64, 64)), (16, B * Hq, (64, 64)),
                               (0, B * Hq, (16, 32)), (200, B, (48, 80))):
        q, qp, k, v, hht = _small_selective_case(rng, cuda, B, Hkv, G, D, n, R, window,
                                                 (dtype, kd, dtype), nb, pad=7)
        live = block_liveness(qp.cpu().numpy(), hht.cpu().numpy(), window=window,
                              q_block=blocks[0], kv_block=blocks[1])
        assert _selective_route(q, k, v, qp.shape[0]) == "small"
        kw = dict(live=live, window=window, q_block=blocks[0], kv_block=blocks[1])
        _same_twice(lambda: selective_mha(q, qp, k, v, hht, **kw), "small", selective_mha,
                    tol, selective_mha_ref(q, qp, k, v, hht, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_small_route_skips_dead_leading_tiles(cuda, dtype):
    """No heavy hitter among the first 128 keys and every query past them
    with a short window: the leading key tiles are dead for every row, and
    the small-head route never loads them."""
    rng = np.random.default_rng(12)
    B, Hkv, G, D, n, R, window = 2, 2, 2, 16, 448, 64, 16
    hh = (rng.random((B, n)) < 0.3).astype(np.int8)
    hh[:, :128] = 0
    r_pos = np.stack([np.sort(rng.choice(np.arange(200, n), R, replace=False))
                      for _ in range(B)])
    live = block_liveness(r_pos, hh, window=window, q_block=64, kv_block=64)
    assert not live[:, :, :2].any() and live.any()
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, dtype)
    q, k, v = g(B, R, Hkv * G, D), g(B, n, Hkv, D), g(B, n, Hkv, D)
    qp, hht = torch.from_numpy(r_pos).to(cuda), torch.from_numpy(hh).to(cuda)
    _same_twice(lambda: selective_mha(q, qp, k, v, hht, live=live, window=window), "small",
                selective_mha, F32_TOL if dtype == torch.float32 else BF16_TOL,
                selective_mha_ref(q, qp, k, v, hht, window=window))


@pytest.mark.cuda
def test_simt_routes_forced_at_small_heads(cuda):
    """The SIMT kernels still take a small-head call when asked (chip_smoke
    times them against the small-head route there)."""
    from repro_torch.kernels.flash_attention.ops import _flash_launch
    from repro_torch.kernels.selective_attention.ops import _selective_launch

    rng = np.random.default_rng(3)
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
    q, k, v = g(4, 64, 4, 16), g(4, 64, 2, 16), g(4, 64, 2, 16)
    valid = torch.from_numpy(rng.random((4, 64)) < 0.8).to(cuda)
    valid[:, 0] = True
    before = _counts(mha_flash)
    got = _flash_launch("simt", q, k, v, kv_valid=valid, causal=True)
    _launched(mha_flash, "simt", before)
    _close(got, mha_flash_ref(q, k, v, kv_valid=valid, causal=True), F32_TOL)
    with pytest.raises(ValueError, match="route"):
        _flash_launch("tc", q, k, v, kv_valid=valid, causal=True)
    q, qp, k, v, hht, live = _selective_case(rng, cuda, 2, 2, 2, 16, 448, 128, 0,
                                             (torch.float32,) * 3)
    before = _counts(selective_mha)
    got = _selective_launch("simt", q, qp, k, v, hht, live=live, window=0, q_block=64,
                            kv_block=64)
    _launched(selective_mha, "simt", before)
    _close(got, selective_mha_ref(q, qp, k, v, hht, window=0), F32_TOL)


def _paged_inputs(cuda, rng, lens, page, n_pages, L, Hkv, G, D, qd, ad):
    """q, arenas and the page view of rows of the given lengths, each with
    its slots drawn at random (never page-aligned) plus the new token's."""
    lens = np.asarray(lens, np.int64)
    tables = np.zeros((len(lens), max(int(lens.max()), 1)), np.int64)
    new_pages, new_slots = np.zeros(len(lens), np.int64), np.zeros(len(lens), np.int64)
    for i, ln in enumerate(lens):
        slots = rng.choice(np.arange(page, n_pages * page), int(ln) + 1, replace=False)
        tables[i, :ln] = slots[:-1]
        new_pages[i], new_slots[i] = divmod(int(slots[-1]), page)
    pg, sp = page_views(tables, lens, new_pages, new_slots, page)
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
    ak, av = g(n_pages, page, L, Hkv, D).to(ad), g(n_pages, page, L, Hkv, D).to(ad)
    q = g(len(lens), Hkv * G, D).to(qd)
    return q, ak, av, torch.from_numpy(pg).to(cuda), torch.from_numpy(sp).to(cuda)


def _paged_check(q, ak, av, pg, sp, layer):
    """The kernel against the plain version; -> the launch's (pages per
    split, splits)."""
    before = paged_decode_mha.launches
    got = paged_decode_mha(q, ak, av, pg, sp, layer=layer, rope_theta=1e6)
    assert paged_decode_mha.launches == before + 1
    want = paged_decode_ref(q, ak, av, pg, sp, layer=layer, rope_theta=1e6)
    exact = q.dtype == ak.dtype == torch.float32
    _close(got, want, F32_TOL if exact else BF16_TOL)
    return paged_decode_mha.last_splits


_PAGED_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                 (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _PAGED_DTYPES, ids=["q32-kv32", "q32-kv16", "q16-kv32",
                                                      "q16-kv16"])
@pytest.mark.parametrize("page", [1, 4, 16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_paged_decode_kernel_matches_plain(cuda, G, D, page, dtypes):
    """Mixed long and short rows in one batch, among them rows whose only
    live slot is the new token; both layers of a two-layer arena."""
    qd, ad = dtypes
    rng = np.random.default_rng(G * 1000 + D * 10 + page)
    lens = [0, 1200, 37, 0, 400, 5]
    q, ak, av, pg, sp = _paged_inputs(cuda, rng, lens, page, 2048 // page, 2, 2, G, D, qd, ad)
    for layer in range(2):
        pps, splits = _paged_check(q, ak, av, pg, sp, layer)
        assert pps * splits >= pg.shape[1] > pps * (splits - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _PAGED_DTYPES[:1] + _PAGED_DTYPES[2:3])
@pytest.mark.parametrize("G", [3, 5, 6, 12])
def test_paged_decode_kernel_uneven_groups(cuda, G, dtypes):
    """Groups that are not a power of two run padded to the next one; the
    pad heads are never written."""
    rng = np.random.default_rng(G)
    q, ak, av, pg, sp = _paged_inputs(cuda, rng, [0, 300, 41], 16, 64, 2, 2, G, 128, *dtypes)
    _paged_check(q, ak, av, pg, sp, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _PAGED_DTYPES[:1] + _PAGED_DTYPES[2:3])
def test_paged_decode_kernel_long_row(cuda, dtypes):
    """N = 1 with a ~4,000-token row (Pmax 252): many splits."""
    rng = np.random.default_rng(5)
    q, ak, av, pg, sp = _paged_inputs(cuda, rng, [4000], 16, 300, 2, 8, 4, 128, *dtypes)
    _, splits = _paged_check(q, ak, av, pg, sp, 1)
    assert splits > 8


@pytest.mark.cuda
def test_paged_decode_kernel_served_shape_splits(cuda):
    """The served call (8 rows of ~430-460 tokens, 32 / 8 heads, head dim
    128, bf16 q over an fp32 arena, page 16) runs split-K with at least
    two blocks per SM of an H100."""
    rng = np.random.default_rng(6)
    lens = rng.integers(430, 461, 8)
    q, ak, av, pg, sp = _paged_inputs(cuda, rng, lens, 16, 512, 2, 8, 4, 128,
                                      torch.bfloat16, torch.float32)
    pps, splits = _paged_check(q, ak, av, pg, sp, 1)
    assert splits > 1 and 8 * 8 * splits >= 264


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _PAGED_DTYPES, ids=["q32-kv32", "q32-kv16", "q16-kv32",
                                                      "q16-kv16"])
@pytest.mark.parametrize("D", [2, 6, 10, 16])
def test_paged_decode_kernel_narrow_and_unaligned_rows(cuda, D, dtypes):
    """Rows whose width is not a multiple of 16 bytes, and arenas 4 bytes
    off a 16-byte boundary, take the kernel's 4-byte copies."""
    qd, ad = dtypes
    rng = np.random.default_rng(D)
    q, ak, av, pg, sp = _paged_inputs(cuda, rng, [0, 70, 9], 4, 64, 2, 2, 4, D, qd, ad)
    _paged_check(q, ak, av, pg, sp, 1)
    shift = 4 // ak.element_size()

    def unaligned(t):
        v = torch.empty(t.numel() + shift, dtype=t.dtype, device=cuda)[shift:].view(t.shape)
        return v.copy_(t)

    ak4, av4 = unaligned(ak), unaligned(av)
    assert ak4.data_ptr() % 16 == 4 and av4.data_ptr() % 16 == 4
    _paged_check(q, ak4, av4, pg, sp, 1)


@pytest.mark.cuda
def test_paged_decode_kernel_dead_row_gives_zero(cuda):
    """A row with no live slot gives exactly 0, as the TPU kernel does (it
    skips every page; the plain version would average the masked values);
    the other rows match the plain version."""
    rng = np.random.default_rng(7)
    q, ak, av, pg, sp = _paged_inputs(cuda, rng, [90, 3, 200], 16, 64, 1, 2, 4, 128,
                                      torch.float32, torch.float32)
    sp[1] = -1
    got = paged_decode_mha(q, ak, av, pg, sp, layer=0, rope_theta=1e6)
    want = paged_decode_ref(q, ak, av, pg, sp, layer=0, rope_theta=1e6)
    torch.cuda.synchronize()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    _close(got[[0, 2]], want[[0, 2]], F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(4))
def test_block_gather_kernel_matches_plain(cuda, seed, dtype):
    """Unrotated gathers and every value are bitwise copies; rotated keys
    differ from the plain version only by sin/cos rounding (the angles are
    bitwise equal: the kernel takes the plain version's frequencies)."""
    rng = np.random.default_rng(seed)
    n_pages, page = int(rng.integers(2, 300)), int(rng.choice([1, 4, 16]))
    tail = ((int(rng.choice([16, 64])),) if seed % 2 else
            (int(rng.choice([1, 2, 8])), int(rng.choice([16, 64, 128]))))
    pk = torch.from_numpy(rng.normal(size=(n_pages, page) + tail).astype(np.float32))
    pk, pv = pk.to(cuda, dtype), (-pk).to(cuda, dtype)
    n_logical = int(rng.integers(1, 2 * n_pages))
    bt = torch.from_numpy(rng.integers(0, n_pages, n_logical).astype(np.int32)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, 4096, (n_logical, page)).astype(np.int32)).to(cuda)
    before = PoolGather.launches
    k, v = assemble_kv(pk, pv, bt, pos, rotate=False)
    kr, vr, kraw = assemble_kv(pk, pv, bt, pos, rotate=True, keep_raw=True)
    assert PoolGather.launches == before + 2
    want_k, want_v = block_gather_ref(pk, pv, bt, pos, rotate=False)
    torch.cuda.synchronize()
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    assert torch.equal(kraw, want_k) and torch.equal(vr, want_v)
    _close(kr, block_gather_ref(pk, pv, bt, pos, rotate=True)[0],
           1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 8, 32, 128, 33])
def test_embedding_bag_kernel_matches_plain(cuda, d, dtype):
    """Both sum each bag's rows in fp32: fp32 outputs differ only by the
    plain version's summation order (1e-5 of max(1, max|out|)); bf16
    outputs by at most the one final rounding (2^-7 relative)."""
    rng = np.random.default_rng(d)
    rows = 5000
    table = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(cuda, dtype)
    for F in (1, 13, 40):
        for B in (1, 512, 4097):
            ids = torch.from_numpy(rng.integers(0, rows, (B, F)).astype(np.int32)).to(cuda)
            before = bag_sum.launches
            got = bag_sum(table, ids)
            assert bag_sum.launches == before + 1
            want = embedding_bag_ref(table, ids)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (B, d)
            assert torch.isfinite(got).all()
            if dtype == torch.float32:
                tol = 1e-5 * max(1.0, float(want.abs().max()))
                torch.testing.assert_close(got, want, rtol=0, atol=tol)
            else:
                torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 32])
def test_embedding_bag_staged_tiles_match_plain(cuda, d, dtype):
    """B5's staged tiles against the plain version: batches that are not
    a multiple of the tile (4,097 bags in tiles of 16, 10,001 in tiles of
    32), B = 1 and the small-batch tiles (512 bags: two a tile on 132
    SMs); F = 0, 1, 40 and 130 (more fields than one chunk of the tile
    when d = 32); ids at 0 and at rows - 1, and bags that repeat one row;
    two calls bitwise equal (the sums run in one order); each call one
    launch."""
    rng = np.random.default_rng(d)
    rows = 3000
    table = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(cuda, dtype)
    for F in (0, 1, 40, 130):
        for B in (1, 33, 512, 4097, 10_001):
            ids = torch.from_numpy(rng.integers(0, rows, (B, F)).astype(np.int32)).to(cuda)
            if F:
                ids[0] = 0
                ids[-1] = rows - 1
                ids[B // 2] = int(rng.integers(rows))
            before = bag_sum.launches
            got, again = bag_sum(table, ids), bag_sum(table, ids)
            assert bag_sum.launches == before + 2
            want = embedding_bag_ref(table, ids)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (B, d) and torch.isfinite(got).all()
            assert torch.equal(got, again)
            scale = max(1.0, float(want.float().abs().max()))
            tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * scale
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_embedding_bag_wide_deep_batches_match_plain(cuda):
    """`bag_sum` at Wide&Deep's serve_p99 and a serve_bulk-sized batch (40
    fields into a 9 M-row d = 1 table): the plain version within 1e-5 of
    max(1, max|out|), a second call bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(3)
    rows = 8_933_376
    table = torch.randn(rows, 1, device=cuda, generator=g) * 0.05
    for B in (512, 262_144):
        ids = torch.randint(0, rows, (B, 40), device=cuda, generator=g, dtype=torch.int32)
        got = bag_sum(table, ids)
        want = embedding_bag_ref(table, ids)
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert torch.equal(got, bag_sum(table, ids))
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 33])
def test_embedding_bag_kernel_accumulates_bf16_in_fp32(cuda, d):
    """100 rows of 1 + 2^-7 in bf16 sum to exactly 101.0 when summed in
    fp32 and rounded once; a running bf16 sum would end at 100.5, which
    the 2^-7 relative tolerance above would let pass."""
    table = torch.full((4, d), 1 + 2 ** -7, dtype=torch.bfloat16, device=cuda)
    ids = torch.zeros((3, 100), dtype=torch.int32, device=cuda)
    got = bag_sum(table, ids)
    assert got.dtype == torch.bfloat16
    assert (got.float().cpu() == 101.0).all()


@pytest.mark.cuda
def test_widedeep_reduced_card_equals_cpu(cuda):
    """Wide&Deep at reduced() width scores and retrieves the same on the
    card (wide sum through the kernel) as on the CPU (plain version)."""
    import copy

    from repro_torch.configs import registry as R
    from repro_torch.launch import steps as S
    from repro_torch.recsys import models as RM

    cfg = R.get_config("wide-deep", smoke=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = RM.init_params(cfg, gen, cuda)
    cpu = copy.deepcopy(model).to("cpu")
    for shape in ("serve_p99", "retrieval_cand"):
        batch = R.make_batch(cfg, shape, gen, cuda, batch=64)
        before = bag_sum.launches
        fn = S.step_of(shape)
        got = fn(model, batch)
        assert bag_sum.launches == before + 1
        want = fn(cpu, {k: v.cpu() for k, v in batch.items()})
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 128, device=cuda)
    k = torch.zeros(1, 8, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mha_flash(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError, match="dtype"):
        mha_flash(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="D <= 128"):
        mha_flash(torch.zeros(1, 8, 4, 256, device=cuda), torch.zeros(1, 8, 2, 256, device=cuda),
                  torch.zeros(1, 8, 2, 256, device=cuda))
    pool = torch.zeros(4, 1, 2, 16, device=cuda)
    table = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        assemble_kv(pool, pool, table.long(), table[:, None])
    with pytest.raises(ValueError, match="positions"):
        assemble_kv(pool, pool, table, table)
    with pytest.raises(TypeError, match="dtype"):
        bag_sum(torch.zeros(4, 1, device=cuda), table[None].long())
    with pytest.raises(ValueError, match="need"):
        bag_sum(torch.zeros(4, 1, 1, device=cuda), table[None])


def _tiny_tokens(cuda, sched, kv_reuse=False):
    """Greedy tokens of the tiny rcllm model served on the card and on the
    CPU.  With `kv_reuse`, a repeat-user trace in two arrival waves (the
    second meets a warm store: prefix-tier hits injected before compute);
    both runs must end with the partition intact and no page held."""
    import copy

    from repro_torch.launch import serve as SERVE
    from repro_torch.serving.api import ServeConfig
    from repro_torch.serving.batching import PendingRequest
    from repro_torch.serving.block_store import check_partition

    tokens, model = {}, None
    config = ServeConfig(decode_steps=4, sched=sched, chunk_tokens=64, kv_reuse=kv_reuse)
    n, zipf = (8, 1.4) if kv_reuse else (4, None)
    for dev in (cuda, torch.device("cpu")):
        sys_, reqs, plans, reuse = SERVE.rcllm_setup(None, dev, n, 1e6, 4, model=model,
                                                     zipf_users=zipf)
        if kv_reuse:
            reqs = [PendingRequest(0.0 if r.rid < n // 2 else 1e3, r.rid, r.n_tokens,
                                   r.decode_steps, r.tokens) for r in reqs]
        engine, backend, _, done = SERVE.serve(sys_.model, sys_.cfg, config, reqs, plans,
                                               sys_.rows, reuse)
        assert len(done) == n and engine.pool.stats().pages_in_use == 0
        check_partition(engine.pool, engine.store)
        tokens[dev.type] = {r: backend.generated[r] for r in sorted(backend.generated)}
        model = copy.deepcopy(sys_.model).to("cpu")
    return tokens


@pytest.mark.cuda
def test_tiny_rcllm_serving_card_equals_cpu(cuda):
    """The whole serving path on the card decodes the plain versions'
    greedy tokens on the CPU (same weights, each its own offline cache)."""
    tokens = _tiny_tokens(cuda, "wave")
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.cuda
def test_tiny_rcllm_chunked_serving_card_equals_cpu(cuda):
    """The same under the chunked scheduler (block gather, selective and
    paged decode kernels on the card)."""
    before = PoolGather.launches
    tokens = _tiny_tokens(cuda, "chunked")
    assert PoolGather.launches > before
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_tiny_rcllm_kv_reuse_serving_card_equals_cpu(cuda, sched):
    """Serving through the shared block store on the card decodes the plain
    versions' tokens on the CPU; the prefix tier's hits reach the selective
    layers through the block gather's second pool."""
    before = PoolGather.pool2_launches
    tokens = _tiny_tokens(cuda, sched, kv_reuse=True)
    assert PoolGather.pool2_launches > before
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rotate", [False, True])
def test_block_gather_kernel_second_pool(cuda, dtype, rotate):
    """Table entries past the first pool read a second pool laid out as a
    layer plane of the serving arena (one-slot pages L planes apart): the
    kernel against the plain version, copies bitwise, the launch counted
    on the second-pool route; an entry past both pools gives zeros."""
    from repro_torch.serving.kv_pool import PagedKVPool

    rng = np.random.default_rng(int(rotate) + 2 * (dtype == torch.bfloat16))
    arena = PagedKVPool(5, 8, 128, page_size=16, n_pages=40, device=cuda, dtype=dtype)
    arena.arena_k.normal_()
    arena.arena_v.normal_()
    pk = torch.from_numpy(rng.normal(size=(300, 1, 8, 128)).astype(np.float32))
    pk, pv = pk.to(cuda, dtype), (-pk).to(cuda, dtype)
    k2, v2 = (p[3] for p in arena.planes())
    n2 = k2.shape[0]
    table = rng.integers(0, 300 + n2, 700).astype(np.int32)
    table[:5] = 300 + n2 + np.arange(5)            # past both pools
    bt = torch.from_numpy(table).to(cuda)
    pos = torch.from_numpy(rng.integers(0, 4096, (700, 1)).astype(np.int32)).to(cuda)
    before = (PoolGather.launches, PoolGather.pool2_launches)
    got = assemble_kv(pk, pv, bt, pos, rotate=rotate, keep_raw=rotate, pool2_k=k2,
                      pool2_v=v2)
    assert (PoolGather.launches, PoolGather.pool2_launches) == (before[0] + 1,
                                                                  before[1] + 1)
    safe = bt.clone()
    safe[:5] = 0
    want = block_gather_ref(pk, pv, safe, pos, rotate=rotate, pool2_k=k2, pool2_v=v2)
    torch.cuda.synchronize()
    assert torch.equal(got[1][5:], want[1][5:])
    assert not got[0][:5].any() and not got[1][:5].any()
    if rotate:
        raw = torch.cat([pk, k2])[safe.long()]
        assert torch.equal(got[2][5:], raw[5:])
        _close(got[0][5:], want[0][5:], 1e-5 if dtype == torch.float32 else 1e-2)
    else:
        assert torch.equal(got[0][5:], want[0][5:])


@pytest.mark.cuda
@pytest.mark.parametrize("two_pools", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_gather_all_layers_is_bitwise_the_per_layer_launches(cuda, dtype, two_pools):
    """One launch gathers layers 1..L-1 of a cached-row pool (and of the
    serving arena's layer planes as the second pool): bitwise the plain
    version, and bitwise L-1 one-layer launches, rotated keys included;
    pad rows read the zero row, entries past both pools give zeros."""
    from repro_torch.kernels.block_gather.ref import block_gather_layers_ref
    from repro_torch.serving.kv_pool import PagedKVPool

    L, H, D, n_rows = 6, 8, 128, 300
    rng = np.random.default_rng(5 + two_pools + 2 * (dtype == torch.bfloat16))
    pk = torch.from_numpy(rng.normal(size=(L, n_rows, 1, H, D)).astype(np.float32))
    pk, pv = pk.to(cuda, dtype), (-pk).to(cuda, dtype)
    pk[:, 0] = 0
    pv[:, 0] = 0
    extra, n2 = (), 0
    if two_pools:
        arena = PagedKVPool(L, H, D, page_size=16, n_pages=12, device=cuda, dtype=dtype)
        arena.arena_k.normal_()
        arena.arena_v.normal_()
        extra = arena.planes()
        n2 = extra[0].shape[1]
    table = rng.integers(0, n_rows + n2, 700).astype(np.int32)
    table[600:] = 0                                  # pad rows: the zero row
    if two_pools:
        table[:5] = n_rows + n2 + np.arange(5)       # past both pools
    bt = torch.from_numpy(table).to(cuda)
    pos = torch.from_numpy(rng.integers(0, 4096, 700).astype(np.int32)).to(cuda)
    g = PoolGather(pk, pv, *extra, rope_theta=1e4)
    before = (PoolGather.launches, PoolGather.layer_launches, PoolGather.pool2_launches)
    got = g(bt, pos, range(1, L), rotate=True, keep_raw=True)
    assert (PoolGather.launches, PoolGather.layer_launches, PoolGather.pool2_launches) == (
        before[0] + 1, before[1] + 1, before[2] + two_pools)
    assert all(t.shape == (L - 1, 700, H, D) and t.is_contiguous() for t in got)
    per_layer = [g(bt, pos, l, rotate=True, keep_raw=True) for l in range(1, L)]
    safe = bt.clone()
    safe[:5 if two_pools else 0] = 0
    want = block_gather_layers_ref(pk[1:], pv[1:], safe, pos[:, None], rope_theta=1e4,
                                   keep_raw=True,
                                   **({"pool2_k": extra[0][1:], "pool2_v": extra[1][1:]}
                                      if two_pools else {}))
    copy = g(bt, None, range(1, L), rotate=False)
    torch.cuda.synchronize()
    for i, (a, w) in enumerate(zip(got, want)):
        assert torch.equal(a, torch.stack([p[i] for p in per_layer]))
        w = w[:, :, 0]
        if two_pools:
            assert not a[:, :5].any()
            a, w = a[:, 5:], w[:, 5:]
        assert torch.equal(a, w)
    assert torch.equal(copy[0], got[2]) and torch.equal(copy[1], got[1])
    assert not got[1][:, 600:].any() and not got[2][:, 600:].any()


@pytest.mark.cuda
def test_selective_pass_gathers_every_layer_in_one_launch(cuda):
    """The selective prefill of the tiny system on the card: one block-
    gather launch per request for layer 0's rows, and one for layers 1..L-1
    of each selective pass (a shape bucket), not one per layer."""
    from repro_torch.core import engine as ENG
    from repro_torch.core.rcllm import make_tiny_system
    from repro_torch.data import synth as SY

    sys_, pool_rv, prof, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=2,
                                              n_layers=4, d_model=32, device=cuda)
    reqs = SY.make_trace(sys_.catalog, pool_rv, prof, 3, qps=5.0, n_users=4, n_candidates=8,
                         reviews_per_user=2, seed=7)
    items = []
    for r in reqs:
        plan = sys_.plan_for(r, 0)
        table, positions, have = sys_.cached_kv(plan, 0)
        items.append((plan, table, positions, have))
    before = (PoolGather.launches, PoolGather.layer_launches)
    out = ENG.selective_prefill_batch(sys_.model, sys_.cfg, items, ENG.SelectiveConfig(),
                                      sys_.rows)
    torch.cuda.synchronize()
    n_bucket = len({(-(-p.n // 128) * 128, max(64, -(-int(s.n_recomputed) // 64) * 64))
                    for (p, *_), (_, s, _, _) in zip(items, out)})
    assert PoolGather.layer_launches == before[1] + n_bucket
    assert PoolGather.launches == before[0] + len(items) + n_bucket
    for (plan, *_), (logits, _, k_all, v_all) in zip(items, out):
        assert k_all.shape == (plan.n, 4) + tuple(sys_.rows.k.shape[3:])
        assert np.isfinite(logits).all() and torch.isfinite(k_all).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _PAGED_DTYPES[:1] + _PAGED_DTYPES[2:3])
def test_paged_decode_kernel_store_shared_pages(cuda, dtypes):
    """Page views as the block store makes them: each row maps shared store
    blocks (several rows read the same physical pages, from any offset)
    between its own private pages, so a row touches many pages full of
    dead (-1) slots and whole splits of them; kernel against the plain
    version (and the served shape's split choice)."""
    rng = np.random.default_rng(13)
    page, n_pages = 16, 512
    store_blocks = [np.arange(p * page, p * page + int(rng.integers(5, 40)))
                    for p in range(1, 120, 3)]
    tables, lens = [], []
    free = iter(range(130, n_pages))
    for _ in range(8):
        pieces, n = [], 0
        for b in rng.choice(len(store_blocks), 12, replace=False):
            blk = store_blocks[b]
            off = np.sort(rng.choice(len(blk), int(rng.integers(1, len(blk) + 1)),
                                     replace=False))
            pieces.append(blk[off])                      # shared, any alignment
            priv = next(free) * page + np.arange(int(rng.integers(1, page)))
            pieces.append(priv)                          # private, partly used
        row = np.concatenate(pieces)
        tables.append(row)
        lens.append(len(row))
    table = np.zeros((8, max(lens)), np.int64)
    for i, row in enumerate(tables):
        table[i, :len(row)] = row
    new = np.asarray([next(free) for _ in range(8)])
    pg, sp = page_views(table, np.asarray(lens), new, np.zeros(8, np.int64), page)
    assert pg.shape[1] > 24 and (sp < 0).mean() > 0.3
    shared = np.intersect1d(pg[0], pg[1])
    assert len(shared[shared > 0])                  # rows share physical pages
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
    ak, av = g(n_pages, page, 2, 8, 128), g(n_pages, page, 2, 8, 128)
    q = g(8, 32, 128).to(dtypes[0])
    ak, av = ak.to(dtypes[1]), av.to(dtypes[1])
    pgt, spt = torch.from_numpy(pg).to(cuda), torch.from_numpy(sp).to(cuda)
    # a split whose pages are all dead: blank out a run of page columns
    spt[:, 4:12] = -1
    _, splits = _paged_check(q, ak, av, pgt, spt, 1)
    assert splits > 1



@pytest.mark.cuda
def test_migrated_request_decodes_bitwise_on_the_card(cuda):
    """KV migration on one card: a request whose slot table maps a store
    block and private pages is exported from one engine's pool (pages
    gathered on the card) and imported into a second engine's (scattered on
    the card, its store block by content key); one decode step through the
    paged-decode kernel then gives bitwise the same logits on both, since
    the kernel reads the same bytes through the same view."""
    from repro_torch.core.rcllm import tiny_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import block_store as BS
    from repro_torch.serving.batch_engine import BatchEngine
    from repro_torch.serving.block_store import SharedBlockStore, check_partition
    from repro_torch.serving.kv_pool import pool_for

    cfg = tiny_config(2, 32)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    engines = []
    for _ in range(2):
        pool = pool_for(cfg, n_pages=64, device=cuda)
        engines.append(BatchEngine(model, cfg, pool=pool, store=SharedBlockStore(pool)))
    src, dst = engines
    g = torch.Generator(device=cuda).manual_seed(1)
    rows = lambda t: torch.randn((t, cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim),
                                 generator=g, device=cuda)
    key = (BS.ITEM_TIER, "migrated-block")
    blk = src.store.insert(key, BS.ITEM_TIER, rows(21), rows(21))
    blk.refcount += 1
    src.store_refs[7] = [key]
    n = 53
    src.pool.alloc_mapped(7, n + 4, np.arange(3, 24), np.asarray(blk.slots, np.int64))
    priv = np.setdiff1d(np.arange(n), np.arange(3, 24))
    src.pool.write_at(7, priv, rows(len(priv)), rows(len(priv)))
    rec = src.export_request_kv(7)
    assert rec.export.page_k.is_cuda and list(rec.payloads) == [key]
    counters = dst.import_request_kv(rec)
    assert counters["digest_hits"] == 0 and counters["pages"] == rec.export.n_pages
    for eng in engines:
        check_partition(eng.pool, eng.store)
        k, v = eng.pool.gather(7)
        assert k.shape[0] == n
    assert all(np.array_equal(a, b) for a, b in zip(src.pool.gather(7), dst.pool.gather(7)))
    before = paged_decode_mha.launches
    out = [eng.decode([7], [11]) for eng in engines]
    assert paged_decode_mha.launches == before + 2 * cfg.n_layers
    assert np.isfinite(out[0]).all() and np.array_equal(out[0], out[1])
    for eng in engines:
        eng.release(7)
        assert eng.pool.stats().pages_in_use == 0
        check_partition(eng.pool, eng.store)


@pytest.mark.cuda
def test_block_gather_rotates_to_original_positions_bitwise(cuda):
    """CacheBlend's gather: the tiny system's cached rows rotated to the
    blocks' original positions (`arange(n) - rope_delta`), not the request
    positions, equal the plain version on the same card tensors bit for
    bit in every layer (keys rotated, values and raw keys copied)."""
    from repro_torch.core import engine as ENG
    from repro_torch.core.rcllm import make_tiny_system
    from repro_torch.data import synth as SY

    sys_, pool_rv, prof, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=2,
                                              n_layers=2, d_model=32, device=cuda)
    req = SY.make_trace(sys_.catalog, pool_rv, prof, 1, qps=5.0, n_users=4, n_candidates=8,
                        reviews_per_user=2, seed=7)[0]
    plan = sys_.plan_for(req, 0)
    table, _, have = sys_.cached_kv(plan, 0)
    original = (np.arange(plan.n) - plan.rope_delta).astype(np.int32)
    assert (original != np.arange(plan.n))[have].any()
    tbl, pos = (torch.from_numpy(a).to(cuda) for a in (table, original))
    theta = sys_.cfg.rope_theta
    gather = ENG.cache_gather(sys_.rows, theta, None, kernels=True)
    for layer in range(sys_.cfg.n_layers):
        before = PoolGather.launches
        k, v, kraw = gather(tbl, pos, layer, rotate=True, keep_raw=True)
        assert PoolGather.launches == before + 1
        want_k, want_v = block_gather_ref(sys_.rows.k[layer], sys_.rows.v[layer], tbl,
                                          pos[:, None], rope_theta=theta, rotate=True)
        raw_k, _ = block_gather_ref(sys_.rows.k[layer], sys_.rows.v[layer], tbl,
                                    pos[:, None], rotate=False)
        torch.cuda.synchronize()
        assert torch.equal(k, want_k[:, 0]) and torch.equal(v, want_v[:, 0])
        assert torch.equal(kraw, raw_k[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_tiny_server_replay_card_equals_cpu(cuda, sched):
    """The session server's speed-0 replay on the card decodes the CPU
    plain versions' tokens (same weights), with the pool clean after."""
    import copy

    from repro_torch.launch import serve as SERVE
    from repro_torch.serving import api as API
    from repro_torch.serving.server import serve_trace

    tokens, model = {}, None
    config = API.ServeConfig(decode_steps=4, sched=sched, chunk_tokens=64)
    for dev in (cuda, torch.device("cpu")):
        sys_, reqs, plans, _ = SERVE.rcllm_setup(None, dev, 4, 1e6, 4, model=model)
        engine = API.build_engine(sys_.model, sys_.cfg, config, cache=sys_.rows)
        backend = API.build_backend(engine, config)
        done, server = serve_trace(backend, config, [(r.arrival_s, API.SubmitRequest(
            rid=r.rid, tokens=r.tokens, max_tokens=4, context=plans[r.rid])) for r in reqs])
        assert all(c.reason == "length" for c in done.values()) and len(done) == 4
        assert engine.pool.stats().pages_in_use == 0
        tokens[dev.type] = {rid: c.tokens for rid, c in sorted(done.items())}
        model = copy.deepcopy(sys_.model).to("cpu")
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.cuda
def test_tiny_rank_card_equals_cpu(cuda):
    """`RcLLMSystem.rank` with all four methods on the card scores as the
    CPU plain versions do (fp32, TF32 off: summation order only)."""
    import copy

    from repro_torch.core.engine import SelectiveConfig
    from repro_torch.core.rcllm import make_tiny_system
    from repro_torch.data import synth as SY

    scores, model = {}, None
    for dev in (cuda, torch.device("cpu")):
        sys_, pool_rv, prof, _ = make_tiny_system(n_items=60, n_requests_hist=30,
                                                  device=dev, model=model)
        reqs = SY.make_trace(sys_.catalog, pool_rv, prof, 2, qps=5.0, n_users=4,
                             n_candidates=10, reviews_per_user=2, seed=99)
        sel = SelectiveConfig(r_item=0.3, r_rev=0.3, window=16)
        scores[dev.type] = [sys_.rank(r, m, sel)[0] for r in reqs
                            for m in ("full", "rcllm", "cacheblend", "epic")]
        model = copy.deepcopy(sys_.model).to("cpu")
    for got, want in zip(scores["cuda"], scores["cpu"]):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _launch_counts():
    """Every serving kernel's launch counter (what `chip_smoke.py` reads)."""
    return {"flash": mha_flash.launches, "selective": selective_mha.launches,
            "paged_decode": paged_decode_mha.launches, "block_gather": PoolGather.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_tiny_attn_backends_decode_equal_tokens(cuda, sched):
    """The attention-backend seam on the card at the tiny config: "cuda",
    "plain", "plain" with the decode pinned to the paged kernel, and
    "cuda" with the per-request rcllm prefill decode the same greedy
    tokens (fp32, TF32 off); "plain" launches no kernel and the decode pin
    only the paged-decode kernel, "cuda" the three of the serving path
    (the flash kernel runs in the offline build, before serving)."""
    from repro_torch.launch import serve as SERVE
    from repro_torch.serving import api as API

    sys_, reqs, plans, _ = SERVE.rcllm_setup(None, cuda, 4, 1e6, 4)
    runs = {"cuda": dict(attn_backend="cuda"), "plain": dict(attn_backend="plain"),
            "plain+paged": dict(attn_backend="plain", decode_kernel="paged")}
    tokens, launched = {}, {}
    for label, kw in runs.items():
        config = API.ServeConfig(decode_steps=4, sched=sched, chunk_tokens=64, **kw)
        before = _launch_counts()
        _, backend, _, done = SERVE.serve(sys_.model, sys_.cfg, config, reqs, plans,
                                          sys_.rows)
        torch.cuda.synchronize()
        launched[label] = {k: v - before[k] for k, v in _launch_counts().items()}
        assert len(done) == 4 and backend.attn_backend == label.split("+")[0]
        tokens[label] = {r: backend.generated[r] for r in sorted(backend.generated)}
    assert tokens["plain"] == tokens["cuda"] == tokens["plain+paged"]
    # serving runs no offline build, so no flash launch
    assert launched["cuda"]["flash"] == 0, launched
    assert all(n > 0 for k, n in launched["cuda"].items() if k != "flash"), launched
    assert not any(launched["plain"].values()), launched
    assert launched["plain+paged"]["paged_decode"] > 0
    assert not any(v for k, v in launched["plain+paged"].items() if k != "paged_decode")
    if sched == "wave":
        # the per-request rcllm prefill, straight through the engine
        from repro_torch.serving.workload import rcllm_batch_requests
        from repro_torch.data import synth as SY
        sys2, pool_rv, prof = SERVE.rcllm_system(None, cuda, model=sys_.model)
        trace = SY.make_trace(sys2.catalog, pool_rv, prof, 4, qps=1e6, n_users=3,
                              n_candidates=8, reviews_per_user=1, seed=2)
        brs = rcllm_batch_requests(sys2, trace, n_reserve=2)
        logits = {}
        for batched in (True, False):
            eng = API.build_engine(sys2.model, sys2.cfg, API.ServeConfig(), cache=sys2.rows,
                                   batched_selective=batched)
            logits[batched] = eng.prefill(brs, mode="rcllm")
        _close(torch.from_numpy(logits[False]), torch.from_numpy(logits[True]), 1e-4)


# ------------------------------------------------ LM serving steps (plain torch)
_LM_ARCHS = ["gemma-7b", "nemotron-4-15b", "starcoder2-15b", "moonshot-v1-16b-a3b",
             "kimi-k2-1t-a32b", "starcoder2-15b:window8"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_reduced_steps_card_equal_cpu(cuda, arch):
    """An LM arch at reduced() size (fp32, TF32 off) prefills and decodes
    on the card as a CPU copy does: logits and caches within 1e-4, greedy
    tokens equal ("starcoder2-15b:window8": an 8-token window, which the
    40-token prompt and the decode steps cross)."""
    import copy
    import dataclasses

    from repro_torch.configs import registry as R
    from repro_torch.models import transformer as TT

    name, _, window = arch.partition(":window")
    cfg = R.get_config(name, smoke=True)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=int(window))
    model = TT.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    cpu = copy.deepcopy(model).to("cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    state = {}
    for m, dev in ((model, cuda), (cpu, torch.device("cpu"))):
        logits, cache = TT.prefill(m, toks.to(dev))
        full = {n: cache[n].new_zeros(R.lm_kv_cache_shape(cfg, 2, 48)) for n in "kv"}
        for n in "kv":
            full[n][:, :, :40] = cache[n]
        state[dev.type] = (logits, full)
    torch.testing.assert_close(state["cuda"][0].cpu(), state["cpu"][0], rtol=1e-4, atol=1e-4)
    pos = torch.tensor([40, 37])
    for _ in range(3):
        nxt = state["cpu"][0].argmax(-1)[:, None]
        for m, dev in ((model, cuda), (cpu, torch.device("cpu"))):
            state[dev.type] = TT.decode_step(m, nxt.to(dev), state[dev.type][1], pos.to(dev))
        (got, gc), (want, wc) = state["cuda"], state["cpu"]
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        for n in "kv":
            torch.testing.assert_close(gc[n].cpu(), wc[n], rtol=1e-4, atol=1e-4)
        assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
        pos = pos + 1


@pytest.mark.cuda
def test_lm_matmul_f32_keeps_bf16_products_unrounded(cuda):
    """bf16 scores leave the product in fp32, as the reference's
    preferred_element_type=float32: equal to the fp32 product of the same
    bf16 values up to summation order, strided operands included."""
    from repro_torch.models.layers import matmul_f32

    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(4, 64, 128, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(4, 300, 128, device=cuda, generator=g).to(torch.bfloat16)
    got = matmul_f32(a, b[:, 10:200].transpose(1, 2))
    want = torch.bmm(a.float(), b[:, 10:200].float().transpose(1, 2))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 6, 12])
def test_lm_decode_attention_reads_the_cache_in_place(cuda, G):
    """bf16 decode over a (B, S, Hkv, D) cache allocates less than one
    copy of its k (scores and probabilities: (B, Hq, S), 2.5 x 4 bytes
    each; a head-major copy of the cache would add all of k), and agrees
    with the per-head product in fp32."""
    from repro_torch.models.layers import decode_attention

    B, S, Hkv, D = 2, 8192, 4, 128
    g = torch.Generator(device=cuda).manual_seed(G)
    q = torch.randn(B, 1, Hkv * G, D, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(torch.bfloat16)
    lens = torch.tensor([5000, 8192], device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = decode_attention(q, k, v, lens, sliding_window=4096)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < k.numel() * k.element_size()
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) / D ** 0.5
    idx = torch.arange(S, device=cuda)
    valid = (idx[None] < lens[:, None]) & (idx[None] >= lens[:, None] - 4096)
    s = s.masked_fill(~valid[:, None, None], -1e30)
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    want = torch.einsum("bhgs,bshd->bhgd", p, v.float()).reshape(B, 1, Hkv * G, D)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


# ------------------------------------------------- training kernels (K6, K7)
_BWD_CASES = {   # (B, Sq, Skv, Hq, Hkv, D, causal, window, q offset)
    "causal": (2, 70, 70, 4, 4, 64, True, None, 0),
    "causal_suffix": (1, 40, 90, 4, 2, 128, True, None, 50),
    "window": (2, 66, 66, 6, 1, 16, True, 9, 0),
    "full_window": (1, 50, 50, 12, 1, 32, False, 7, 0),
    "full": (2, 33, 47, 3, 1, 64, False, None, 0),
}


def _bwd_inputs(cuda, case, dtype, D=None, G=None, seed=0):
    from repro_torch.models.layers import chunked_attention

    B, Sq, Skv, Hq, Hkv, d, causal, window, off = _BWD_CASES[case]
    D = D or d
    if G is not None:
        Hq = Hkv * G
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, Skv, Hkv, D, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, Skv, Hkv, D, device=cuda, generator=g).to(dtype)
    dout = torch.randn(B, Sq, Hq, D, device=cuda, generator=g).to(dtype)
    qpos = torch.arange(off, off + Sq, device=cuda, dtype=torch.int32)
    kpos = torch.arange(Skv, device=cuda, dtype=torch.int32)
    out, lse = chunked_attention(q, k, v, causal=causal, q_positions=qpos, kv_positions=kpos,
                                 sliding_window=window, q_chunk=32, kv_chunk=32,
                                 return_lse=True)
    return ((q, k, v, out.contiguous(), lse.contiguous(), dout, qpos, kpos),
            dict(causal=causal, window=window))


def _bwd_want_route(dtype, D):
    """K6's route, written out again: the small-head kernels take D <= 32,
    the tensor cores bf16 at D 64, 128 or 256, the SIMT kernels everything
    else."""
    if D <= 32:
        return "small"
    return "tc" if dtype == torch.bfloat16 and D in (64, 128, 256) else "simt"


def _bwd_check(cuda, args, kw, tol):
    """One K6 call on the route the rule names (one more launch, a tensor-
    core one iff "tc"), within tol x max(1, max|grad|) of `flash_bwd_ref`."""
    from repro_torch.kernels.flash_attention.ops import _bwd_route, mha_flash_bwd
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref

    q = args[0]
    route = _bwd_want_route(q.dtype, q.shape[3])
    assert _bwd_route(*args[:3]) == route
    before = _counts(mha_flash_bwd)
    got = mha_flash_bwd(*args, **kw)
    _launched(mha_flash_bwd, route, before)
    want = flash_bwd_ref(*args, **kw)
    for a, b in zip(got, want):
        _close(a, b, tol * max(1.0, float(b.float().abs().max())))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    """K6 against `flash_bwd_ref` on the card: fp32 within 1e-4, bf16
    within 2e-2 of max(1, max|grad|) (the same roundings of p and dS; the
    order of sums differs)."""
    args, kw = _bwd_inputs(cuda, case, dtype)
    _bwd_check(cuda, args, kw, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.bfloat16, 112)])
@pytest.mark.parametrize("case", ["window", "full_window"])
def test_flash_bwd_simt_route_windowed(cuda, case, dtype, D):
    """The SIMT kernels with a window, causal and not: fp32 at D 64 and
    bf16 at D 112, which no other route takes (the cases' own head dims
    take the small-head route)."""
    args, kw = _bwd_inputs(cuda, case, dtype, D=D)
    assert _bwd_want_route(dtype, D) == "simt"
    _bwd_check(cuda, args, kw, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 6, 12])
def test_flash_bwd_kernel_takes_every_group_and_head_dim(cuda, G, D):
    args, kw = _bwd_inputs(cuda, "window", torch.bfloat16, D=D, G=G, seed=G + D)
    _bwd_check(cuda, args, kw, 2e-2)


# K6's tensor-core route over several 64-row tiles: (B, Sq, Skv, Hkv,
# causal, window, q offset); Hq = Hkv * G
_BWD_TC_CASES = {
    "causal": (2, 192, 192, 2, True, None, 0),
    "window": (1, 256, 256, 2, True, 70, 0),
    "full": (2, 100, 150, 2, False, None, 0),
    "full_window": (1, 200, 180, 2, False, 50, 0),
    "causal_suffix": (1, 90, 250, 2, True, None, 160),
    "ragged": (2, 77, 77, 2, True, None, 0),
}


def _bwd_tc_inputs(cuda, case, G, D, seed=0):
    from repro_torch.models.layers import chunked_attention

    B, Sq, Skv, Hkv, causal, window, off = _BWD_TC_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = dict(device=cuda, dtype=torch.bfloat16)
    q = torch.randn(B, Sq, Hkv * G, D, generator=g, **bf)
    k = torch.randn(B, Skv, Hkv, D, generator=g, **bf)
    v = torch.randn(B, Skv, Hkv, D, generator=g, **bf)
    dout = torch.randn(B, Sq, Hkv * G, D, generator=g, **bf)
    qpos = torch.arange(off, off + Sq, device=cuda, dtype=torch.int32)
    kpos = torch.arange(Skv, device=cuda, dtype=torch.int32)
    out, lse = chunked_attention(q, k, v, causal=causal, q_positions=qpos, kv_positions=kpos,
                                 sliding_window=window, q_chunk=64, kv_chunk=64,
                                 return_lse=True)
    return ((q, k, v, out.contiguous(), lse.contiguous(), dout, qpos, kpos),
            dict(causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_BWD_TC_CASES))
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 6, 12])
def test_flash_bwd_tc_route_matches_plain(cuda, G, D, case):
    """The tensor-core route against `flash_bwd_ref`: causal, windowed,
    non-causal (with and without a window), a suffix of queries at offset
    positions against a longer key range, and a ragged length; bf16 within
    2e-2 of max(1, max|grad|)."""
    args, kw = _bwd_tc_inputs(cuda, case, G, D, seed=G * 1000 + D)
    _bwd_check(cuda, args, kw, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
def test_flash_bwd_tc_route_is_deterministic(cuda, D):
    """No atomics: two calls on the same inputs give bitwise equal dQ, dK
    and dV (a kv head's dK / dV sums G = 6 heads and every query tile)."""
    from repro_torch.kernels.flash_attention.ops import mha_flash_bwd

    args, kw = _bwd_tc_inputs(cuda, "window", 6, D, seed=D)
    first = [t.clone() for t in mha_flash_bwd(*args, **kw)]
    second = mha_flash_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K6's small-head route (D <= 32): (B, Sq, Skv, Hkv, causal, window, q
# offset); Hq = Hkv * G.  Several 64-row tiles, ragged ends, a suffix of
# queries at offset positions against a longer key range
_BWD_SMALL_CASES = {
    "causal": (2, 130, 130, 2, True, None, 0),
    "full": (2, 100, 150, 2, False, None, 0),
    "window": (1, 200, 200, 2, True, 33, 0),
    "full_window": (1, 120, 140, 2, False, 20, 0),
    "ragged_suffix": (1, 77, 250, 2, True, None, 173),
}


def _bwd_small_inputs(cuda, case, G, D, dtype, seed=0):
    from repro_torch.models.layers import chunked_attention

    B, Sq, Skv, Hkv, causal, window, off = _BWD_SMALL_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    q, k, v = mk(B, Sq, Hkv * G, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)
    dout = mk(B, Sq, Hkv * G, D)
    qpos = torch.arange(off, off + Sq, device=cuda, dtype=torch.int32)
    kpos = torch.arange(Skv, device=cuda, dtype=torch.int32)
    out, lse = chunked_attention(q, k, v, causal=causal, q_positions=qpos, kv_positions=kpos,
                                 sliding_window=window, q_chunk=64, kv_chunk=64,
                                 return_lse=True)
    return ((q, k, v, out.contiguous(), lse.contiguous(), dout, qpos, kpos),
            dict(causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_BWD_SMALL_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 12, 16, 32])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_bwd_small_route_matches_plain(cuda, G, D, dtype, case):
    """The small-head route (a row per thread) against `flash_bwd_ref`:
    causal, non-causal, windowed, a ragged suffix of queries against a
    longer key range; fp32 within 1e-4 and bf16 within 2e-2 of max|plain|
    (D 12 pads each row to 16 columns, and in bf16 its 24-byte rows are
    copied without the 16-byte path)."""
    from repro_torch.kernels.flash_attention.ops import _bwd_route, mha_flash_bwd
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref

    args, kw = _bwd_small_inputs(cuda, case, G, D, dtype, seed=G * 100 + D)
    assert _bwd_route(*args[:3]) == "small"
    before = (mha_flash_bwd.launches, mha_flash_bwd.tc_launches, mha_flash_bwd.small_launches)
    got = mha_flash_bwd(*args, **kw)
    assert (mha_flash_bwd.launches, mha_flash_bwd.tc_launches,
            mha_flash_bwd.small_launches) == (before[0] + 1, before[1], before[2] + 1)
    want = flash_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_small_route_is_deterministic(cuda, dtype):
    """No atomics: two calls of the small-head route give bitwise equal dQ,
    dK and dV (a key's dK / dV sums G = 4 heads over four splits)."""
    from repro_torch.kernels.flash_attention.ops import mha_flash_bwd

    args, kw = _bwd_small_inputs(cuda, "window", 4, 16, dtype, seed=3)
    first = [t.clone() for t in mha_flash_bwd(*args, **kw)]
    second = mha_flash_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.flash_attention.ops import mha_flash_bwd

    args, kw = _bwd_inputs(cuda, "causal", torch.float32)
    q, k, v, out, lse, dout, qpos, kpos = args
    with pytest.raises(TypeError):
        mha_flash_bwd(q, k.to(torch.bfloat16), v, out, lse, dout, qpos, kpos, **kw)
    with pytest.raises(ValueError):
        mha_flash_bwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, out, lse, dout,
                      qpos, kpos, **kw)
    big = torch.zeros(1, 4, 1, 288, device=cuda)
    with pytest.raises(ValueError):
        mha_flash_bwd(big, big, big, big, torch.zeros(1, 4, 1, device=cuda), big,
                      qpos[:4], kpos[:4])
    with pytest.raises(TypeError):
        mha_flash_bwd(q, k, v, out, lse, dout, qpos.long(), kpos, **kw)


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card_equals_the_cpu(cuda):
    """The differentiable attention of the training path (plain forward,
    K6 backward) on the card against the CPU (plain backward), fp32."""
    from repro_torch.models.layers import flash_attention

    grads = {}
    for dev in (cuda, torch.device("cpu")):
        g = torch.Generator().manual_seed(4)
        q, k, v = (torch.randn(2, 45, 6, 32, generator=g).to(dev).requires_grad_()
                   for _ in range(3))
        k = k[:, :, :2].detach().requires_grad_()
        v = v[:, :, :2].detach().requires_grad_()
        pos = torch.arange(45)
        out = flash_attention(q, k, v, causal=True, q_positions=pos, kv_positions=pos,
                              sliding_window=20, q_chunk=16, kv_chunk=16)
        (out * torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)).sum().backward()
        grads[dev.type] = [t.grad.cpu() for t in (q, k, v)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 32])
def test_bag_backward_kernel_matches_plain(cuda, dtype, d):
    """K7 against `bag_backward_ref`: repeated rows accumulate; fp32
    within 1e-5 and bf16 within 2^-7 of max(1, max|grad|) (atomics add in
    another order; bf16 rounds once)."""
    from repro_torch.kernels.embedding_bag.ops import bag_backward
    from repro_torch.kernels.embedding_bag.ref import bag_backward_ref

    g = torch.Generator(device=cuda).manual_seed(d)
    rows, B, F = 5000, 300, 40
    ids = torch.randint(0, rows, (B, F), device=cuda, generator=g, dtype=torch.int32)
    ids[:20] = ids[0]
    d_out = torch.randn(B, d, device=cuda, generator=g).to(dtype)
    before = bag_backward.launches
    got = bag_backward(ids, d_out, rows)
    assert bag_backward.launches == before + 1
    want = bag_backward_ref(ids, d_out, rows)
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * max(1.0, float(want.float().abs().max()))
    _close(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 32])
def test_bag_backward_kernel_edges(cuda, dtype, d):
    """K7 against `bag_backward_ref` at F = 0, 1, 40 and 130, B = 1 and
    4,097, ids at 0 and rows - 1 and a bag that repeats one row (40 or
    130 adds into it), within BAG_TOL of max(1, max|grad|)."""
    from repro_torch.kernels.embedding_bag.ops import bag_backward
    from repro_torch.kernels.embedding_bag.ref import bag_backward_ref

    g = torch.Generator(device=cuda).manual_seed(10 + d)
    rows = 2000
    for F in (0, 1, 40, 130):
        for B in (1, 4097):
            ids = torch.randint(0, rows, (B, F), device=cuda, generator=g, dtype=torch.int32)
            if F:
                ids[0, 0], ids[-1, -1] = 0, rows - 1
                ids[B // 2] = 7
            d_out = torch.randn(B, d, device=cuda, generator=g).to(dtype)
            got = bag_backward(ids, d_out, rows)
            want = bag_backward_ref(ids, d_out, rows)
            scale = max(1.0, float(want.float().abs().max()))
            _close(got, want, (1e-5 if dtype == torch.float32 else 2 ** -7) * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 32])
def test_windowed_bag_kernels_match_plain(cuda, dtype, d):
    """B5 and K7 on row windows (a rank's block of a table split by rows
    over 2 and 4 ranks, the whole table at row0 = 0) against their plain
    versions on the same `row0`: B5 within BAG_TOL and bitwise on a second
    call, K7 within BAG_TOL; ids far outside every window (2e9) are
    skipped, never loaded; the whole table's window at row0 = 0 is the
    unwindowed call, and a window shifted with its ids is bitwise the
    same sums."""
    from repro_torch.kernels.embedding_bag.ops import bag_backward
    from repro_torch.kernels.embedding_bag.ref import bag_backward_ref

    g = torch.Generator(device=cuda).manual_seed(20 + d)
    rows, B, F = 8192, 4097, 40
    table = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    ids = torch.randint(0, rows, (B, F), device=cuda, generator=g, dtype=torch.int32)
    ids[:20] = ids[0]
    ids[7, 3] = 2_000_000_000
    d_out = torch.randn(B, d, device=cuda, generator=g).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    whole = bag_sum(table, ids[:, :1].clone().fill_(5))
    assert torch.equal(whole, bag_sum(table, ids[:, :1].clone().fill_(5), row0=0))
    assert torch.equal(bag_sum(table, ids[8:] + 7, row0=7), bag_sum(table, ids[8:]))
    for n in (2, 4):
        step = rows // n
        for c in range(n):
            block = table[c * step:(c + 1) * step]
            before = (bag_sum.launches, bag_backward.launches)
            got, again = bag_sum(block, ids, row0=c * step), bag_sum(block, ids, row0=c * step)
            grad = bag_backward(ids, d_out, step, row0=c * step)
            assert (bag_sum.launches, bag_backward.launches) == (before[0] + 2, before[1] + 1)
            want = embedding_bag_ref(block, ids, row0=c * step)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            _close(got.float(), want.float(), tol * max(1.0, float(want.float().abs().max())))
            gwant = bag_backward_ref(ids, d_out, step, row0=c * step)
            _close(grad.float(), gwant.float(), tol * max(1.0, float(gwant.float().abs().max())))


@pytest.mark.cuda
def test_wide_bag_autograd_launches_both_kernels(cuda):
    from repro_torch.kernels.embedding_bag.ops import bag_backward, bag_sum
    from repro_torch.kernels.embedding_bag.ref import bag_backward_ref
    from repro_torch.recsys.models import WideBagSum

    g = torch.Generator(device=cuda).manual_seed(9)
    table = torch.randn(3000, 1, device=cuda, generator=g).requires_grad_()
    ids = torch.randint(0, 3000, (64, 40), device=cuda, generator=g, dtype=torch.int32)
    w = torch.randn(64, device=cuda, generator=g)
    before = (bag_sum.launches, bag_backward.launches)
    (WideBagSum.apply(table, ids)[:, 0] * w).sum().backward()
    assert (bag_sum.launches, bag_backward.launches) == (before[0] + 1, before[1] + 1)
    _close(table.grad, bag_backward_ref(ids, w[:, None], 3000), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rcllm-qwen3-8b", "moonshot-v1-16b-a3b", "wide-deep",
                                  "schnet"])
def test_reduced_train_step_card_equals_cpu(cuda, arch):
    """One train step at reduced() size (fp32, TF32 off): loss and
    gradient norm on the card within 1e-4 of a CPU copy's."""
    import copy

    from repro_torch.configs import registry as R
    from repro_torch.launch import steps as S
    from repro_torch.training.train_loop import trainable

    cfg = R.get_config(arch, smoke=True)
    shape = {"lm": "train_4k", "recsys": "train_batch", "gnn": "molecule"}[R.family_of(arch)]
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = S.init_model(cfg, gen, cuda, shape)
    batch = R.make_batch(cfg, shape, gen, cuda, batch=4,
                         seq=64 if R.family_of(arch) == "lm" else None)
    cpu = copy.deepcopy(model).to("cpu")
    out = {}
    for m, b in ((model, batch), (cpu, {k: v.cpu() for k, v in batch.items()})):
        with trainable(m):
            out[next(m.parameters()).device.type] = S.train_step(m, b)
    for key in ("loss", "gnorm"):
        assert float(out["cuda"][key]) == pytest.approx(float(out["cpu"][key]), rel=1e-4)
