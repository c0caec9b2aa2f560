"""Port parity for the embedding-bag kernel (B5).

On the CPU the wrapper `bag_sum` runs its plain PyTorch version; these
tests hold it to the JAX package's oracle (`embedding_bag_ref`) and to the
Pallas kernel in interpret mode, over the sweep of
`tests/test_kernels.py:test_embedding_bag_sweep`, the seeded property
sweep of `tests/test_kernel_properties.py:_check_embedding_bag`, and the
d = 1 table of Wide&Deep's wide part.  The CUDA kernel is held to the
same plain version on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`; here its launch geometry (`ops.staged_geometry`) and
index walk (emulated in numpy) are held to their invariants, their
refusals and the Pallas kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import bag_sum as jax_bag_sum
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_embedding_bag_ref
from repro_torch.kernels.embedding_bag import ops as EO
from repro_torch.kernels.embedding_bag.ops import bag_sum
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# fp32: the frameworks sum the same rows in another order (relative 1e-5
# over <= 40 O(1) terms).  bf16 against the Pallas kernel: both sum in fp32
# and round once, so at most one bf16 ulp apart (2^-7 relative, when the
# fp32 sums straddle a rounding boundary).  bf16 against the jnp oracle,
# which sums in the table's dtype: the JAX package's own 2e-2.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
JNP_BF16_TOL = 2e-2


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _check(table_np, ids_np, dtype):
    table = torch.from_numpy(table_np).to(dtype)
    ids = torch.from_numpy(ids_np)
    before = bag_sum.launches
    got = bag_sum(table, ids)
    assert bag_sum.launches == before                 # CPU: plain version, no launch
    assert got.dtype == dtype and got.shape == (ids.shape[0], table.shape[1])
    torch.testing.assert_close(got, embedding_bag_ref(table, ids), rtol=0, atol=0)
    jt, ji = jnp.asarray(table_np, DTYPES[dtype]), jnp.asarray(ids_np)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(jax_bag_sum(jt, ji, interpret=True)),
                               atol=tol, rtol=tol)
    tol = TOL[dtype] if dtype == torch.float32 else JNP_BF16_TOL
    np.testing.assert_allclose(_np32(got), _np32(jax_embedding_bag_ref(jt, ji)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("rows,d,B,F", [(256, 16, 8, 5), (1000, 32, 4, 13),
                                        (64, 128, 16, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_jax_sweep(rows, d, B, F, dtype):
    """`tests/test_kernels.py:test_embedding_bag_sweep`'s cases."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, (B, F)).astype(np.int32)
    _check(table, ids, dtype)


@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_jax_property_sweep(seed):
    """`tests/test_kernel_properties.py:_check_embedding_bag`'s draws."""
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(8, 600))
    d = int(rng.choice([8, 16, 32, 64]))
    B = int(2 ** rng.integers(0, 5))
    F = int(rng.integers(1, 16))
    dtype = torch.bfloat16 if rng.integers(0, 4) == 0 else torch.float32
    table = rng.normal(size=(rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, (B, F)).astype(np.int32)
    _check(table, ids, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3])
def test_plain_matches_jax_narrow_rows(d, dtype):
    """A (rows, 1) table as Wide&Deep's wide part holds, 40 fields; and an
    odd width."""
    rng = np.random.default_rng(7)
    table = (rng.normal(size=(4096, d)) * 0.05).astype(np.float32)
    ids = rng.integers(0, 4096, (8, 40)).astype(np.int32)
    _check(table, ids, dtype)


@pytest.mark.parametrize("F,want,running_bf16", [(64, 64.5, 64.5), (100, 101.0, 100.5)])
def test_bf16_tables_accumulate_in_fp32(F, want, running_bf16):
    """F rows of 1 + 2^-7 in bf16, summed in fp32 (exact: F + F/128) and
    rounded once: 64.5 for F = 64, and 101.0 for F = 100, where a running
    bf16 sum, which rounds from the third term on, ends at 100.5."""
    x = 1 + 2 ** -7
    table = torch.full((4, 2), x, dtype=torch.bfloat16)
    ids = torch.zeros((1, F), dtype=torch.int32)
    got = bag_sum(table, ids)
    assert got.dtype == torch.bfloat16
    assert got.float().tolist() == [[want, want]]
    running = torch.zeros((), dtype=torch.bfloat16)
    for _ in range(F):
        running = running + table[0, 0]
    assert float(running) == running_bf16
    pallas = jax_bag_sum(jnp.asarray(table.float().numpy(), jnp.bfloat16),
                         jnp.asarray(ids.numpy()), interpret=True)
    assert np.asarray(pallas, np.float32).tolist() == [[want, want]]


def test_cpu_wrapper_counts_nothing_and_mixed_devices_raise():
    table = torch.zeros(8, 4)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    before = bag_sum.launches
    assert bag_sum(table, ids).shape == (2, 4)
    assert bag_sum.launches == before
    with pytest.raises(ValueError, match="different devices"):
        bag_sum(table.to("meta"), ids)
    with pytest.raises(ValueError, match="unsupported device"):
        bag_sum(table.to("meta"), ids.to("meta"))


# --------------------------------------------------------------------------
# the staged kernel's geometry and index walk (`ops.staged_geometry`, the
# loops of `bag.cu:bag_staged_kernel`), emulated here on the CPU

GEOMETRY_CASES = [  # (B, F, d, element bytes, 16-byte vectors)
    (262_144, 40, 1, 4, False), (512, 40, 1, 4, False), (262_144, 40, 1, 2, False),
    (262_144, 40, 32, 4, True), (1, 40, 32, 4, True), (4097, 130, 3, 4, False),
    (10_001, 130, 32, 2, True), (5, 7, 33, 2, False), (3, 2, 4096, 4, True),
    (70, 0, 1, 4, False), (1, 1, 1, 4, False), (9000, 500, 8, 4, True)]


@pytest.mark.parametrize("B,F,d,elt,vec", GEOMETRY_CASES)
def test_staged_geometry_invariants(B, F, d, elt, vec):
    """The launch `staged_geometry` picks: a bag's vectors over the fewest
    power-of-two lanes (at most 256), tiles of at most 32 bags that cover
    the batch and make at least one tile an SM where the batch has the
    bags, a chunk of fields that fits 48 KB at an odd stride (what
    `bag.cu:launch_staged` accepts)."""
    sms = 132
    g = EO.staged_geometry(B, F, d, elt, vec, sms)
    V = 16 // elt if vec else 1
    cols, P = d // V, 1 << g.lgP
    tiles = -(-B // g.TB)
    assert P <= EO.BAG_THREADS and (P >= cols or P == EO.BAG_THREADS)
    assert P == 1 or P // 2 < cols
    assert 1 <= g.TB <= min(EO.TILE_BAGS, EO.BAG_THREADS // P)
    assert tiles >= min(B, sms) and -(-cols // P) <= 65535
    assert g.S % 2 == 1 and g.S >= g.FC >= 1 and (F == 0 or g.FC <= F)
    assert g.TB * g.S * P * V * elt <= EO.STAGE_BYTES


def _staged_walk(table, ids, vec, row0=0):
    """`bag_staged_kernel` step by step in numpy: each block's gather walk
    (every thread's (bag, field) counters, 8 or 4 units at a time) into a
    shared tile at (bag * S + field) * P + lane (a zero where the id lies
    outside the table's row window row0 .. row0 + rows - 1, whose row is
    never read), then each bag's fp32 sum in field order, rounded once.
    Asserts that the walk writes each unit of a chunk once, inside the
    tile, and (4-byte rows) that a warp's reads in the sum fall in 32
    banks.  -> (B, d) in the table's dtype."""
    (B, F), (_, d) = ids.shape, table.shape
    elt = table.element_size()
    g = EO.staged_geometry(B, F, d, elt, vec, sms=132)
    V = 16 // elt if vec else 1
    cols, P = d // V, 1 << g.lgP
    batch = 4 if V * elt == 16 else 8
    rps = EO.BAG_THREADS // P
    rows = table.float().numpy().reshape(-1, cols, V)
    ids_np = ids.numpy()
    out = np.zeros((B, cols, V), np.float32)
    for tile in range(-(-B // g.TB)):
        b0 = tile * g.TB
        nb = min(g.TB, B - b0)
        for cb in range(-(-cols // P)):
            acc = np.zeros((g.TB * P, V), np.float32)
            for f0 in range(0, F, g.FC):
                fc = min(g.FC, F - f0)
                units, dj, df = nb * fc, rps // fc, rps % fc
                smem = np.full((g.TB * g.S * P, V), np.nan, np.float32)
                written = np.zeros(g.TB * g.S * P, np.int64)
                for t in range(EO.BAG_THREADS):
                    c = t % P
                    col = cb * P + c
                    u = t // P
                    jj, ff = divmod(u, fc)
                    while u < units:
                        for k in range(batch):
                            if u + k * rps < units and col < cols:
                                at = (jj * g.S + ff) * P + c
                                rid = int(ids_np[b0 + jj, f0 + ff]) - row0
                                smem[at] = rows[rid, col] if 0 <= rid < len(rows) else 0.0
                                written[at] += 1
                            jj, ff = jj + dj, ff + df
                            if ff >= fc:
                                ff, jj = ff - fc, jj + 1
                        u += batch * rps
                live = [(jj * g.S + ff) * P + c for jj in range(nb) for ff in range(fc)
                        for c in range(P) if cb * P + c < cols]
                assert sorted(np.flatnonzero(written)) == sorted(live)
                assert written.max() <= 1
                for t in range(nb * P):
                    j, c = divmod(t, P)
                    for f in range(fc):
                        acc[t] += smem[(j * g.S + f) * P + c]
                if P == 1 and V * elt == 4:
                    for w0 in range(0, nb, 32):
                        lanes = np.arange(w0, min(w0 + 32, nb))
                        for f in range(fc):
                            banks = (lanes * g.S + f) % 32
                            assert len(set(banks)) == len(lanes)
            for t in range(nb * P):
                j, c = divmod(t, P)
                if cb * P + c < cols:
                    out[b0 + j, cb * P + c] = acc[t]
    return torch.from_numpy(out.reshape(B, d)).to(table.dtype)


@pytest.mark.parametrize("B,F,d,vec", [(1, 40, 1, False), (40, 13, 1, False), (9, 130, 1, False),
                                       (5, 40, 3, False), (3, 20, 32, True), (2, 9, 33, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_walk_matches_pallas_bitwise(B, F, d, vec, dtype):
    """The staged kernel's index walk, emulated, sums each bag's rows in
    the Pallas kernel's order (f = 0..F-1 in fp32, rounded once): bitwise
    the JAX package's kernel in interpret mode; repeated rows and ids at 0
    and rows - 1 included."""
    rng = np.random.default_rng(B * 1000 + F * 10 + d)
    rows = 300
    table_np = rng.normal(size=(rows, d)).astype(np.float32)
    ids_np = rng.integers(0, rows, (B, F)).astype(np.int32)
    ids_np[0, 0], ids_np[-1, -1] = 0, rows - 1
    ids_np[B // 2] = 5
    table = torch.from_numpy(table_np).to(dtype)
    got = _staged_walk(table, torch.from_numpy(ids_np), vec)
    pallas = jax_bag_sum(jnp.asarray(table_np, DTYPES[dtype]), jnp.asarray(ids_np),
                         interpret=True)
    assert np.array_equal(_np32(got), _np32(pallas))
    torch.testing.assert_close(got.float(), embedding_bag_ref(table, torch.from_numpy(ids_np))
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("args,match", [
    ((0, 40, 1, 4, False, 132), "B=0"), ((8, -1, 1, 4, False, 132), "F=-1"),
    ((8, 40, 1, 4, False, 0), "sms=0"), ((8, 40, 3, 4, True, 132), "of the 4-element vector")])
def test_staged_geometry_refuses_what_the_kernel_does_not_take(args, match):
    """No batch, a negative field count, no SM and a row that 16-byte
    vectors do not divide raise before any launch, on the CPU as on the
    card (`bag_sum` computes the geometry only for CUDA tensors)."""
    with pytest.raises(ValueError, match=match):
        EO.staged_geometry(*args)


@pytest.mark.parametrize("B,TB", [(262_144, 32), (65_536, 32), (8_448, 32), (512, 2), (1, 1)])
def test_staged_geometry_at_wide_deep_batches(B, TB):
    """Wide&Deep's wide sum on 132 SMs (40 fields, 4-byte rows): full
    tiles of 32 bags from serve_bulk down to 8,448 bags (two tiles an SM),
    tiles of 2 at serve_p99's 512 (256 tiles), one bag alone; all 40
    fields in one chunk at the stride 41."""
    assert EO.staged_geometry(B, 40, 1, 4, False, 132) == EO.Geometry(0, TB, 40, 41)


@pytest.mark.parametrize("F,B,d", [(1, 33, 1), (40, 65, 1), (130, 7, 1), (40, 33, 32),
                                   (130, 3, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_jax_edges(F, B, d, dtype):
    """The shapes the staged route's card tests cover: batches that are
    not a multiple of a tile, 130 fields, ids at 0 and rows - 1, a bag
    that repeats one row."""
    rng = np.random.default_rng(F + B + d)
    rows = 500
    table = rng.normal(size=(rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, (B, F)).astype(np.int32)
    ids[0, 0], ids[-1, -1] = 0, rows - 1
    ids[B // 2] = 11
    _check(table, ids, dtype)


# ------------------------------------------------------- the row window
WINDOW_CASES = [(1, 40, 1, False), (40, 13, 1, False), (9, 130, 1, False), (3, 20, 32, True),
                (2, 9, 33, False)]


@pytest.mark.parametrize("B,F,d,vec", WINDOW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_walk_is_pallas_on_the_window_bitwise(B, F, d, vec, dtype):
    """On a row window (a rank's block of a table split by rows) the
    staged kernel's walk skips every id outside it and sums the others in
    field order: bitwise the Pallas kernel on the whole table with the
    rows outside the window zeroed; the plain version (`row0`) too within
    TOL.  At row0 = 0 with the whole table the walk is the unwindowed
    one, bitwise."""
    rng = np.random.default_rng(B * 100 + F + d)
    rows, n = 300, 3
    table_np = rng.normal(size=(rows, d)).astype(np.float32)
    ids_np = rng.integers(0, rows, (B, F)).astype(np.int32)
    ids_np[0, 0], ids_np[-1, -1] = 0, rows - 1
    table = torch.from_numpy(table_np).to(dtype)
    ids = torch.from_numpy(ids_np)
    assert torch.equal(_staged_walk(table, ids, vec, row0=0), _staged_walk(table, ids, vec))
    assert torch.equal(bag_sum(table, ids, row0=0), bag_sum(table, ids))
    for w in range(n):
        r0 = w * rows // n
        block = table[r0:r0 + rows // n]
        masked = np.zeros_like(table_np)
        masked[r0:r0 + rows // n] = table_np[r0:r0 + rows // n]
        pallas = jax_bag_sum(jnp.asarray(masked, DTYPES[dtype]), jnp.asarray(ids_np),
                             interpret=True)
        got = _staged_walk(block, ids, vec, row0=r0)
        assert np.array_equal(_np32(got), _np32(pallas))
        plain = bag_sum(block, ids, row0=r0)
        assert plain.shape == (B, d)
        torch.testing.assert_close(plain.float(), got.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_sums_add_up_and_gradients_concatenate(n, dtype):
    """The windows' bag sums over the ranks add up to the whole table's
    (fp32 within TOL: each window sums its fields, then the windows are
    added); K7's plain version on each window is that block of the whole
    gradient, bitwise (an id outside a window adds nothing, not even a
    signed zero), ids far outside every window included."""
    from repro_torch.kernels.embedding_bag.ref import bag_backward_ref

    rng = np.random.default_rng(n)
    rows, d, B, F = 4096, 3, 33, 40
    table = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, rows, (B, F)).astype(np.int32))
    ids[:5] = ids[0]
    whole = bag_sum(table, ids)
    step = rows // n
    parts = sum(bag_sum(table[c * step:(c + 1) * step], ids, row0=c * step).float()
                for c in range(n))
    torch.testing.assert_close(parts, whole.float(), rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    d_out = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dtype)
    want = bag_backward_ref(ids, d_out, rows)
    blocks = [EO.bag_backward(ids, d_out, step, row0=c * step) for c in range(n)]
    assert torch.equal(torch.cat(blocks), want)
    far = ids.clone()
    far[1] = 2_000_000_000
    assert torch.equal(EO.bag_backward(far, d_out, step, row0=step),
                       bag_backward_ref(far, d_out, rows)[step:2 * step])
    zero = ids.clone()
    zero[1] = 0                                           # outside the window too
    assert torch.equal(bag_sum(table[step:2 * step], far, row0=step),
                       bag_sum(table[step:2 * step], zero, row0=step))
