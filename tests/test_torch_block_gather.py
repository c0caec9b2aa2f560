"""Port parity for the block-gather kernel (B4) and the device assembly of
cached KV it serves.

On the CPU the wrapper `assemble_kv` runs its plain PyTorch version; these
tests hold it to the JAX package's oracle (`block_gather_ref`) and to the
Pallas kernel in interpret mode over seeded sweeps mirroring
`tests/test_kernel_properties.py:_check_block_gather` (rotate on/off,
fp32/bf16, ragged tables), in the multi-head form the serving path uses,
and for the assembly of whole plans: gathering the device pool of cached
rows by a plan's block table equals the JAX package's host
`gather_cached_kv` bit for bit.  The CUDA kernel is held to the same plain
version on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assembly as JA
from repro.core import item_cache as JIC
from repro.core import placement as JPL
from repro.core import semantic_cache as JSC
from repro.data import synth as JSY
from repro.kernels.block_gather.ops import assemble_kv as jax_assemble_kv
from repro.kernels.block_gather.ref import block_gather_ref as jax_block_gather_ref
from repro.kernels.block_gather.ref import rope_rotate as jax_rope_rotate
from repro.models.layers import apply_rope as jax_apply_rope
from repro_torch.core import assembly as TA
from repro_torch.core import engine as TENG
from repro_torch.core import item_cache as TIC
from repro_torch.core import placement as TPL
from repro_torch.core import semantic_cache as TSC
from repro_torch.core.cache_rows import ZERO_ROW, CacheRows
from repro_torch.data import synth as TSY
from repro_torch.kernels.block_gather.ops import PoolGather, assemble_kv
from repro_torch.kernels.block_gather.ref import block_gather_ref, gather_pages
from repro_torch.serving.kv_pool import PagedKVPool

# fp32 keys rotated by positions < 4096: the two frameworks' sin/cos and
# pow may differ by an ulp, which the angle (up to ~4096 rad) turns into
# ~1e-4 relative (the JAX package holds its own kernel to its oracle at
# 2e-4); values, and keys without rotation, are copies and must be exact
ROT_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # bf16: + one bf16 rounding
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _case(seed, heads=None):
    """A random pool/table/positions case as `_check_block_gather` draws
    it (ragged tables: any n_logical, duplicates allowed past the first
    sweep seeds)."""
    rng = np.random.default_rng(seed)
    npages = int(rng.integers(4, 48))
    page = int(rng.choice([1, 4, 8, 16]))
    d = int(rng.choice([16, 32, 64]))
    n_logical = int(rng.integers(1, npages + 1))
    tail = (d,) if heads is None else (heads, d)
    pk = rng.normal(size=(npages, page) + tail).astype(np.float32)
    pv = rng.normal(size=(npages, page) + tail).astype(np.float32)
    bt = rng.choice(npages, n_logical, replace=bool(seed % 2)).astype(np.int32)
    pos = rng.integers(0, 4096, (n_logical, page)).astype(np.int32)
    return pk, pv, bt, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_jax_oracle(seed, rotate, dtype):
    pk, pv, bt, pos = _case(seed)
    t = lambda a: torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a)
    ko, vo = assemble_kv(t(pk), t(pv), t(bt), t(pos), rope_theta=1e4, rotate=rotate)
    j = lambda a: jnp.asarray(a, DTYPES[dtype]) if a.dtype == np.float32 else jnp.asarray(a)
    kr, vr = jax_block_gather_ref(j(pk), j(pv), jnp.asarray(bt), jnp.asarray(pos),
                                  rope_theta=1e4, rotate=rotate)
    assert ko.dtype == vo.dtype == dtype and ko.shape == (len(bt),) + pk.shape[1:]
    np.testing.assert_array_equal(_np32(vo), _np32(vr))
    if rotate:
        np.testing.assert_allclose(_np32(ko), _np32(kr), atol=ROT_TOL[dtype],
                                   rtol=ROT_TOL[dtype])
    else:
        np.testing.assert_array_equal(_np32(ko), _np32(kr))


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_plain_matches_pallas_interpret(seed, rotate):
    pk, pv, bt, pos = _case(seed + 10)
    ko, vo = assemble_kv(*map(torch.from_numpy, (pk, pv, bt, pos)), rope_theta=1e4,
                         rotate=rotate)
    kj, vj = jax_assemble_kv(*map(jnp.asarray, (pk, pv, bt, pos)), rope_theta=1e4,
                             rotate=rotate, interpret=True)
    np.testing.assert_array_equal(vo.numpy(), np.asarray(vj))
    tol = ROT_TOL[torch.float32] if rotate else 0.0
    np.testing.assert_allclose(ko.numpy(), np.asarray(kj), atol=tol, rtol=tol)


@pytest.mark.parametrize("seed", range(4))
def test_multi_head_slots_rotate_per_head(seed):
    """Slots of (Hkv, Dh) rotate each head over its own Dh: the result is
    the JAX oracle applied head by head (not to the flattened row)."""
    pk, pv, bt, pos = _case(seed, heads=3)
    ko, vo, kraw = assemble_kv(*map(torch.from_numpy, (pk, pv, bt, pos)),
                               rope_theta=1e4, rotate=True, keep_raw=True)
    for h in range(pk.shape[2]):
        kr, vr = jax_block_gather_ref(jnp.asarray(pk[:, :, h]), jnp.asarray(pv[:, :, h]),
                                      jnp.asarray(bt), jnp.asarray(pos), rope_theta=1e4)
        np.testing.assert_allclose(ko[:, :, h].numpy(), np.asarray(kr),
                                   atol=ROT_TOL[torch.float32], rtol=ROT_TOL[torch.float32])
        np.testing.assert_array_equal(vo[:, :, h].numpy(), np.asarray(vr))
    np.testing.assert_array_equal(kraw.numpy(), pk[bt])
    flat, _ = jax_block_gather_ref(jnp.asarray(pk.reshape(pk.shape[:2] + (-1,))),
                                   jnp.asarray(pv.reshape(pv.shape[:2] + (-1,))),
                                   jnp.asarray(bt), jnp.asarray(pos), rope_theta=1e4)
    assert not np.allclose(ko.numpy().reshape(np.shape(flat)), np.asarray(flat), atol=1e-3)


def test_zero_row_and_unrotated_copy_are_exact():
    rng = np.random.default_rng(3)
    pool = torch.from_numpy(rng.normal(size=(9, 1, 2, 16)).astype(np.float32))
    pool[ZERO_ROW] = 0
    table = torch.tensor([4, ZERO_ROW, 8, 4, ZERO_ROW], dtype=torch.int32)
    pos = torch.tensor([[700], [5], [0], [3000], [4095]], dtype=torch.int32)
    k, v = assemble_kv(pool, -pool, table, pos, rotate=False)
    assert torch.equal(k, pool[table.long()]) and torch.equal(v, -pool[table.long()])
    k, v = assemble_kv(pool, pool, table, pos, rotate=True)
    zero = table == ZERO_ROW
    assert not k[zero].any() and not v[zero].any()
    assert torch.equal(k[2], pool[8])                   # position 0: identity
    with pytest.raises(ValueError, match="rotate=True"):
        assemble_kv(pool, pool, table, pos, rotate=False, keep_raw=True)


# ------------------------------------------------- plan assembly on the pool
L_, HKV, DH = 2, 2, 4


def _pools(SY, PL, IC, SC, rows=None):
    """Both cache pools over the same seeded fake KV, as
    `RcLLMSystem.build` builds them (the port's also fills `rows`)."""
    prof = dataclasses.replace(SY.PROFILES["amazon"], n_items=60, n_clusters=6,
                               mean_item_tokens=24, mean_review_tokens=20)
    catalog = SY.make_catalog(prof, vocab_size=4096, seed=0)
    rpool = SY.make_review_pool(vocab_size=4096, n_phrases=120, seed=1)
    trace = SY.make_trace(catalog, rpool, prof, n_requests=12, qps=10.0, n_users=6,
                          n_candidates=8, reviews_per_user=2, seed=2)
    placement = PL.place(catalog.n_items, [r.candidate_items for r in trace], 2)
    rng = np.random.default_rng(7)
    fake = lambda docs: [tuple(rng.normal(size=(2, len(d), L_, HKV, DH)).astype(np.float32))
                         for d in docs]
    corpus = list({r.user_id: r.history_tokens for r in trace}.values())
    embed = np.random.default_rng(9).normal(size=(4096, 16)).astype(np.float32)
    corpus_kv = fake(corpus)
    semantic = SC.build_semantic_cache(corpus, embed, n_bits=8, seed=0)
    kw = {} if rows is None else {"rows": rows}
    SC.materialize_kv(semantic, corpus, None, kv_by_doc=lambda i: corpus_kv[i], **kw)
    docs = [np.concatenate([[SY.ITEM_SEP], t]).astype(np.int32)
            for t in catalog.item_tokens]
    store = IC.build_item_store(docs, placement, kv_list=fake(docs), coverage=0.8,
                                seed=0, **kw)
    return catalog, trace, semantic, store, embed


@pytest.fixture(scope="module")
def pools():
    rows = CacheRows(L_, HKV, DH)
    t = _pools(TSY, TPL, TIC, TSC, rows)
    return _pools(JSY, JPL, JIC, JSC), t, rows.to_device("cpu")


def test_plan_assembly_on_the_pool_equals_reference_gather(pools):
    """A plan's block table gathered from the device pool (every layer,
    unrotated) is bitwise the reference's host assembly of the same plan;
    the realigned layers equal the reference oracle's rotation of it."""
    (jc, jt, jsem, jstore, embed), (tc, tt, tsem, tstore, _), rows = pools
    instr = JSY.make_instruction(207, jc.vocab_size)
    n_item = n_sem = 0
    for a, b in zip(jt, tt):
        for inst in (0, 1):
            pj = JA.build_plan(*a.prompt_segments(jc, instr), a.history_marker_mask,
                               jstore, jsem, embed, instance=inst)
            pt = TA.build_plan(*b.prompt_segments(tc, instr), b.history_marker_mask,
                               tstore, tsem, embed, instance=inst)
            kj, vj, hj = JA.gather_cached_kv(pj, jstore, jsem, inst, L_, HKV, DH)
            table, positions, have = TA.plan_block_table(pt, tstore, tsem, inst)
            np.testing.assert_array_equal(have, hj)
            np.testing.assert_array_equal(positions, np.arange(pt.n))
            assert (table[~have] == ZERO_ROW).all()
            tbl, pos = torch.from_numpy(table), torch.from_numpy(positions)
            gather = TENG.cache_gather(rows, 1e4, None, kernels=True)
            for layer in range(L_):
                k, v = gather(tbl, pos, layer, rotate=False)
                np.testing.assert_array_equal(k.numpy(), kj[:, layer])
                np.testing.assert_array_equal(v.numpy(), vj[:, layer])
                kr, vr, kraw = gather(tbl, pos, layer, rotate=True, keep_raw=True)
                np.testing.assert_array_equal(kraw.numpy(), kj[:, layer])
                np.testing.assert_array_equal(vr.numpy(), vj[:, layer])
                want = jax_rope_rotate(jnp.asarray(kj[:, layer]),
                                   jnp.asarray(positions)[:, None], 1e4)
                np.testing.assert_allclose(kr.numpy(), np.asarray(want),
                                           atol=ROT_TOL[torch.float32],
                                           rtol=ROT_TOL[torch.float32])
            n_item += int((have & (pt.source == TA.FROM_ITEM)).sum())
            n_sem += int((have & (pt.source == TA.FROM_SEMANTIC)).sum())
    assert n_item > 0 and n_sem > 0        # both cache pools were exercised


def test_cache_rows_pack_every_block_once(pools):
    _, (_, _, tsem, tstore, _), rows = pools
    blocks = {id(b): b for sh in tstore.shards for b in sh.blocks.values()}
    n = 1 + sum(len(b.k) for b in blocks.values()) + tsem.n_prototypes
    assert rows.n_rows == n and rows.k.shape == (L_, n, 1, HKV, DH)
    assert not rows.k[:, ZERO_ROW].any() and not rows.v[:, ZERO_ROW].any()
    for b in blocks.values():
        np.testing.assert_array_equal(rows.k[:, b.row:b.row + len(b.k), 0].permute(1, 0, 2, 3),
                                      b.k)
    protos = slice(tsem.proto_row, tsem.proto_row + tsem.n_prototypes)
    np.testing.assert_array_equal(rows.v[:, protos, 0].permute(1, 0, 2, 3), tsem.proto_v)


# ---------------------------------------------- every layer in one launch
@pytest.mark.parametrize("two_pools", [False, True])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_layer_gather_is_one_plain_call_per_layer(dtype, rotate, two_pools):
    """The all-layer gather (`PoolGather` over a stack of layer planes,
    the selective pass's one launch) equals one plain call per layer, bit
    for bit, in every layer: values and raw keys copied, keys rotated or
    copied, pad rows reading the zero row, entries into the serving
    arena's planes (the second pool); a sub-range and a single layer are
    the same rows."""
    rng = np.random.default_rng(11 + 2 * rotate + two_pools)
    L, H, D, n_rows = 4, 2, 16, 40
    pk = torch.from_numpy(rng.normal(size=(L, n_rows, 1, H, D)).astype(np.float32)).to(dtype)
    pk[:, ZERO_ROW] = 0
    pv = -pk
    extra, n2 = (), 0
    if two_pools:
        arena = PagedKVPool(L, H, D, page_size=4, n_pages=6, device="cpu", dtype=dtype)
        arena.arena_k.copy_(torch.randn(arena.arena_k.shape))
        arena.arena_v.copy_(torch.randn(arena.arena_v.shape))
        extra = arena.planes()
        n2 = extra[0].shape[1]
    table = rng.integers(0, n_rows + n2, 50).astype(np.int32)
    table[40:] = ZERO_ROW                                     # pad rows
    tbl = torch.from_numpy(table)
    pos = torch.from_numpy(rng.integers(0, 4096, 50).astype(np.int32))
    g = PoolGather(pk, pv, *extra, rope_theta=1e4)
    got = g(tbl, pos, range(L), rotate=rotate, keep_raw=rotate)
    assert len(got) == (3 if rotate else 2)
    assert all(t.shape == (L, 50, H, D) and t.dtype == dtype for t in got)
    for layer in range(L):
        k2 = {"pool2_k": extra[0][layer], "pool2_v": extra[1][layer]} if two_pools else {}
        want = block_gather_ref(pk[layer], pv[layer], tbl, pos[:, None], rope_theta=1e4,
                                rotate=rotate, **k2)
        if rotate:
            want += (gather_pages(pk[layer], tbl.long(), k2.get("pool2_k")),)
        one = g(tbl, pos, layer, rotate=rotate, keep_raw=rotate)
        for a, b, w in zip(got, one, want):
            assert torch.equal(a[layer], w[:, 0]) and torch.equal(b, w[:, 0])
    assert not got[1][:, 40:].any()
    sub = g(tbl, pos, range(1, L), rotate=rotate, keep_raw=rotate)
    assert all(torch.equal(a[1:], b) for a, b in zip(got, sub))


def test_all_layer_gather_of_a_plan_equals_the_reference_assembly(pools):
    """A plan's block table gathered for every layer in one call of the
    port's all-layer gather: the values and raw keys are bitwise the JAX
    package's host assembly (`gather_cached_kv`), and the rotated keys its
    per-layer rotation (`repro/core/engine.py`'s `apply_rope` of each
    layer's cached keys to the request positions)."""
    (jc, jt, jsem, jstore, embed), (tc, tt, tsem, tstore, _), rows = pools
    instr = JSY.make_instruction(207, jc.vocab_size)
    g = TENG.cache_gather(rows, 1e4, None, kernels=True)
    for a, b in list(zip(jt, tt))[:4]:
        pj = JA.build_plan(*a.prompt_segments(jc, instr), a.history_marker_mask, jstore, jsem,
                           embed, instance=1)
        pt = TA.build_plan(*b.prompt_segments(tc, instr), b.history_marker_mask, tstore, tsem,
                           embed, instance=1)
        kj, vj, _ = JA.gather_cached_kv(pj, jstore, jsem, 1, L_, HKV, DH)
        table, positions, _ = TA.plan_block_table(pt, tstore, tsem, 1)
        kr, v, kraw = g(torch.from_numpy(table), torch.from_numpy(positions), range(L_),
                        rotate=True, keep_raw=True)
        for layer in range(L_):
            np.testing.assert_array_equal(kraw[layer].numpy(), kj[:, layer])
            np.testing.assert_array_equal(v[layer].numpy(), vj[:, layer])
            want = jax_apply_rope(jnp.asarray(kj[None, :, layer]), jnp.asarray(positions)[None],
                                  1e4)[0]
            np.testing.assert_allclose(kr[layer].numpy(), np.asarray(want),
                                       atol=ROT_TOL[torch.float32], rtol=ROT_TOL[torch.float32])
