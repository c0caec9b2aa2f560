"""Port parity for the three attention kernels on the serving path.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions to the JAX package's oracles (`ref.py`)
over seeded random sweeps mirroring `tests/test_kernel_properties.py`
(GQA groups, ragged masks, random (window, hh), random paged layouts
with dead pages), plus one small case per kernel against the Pallas
kernel in interpret mode.  The host-side maps the kernels consume
(`block_liveness`, `page_views`) must equal the JAX ones exactly.

The CUDA kernels are held to these plain versions on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha_flash as jax_mha_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.paged_attention.ops import paged_decode_mha as jax_paged_mha
from repro.kernels.paged_attention.ref import (
    masked_decode_attention_ref as jax_masked_decode_ref,
)
from repro.kernels.paged_attention.ref import paged_decode_ref as jax_paged_ref
from repro.kernels.selective_attention.kernel import (
    block_liveness as jax_block_liveness,
)
from repro.kernels.selective_attention.ops import selective_mha as jax_selective_mha
from repro.kernels.selective_attention.ref import (
    selective_attention_ref as jax_selective_ref,
)
from repro.serving.kv_pool import page_views as jax_page_views
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.paged_attention import ref as PR
from repro_torch.kernels.paged_attention.ops import paged_decode_mha
from repro_torch.kernels.selective_attention import ref as SR
from repro_torch.kernels.selective_attention.ops import block_liveness, selective_mha
from repro_torch.serving.kv_pool import page_views

SEEDS = range(6)
GQA_GROUPS = (1, 2, 4)
F32_TOL = 1e-5    # fp32 vs fp32: summation order only
BF16_TOL = 2e-2   # bf16 inputs/outputs: one bf16 rounding of the result


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ------------------------------ flash ----------------------------------
def _flash_case(seed):
    rng = np.random.default_rng(seed)
    B = int(2 ** rng.integers(0, 3))
    G = int(rng.choice(GQA_GROUPS))
    Hkv = int(rng.choice([1, 2]))
    D = int(rng.choice([8, 16, 32]))
    Sq = int(rng.integers(1, 80))
    Skv = int(rng.integers(1, 120))
    causal = bool(rng.integers(0, 2)) and Sq <= Skv
    Hq = G * Hkv
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    return q, k, v, causal, G


@pytest.mark.parametrize("seed", SEEDS)
def test_flash_plain_matches_jax_oracle(seed):
    q, k, v, causal, G = _flash_case(seed)
    B, Sq, Hq, D = q.shape
    got = mha_flash(_t(q), _t(k), _t(v), causal=causal)
    kk = np.repeat(k, G, 2).transpose(0, 2, 1, 3).reshape(B * Hq, -1, D)
    vv = np.repeat(v, G, 2).transpose(0, 2, 1, 3).reshape(B * Hq, -1, D)
    qq = q.transpose(0, 2, 1, 3).reshape(B * Hq, Sq, D)
    ref = jax_flash_ref(jnp.asarray(qq), jnp.asarray(kk), jnp.asarray(vv), causal=causal)
    ref = np.asarray(ref).reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), ref, atol=F32_TOL, rtol=F32_TOL)
    # the flattened-head oracle ports one to one
    port_ref = FR.flash_attention_ref(_t(qq), _t(kk), _t(vv), causal=causal)
    np.testing.assert_allclose(
        _np(port_ref), np.asarray(jax_flash_ref(jnp.asarray(qq), jnp.asarray(kk),
                                                jnp.asarray(vv), causal=causal)),
        atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_flash_plain_ragged_kv_valid(seed):
    """Arbitrary interleaved key masks: equal to the oracle on each row's
    compacted live keys."""
    rng = np.random.default_rng(seed)
    B = int(2 ** rng.integers(0, 3))
    G = int(rng.choice(GQA_GROUPS))
    Hkv = int(rng.choice([1, 2]))
    D = int(rng.choice([8, 16]))
    Sq, Skv = int(rng.integers(1, 40)), int(rng.integers(2, 100))
    Hq = G * Hkv
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    valid = rng.random((B, Skv)) < rng.uniform(0.2, 0.9)
    valid[np.arange(B), rng.integers(0, Skv, B)] = True  # >=1 live key
    got = _np(mha_flash(_t(q), _t(k), _t(v), kv_valid=_t(valid), causal=False))
    for b in range(B):
        kb = np.repeat(k[b, valid[b]], G, 1).transpose(1, 0, 2)
        vb = np.repeat(v[b, valid[b]], G, 1).transpose(1, 0, 2)
        ref = jax_flash_ref(jnp.asarray(q[b].transpose(1, 0, 2)), jnp.asarray(kb),
                            jnp.asarray(vb), causal=False)
        np.testing.assert_allclose(got[b], np.asarray(ref).transpose(1, 0, 2),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_flash_plain_bf16_matches_jax_oracle():
    rng = np.random.default_rng(11)
    B, S, Hkv, G, D = 2, 40, 2, 2, 16
    q = rng.normal(size=(B, S, Hkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    bf = lambda a: _t(a).to(torch.bfloat16)
    got = mha_flash(bf(q), bf(k), bf(v), causal=True)
    assert got.dtype == torch.bfloat16
    qq = jnp.asarray(q, jnp.bfloat16).transpose(0, 2, 1, 3).reshape(B * Hkv * G, S, D)
    kk = jnp.repeat(jnp.asarray(k, jnp.bfloat16), G, 2).transpose(0, 2, 1, 3).reshape(-1, S, D)
    vv = jnp.repeat(jnp.asarray(v, jnp.bfloat16), G, 2).transpose(0, 2, 1, 3).reshape(-1, S, D)
    ref = np.asarray(jax_flash_ref(qq, kk, vv, causal=True), np.float32)
    ref = ref.reshape(B, Hkv * G, S, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), ref, atol=BF16_TOL, rtol=BF16_TOL)


def test_flash_plain_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    B, S, Hkv, G, D = 2, 40, 2, 2, 16
    q = rng.normal(size=(B, S, Hkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[1, 30:] = False                                 # a padded tail
    want = jax_mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_valid=jnp.asarray(valid), causal=True, q_block=16,
                         kv_block=16, interpret=True)
    got = mha_flash(_t(q), _t(k), _t(v), kv_valid=_t(valid), causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


# ---------------------------- selective --------------------------------
def _selective_case(seed):
    rng = np.random.default_rng(seed)
    Hkv, G, D = int(rng.choice([1, 2])), int(rng.choice([1, 2])), 32
    S = int(rng.integers(32, 200))
    R = int(rng.integers(1, min(S, 48) + 1))
    window = int(rng.choice([8, 24, 64]))
    q = rng.normal(size=(1, R, G * Hkv, D)).astype(np.float32)
    k = rng.normal(size=(1, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(1, S, Hkv, D)).astype(np.float32)
    qpos = np.sort(rng.choice(S, R, replace=False)).astype(np.int32)
    hh = (rng.random(S) < rng.uniform(0, 0.3)).astype(np.int8)
    return q, k, v, qpos, hh, window, G


@pytest.mark.parametrize("seed", SEEDS)
def test_selective_plain_matches_jax_oracle(seed):
    q, k, v, qpos, hh, window, G = _selective_case(seed)
    _, R, Hq, D = q.shape
    got = selective_mha(_t(q), _t(qpos), _t(k), _t(v), _t(hh), window=window)
    qf = q.transpose(0, 2, 1, 3).reshape(Hq, R, D)
    kf = np.repeat(k, G, 2).transpose(0, 2, 1, 3).reshape(Hq, -1, D)
    vf = np.repeat(v, G, 2).transpose(0, 2, 1, 3).reshape(Hq, -1, D)
    ref = jax_selective_ref(jnp.asarray(qf), jnp.asarray(qpos), jnp.asarray(kf),
                            jnp.asarray(vf), jnp.asarray(hh), window=window)
    ref = np.asarray(ref).reshape(1, Hq, R, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), ref, atol=F32_TOL, rtol=F32_TOL)
    port_ref = SR.selective_attention_ref(_t(qf), _t(qpos), _t(kf), _t(vf), _t(hh),
                                          window=window)
    np.testing.assert_allclose(_np(port_ref), np.asarray(ref).transpose(0, 2, 1, 3)
                               .reshape(Hq, R, D), atol=F32_TOL, rtol=F32_TOL)


def _serving_selective_case(seed, B=2):
    """The engine's call: per-request positions, window 0, hh = validity."""
    rng = np.random.default_rng(seed)
    Hkv, G, D, n, R = 2, 2, 16, 128, 64
    q = rng.normal(size=(B, R, Hkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, n, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, n, Hkv, D)).astype(np.float32)
    valid = np.zeros((B, n), np.int8)
    r_pos = np.zeros((B, R), np.int32)
    for b in range(B):
        nb = int(rng.integers(R + 1, n))
        valid[b, :nb] = 1
        r_pos[b] = np.sort(rng.choice(nb, R, replace=False))
    return q, k, v, r_pos, valid


@pytest.mark.parametrize("seed", range(3))
def test_block_liveness_equals_jax(seed):
    rng = np.random.default_rng(seed)
    q, k, v, r_pos, valid = _serving_selective_case(seed, B=3)
    for window, qb, kb in ((0, 64, 64), (int(rng.integers(1, 80)), 16, 32)):
        got = block_liveness(r_pos, valid, window=window, q_block=qb, kv_block=kb)
        want = jax_block_liveness(r_pos, valid, window=window, q_block=qb, kv_block=kb)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    pad = np.concatenate([r_pos, np.full((3, 5), -1, np.int32)], axis=1)
    hh = (rng.random(valid.shape) < 0.1).astype(np.int8)
    np.testing.assert_array_equal(
        block_liveness(pad, hh, window=24, q_block=16, kv_block=32),
        jax_block_liveness(pad, hh, window=24, q_block=16, kv_block=32))


def test_selective_plain_matches_pallas_interpret():
    q, k, v, r_pos, valid = _serving_selective_case(7)
    live = jax_block_liveness(r_pos, valid, window=0, q_block=64, kv_block=64)
    want = jax_selective_mha(jnp.asarray(q), jnp.asarray(r_pos), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(valid), live=jnp.asarray(live),
                             window=0, q_block=64, kv_block=64, interpret=True)
    got = selective_mha(_t(q), _t(r_pos), _t(k), _t(v), _t(valid),
                        live=block_liveness(r_pos, valid, window=0, q_block=64,
                                            kv_block=64), window=0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


# --------------------------- paged decode ------------------------------
def _random_layout(rng, n_pages, page, n_rows, max_len):
    """Random per-row slot tables as serving produces them (arbitrary,
    never page-aligned slots) plus one freshly claimed decode slot."""
    lens = rng.integers(0, max_len, n_rows)
    S = max(int(lens.max()) + 1, 1)
    tables = np.zeros((n_rows, S), np.int64)
    new_pages = np.zeros(n_rows, np.int64)
    new_slots = np.zeros(n_rows, np.int64)
    for i in range(n_rows):
        slots = rng.choice(np.arange(page, n_pages * page), int(lens[i]) + 1,
                           replace=False)
        tables[i, : lens[i]] = slots[:-1]
        new_pages[i] = slots[-1] // page
        new_slots[i] = slots[-1] % page
    return tables, lens.astype(np.int64), new_pages, new_slots


def _paged_case(seed):
    rng = np.random.default_rng(seed)
    page = int(rng.choice([4, 8, 16]))
    n_pages = int(rng.integers(6, 24))
    L = int(rng.integers(1, 3))
    Hkv, G = int(rng.choice([1, 2])), int(rng.choice(GQA_GROUPS))
    D = int(rng.choice([8, 16, 32]))
    N = int(2 ** rng.integers(0, 4))
    max_len = min(n_pages * page - page - 1, int(rng.integers(2, 40)))
    layout = _random_layout(rng, n_pages, page, N, max_len)
    ak = rng.normal(size=(n_pages, page, L, Hkv, D)).astype(np.float32)
    av = rng.normal(size=(n_pages, page, L, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(N, G * Hkv, D)).astype(np.float32)
    return layout, page, ak, av, q, L


@pytest.mark.parametrize("seed", SEEDS)
def test_page_views_equal_jax(seed):
    layout, page, *_ = _paged_case(seed)
    got = page_views(*layout, page)
    want = jax_page_views(*layout, page)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_paged_plain_matches_jax_oracle(seed):
    layout, page, ak, av, q, L = _paged_case(seed)
    pg_ids, sl_pos = page_views(*layout, page)
    # a dead pad column (scratch page, all -1) must contribute nothing
    assert (sl_pos[:, -1] == -1).all() or pg_ids.shape[1] % 4 == 0
    for layer in range(L):
        got = paged_decode_mha(_t(q), _t(ak), _t(av), _t(pg_ids), _t(sl_pos),
                               layer=layer, rope_theta=1e4)
        want = jax_paged_ref(jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av),
                             jnp.asarray(pg_ids), jnp.asarray(sl_pos), layer=layer,
                             rope_theta=1e4)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_paged_dead_pages_contribute_nothing():
    """Appending pages whose slots are all -1 leaves the output exactly
    unchanged (the kernel skips them; the plain version masks them)."""
    layout, page, ak, av, q, _ = _paged_case(3)
    pg_ids, sl_pos = page_views(*layout, page)
    extra = np.tile(np.arange(1, 5, dtype=np.int32), (pg_ids.shape[0], 1))
    pg2 = np.concatenate([pg_ids, extra], axis=1)
    sp2 = np.concatenate([sl_pos, np.full(extra.shape + (page,), -1, np.int32)], axis=1)
    a = paged_decode_mha(_t(q), _t(ak), _t(av), _t(pg_ids), _t(sl_pos), layer=0)
    b = paged_decode_mha(_t(q), _t(ak), _t(av), _t(pg2), _t(sp2), layer=0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_masked_decode_attention_matches_jax():
    rng = np.random.default_rng(7)
    N, T, Hkv, G, D = 4, 33, 2, 2, 16
    q = rng.normal(size=(N, G * Hkv, D)).astype(np.float32)
    k = rng.normal(size=(N, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(N, T, Hkv, D)).astype(np.float32)
    valid = rng.random((N, T)) < 0.6
    valid[:, -1] = True
    got = PR.masked_decode_attention_ref(_t(q), _t(k), _t(v), _t(valid))
    want = jax_masked_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    assert PR.NEG_INF == -1e30 == FR.NEG_INF


def test_paged_plain_matches_pallas_interpret():
    layout, page, ak, av, q, L = _paged_case(2)
    pg_ids, sl_pos = page_views(*layout, page)
    want = jax_paged_mha(jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av),
                         jnp.asarray(pg_ids), jnp.asarray(sl_pos), layer=L - 1,
                         rope_theta=1e4, interpret=True)
    got = paged_decode_mha(_t(q), _t(ak), _t(av), _t(pg_ids), _t(sl_pos),
                           layer=L - 1, rope_theta=1e4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_cpu_wrappers_count_no_launches():
    """On CPU tensors the wrappers run the plain versions: no kernel is
    launched, so no launch is counted."""
    before = (mha_flash.launches, selective_mha.launches, paged_decode_mha.launches)
    q, k, v, causal, _ = _flash_case(0)
    mha_flash(_t(q), _t(k), _t(v), causal=causal)
    q, k, v, qpos, hh, window, _ = _selective_case(0)
    selective_mha(_t(q), _t(qpos), _t(k), _t(v), _t(hh), window=window)
    layout, page, ak, av, q, _ = _paged_case(0)
    pg_ids, sl_pos = page_views(*layout, page)
    paged_decode_mha(_t(q), _t(ak), _t(av), _t(pg_ids), _t(sl_pos), layer=0)
    assert (mha_flash.launches, selective_mha.launches,
            paged_decode_mha.launches) == before


def test_wrappers_reject_mixed_devices():
    q, k, v, causal, _ = _flash_case(1)
    with pytest.raises(ValueError, match="devices"):
        mha_flash(_t(q), _t(k).to("meta"), _t(v), causal=causal)
