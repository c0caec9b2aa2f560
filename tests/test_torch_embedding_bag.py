"""Port parity for the embedding-bag kernel (B5).

On the CPU the wrapper `bag_sum` runs its plain PyTorch version; these
tests hold it to the JAX package's oracle (`embedding_bag_ref`) and to the
Pallas kernel in interpret mode, over the sweep of
`tests/test_kernels.py:test_embedding_bag_sweep`, the seeded property
sweep of `tests/test_kernel_properties.py:_check_embedding_bag`, and the
d = 1 table of Wide&Deep's wide part.  The CUDA kernel is held to the
same plain version on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import bag_sum as jax_bag_sum
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_embedding_bag_ref
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
