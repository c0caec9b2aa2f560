"""Route choice of the flash (B1) and selective (B2) wrappers, on the CPU.

A CUDA call launches the small-head route ("small"), the tensor-core
route ("tc") or the SIMT kernel ("simt") that `_route` names from dtypes
and shapes alone, and raises for what none takes; the kernels themselves
are held to their plain versions on the card (`test_torch_cuda.py`).  Here the rule is written out
again independently and compared with `_route` over every dtype, head
dim, group size and mask-row count the routes distinguish."""
import itertools
import re

import pytest
import torch

from repro_torch.kernels.flash_attention.ops import _bwd_route as bwd_route
from repro_torch.kernels.flash_attention.ops import _route as flash_route
from repro_torch.kernels.selective_attention.ops import _route as selective_route
from repro_torch.kernels.selective_attention.ops import check_live_tiles

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = list(itertools.product((F32, BF16), repeat=3))          # (q, k, v)
GROUPS = (1, 2, 3, 4, 8, 16)
B, HKV = 3, 2


def _operands(dtypes, D, G):
    qd, kd, vd = dtypes
    q = torch.zeros(B, 1, HKV * G, D, dtype=qd)
    return q, torch.zeros(B, 5, HKV, D, dtype=kd), torch.zeros(B, 5, HKV, D, dtype=vd)


def _mask_rows(G):
    """NB values that divide B*Hq: one row, one per batch row, per kv head
    and per query head."""
    return sorted({1, B, B * HKV, B * HKV * G})


# head dims either side of the small-head route's limit (32) and the
# tensor-core route's two
HEAD_DIMS = [1, 8, 12, 16, 32, 33, 64, 128]


def _expected(dtypes, D, G, nb, *, fp32_keys):
    if D <= 32:
        return "small"
    qd, kd, vd = dtypes
    dtypes_ok = qd == vd == BF16 and (kd in (F32, BF16) if fp32_keys else kd == BF16)
    tc = dtypes_ok and D in (64, 128) and G in (1, 2, 4, 8) and (B * HKV) % nb == 0
    return "tc" if tc else "simt"


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: "-".join(str(t)[6:] for t in d))
def test_selective_route(dtypes, D):
    """D <= 32 takes the small-head route in any dtypes, at any group
    size and mask-row count; above it bf16 q and v (k bf16 or fp32, the
    served call's), D in {64, 128}, G in {1, 2, 4, 8} and NB | B*Hkv take
    the tensor cores, and the rest the SIMT kernel."""
    for G in GROUPS:
        q, k, v = _operands(dtypes, D, G)
        for nb in _mask_rows(G):
            assert selective_route(q, k, v, nb) == _expected(dtypes, D, G, nb, fp32_keys=True)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: "-".join(str(t)[6:] for t in d))
def test_flash_route(dtypes, D):
    """D <= 32 takes the small-head route; above it only all-bf16
    operands take the tensor cores, with the same head dims, group sizes
    and kv_valid row counts."""
    for G in GROUPS:
        q, k, v = _operands(dtypes, D, G)
        for nb in _mask_rows(G):
            assert flash_route(q, k, v, nb) == _expected(dtypes, D, G, nb, fp32_keys=False)


def _bad_cases():
    bf = dict(dtype=BF16)
    q = torch.zeros(2, 4, 8, 128, **bf)
    kv = torch.zeros(2, 6, 2, 128, **bf)
    return {
        "head-dim-256": ((torch.zeros(2, 4, 8, 256, **bf), torch.zeros(2, 6, 2, 256, **bf),
                          torch.zeros(2, 6, 2, 256, **bf), 1), ValueError, "D <= 128"),
        "hkv-not-dividing-hq": ((torch.zeros(2, 4, 6, 128, **bf), torch.zeros(2, 6, 4, 128, **bf),
                                 torch.zeros(2, 6, 4, 128, **bf), 1), ValueError, "Hkv | Hq"),
        "float16": ((q.half(), kv.half(), kv.half(), 1), TypeError, "dtype"),
        "float64-keys": ((q, kv.double(), kv, 1), TypeError, "dtype"),
        "mask-rows-not-dividing": ((q, kv, kv, 3), ValueError, "NB"),
        "k-v-shapes-differ": ((q, kv, kv[:, :5], 1), ValueError, "k/v shape"),
        "batch-differs": ((q, kv[:1], kv[:1], 1), ValueError, "k/v shape"),
    }


@pytest.mark.parametrize("route", [flash_route, selective_route], ids=["flash", "selective"])
@pytest.mark.parametrize("case", list(_bad_cases()))
def test_routes_refuse_what_neither_kernel_takes(route, case):
    args, exc, match = _bad_cases()[case]
    with pytest.raises(exc, match=match):
        route(*args)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_selective_liveness_tiles_per_route(G):
    """The engine's 64 x 64 liveness tiles suit all three routes; the
    tensor-core route needs 64 / G queries and 64 keys inside one tile,
    SIMT 16 and 32; the small-head route takes any tile (a block ORs the
    entries it touches), but not an empty one."""
    check_live_tiles("tc", G, 64, 64)
    check_live_tiles("simt", G, 64, 64)
    check_live_tiles("small", G, 64, 64)
    check_live_tiles("simt", G, 16, 32)
    for q_block, kv_block in ((1, 1), (16, 32), (48, 80), (7, 13)):
        check_live_tiles("small", G, q_block, kv_block)
    with pytest.raises(ValueError, match="small route"):
        check_live_tiles("small", G, 0, 64)
    with pytest.raises(ValueError, match="tc route"):
        check_live_tiles("tc", G, 64, 32)
    if G < 4:
        with pytest.raises(ValueError, match="tc route"):
            check_live_tiles("tc", G, 16, 64)
    else:
        check_live_tiles("tc", G, 16, 64)
    with pytest.raises(ValueError, match="simt route"):
        check_live_tiles("simt", G, 8, 32)


@pytest.mark.parametrize("D", [16, 64, 112, 128, 256, 288, 1, 8, 32, 33])
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: "-".join(str(t)[6:] for t in d))
def test_bwd_route(dtypes, D):
    """The attention backward: D <= 32 takes the small-head route (a row
    per thread) in any dtype; all-bf16 operands at D 64, 128 or 256 take
    the tensor cores at any group size; fp32, mixed dtypes and bf16 at
    any other D <= 256 the SIMT kernels; D > 256 and Hkv not dividing Hq
    are refused."""
    qd, kd, vd = dtypes
    for G in (1, 4, 6, 12):
        q = torch.zeros(B, 3, HKV * G, D, dtype=qd)
        k, v = torch.zeros(B, 5, HKV, D, dtype=kd), torch.zeros(B, 5, HKV, D, dtype=vd)
        if D > 256:
            with pytest.raises(ValueError, match=re.escape("D <= 256")):
                bwd_route(q, k, v)
            continue
        tc = qd == kd == vd == BF16 and D in (64, 128, 256)
        assert bwd_route(q, k, v) == ("small" if D <= 32 else "tc" if tc else "simt")
        odd = torch.zeros(B, 3, HKV * G + 1, D, dtype=qd)
        with pytest.raises(ValueError, match=re.escape("Hkv | Hq")):
            bwd_route(odd, k, v)


@pytest.mark.parametrize("D", [16, 64, 128])
def test_forced_route_takes_simt_or_the_chosen_route_only(D):
    """The route-taking launch entries (`_flash_launch`, `_selective_launch`,
    which time one route against another on the card) refuse, before any
    launch, a route that does not take the operands: "simt" takes every
    one, the others only what `_route` names."""
    from repro_torch.kernels.flash_attention.ops import _flash_launch
    from repro_torch.kernels.selective_attention.ops import _selective_launch

    q, k, v = _operands((BF16, BF16, BF16), D, 2)
    chosen = flash_route(q, k, v, 1)
    for route in ("small", "tc"):
        if route == chosen:
            continue
        with pytest.raises(ValueError, match="route"):
            _flash_launch(route, q, k, v, kv_valid=None, causal=True)
        with pytest.raises(ValueError, match="route"):
            _selective_launch(route, q, torch.zeros(1, 1, dtype=torch.int32), k, v,
                              torch.ones(1, 5, dtype=torch.uint8), live=None, window=0,
                              q_block=64, kv_block=64)
