"""Block-gather wrapper: cached pre-RoPE KV pages gathered by a block
table into logical order, keys optionally rotated to their target
positions.  A second pool (the serving arena, where the block store keeps
shared prefix rows) can be addressed by the same table.

`PoolGather` binds the kernel to its pools once: their shapes, strides,
dtypes and alignment, the rotation frequencies and the library handle.
A call then checks only its table and positions, allocates the outputs
and launches, for one layer plane or a range of layers at once (the
selective prefill's layers 1..L-1 in one launch).  `assemble_kv` binds
one plane and calls it in one step.

A CPU tensor runs the plain version (`ref.py`); a CUDA tensor launches
the hand-written kernel (`gather.cu`) or raises.  `PlainGather` binds the
plain version alone, on any device (the plain attention backend).  `PoolGather.launches`
counts kernel launches and nothing else, `PoolGather.layer_launches`
those of them that were given a range of layers, and
`PoolGather.pool2_launches` those given a second pool."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.block_gather.ref import block_gather_layers_ref, rope_freqs

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"rt_block_gather": [_P, _I, _I] + [_P] * 5 + [_I, _I, _P]}
_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


class _Pools(ctypes.Structure):
    """`gather.cu:GatherPools`, field for field."""
    _fields_ = ([(n, _P) for n in ("k", "v", "k2", "v2", "freqs")]
                + [(n, _LL) for n in ("layer_stride", "page_stride", "layer_stride2",
                                      "page_stride2")]
                + [(n, _I) for n in ("n_pages", "n_pages2", "n_layers", "page", "H", "Dh",
                                     "k_dtype", "v_dtype", "vec")])


def device_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The plain version's frequencies, computed once per (d, theta,
    device) by the same PyTorch expression, so kernel and plain version
    rotate by bitwise the same angles."""
    key = (d, float(theta), device)
    f = _FREQS.get(key)
    if f is None:
        f = _FREQS[key] = rope_freqs(d, theta, device).contiguous()
    return f


class PlainGather:
    """The plain version (`ref.block_gather_layers_ref`) of `PoolGather`'s
    calls, bound to the same pools on any device and launching nothing:
    what the serving path gathers with under the plain attention backend
    (`core.engine.cache_gather`).  Pools, calls and outputs as
    `PoolGather` takes and gives them."""

    def __init__(self, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 pool2_k: Optional[torch.Tensor] = None,
                 pool2_v: Optional[torch.Tensor] = None, *, rope_theta: float = 10_000.0):
        if (pool2_k is None) != (pool2_v is None):
            raise ValueError("pool2_k and pool2_v go together")
        if pool_k.dim() not in (4, 5) or pool_v.shape != pool_k.shape:
            raise ValueError(f"pools {tuple(pool_k.shape)}/{tuple(pool_v.shape)}: need equal "
                             "shapes (L, n_pages, page, d) or (L, n_pages, page, Hkv, Dh)")
        self.two = pool2_k is not None
        if self.two and (pool2_k.dim() != pool_k.dim() or pool2_k.shape[0] != pool_k.shape[0]
                         or pool2_k.shape[2:] != pool_k.shape[2:]
                         or pool2_v.shape != pool2_k.shape or pool2_k.dtype != pool_k.dtype
                         or pool2_v.dtype != pool_v.dtype):
            raise ValueError(f"second pools {tuple(pool2_k.shape)}/{tuple(pool2_v.shape)}: "
                             f"need the first pools' layers and page shape "
                             f"{tuple(pool_k.shape[:1] + pool_k.shape[2:])} and dtypes")
        self.pool_k, self.pool_v, self.pool2_k, self.pool2_v = pool_k, pool_v, pool2_k, pool2_v
        self.rope_theta = float(rope_theta)
        self.n_layers, _, self.page = pool_k.shape[:3]
        self.tail = tuple(pool_k.shape[3:])

    def _layer_range(self, layers) -> Tuple[bool, int, int]:
        """(one layer?, first layer, number of layers) of a call's `layers`."""
        single = isinstance(layers, int)
        lo, n = (layers, 1) if single else (layers.start, len(layers))
        if lo < 0 or n < 1 or lo + n > self.n_layers or not (single or layers.step == 1):
            raise ValueError(f"layers {layers}: need a layer or a non-empty step-1 range "
                             f"within [0, {self.n_layers})")
        return single, lo, n

    def _check_call(self, block_table: torch.Tensor, rotate: bool, keep_raw: bool):
        if keep_raw and not rotate:
            raise ValueError("keep_raw returns the unrotated keys beside rotated ones: "
                             "it needs rotate=True")
        if block_table.dim() != 1:
            raise ValueError(f"block_table {tuple(block_table.shape)}: need (n_logical,)")

    def __call__(self, block_table: torch.Tensor, positions: Optional[torch.Tensor] = None,
                 layers=0, *, rotate: bool = True, keep_raw: bool = False):
        self._check_call(block_table, rotate, keep_raw)
        self._layer_range(layers)
        K.on_cuda(self.pool_k, block_table, *((positions,) if rotate else ()))
        return self.plain(block_table, positions, layers, rotate=rotate, keep_raw=keep_raw)

    def plain(self, block_table: torch.Tensor, positions: Optional[torch.Tensor] = None,
              layers=0, *, rotate: bool = True, keep_raw: bool = False):
        """The plain version (`ref.block_gather_layers_ref`) of a call, on
        the pools' device, in the call's output shapes."""
        single = isinstance(layers, int)
        sl = slice(layers, layers + 1) if single else slice(layers.start, layers.stop)
        n_logical = block_table.shape[0]
        out = block_gather_layers_ref(
            self.pool_k[sl], self.pool_v[sl], block_table,
            positions.reshape(n_logical, self.page) if rotate else None,
            rope_theta=self.rope_theta, rotate=rotate, keep_raw=keep_raw,
            pool2_k=self.pool2_k[sl] if self.two else None,
            pool2_v=self.pool2_v[sl] if self.two else None)
        rows = n_logical * self.page
        shape = (rows,) + self.tail if single else (len(out[0]), rows) + self.tail
        return tuple(t.reshape(shape) for t in out)


class PoolGather(PlainGather):
    """The block-gather kernel bound to its pools.

    pool_k/pool_v: (L, n_pages, page, d) or (L, n_pages, page, Hkv, Dh)
    stacks of layer planes, keys pre-RoPE, with one layer stride and one
    page stride each (K and V alike) and every page contiguous: the
    cached-row pool's (L, n_rows, 1, Hkv, Dh), or `PagedKVPool.planes()`.
    pool2_k/pool2_v (optional, together): a second stack of the same
    layers, page shape and dtypes, read by table entries in [n_pages,
    n_pages + n_pages2) (entry - n_pages).  Everything about the pools is
    checked here, once; `rope_theta` fixes the rotation's frequencies.
    The class counts the launches of every binding (module docstring)."""

    launches = 0
    layer_launches = 0
    pool2_launches = 0

    def __init__(self, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 pool2_k: Optional[torch.Tensor] = None,
                 pool2_v: Optional[torch.Tensor] = None, *, rope_theta: float = 10_000.0):
        super().__init__(pool_k, pool_v, pool2_k, pool2_v, rope_theta=rope_theta)
        n_pages = pool_k.shape[1]
        extra = (pool2_k, pool2_v) if self.two else ()
        self.cuda = K.on_cuda(pool_k, pool_v, *extra)
        if not self.cuda:
            return
        H, D = (1, self.tail[0]) if len(self.tail) == 1 else self.tail
        if D % 2 or D > 4096:
            raise ValueError(f"head dim {D}: need an even Dh <= 4096")
        strides = []
        for a, b, name in ((pool_k, pool_v, "pools"), *(((pool2_k, pool2_v, "second pools"),)
                                                       if self.two else ())):
            if a.stride() != b.stride() or not a[0, 0].is_contiguous():
                raise ValueError(f"{name}: need K and V of one layout, each page contiguous")
            strides += [a.stride(0), a.stride(1)]
        if not self.two:
            strides += [0, 0]
        self._k_dtype, self._v_dtype = pool_k.dtype, pool_v.dtype
        kc, vc = K.dtype_code("pool_k", pool_k), K.dtype_code("pool_v", pool_v)
        self.device, self._index = pool_k.device, pool_k.device.index
        self._freqs = device_freqs(D, self.rope_theta, self.device)
        nk, nv = 16 // pool_k.element_size(), 16 // pool_v.element_size()
        es = min(pool_k.element_size(), pool_v.element_size())
        vec = ((D // 2) % nk == 0 and (H * D) % nv == 0
               and all(t.data_ptr() % 16 == 0 for t in (pool_k, pool_v, *extra))
               and all(s * es % 16 == 0 for s in strides))
        self._pools = _Pools(pool_k.data_ptr(), pool_v.data_ptr(), K.ptr(pool2_k),
                             K.ptr(pool2_v), self._freqs.data_ptr(), *strides, n_pages,
                             pool2_k.shape[1] if self.two else 0, self.n_layers, self.page,
                             H, D, kc, vc, int(vec))
        self._addr = ctypes.addressof(self._pools)
        self._lib = _build.library("block_gather", _SIGNATURES)
        self._fn = self._lib.rt_block_gather

    def _operand(self, name: str, t: torch.Tensor, numel: int) -> None:
        if t.dtype is not torch.int32:
            raise TypeError(f"{name} dtype {t.dtype} not in (torch.int32,)")
        if not t.is_contiguous() or t.get_device() != self._index or t.numel() != numel:
            raise ValueError(f"{name} {tuple(t.shape)}: need a contiguous int32 tensor of "
                             f"{numel} entries on {self.device}")

    def __call__(self, block_table: torch.Tensor, positions: Optional[torch.Tensor] = None,
                 layers=0, *, rotate: bool = True, keep_raw: bool = False):
        """block_table: (n_logical,) int32; positions: n_logical x page
        int32 target positions, read only when `rotate`; layers: one layer
        (an int) or a range of them (step 1).  -> (k, v), with `keep_raw`
        (needs `rotate`) also the keys before rotation, written by the
        same launch: (k, v, k_raw), each (n_logical * page, ...) for one
        layer, (len(layers), n_logical * page, ...) for a range, in its
        pool's dtype."""
        if not self.cuda:
            return super().__call__(block_table, positions, layers, rotate=rotate,
                                    keep_raw=keep_raw)
        self._check_call(block_table, rotate, keep_raw)
        single, lo, n = self._layer_range(layers)
        n_logical = block_table.shape[0]
        rows = n_logical * self.page
        self._operand("block_table", block_table, n_logical)
        if rotate:
            self._operand("positions", positions, rows)
        shape = (rows,) + self.tail if single else (n, rows) + self.tail
        k = torch.empty(shape, dtype=self._k_dtype, device=self.device)
        v = torch.empty(shape, dtype=self._v_dtype, device=self.device)
        raw = torch.empty(shape, dtype=self._k_dtype, device=self.device) if keep_raw else None
        if n_logical == 0:
            return (k, v, raw) if keep_raw else (k, v)
        args = (self._addr, lo, n, block_table.data_ptr(),
                positions.data_ptr() if rotate else None, k.data_ptr(), v.data_ptr(),
                None if raw is None else raw.data_ptr(), n_logical, int(rotate))
        if torch._C._cuda_getDevice() == self._index:
            err = self._fn(*args, torch._C._cuda_getCurrentRawStream(self._index))
        else:
            with torch.cuda.device(self.device):
                err = self._fn(*args, torch._C._cuda_getCurrentRawStream(self._index))
        if err:
            _build.check(self._lib, err, "block_gather")
        PoolGather.launches += 1
        PoolGather.layer_launches += not single
        PoolGather.pool2_launches += self.two
        return (k, v, raw) if keep_raw else (k, v)


def assemble_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                block_table: torch.Tensor, positions: torch.Tensor, *,
                rope_theta: float = 10_000.0, rotate: bool = True,
                keep_raw: bool = False, pool2_k: Optional[torch.Tensor] = None,
                pool2_v: Optional[torch.Tensor] = None):
    """pool_k/pool_v: (n_pages, page, d) or (n_pages, page, Hkv, Dh)
    physical pools, keys pre-RoPE; block_table: (n_logical,) int32;
    positions: (n_logical, page) int32 target positions (read only when
    `rotate`).  -> (k, v), each (n_logical, page, ...) in its pool's
    dtype; with `keep_raw` (needs `rotate`) also the gathered keys before
    rotation, written by the same launch: (k, v, k_raw).

    `pool2_k`/`pool2_v` (optional, together): a second pool of n_pages2
    pages of the same page shape and dtype, read by table entries in
    [n_pages, n_pages + n_pages2) (entry - n_pages).  Its pages may lie
    any fixed number of elements apart (a layer plane of the serving
    arena, `PagedKVPool.planes()[layer]`), each page itself contiguous.

    Binds the pools and launches in one call, checking everything each
    time; a caller that gathers from the same pools again binds them once
    (`PoolGather`)."""
    if (pool2_k is None) != (pool2_v is None):
        raise ValueError("pool2_k and pool2_v go together")
    if pool_k.dim() not in (3, 4) or pool_v.shape != pool_k.shape:
        raise ValueError(f"pools {tuple(pool_k.shape)}/{tuple(pool_v.shape)}: need "
                         "equal shapes (n_pages, page, d) or (n_pages, page, Hkv, Dh)")
    page = pool_k.shape[1]
    n_logical = block_table.shape[0] if block_table.dim() == 1 else -1
    if block_table.dim() != 1 or tuple(positions.shape) != (n_logical, page):
        raise ValueError(f"block_table {tuple(block_table.shape)} / positions "
                         f"{tuple(positions.shape)}: need (n_logical,) / (n_logical, {page})")
    two = pool2_k is not None
    g = PoolGather(pool_k[None], pool_v[None], pool2_k[None] if two else None,
                   pool2_v[None] if two else None, rope_theta=rope_theta)
    out = g(block_table, positions, 0, rotate=rotate, keep_raw=keep_raw)
    return tuple(t.view((n_logical,) + tuple(pool_k.shape[1:])) for t in out)
