"""The dry run of every registry cell on a production mesh, with no card:
the counterpart of the JAX package's `launch/dryrun.py`.

The reference lowers each of the 40 cells (`configs.registry.cells`) on a
fake 256-device pod (16 x 16, axes data and model) or 512-device pair of
pods (2 x 16 x 16, axes pod, data and model), compiles it with XLA and
records per-device memory, FLOPs, bytes and collective bytes.  The port
runs one process per rank, so it traces one rank's step instead:

* the rank joins a fake world of 256 or 512 ranks (`launch.mesh.
  fake_world`: torch's ``fake`` backend, whose collectives move nothing)
  and builds its mesh with every group a real mesh has;
* under `FakeTensorMode` (tensors with shapes, dtypes and devices and no
  memory) `launch.steps.build` makes the rank's bundle (its shard of the
  model, its block of the cell's inputs, its optimizer state) and the
  step runs once.  The fake tensors lie on a ``cuda`` device where torch
  is built with CUDA, else on the CPU (a CPU-only torch can neither take
  a gradient of nor multiply into an fp32 result on a fake CUDA tensor);
* the kernel wrappers see fake tensors under the dry run and take their
  shape-only branch (`kernels.shape_only`): outputs of the right shape,
  the kernel's FLOPs and bytes by its bound's formula, no launch and no
  plain version in the kernel's place.

A record has the reference's keys where one exists:

* ``flops_per_device``: `torch.utils.flop_counter.FlopCounterMode`'s
  count of the step's matrix products (forward, backward and the
  recomputation of remat layers), plus the shape-only kernels' FLOPs;
* ``bytes_per_device``: the step's memory traffic by this rule: every op
  that returns a tensor and is not a view (nor a query of metadata) reads
  each tensor input once and writes each tensor output once, except that an in-place op's destination is written, not
  read, and an indexed write (`index_put_`, `scatter_`, `index_add_`,
  `index_copy_`) writes as many bytes as its values, not the whole
  destination; ``empty`` factories and collectives count nothing.  Plus
  the shape-only kernels' bytes.  That is the traffic of unfused eager
  execution, an upper bound of what a fused program moves;
* ``collectives``: ``per_op_bytes``, ``counts`` and ``total_bytes`` from
  the port's own collectives (`sharding.ctx.count_collectives`: output
  bytes times the reference's wire multipliers), and ``other``
  (broadcasts and object collectives, apart);
* ``memory``: ``argument_size``, the rank's parameters, optimizer state
  and inputs, exact (``argument_parts`` has the three), and
  ``temp_size``, the peak of the live bytes of the tensors the step
  creates (``temp_size_is``: modelled, from the fake tensors' storages;
  nothing is allocated, so it is never measured);
* ``roofline``: `launch.roofline.roofline_terms` at an H100 SXM's peaks.

A cell that fails is recorded with ``ok: false``, its error and its
traceback, and the run goes on.  `registry.refuse_multi_card`
(ogb_products) does not apply: this is the multi-card setting it waits
for.

    # every cell at both meshes (about twenty minutes on one CPU)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape decode_32k --mesh single --force
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import kernels as K
from repro_torch.configs import registry as R
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.roofline import roofline_terms
from repro_torch.sharding import ctx as CTX

POD, MULTI_POD = (16, 16), (2, 16, 16)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# indexed writes: (the op's base name, the argument holding the values)
_INDEXED = {"index_put_": "values", "index_put": "values", "_index_put_impl_": "values",
            "scatter_": "src", "scatter": "src", "scatter_add_": "src", "scatter_add": "src",
            "index_add_": "source", "index_add": "source", "index_copy_": "source",
            "index_copy": "source"}


def fake_device() -> str:
    """The fake tensors' device: ``cuda`` where torch is built with CUDA,
    else ``cpu`` (the module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() and torch.cuda.is_available() else "cpu"


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(tree) -> int:
    """Bytes of the elements of every tensor in `tree` (views by their own
    elements)."""
    return K.nbytes(*_tensors(tree))


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


class Traffic(TorchDispatchMode):
    """Counts the traced ops' bytes (the module docstring's rule) and the
    live bytes of the storages the ops create, with their peak.  Storages
    that existed before (`preexisting`: the step's arguments) are not
    counted live."""

    def __init__(self, preexisting=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._pre = {_storage(t)[0] for t in preexisting}
        self._tensors = set()
        self._holders: Dict[int, list] = {}

    def _drop(self, tid: int, key: int) -> None:
        self._tensors.discard(tid)
        holder = self._holders.get(key)
        if holder is None:
            return
        holder[0] -= 1
        if holder[0] == 0:
            self.live -= holder[1]
            del self._holders[key]

    def _track(self, t: torch.Tensor) -> None:
        tid = id(t)
        if tid in self._tensors:
            return
        key, size = _storage(t)
        if key in self._pre:
            return
        self._tensors.add(tid)
        holder = self._holders.get(key)
        if holder is None:
            holder = self._holders[key] = [0, size]
            self.live += size
            self.peak = max(self.peak, self.live)
        holder[0] += 1
        weakref.finalize(t, self._drop, tid, key)

    def _op_bytes(self, func, args, kwargs, out) -> int:
        """The module docstring's rule for one op."""
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        written = {a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        reads = nbytes([v for k, v in named.items() if k not in written])
        values = _INDEXED.get(func.__name__.split(".")[0])
        if values is not None:
            return reads + nbytes(named.get(values))
        return reads + nbytes(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if func.namespace in ("c10d", "_c10d_functional", "prim") or not outs:
            return out
        if not func.is_view and func.__name__.split(".")[0] not in _NO_TRAFFIC:
            self.bytes += self._op_bytes(func, args, kwargs, out)
        for t in outs:
            self._track(t)
        return out


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """A batched product's FLOPs, 2 b m k n, for every overload of `bmm`
    (FlopCounterMode's own formula takes `bmm.dtype`'s fp32-result
    argument for its output shape)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def _bundle_state(bundle) -> Dict[str, list]:
    """The rank's argument tensors: parameters, optimizer state, inputs."""
    opt = []
    if bundle.optimizer is not None:
        for st in bundle.optimizer.state.values():
            opt += _tensors(st)
    return {"params": list(bundle.model.parameters()), "opt_state": opt,
            "inputs": _tensors(bundle.inputs)}


@contextlib.contextmanager
def fake_bundle(arch: str, shape: str, mesh_shape: Sequence[int], *, rank: int = 0,
                layers: Optional[int] = None, batch_size: Optional[int] = None,
                seq: Optional[int] = None, record=None):
    """Rank `rank`'s bundle of a cell (`launch.steps.build`; `layers`,
    `batch_size` and `seq` cut it) on a fake world of `mesh_shape`, its
    tensors fake, while the block runs; the shape-only kernels report to
    `record(name, flops, bytes)` (default: nowhere)."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    dev = torch.device(fake_device())
    from torch._subclasses.fake_tensor import FakeTensorMode

    prev, K.DRY_RUN = K.DRY_RUN, record or (lambda *a: None)
    try:
        with MESH.fake_world(math.prod(mesh_shape), rank), \
                FakeTensorMode(allow_non_fake_inputs=True):
            mesh = MESH.make_production_mesh(shape=mesh_shape)
            gen = torch.Generator(device=dev).manual_seed(0)
            yield STEPS.build(arch, shape, mesh, dev, generator=gen, batch_size=batch_size,
                              seq=seq, layers=layers, multi_card=True)
    finally:
        K.DRY_RUN = prev


def argument_bytes(arch: str, shape: str, mesh_shape: Sequence[int], **cut) -> Dict[str, int]:
    """The rank's parameter, optimizer-state and input bytes of a cell on
    `mesh_shape` (`fake_bundle`), without running its step."""
    with fake_bundle(arch, shape, mesh_shape, **cut) as bundle:
        return {k: nbytes(v) for k, v in _bundle_state(bundle).items()}


def trace_cell(arch: str, shape: str, mesh_shape: Sequence[int], *, rank: int = 0,
               layers: Optional[int] = None, batch_size: Optional[int] = None,
               seq: Optional[int] = None) -> dict:
    """One rank's step of a cell on a fake world of `mesh_shape` (the
    module docstring); `layers`, `batch_size` and `seq` cut the cell as
    `launch.steps.build` does.  -> the record's measured part (raises on
    failure)."""
    kernels: Dict[str, Dict[str, float]] = {}

    def record(name: str, flops: float, nb: float) -> None:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nb

    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    with fake_bundle(arch, shape, mesh_shape, rank=rank, layers=layers,
                     batch_size=batch_size, seq=seq, record=record) as bundle:
        args = _bundle_state(bundle)
        t_build = time.time() - t0
        traffic = Traffic([t for ts in args.values() for t in ts])
        flops = FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flops})
        with CTX.count_collectives() as coll, flops as fc, traffic:
            out = bundle.fn(bundle.inputs)
            out_bytes = nbytes(out)
            del out
        t_trace = time.time() - t0 - t_build
    parts = {k: nbytes(v) for k, v in args.items()}
    return {
        "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
        "device": fake_device(), "rank": rank, "mesh_shape": list(mesh_shape),
        "cuts": {k: v for k, v in (("n_layers", layers), ("batch", batch_size), ("seq", seq))
                 if v is not None},
        "flops_per_device": float(fc.get_total_flops()) +
        sum(k["flops"] for k in kernels.values()),
        "bytes_per_device": float(traffic.bytes) + sum(k["bytes"] for k in kernels.values()),
        "collectives": {k: coll[k] for k in ("per_op_bytes", "counts", "total_bytes", "other")},
        "kernels": kernels,
        "memory": {"argument_size": sum(parts.values()), "argument_parts": parts,
                   "output_size": out_bytes, "temp_size": traffic.peak,
                   "temp_size_is": "modelled (peak live fake bytes of the step)",
                   "generated_code_size": None},
        "n_chips": math.prod(mesh_shape),
    }


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             skip_existing: bool = True) -> dict:
    """The reference's `run_cell`: one cell at (2, 16, 16) or (16, 16),
    its record written to ``out_dir/<arch>__<shape>__<mesh>.json``."""
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    out_path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            rec = json.load(f)
        if rec.get("ok"):
            print(f"[skip] {arch} x {shape} x {mesh_name} (cached)")
            return rec
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    t0 = time.time()
    try:
        rec.update(trace_cell(arch, shape, MULTI_POD if multi_pod else POD))
        rec["ok"] = True
        rec["roofline"] = roofline_terms(rec)
        rec["roofline"]["is"] = "modelled at H100 SXM peaks"
    except Exception as e:          # recorded for triage; the run goes on
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} x {shape} x {mesh_name}: {rec['error']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[{'ok' if rec['ok'] else 'FAIL'}] {arch} x {shape} x {mesh_name} "
          f"({time.time() - t0:.0f}s)")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    cells = list(R.cells())
    if args.arch != "all":
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape != "all":
        cells = [c for c in cells if c[1] == args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out, skip_existing=not args.force)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
