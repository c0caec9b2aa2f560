#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--n-layers N] [--requests N] [--decode-steps N]

Run from the repository root; needs one CUDA GPU, `nvcc` and nothing
else (no network, no JAX).  Phases:

1. set-up: the card's name and power limit, TF32 off, and a build of
   every CUDA kernel of the serving path from the sources in this
   checkout (one `nvcc` per source, all at once);
2. wave serving: the rcllm system at the full width of `rcllm-qwen3-8b`
   (random weights from a seeded generator; the offline KV build runs
   the flash kernel and packs the cached rows into a device pool)
   serves a few requests through the wave-scheduled continuous batcher
   (block-gather kernel assembling and realigning the cached KV,
   selective kernel in prefill, paged-decode kernel in decode).  Every
   kernel must have launched in this run, the flash and selective
   kernels on their tensor-core (bf16) routes.  A warm rerun of the same
   prefill and decode, without the batcher, splits the time by stage
   (host clock, card synchronised at each span) and reads the card's
   busy share and host<->card copy time under torch.profiler;
2c. chunked serving: the same system and trace through the chunked
   (unified-step) scheduler at full depth; the block-gather, selective
   (tensor-core route) and paged-decode kernels must each have launched
   in this run;
2d. recsys scoring and retrieval: Wide&Deep, AutoInt, DIEN and BERT4Rec
   at their published widths (random weights from a seeded generator)
   score a serve_p99 batch (512) and one retrieval_cand query against
   1,000,000 candidates, and Wide&Deep also a serve_bulk batch (262,144);
   Wide&Deep's wide sum must have launched the embedding-bag kernel.
   It runs after the rcllm kernels' checks and times of phases 3 and 4,
   so that no recsys model is on the card while the rcllm path runs;
3. checks: each kernel against its plain PyTorch version on the inputs
   one of its serving calls saw, in the working dtypes and in fp32 (the
   block gather bitwise where it copies); the served logits finite; and
   the tiny rcllm model served on the card, wave and chunked, decodes
   the same tokens as on the CPU (the plain versions).  The flash and
   selective kernels have two routes each: the tensor-core route is
   held to its plain version at the largest served call (the records
   "flash_attention" and "selective_attention"), the SIMT kernel at the
   largest fp32 call of the tiny runs (the records "...:fp32", whose
   launches are those runs') and at the served call cast to fp32.  The
   paged-decode kernel also against its split-K plain version at the
   split it chose, and it must run at least two blocks per SM.  The
   embedding bag on its serve_p99 and serve_bulk inputs, also with a bf16 and a d = 32
   table; and each recsys model at full width scores and retrieves the
   same on the card as a CPU copy of it;
4. kernel times (CUDA events, median of 20 after warm-up; and the
   device time alone under torch.profiler; for the paged-decode kernel
   also with the L2 flushed before each call) beside the plain version, one
   library call computing the same function where there is one, and the
   card's bound for the work.

The line before the last is the per-kernel JSON record; the last line is
`{"ok": true, "device": {...}}`.  A fuller report goes to
`chiprun_out/chip_smoke_report.json`.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import registry as RREG  # noqa: E402
from repro_torch.configs.rcllm_qwen3_8b import CONFIG as QWEN3_8B  # noqa: E402
from repro_torch.core import engine as ENG  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.block_gather import ops as BO  # noqa: E402
from repro_torch.kernels.block_gather.ref import block_gather_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as EO  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mask_rows, mha_flash_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as PO  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_ref,
    paged_decode_split_ref,
)
from repro_torch.kernels.selective_attention import ops as SO  # noqa: E402
from repro_torch.kernels.selective_attention.ref import selective_mha_ref  # noqa: E402
from repro_torch.launch import serve as SERVE  # noqa: E402
from repro_torch.launch import steps as STEPS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.recsys import models as RM  # noqa: E402
from repro_torch.serving import batch_engine as BE  # noqa: E402
from repro_torch.serving.api import ServeConfig  # noqa: E402
from repro_torch.serving.kv_pool import PagedKVPool  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: no TF32
# max |kernel - plain|: bf16 outputs carry one bf16 rounding (2^-8
# relative) plus probabilities rounded at another point; fp32 differs
# only by summation order over <= 512 keys of O(1) terms
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# block gather, relative to max(1, max|plain|): copies are exact; rotated
# keys see the same angles (the kernel takes the plain version's
# frequencies) and differ only by a sin/cos ulp, plus one bf16 rounding
GATHER_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
# embedding bag, relative to max(1, max|plain|): both sum in fp32, so fp32
# outputs differ only by summation order and bf16 ones by the one rounding
BAG_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
# recsys models on the card against a CPU copy (fp32, TF32 off): only the
# order of sums differs, carried through DIEN's 2 x 100 GRU steps
RECSYS_TOL = 1e-4
# the recsys cells run at full width on one card; the other archs'
# serve_bulk cells were sized for a pod (BERT4Rec's attention scores alone
# ~84 GB in fp32) and wait for the tensor-parallel slice
RECSYS_CELLS = {"wide-deep": ("serve_p99", "serve_bulk", "retrieval_cand"),
                "autoint": ("serve_p99", "retrieval_cand"),
                "dien": ("serve_p99", "retrieval_cand"),
                "bert4rec": ("serve_p99", "retrieval_cand")}
RCLLM_KERNELS = ("flash_attention", "selective_attention", "paged_decode_attention",
                 "block_gather")
# kernels with two routes: "<name>" counts and records the tensor-core route
# (bf16, the served path at full width), "<name>:fp32" the SIMT kernel
# (fp32, the tiny card == CPU path)
TWO_ROUTES = ("flash_attention", "selective_attention")

KERNELS = {
    "flash_attention": dict(
        fn=FO.mha_flash, source="src/repro_torch/kernels/flash_attention/flash.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:83"),
    "selective_attention": dict(
        fn=SO.selective_mha,
        source="src/repro_torch/kernels/selective_attention/selective.cu",
        replaces="src/repro/kernels/selective_attention/kernel.py:129"),
    "paged_decode_attention": dict(
        fn=PO.paged_decode_mha,
        source="src/repro_torch/kernels/paged_attention/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:112"),
    "block_gather": dict(
        fn=BO.assemble_kv, source="src/repro_torch/kernels/block_gather/gather.cu",
        replaces="src/repro/kernels/block_gather/kernel.py:41"),
    "embedding_bag": dict(
        fn=EO.bag_sum, source="src/repro_torch/kernels/embedding_bag/bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:35"),
}


def log(*a):
    print(*a, flush=True)


def reset_counts():
    for name, spec in KERNELS.items():
        spec["fn"].launches = 0
        if name in TWO_ROUTES:
            spec["fn"].tc_launches = 0


# ------------------------------------------------------------- recording
def _snapshot(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


class Recorder:
    """Wraps a kernel wrapper where the engine calls it and keeps the
    inputs of its largest call (by query size) for the checks."""

    def __init__(self, fn, snapshot=None):
        self.fn = fn
        self.snapshot = snapshot
        self.size = -1
        self.args = self.kwargs = None

    def __call__(self, *args, **kwargs):
        size = args[0].numel()
        if args[0].is_cuda and size > self.size:
            self.size = size
            if self.snapshot is not None:
                self.args, self.kwargs = self.snapshot(args, kwargs)
            else:
                self.args = tuple(_snapshot(a) for a in args)
                self.kwargs = {k: _snapshot(v) for k, v in kwargs.items()}
        return self.fn(*args, **kwargs)


def _paged_snapshot(args, kwargs):
    """Decode reads only the pages in its view: keep those (renumbered),
    not the whole arena, so later decode steps cannot change them."""
    q, ak, av, pg, sp = args
    used, inv = torch.unique(pg.long(), return_inverse=True)
    return ((q.clone(), ak[used].clone(), av[used].clone(),
             inv.to(torch.int32).contiguous(), sp.clone()), dict(kwargs))


class GatherRecorder:
    """Keeps the inputs of the largest rotated (the selective layers') and
    the largest unrotated (layer 0's Eq. 3 rows) block-gather call.  The
    pools are planes of the read-only cached-row pool and the tables are
    never written after the call, so references suffice."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {}

    def __call__(self, *args, **kwargs):
        mode = "rotate" if kwargs.get("rotate", True) else "copy"
        size = args[2].numel()
        if size > self.calls.get(mode, (-1,))[0]:
            self.calls[mode] = (size, args, dict(kwargs))
        return self.fn(*args, **kwargs)


class BagRecorder:
    """Keeps the inputs of the latest embedding-bag call per batch size
    (serve_p99, serve_bulk, retrieval).  The table is a model parameter
    and the ids are made anew for each call, so references suffice."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {}

    def __call__(self, table, ids):
        self.calls[ids.shape[0]] = (table, ids)
        return self.fn(table, ids)


def install_recorders():
    rec = {"flash_attention": Recorder(FO.mha_flash),
           "selective_attention": Recorder(SO.selective_mha),
           "paged_decode_attention": Recorder(PO.paged_decode_mha, _paged_snapshot),
           "block_gather": GatherRecorder(BO.assemble_kv)}
    patches = [(ENG, "mha_flash", rec["flash_attention"]),
               (TT, "mha_flash", rec["flash_attention"]),
               (ENG, "selective_mha", rec["selective_attention"]),
               (BE, "paged_decode_mha", rec["paged_decode_attention"]),
               (ENG, "assemble_kv", rec["block_gather"])]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, r in patches:
        setattr(mod, name, r)
    return rec, saved


# ------------------------------------------- plain versions, library, bound
def plain_call(name, args, kw):
    if name == "embedding_bag":
        return embedding_bag_ref(*args)
    if name == "block_gather":
        k, v = block_gather_ref(*args, rope_theta=kw.get("rope_theta", 1e4),
                                rotate=kw.get("rotate", True))
        return (k, v, args[0][args[2].long()]) if kw.get("keep_raw") else (k, v)
    if name == "flash_attention":
        return mha_flash_ref(*args, **kw)
    if name == "selective_attention":
        q, qp, k, v, hh = args
        return selective_mha_ref(q, torch.as_tensor(qp, device=q.device),
                                 k, v, torch.as_tensor(hh, device=q.device),
                                 window=kw.get("window", 256))
    return paged_decode_ref(*args, **kw)


def to_fp32(name, args, kw):
    f = lambda t: t.float() if torch.is_tensor(t) and t.is_floating_point() else t
    if name == "paged_decode_attention":
        return (f(args[0]),) + tuple(args[1:]), kw
    if name == "selective_attention":
        q, qp, k, v, hh = args
        return (f(q), qp, f(k), f(v), hh), kw
    return tuple(f(a) for a in args), kw


def library_call(name, args, kw):
    """One PyTorch call computing the same function (a yardstick timed
    here; the port never calls it), or None."""
    if name == "paged_decode_attention":
        return None
    if name == "embedding_bag":
        table, ids = args
        return lambda: F.embedding_bag(ids, table, mode="sum")
    if name == "block_gather":
        if kw.get("rotate", True):
            return None           # no one PyTorch call gathers and rotates
        pk, pv, bt = args[0], args[1], args[2].long()
        return lambda: (torch.index_select(pk, 0, bt), torch.index_select(pv, 0, bt))
    q = args[0]
    B, Sq, Hq, D = q.shape
    if name == "flash_attention":
        k, v = args[1], args[2]
        Skv = k.shape[1]
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if kw.get("causal", True):
            mask = torch.tril(mask)
        mask = mask[None, None].expand(B, Hq, Sq, Skv)
        if kw.get("kv_valid") is not None:
            kvv = kw["kv_valid"].bool()
            mask = mask & kvv[mask_rows(kvv.shape[0], B, Hq, q.device)][:, :, None, :]
    else:
        qp, k, v, hh = args[1], args[2], args[3], args[4]
        k = k.to(q.dtype)
        v = v.to(q.dtype)
        qp = torch.as_tensor(qp, device=q.device).long()
        hh = torch.as_tensor(hh, device=q.device) > 0
        kpos = torch.arange(k.shape[1], device=q.device)
        window = kw.get("window", 256)
        m = (qp[:, :, None] >= kpos) & ((qp[:, :, None] - kpos < window) | hh[:, None, :])
        rows = mask_rows(m.shape[0], B, Hq, q.device)
        mask = m[rows]                                         # (B, Hq, R, S)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def work(name, args, kw, out):
    """(bytes, flops) the function needs on these inputs: each input read
    once, the output written once, operations over live (query, key)
    pairs only (4*D per pair per head: QK^T and PV)."""
    if name == "embedding_bag":
        # ids read once, each bag's rows read once, the sums written once;
        # one add per row element
        table, ids = args
        rows = ids.numel() * table.shape[1]
        return nbytes(ids) + rows * table.element_size() + nbytes(out), rows
    if name == "block_gather":
        # each selected K and V row read once, every output written once;
        # a rotation is 4 products and 2 sums per key pair (3 per element)
        pk, pv, bt, pos = args
        rows = bt.numel() * pk[0].numel()
        reads = rows * (pk.element_size() + pv.element_size()) + nbytes(bt)
        rot = kw.get("rotate", True)
        return reads + (nbytes(pos) if rot else 0) + nbytes(*out), 3 * rows if rot else 0
    q = args[0]
    D = q.shape[-1]
    if name == "flash_attention":
        k, v = args[1], args[2]
        B, Sq, Hq, _ = q.shape
        Skv = k.shape[1]
        live = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if kw.get("causal", True):
            live = torch.tril(live)
        live = live[None, None].expand(B, Hq, Sq, Skv)
        if kw.get("kv_valid") is not None:
            kvv = kw["kv_valid"].bool()
            live = live & kvv[mask_rows(kvv.shape[0], B, Hq, q.device)][:, :, None, :]
        pairs = int(live.sum())
        return nbytes(q, k, v, kw.get("kv_valid"), out), 4 * D * pairs
    if name == "selective_attention":
        qp, k, v, hh = args[1], args[2], args[3], args[4]
        B, R, Hq, _ = q.shape
        qp_t = torch.as_tensor(qp, device=q.device).long()
        hh_t = torch.as_tensor(hh, device=q.device) > 0
        kpos = torch.arange(k.shape[1], device=q.device)
        window = kw.get("window", 256)
        m = (qp_t[:, :, None] >= kpos) & ((qp_t[:, :, None] - kpos < window)
                                          | hh_t[:, None, :])
        pairs = int(m[mask_rows(m.shape[0], B, Hq, q.device)].sum())
        live = torch.as_tensor(kw["live"]) if kw.get("live") is not None else None
        extra = nbytes(qp_t.int(), hh_t.to(torch.uint8), live)
        return nbytes(q, k, v, out) + extra, 4 * D * pairs
    ak, av, pg, sp = args[1], args[2], args[3], args[4]
    N, Hq, _ = q.shape
    Hkv = ak.shape[3]
    live_slots = int((sp >= 0).sum())
    kv_bytes = 2 * live_slots * Hkv * D * ak.element_size()
    flops = 4 * D * Hq * live_slots + 3 * D * Hkv * live_slots   # + rotation
    return nbytes(q, pg, sp, out) + kv_bytes, flops


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(statistics.median(times))


def device_ms(fn, reps=20, flush=None):
    """Mean device time per call: the card's kernel and copy intervals
    under torch.profiler, so the wrapper's host work between launches
    (which a CUDA-event time of one short call includes) is left out.
    With `flush` (a buffer larger than the 50 MB L2), the buffer is
    written before each call, so the call finds its inputs out of L2;
    the writes themselves are not counted."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def run(cold):
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(reps):
                if cold:
                    flush.fill_(i & 0xFF)
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    dur = lambda e: e.time_range.end - e.time_range.start
    warm = run(False)
    if flush is None:
        return sum(map(dur, warm)) / reps / 1e3
    names = {e.name for e in warm}
    return sum(dur(e) for e in run(True) if e.name in names) / reps / 1e3


class Spans:
    """Inclusive host-clock seconds per wrapped function.  The card is
    synchronised at entry and exit, so device work lands in the span
    that issued it (this slows the run: the spans are taken in a run of
    their own, never in the served one)."""

    def __init__(self):
        self.s, self.saved = {}, []

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
            return out
        self.saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, timed)

    def restore(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)


def warm_run(engine, plans, steps):
    """The serving path without the batcher: one rcllm prefill of every
    request's plan in one batch, then `steps` greedy decode steps and
    the release of every request.  -> (prefill, decode), to be called in
    that order."""
    rids = sorted(plans)
    brs = [BE.BatchRequest(rid=rid, tokens=plans[rid][0].tokens, plan=plans[rid][0],
                           block_table=plans[rid][1], positions=plans[rid][2],
                           have=plans[rid][3], n_reserve=steps) for rid in rids]
    state = {}

    def prefill():
        state["toks"] = engine.prefill(brs, "rcllm").argmax(-1)

    def decode():
        toks = state.pop("toks")
        for _ in range(steps):
            toks = engine.decode(rids, toks).argmax(-1)
        for rid in rids:
            engine.release(rid)
    return prefill, decode


def device_busy(fn):
    """Run `fn` under torch.profiler.  -> (wall s, device-busy s as the
    union of the card's kernel and copy intervals, top device consumers
    [(name, ms)], host<->card copy s, number of those copies); busy is
    None when the profiler saw no device event."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, memcpy_us, n_memcpy = [], {}, 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dur = e.time_range.end - e.time_range.start
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
            if "memcpy" in e.name.lower() and "dtod" not in e.name.lower():
                memcpy_us += dur
                n_memcpy += 1
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (wall, (busy / 1e6 if spans else None), [(n[:60], us / 1e3) for n, us in top],
            memcpy_us / 1e6, n_memcpy)


def shapes(args, kw):
    out = []
    for a in list(args) + [kw.get("kv_valid"), kw.get("live")]:
        if torch.is_tensor(a) or isinstance(a, np.ndarray):
            out.append(f"{tuple(a.shape)}:{str(a.dtype).replace('torch.', '')}")
    return out


def counts():
    """Launches per kernel since the last reset_counts(), the two routes of
    TWO_ROUTES apart."""
    out = {}
    for n, spec in KERNELS.items():
        fn = spec["fn"]
        if n in TWO_ROUTES:
            out[n] = fn.tc_launches
            out[f"{n}:fp32"] = fn.launches - fn.tc_launches
        else:
            out[n] = fn.launches
    return out


def route_of(name, a, kw):
    """The route ("tc" or "simt") the wrapper takes for this call."""
    if name == "flash_attention":
        kvv = kw.get("kv_valid")
        return FO._route(a[0], a[1], a[2], 1 if kvv is None else kvv.shape[0])
    qp = torch.as_tensor(a[1])
    return SO._route(a[0], a[2], a[3], qp.shape[0] if qp.dim() == 2 else 1)


def check_route(name, a, kw, want):
    route = route_of(name, a, kw)
    if route != want:
        raise RuntimeError(f"{name}: the recorded call took the {route} route, want {want}")
    return route


def log_serve(label, rep, peak_gb):
    log(f"  {label}: TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f} ms p99 "
        f"{rep['ttft_p99_s'] * 1e3:.1f} ms; TBT p50 {rep['tbt_p50_s'] * 1e3:.1f} ms; "
        f"decode {rep['throughput_tok_s']:.1f} tok/s"
        + ("" if peak_gb is None else f"; peak CUDA memory {peak_gb:.1f} GB"))


def check_served(label, launched, required, done, backend, args, config, cfg):
    """Every required kernel launched in the run, every request completed
    with its full output of valid token ids."""
    missing = [n for n in required if launched[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {label} serving path: {missing}")
    if len(done) != args.requests:
        raise RuntimeError(f"{label}: {len(done)} of {args.requests} requests completed")
    for c in done:
        toks = backend.generated[c.rid]
        if len(toks) != config.decode_steps or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"{label}: request {c.rid} generated {toks}")


def timed_record(name, spec, launches, a, kw, out, err, wdt, extra, label=None):
    """Kernel, plain and library times plus the bound for one call."""
    fn = spec["fn"]
    ms = time_ms(lambda: fn(*a, **kw))
    dev_ms = device_ms(lambda: fn(*a, **kw))
    plain_ms = time_ms(lambda: plain_call(name, a, kw))
    lib = library_call(name, a, kw)
    lib_ms = time_ms(lib) if lib is not None else None
    b, fl = work(name, a, kw, out)
    t_bytes, t_ops = b / HBM_BYTES_S * 1e3, fl / PEAK_FLOPS[wdt] * 1e3
    label = label or (name if kw.get("rotate", True) else f"{name}:copy")
    rec = {"name": label, "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "device_ms": dev_ms, "shapes": shapes(a, kw), "bytes": b,
           "flops": fl, **extra}
    log(f"time {label}: kernel {ms:.4f} ms (device only {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({rec['bound_by']})")
    return rec


def gather_records(calls, spec, launches):
    """The block gather against its plain version on the inputs of its
    largest rotated call (the selective layers') and its largest copy
    (layer 0's Eq. 3 rows): in the pool's serving dtype (fp32) and cast to
    the model's bf16.  Copies (values, unrotated and raw keys) must be
    bitwise; rotated keys within GATHER_TOL of max(1, max|plain|)."""
    fn = spec["fn"]
    records = []
    for mode in ("rotate", "copy"):
        if mode not in calls:
            raise RuntimeError(f"block_gather: no {mode} call was recorded")
        _, a, kw = calls[mode]
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            ad = (a[0].to(dt), a[1].to(dt), a[2], a[3])
            got, want = fn(*ad, **kw), plain_call("block_gather", ad, kw)
            torch.cuda.synchronize()
            exact = [torch.equal(g, w) for g, w in zip(got, want)]
            if mode == "rotate":
                exact = exact[1:]                    # values and raw keys
                scale = max(1.0, float(want[0].float().abs().max()))
                err = float((got[0].float() - want[0].float()).abs().max())
                if not torch.isfinite(got[0]).all() or err > GATHER_TOL[dt] * scale:
                    raise RuntimeError(f"block_gather {dt}: rotated keys max|kernel-plain| "
                                       f"{err} > {GATHER_TOL[dt]} x {scale}")
            else:
                err = 0.0
            if not all(exact):
                raise RuntimeError(f"block_gather {mode} {dt}: copies not bitwise {exact}")
            errs[dt] = err
        log(f"check block_gather {mode}: {shapes(a, kw)} copies bitwise; rotated keys "
            f"max|kernel-plain| fp32 {errs[torch.float32]:.3g}, bf16 "
            f"{errs[torch.bfloat16]:.3g} (tol {GATHER_TOL} x max(1, max|k|))")
        out = fn(*a, **kw)
        records.append(timed_record("block_gather", spec, launches, a, kw, out,
                                    errs[torch.float32], torch.float32,
                                    {"tol": GATHER_TOL[torch.float32],
                                     "bf16_max_abs_err": errs[torch.bfloat16]}))
    return records


def device_inputs(name, a, kw, dev):
    """A recorded call's inputs with the selective kernel's mask operands
    on the card, as the engine passes them."""
    if name == "selective_attention":
        kw = dict(kw, live=torch.as_tensor(kw["live"], dtype=torch.int32, device=dev))
        a = (a[0], torch.as_tensor(a[1], device=dev), a[2], a[3],
             torch.as_tensor(a[4], device=dev))
    return a, kw


def selective_host_inputs_ms(a, kw):
    """CUDA-event ms of the selective wrapper when its mask operands arrive
    as the engine passed them before it made them once per call: int64
    positions, int8 validity and the liveness map in host memory, which
    the wrapper copies and converts on every call."""
    q, qp, k, v, hh = a
    qp64, hh8 = qp.long(), hh.to(torch.int8)
    live = kw["live"].cpu().numpy()
    return time_ms(lambda: SO.selective_mha(q, qp64, k, v, hh8, **dict(kw, live=live)))


def paged_split_record(a, kw):
    """B3 at the served call: the kernel's split choice (pages per split,
    splits, blocks: at least two per SM), the kernel against the split-K
    plain version at the same split (within TOL), and its device time with
    the L2 flushed before each call by writing a 256 MB buffer (a decode
    step reaches each layer's K/V after the other layers' weights)."""
    fn = PO.paged_decode_mha
    q, ak = a[0], a[1]
    out = fn(*a, **kw)
    pps, splits = fn.last_splits
    blocks = q.shape[0] * ak.shape[3] * splits
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if blocks < 2 * sms:
        raise RuntimeError(f"paged_decode_attention: {blocks} blocks at the served call, "
                           f"fewer than two per SM ({sms} SMs)")
    split = paged_decode_split_ref(*a, **kw, pages_per_split=pps)
    torch.cuda.synchronize()
    err = float((out.float() - split.float()).abs().max())
    if not torch.isfinite(out).all() or err > TOL[q.dtype]:
        raise RuntimeError(f"paged_decode_attention: max|kernel - split plain| {err} > "
                           f"{TOL[q.dtype]}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=q.device)
    cold = device_ms(lambda: fn(*a, **kw), flush=flush)
    del flush
    log(f"check paged_decode_attention split-K: {splits} splits of {pps} pages, {blocks} "
        f"blocks on {sms} SMs; max|kernel - split plain| {err:.3g}; device time with the "
        f"L2 flushed {cold:.4f} ms")
    return {"pages_per_split": pps, "splits": splits, "blocks": blocks,
            "split_ref_max_abs_err": err, "device_cold_ms": cold, "flush_mb": 256}


def checked_record(name, spec, launches, a, kw, extra, fp32_too=False, label=None):
    """The kernel against its plain version on these inputs (within
    TOL of their working dtype; with `fp32_too` also the same call cast to
    fp32, which takes the SIMT route), then its timed record."""
    fn = spec["fn"]
    out = fn(*a, **kw)
    plain = plain_call(name, a, kw)
    torch.cuda.synchronize()
    wdt = a[0].dtype
    err = float((out.float() - plain.float()).abs().max())
    if not torch.isfinite(out).all() or err > TOL[wdt]:
        raise RuntimeError(f"{label or name}: max|kernel-plain| {err} > {TOL[wdt]} ({wdt})")
    extra = dict(extra, tol=TOL[wdt])
    msg = ""
    if fp32_too:
        a32, kw32 = to_fp32(name, a, kw)
        out32 = fn(*a32, **kw32)
        err32 = float((out32 - plain_call(name, a32, kw32)).abs().max())
        if err32 > TOL[torch.float32]:
            raise RuntimeError(f"{name}: fp32 max|kernel-plain| {err32} > {TOL[torch.float32]}")
        extra["fp32_max_abs_err"] = err32
        msg = f"; same call in fp32 {err32:.3g} (tol {TOL[torch.float32]})"
    route = f" ({extra['kernel_route']} route)" if "kernel_route" in extra else ""
    log(f"check {label or name}{route}: {shapes(a, kw)} max|kernel-plain| {err:.3g} "
        f"(tol {TOL[wdt]}, {str(wdt).replace('torch.', '')}){msg}")
    return timed_record(name, spec, launches, a, kw, out, err, wdt, extra, label=label)


# ---------------------------------------------------------------- recsys
def recsys_phase(dev, repeats=5):
    """Every recsys cell of RECSYS_CELLS at its published width, through
    the launcher's step functions.  -> (cells, models, recorded
    embedding-bag calls); the models stay on the card for the checks."""
    bag = BagRecorder(EO.bag_sum)
    saved, RM.bag_sum = RM.bag_sum, bag
    cells, models = [], {}
    try:
        for arch, shapes in RECSYS_CELLS.items():
            cfg = RREG.get_config(arch)
            base = torch.cuda.memory_allocated()
            gen = torch.Generator(device=dev).manual_seed(0)
            t0 = time.perf_counter()
            model = models[arch] = RM.init_params(cfg, gen, dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            param_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
            for shape in shapes:
                torch.cuda.reset_peak_memory_stats()
                batch = RREG.make_batch(cfg, shape, gen, dev)
                fn = STEPS.step_of(shape)
                out, times = STEPS.time_step(fn, model, batch, repeats)
                wall, busy, top, _, _ = device_busy(lambda: fn(model, batch))
                n = batch[next(iter(batch))].shape[0]
                want = (n, RREG.RECSYS_SHAPES[shape].dims["n_candidates"]) \
                    if shape == "retrieval_cand" else (n,)
                finite = bool(torch.isfinite(out).all())
                cell = {"arch": arch, "shape": shape, "batch": int(n),
                        "ms_per_call": statistics.median(times) * 1e3,
                        "ms_min": min(times) * 1e3, "repeats": repeats,
                        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                        "param_gb": param_gb, "init_s": init_s,
                        "profiled_wall_ms": wall * 1e3,
                        "device_busy_ms": None if busy is None else busy * 1e3,
                        "device_idle_share": None if busy is None else 1 - busy / wall,
                        "top_device": top, "out_shape": list(out.shape), "finite": finite}
                cells.append(cell)
                log(f"  recsys {arch} {shape}: batch {n}, {cell['ms_per_call']:.3f} ms per call "
                    f"(median of {repeats}), peak {cell['peak_gb']:.2f} GB above the phase's "
                    f"start (params {param_gb:.3f} GB), output {tuple(out.shape)} "
                    f"{'finite' if finite else 'NOT finite'}; profiled call: wall "
                    f"{wall * 1e3:.3f} ms, device busy "
                    f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms'}; top device: "
                    + "; ".join(f"{k} {ms:.3f} ms" for k, ms in top[:4]))
                if tuple(out.shape) != want or not finite:
                    raise RuntimeError(f"recsys {arch} {shape}: output {tuple(out.shape)} "
                                       f"(want {want}), finite {finite}")
                del batch, out
    finally:
        RM.bag_sum = saved
    return cells, models, bag.calls


def bag_records(calls, spec, launches, models):
    """The embedding bag against its plain version on the inputs of
    Wide&Deep's serve_bulk and serve_p99 calls: the wide table in fp32 and
    in bf16, and the same ids into the (rows, 32) deep table.  Each within
    BAG_TOL of max(1, max|plain|)."""
    fn = spec["fn"]
    records = []
    deep_table = models["wide-deep"].table
    for shape in ("serve_bulk", "serve_p99"):
        b = RREG.RECSYS_SHAPES[shape].dims["batch"]
        if b not in calls:
            raise RuntimeError(f"embedding_bag: no call of batch {b} ({shape}) was recorded")
        table, ids = calls[b]
        errs = {}
        for label, t in (("fp32 d=1", table), ("bf16 d=1", table.to(torch.bfloat16)),
                         ("fp32 d=32", deep_table)):
            got, want = fn(t, ids), embedding_bag_ref(t, ids)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.float().abs().max()))
            err = float((got.float() - want.float()).abs().max())
            tol = BAG_TOL[t.dtype] * scale
            if got.dtype != t.dtype or not torch.isfinite(got).all() or err > tol:
                raise RuntimeError(f"embedding_bag {shape} {label}: max|kernel-plain| "
                                   f"{err} > {tol}")
            errs[label] = err
            del got, want
        log(f"check embedding_bag {shape}: ids {tuple(ids.shape)} into {tuple(table.shape)}; "
            "max|kernel-plain| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {BAG_TOL} x max(1, max|plain|))")
        a = (table, ids)
        out = fn(*a)
        # rows narrower than a 32-byte sector cost the card a whole sector
        row = table.shape[1] * table.element_size()
        sector_bytes = nbytes(ids) + ids.numel() * max(32, -(-row // 32) * 32) + nbytes(out)
        extra = {"tol": BAG_TOL[torch.float32], "bf16_max_abs_err": errs["bf16 d=1"],
                 "d32_max_abs_err": errs["fp32 d=32"],
                 "sector_bound_ms": sector_bytes / HBM_BYTES_S * 1e3}
        records.append(timed_record("embedding_bag", spec, launches, a, {}, out,
                                    errs["fp32 d=1"], torch.float32, extra,
                                    label="embedding_bag" if shape == "serve_bulk"
                                    else f"embedding_bag:{shape}"))
    return records


def recsys_card_vs_cpu(models, dev, batch=64, n_candidates=4096):
    """Each model at full width scores a batch of `batch` and retrieves
    against `n_candidates` candidates on the card (kernel) and on a CPU
    copy of itself (plain versions): allclose within RECSYS_TOL."""
    out = {}
    for arch, model in models.items():
        cpu = copy.deepcopy(model).to("cpu")
        gen = torch.Generator(device=dev).manual_seed(1)
        errs = {}
        for shape in ("serve_p99", "retrieval_cand"):
            b = RREG.make_batch(model.cfg, shape, gen, dev, batch=batch)
            if shape == "retrieval_cand":
                b["candidate_ids"] = b["candidate_ids"][:n_candidates]
            fn = STEPS.step_of(shape)
            got = fn(model, b).cpu()
            want = fn(cpu, {k: v.cpu() for k, v in b.items()})
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=RECSYS_TOL, atol=RECSYS_TOL):
                raise RuntimeError(f"recsys {arch} {shape}: card vs CPU max abs diff {err} "
                                   f"beyond rtol=atol={RECSYS_TOL}")
            errs[shape] = err
        out[arch] = errs
        log(f"check recsys {arch} at full width, card == CPU copy: max abs diff "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (batch {batch}, {n_candidates} candidates; rtol=atol={RECSYS_TOL})")
        del cpu
    return out


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-layers", type=int, default=QWEN3_8B.n_layers,
                    help="depth to run (width is never cut)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--qps", type=float, default=8.0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on a GPU")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: build every kernel from this checkout's sources ----
    build_s = _build.build()
    log(f"kernel build: {build_s:.1f} s (parallel nvcc, sm_90a)")
    for name in _build.SOURCES:
        text = _build.library_path(name).with_suffix(".log")
        for line in (text.read_text().splitlines() if text.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- phase 2: wave rcllm serving at Qwen3-8B width ----
    cfg = dataclasses.replace(QWEN3_8B, n_layers=args.n_layers)
    config = ServeConfig(decode_steps=args.decode_steps)
    rec, saved = install_recorders()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system, reqs, plans = SERVE.rcllm_setup(cfg, dev, args.requests, args.qps,
                                            config.decode_steps)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    engine, backend, batcher, done = SERVE.serve(system.model, cfg, config, reqs, plans,
                                                 system.rows)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0 - t_build
    launches = {"wave": counts()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rep = SERVE.report(config, engine, backend, batcher, done, warmup=False)
    log(f"serving: {cfg.name} d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim {cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
        f"depth {cfg.n_layers} of {QWEN3_8B.n_layers} layers, "
        f"{cfg.param_count() / 1e9:.2f} B params bf16; cached-row pool "
        f"{system.rows.n_rows} rows, {system.rows.nbytes / 1e9:.2f} GB on the card")
    log(f"  offline build + workload {t_build:.1f} s, wave serving {t_serve:.1f} s, "
        f"{len(done)} requests x {config.decode_steps} tokens")
    log_serve("wave", rep, peak_gb)
    log(f"  kernel launches in the wave run: {launches['wave']}")
    check_served("wave", launches["wave"], RCLLM_KERNELS, done, backend, args, config, cfg)

    # ---- phase 2c: the same trace through the chunked scheduler ----
    cconfig = ServeConfig(decode_steps=args.decode_steps, sched="chunked")
    reset_counts()
    t0 = time.perf_counter()
    c_engine, c_backend, c_batcher, c_done = SERVE.serve(system.model, cfg, cconfig, reqs,
                                                         plans, system.rows)
    torch.cuda.synchronize()
    t_chunked = time.perf_counter() - t0
    launches["chunked"] = counts()
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    crep = SERVE.report(cconfig, c_engine, c_backend, c_batcher, c_done, warmup=True)
    ticks = c_batcher.workers[0].ticks
    same = sum(c_backend.generated[r] == backend.generated[r] for r in backend.generated)
    log(f"chunked serving (chunk {cconfig.chunk_tokens} tokens, step budget "
        f"{cconfig.resolved_step_tokens}; depth {cfg.n_layers}): {t_chunked:.1f} s, "
        f"{len(ticks)} ticks ({sum(t.oversized for t in ticks)} oversized); "
        f"{same}/{len(backend.generated)} requests decoded the wave run's tokens")
    log_serve("chunked", crep, None)
    log(f"  kernel launches in the chunked run: {launches['chunked']}")
    check_served("chunked", launches["chunked"],
                 ("block_gather", "selective_attention", "paged_decode_attention"),
                 c_done, c_backend, args, cconfig, cfg)
    del c_engine, c_backend, c_batcher

    # ---- phase 2b: where the time goes (warm wave prefill and decode) ----
    spans = Spans()
    spans.wrap(BE.BatchEngine, "prefill", "prefill")
    spans.wrap(ENG, "layer0", "layer0")
    spans.wrap(ENG, "select_recompute", "select_recompute")
    spans.wrap(ENG, "selective_layers_batch", "selective_layers_batch")
    spans.wrap(ENG, "selective_layers", "selective_layers")
    spans.wrap(PagedKVPool, "write_at_batch", "pool_writes")
    spans.wrap(BE.BatchEngine, "decode", "decode")
    spans.wrap(BE, "decode_step", "decode_step")
    for f in warm_run(engine, plans, config.decode_steps - 1):
        f()
    spans.restore()
    s = spans.s
    steps = config.decode_steps - 1
    breakdown = {
        "requests": len(plans), "decode_steps": steps,
        "prefill_s": s["prefill"],
        "prefill": {"layer0_eq3": s["layer0"], "select_recompute_host": s["select_recompute"],
                    "selective_layers_device": s["selective_layers"],
                    "selective_batch_setup": s["selective_layers_batch"] - s["selective_layers"],
                    "pool_writes": s["pool_writes"]},
        "decode_step_ms": s["decode"] / steps * 1e3,
        "decode": {"model_step_ms": s["decode_step"] / steps * 1e3,
                   "page_tables_host_ms": (s["decode"] - s["decode_step"]) / steps * 1e3},
    }
    known = sum(breakdown["prefill"].values())
    breakdown["prefill"]["other"] = s["prefill"] - known
    pre, dec = warm_run(engine, plans, steps)
    for phase, fn in (("prefill", pre), ("decode", dec)):
        wall, busy, top, memcpy_s, n_memcpy = device_busy(fn)
        breakdown[f"{phase}_profiled_wall_s"] = wall
        breakdown[f"{phase}_device_busy_s"] = busy
        breakdown[f"{phase}_device_busy_share"] = None if busy is None else busy / wall
        breakdown[f"{phase}_device_idle_share"] = None if busy is None else 1 - busy / wall
        breakdown[f"{phase}_host_card_memcpy_s"] = memcpy_s
        breakdown[f"{phase}_host_card_memcpy_count"] = n_memcpy
        breakdown[f"{phase}_top_device"] = top
    log(f"breakdown (warm, {len(plans)} requests in one prefill batch, then {steps} "
        f"decode steps; host clock, card synchronised at each span):")
    log("  prefill " + f"{s['prefill']:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in breakdown["prefill"].items()))
    log(f"  decode step {breakdown['decode_step_ms']:.2f} ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in breakdown["decode"].items()))
    log("  device-busy / idle share of the profiled wall: " + "; ".join(
        f"{phase} {breakdown[f'{phase}_device_busy_share']} / "
        f"{breakdown[f'{phase}_device_idle_share']}" for phase in ("prefill", "decode")))
    for phase in ("prefill", "decode"):
        busy = breakdown[f"{phase}_device_busy_s"]
        log(f"  profiled {phase}: wall {breakdown[f'{phase}_profiled_wall_s']:.3f} s, device busy "
            f"{'not measured (no device events)' if busy is None else f'{busy:.3f} s'}, idle share "
            f"{breakdown[f'{phase}_device_idle_share']}; host<->card memcpy "
            f"{breakdown[f'{phase}_host_card_memcpy_s'] * 1e3:.3f} ms in "
            f"{breakdown[f'{phase}_host_card_memcpy_count']} copies; top device: "
            + "; ".join(f"{n} {ms:.2f} ms" for n, ms in breakdown[f"{phase}_top_device"]))

    # ---- phase 3: checks ----
    plan, table, positions, have = plans[min(plans)]
    br = BE.BatchRequest(rid=-1, tokens=plan.tokens, plan=plan, block_table=table,
                         positions=positions, have=have)
    logits = engine.prefill([br], "rcllm")
    rfrac = engine.last_stats[br.rid].recompute_fraction()
    engine.release(br.rid)
    if logits.shape != (1, cfg.vocab_size) or not np.isfinite(logits).all():
        raise RuntimeError(f"served logits not finite / wrong shape {logits.shape}")
    log(f"  prefill logits finite, shape {logits.shape}; {plan.n} prompt tokens, "
        f"recompute fraction {rfrac:.3f}")

    total = {n: sum(run[n] for run in launches.values()) for n in launches["wave"]}
    records = []
    for name, spec in KERNELS.items():
        if name == "block_gather":
            records += gather_records(rec[name].calls, spec, total[name])
            continue
        if name == "embedding_bag":
            continue    # recorded after the recsys phase below
        a, kw = device_inputs(name, rec[name].args, rec[name].kwargs, dev)
        extra = {}
        if name in TWO_ROUTES:
            extra["kernel_route"] = check_route(name, a, kw, "tc")
        if name == "selective_attention":
            extra["ms_host_inputs"] = selective_host_inputs_ms(a, kw)
        if name == "paged_decode_attention":
            extra.update(paged_split_record(a, kw))
        records.append(checked_record(name, spec, total[name], a, kw, extra, fp32_too=True))
    # ---- phase 2d: recsys scoring and retrieval at published widths ----
    # (after the rcllm checks and times, so that no recsys model is on the
    # card while the rcllm path runs)
    log("recsys scoring and retrieval (published widths, seeded random weights):")
    reset_counts()
    t0 = time.perf_counter()
    recsys_cells, recsys_models, bag_calls = recsys_phase(dev)
    torch.cuda.synchronize()
    t_recsys = time.perf_counter() - t0
    launches["recsys"] = counts()
    log(f"  recsys phase {t_recsys:.1f} s; kernel launches: {launches['recsys']}")
    if launches["recsys"]["embedding_bag"] == 0:
        raise RuntimeError("embedding_bag never launched on the recsys path")
    bag_total = sum(run["embedding_bag"] for run in launches.values())
    records += bag_records(bag_calls, KERNELS["embedding_bag"], bag_total, recsys_models)
    del rec, bag_calls
    recsys_checks = recsys_card_vs_cpu(recsys_models, dev)
    del recsys_models

    # small-input reference: the tiny rcllm model served on the card
    # (kernels) decodes the same greedy tokens as on the CPU (plain), under
    # both schedulers.  Its fp32 calls are the SIMT routes of B1 and B2.
    reset_counts()
    tiny_rec, tiny_saved = install_recorders()
    try:
        for sched in ("wave", "chunked"):
            tiny = {}
            model = None
            tconfig = ServeConfig(decode_steps=4, sched=sched, chunk_tokens=64)
            for d in (dev, torch.device("cpu")):
                tsys, treqs, tplans = SERVE.rcllm_setup(None, d, 4, 1e6, 4, model=model)
                _, tb, _, _ = SERVE.serve(tsys.model, tsys.cfg, tconfig, treqs, tplans,
                                          tsys.rows)
                tiny[d.type] = {r: tb.generated[r] for r in sorted(tb.generated)}
                model = copy.deepcopy(tsys.model).to("cpu")
            if tiny["cuda"] != tiny["cpu"]:
                raise RuntimeError(f"tiny rcllm {sched} tokens differ: card {tiny['cuda']} "
                                   f"cpu {tiny['cpu']}")
            log(f"check tiny rcllm {sched} serving: card tokens == CPU plain-version tokens "
                f"{tiny['cuda']}")
    finally:
        for mod, name, fn in tiny_saved:
            setattr(mod, name, fn)
    launches["tiny"] = counts()
    log(f"  kernel launches in the tiny card runs (wave + chunked): {launches['tiny']}")
    for name in TWO_ROUTES:
        label = f"{name}:fp32"
        if launches["tiny"][label] == 0:
            raise RuntimeError(f"the SIMT route of {name} never launched on the tiny fp32 path")
        a, kw = device_inputs(name, tiny_rec[name].args, tiny_rec[name].kwargs, dev)
        extra = {"kernel_route": check_route(name, a, kw, "simt")}
        records.append(checked_record(name, KERNELS[name],
                                      sum(run[label] for run in launches.values()), a, kw,
                                      extra, label=label))
    del tiny_rec

    report = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s, "offline_build_s": t_build, "serving_s": t_serve,
              "chunked_serving_s": t_chunked, "recsys_s": t_recsys, "peak_cuda_gb": peak_gb,
              "depth": cfg.n_layers, "serve": rep, "serve_chunked": crep,
              "chunked_ticks": [dataclasses.asdict(t) for t in ticks],
              "chunked_tokens_equal_wave": same, "launches": launches,
              "cache_rows": system.rows.n_rows, "cache_rows_gb": system.rows.nbytes / 1e9,
              "recompute_fraction": rfrac, "prompt_tokens": plan.n, "breakdown": breakdown,
              "recsys_cells": recsys_cells, "recsys_card_vs_cpu": recsys_checks,
              "kernels": records, "total_s": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    log(f"total {report['total_s']:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
