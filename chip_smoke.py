#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--n-layers N] [--requests N] [--decode-steps N]

Run from the repository root; needs one CUDA GPU, `nvcc` and nothing
else (no network, no JAX).  Phases:

1. set-up: the card's name and power limit, TF32 off, and a build of
   every CUDA kernel of the serving path from the sources in this
   checkout (one `nvcc` per source, all at once);
2. serving: the rcllm system at the full width of `rcllm-qwen3-8b`
   (random weights from a seeded generator; the offline KV build runs
   the flash kernel) serves a few requests through the wave-scheduled
   continuous batcher (selective kernel in prefill, paged-decode kernel
   in decode).  Every kernel must have launched in this run;
   A warm rerun of the same prefill and decode, without the batcher,
   splits the time by stage (host clock, card synchronised at each
   span) and reads the card's busy share under torch.profiler;
3. checks: each kernel against its plain PyTorch version on the inputs
   one of its serving calls saw, in the working dtypes and in fp32; the
   served logits finite; and the tiny rcllm model served on the card
   decodes the same tokens as on the CPU (the plain versions);
4. kernel times (CUDA events, median of 20 after warm-up) beside the
   plain version, one library call computing the same function where
   there is one, and the card's bound for the work.

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

from repro_torch.configs.rcllm_qwen3_8b import CONFIG as QWEN3_8B  # noqa: E402
from repro_torch.core import engine as ENG  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mask_rows, mha_flash_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as PO  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_decode_ref  # noqa: E402
from repro_torch.kernels.selective_attention import ops as SO  # noqa: E402
from repro_torch.kernels.selective_attention.ref import selective_mha_ref  # noqa: E402
from repro_torch.launch import serve as SERVE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
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
}


def log(*a):
    print(*a, flush=True)


def reset_counts():
    for spec in KERNELS.values():
        spec["fn"].launches = 0


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
        if size > self.size:
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


def install_recorders():
    rec = {"flash_attention": Recorder(FO.mha_flash),
           "selective_attention": Recorder(SO.selective_mha),
           "paged_decode_attention": Recorder(PO.paged_decode_mha, _paged_snapshot)}
    patches = [(ENG, "mha_flash", rec["flash_attention"]),
               (TT, "mha_flash", rec["flash_attention"]),
               (ENG, "selective_mha", rec["selective_attention"]),
               (BE, "paged_decode_mha", rec["paged_decode_attention"])]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, r in patches:
        setattr(mod, name, r)
    return rec, saved


# ------------------------------------------- plain versions, library, bound
def plain_call(name, args, kw):
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


class Spans:
    """Inclusive host-clock seconds per wrapped function.  The card is
    synchronised at entry and exit, so device work lands in the span
    that issued it (this slows the run: the spans are taken in a run of
    their own, never in the served one)."""

    def __init__(self):
        self.s, self.saved = {}, []

    def wrap(self, owner, name, label, static=False):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
            return out
        self.saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, staticmethod(timed) if static else timed)

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
                           cached_k=plans[rid][1], cached_v=plans[rid][2],
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
    [(name, ms)]); busy is None when the profiler saw no device event."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall, (busy / 1e6 if spans else None), [(n[:60], us / 1e3) for n, us in top]


def shapes(args, kw):
    out = []
    for a in list(args) + [kw.get("kv_valid"), kw.get("live")]:
        if torch.is_tensor(a) or isinstance(a, np.ndarray):
            out.append(f"{tuple(a.shape)}:{str(a.dtype).replace('torch.', '')}")
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

    # ---- phase 2: rcllm serving at Qwen3-8B width ----
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
    engine, backend, batcher, done = SERVE.serve(system.model, cfg, config, reqs, plans)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0 - t_build
    launches = {n: spec["fn"].launches for n, spec in KERNELS.items()}
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rep = SERVE.report(config, engine, backend, batcher, done, warmup=False)
    log(f"serving: {cfg.name} d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim {cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
        f"depth {cfg.n_layers} of {QWEN3_8B.n_layers} layers, "
        f"{cfg.param_count() / 1e9:.2f} B params bf16")
    log(f"  offline build + workload {t_build:.1f} s, serving {t_serve:.1f} s, "
        f"{len(done)} requests x {config.decode_steps} tokens")
    log(f"  TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f} ms p99 {rep['ttft_p99_s'] * 1e3:.1f} ms; "
        f"TBT p50 {rep['tbt_p50_s'] * 1e3:.1f} ms; decode {rep['throughput_tok_s']:.1f} tok/s; "
        f"peak CUDA memory {peak_gb:.1f} GB")
    log(f"  kernel launches in this run: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the serving path: {missing}")
    if len(done) != args.requests:
        raise RuntimeError(f"{len(done)} of {args.requests} requests completed")
    for c in done:
        toks = backend.generated[c.rid]
        if len(toks) != config.decode_steps or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"request {c.rid} generated {toks}")

    # ---- phase 2b: where the time goes (warm; the counts are read) ----
    spans = Spans()
    spans.wrap(BE.BatchEngine, "prefill", "prefill")
    spans.wrap(ENG, "layer0", "layer0")
    spans.wrap(ENG, "select_recompute", "select_recompute")
    spans.wrap(ENG, "selective_layers_batch", "selective_layers_batch")
    spans.wrap(ENG, "selective_layers", "selective_layers")
    spans.wrap(BE.BatchEngine, "_selective_rows", "merge_rows", static=True)
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
                    "kv_staging_host_device": s["selective_layers_batch"] - s["selective_layers"],
                    "merge_rows_host": s["merge_rows"],
                    "pool_writes": s["pool_writes"]},
        "decode_step_ms": s["decode"] / steps * 1e3,
        "decode": {"model_step_ms": s["decode_step"] / steps * 1e3,
                   "page_tables_host_ms": (s["decode"] - s["decode_step"]) / steps * 1e3},
    }
    known = sum(breakdown["prefill"].values())
    breakdown["prefill"]["other"] = s["prefill"] - known
    pre, dec = warm_run(engine, plans, steps)
    for phase, fn in (("prefill", pre), ("decode", dec)):
        wall, busy, top = device_busy(fn)
        breakdown[f"{phase}_profiled_wall_s"] = wall
        breakdown[f"{phase}_device_busy_s"] = busy
        breakdown[f"{phase}_device_idle_share"] = None if busy is None else 1 - busy / wall
        breakdown[f"{phase}_top_device"] = top
    log(f"breakdown (warm, {len(plans)} requests in one prefill batch, then {steps} "
        f"decode steps; host clock, card synchronised at each span):")
    log("  prefill " + f"{s['prefill']:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in breakdown["prefill"].items()))
    log(f"  decode step {breakdown['decode_step_ms']:.2f} ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in breakdown["decode"].items()))
    for phase in ("prefill", "decode"):
        busy = breakdown[f"{phase}_device_busy_s"]
        log(f"  profiled {phase}: wall {breakdown[f'{phase}_profiled_wall_s']:.3f} s, device busy "
            f"{'not measured (no device events)' if busy is None else f'{busy:.3f} s'}, idle share "
            f"{breakdown[f'{phase}_device_idle_share']}; top device: "
            + "; ".join(f"{n} {ms:.2f} ms" for n, ms in breakdown[f"{phase}_top_device"]))

    # ---- phase 3: checks ----
    plan, ck, cv, have = plans[min(plans)]
    br = BE.BatchRequest(rid=-1, tokens=plan.tokens, plan=plan, cached_k=ck,
                         cached_v=cv, have=have)
    logits = engine.prefill([br], "rcllm")
    rfrac = engine.last_stats[br.rid].recompute_fraction()
    engine.release(br.rid)
    if logits.shape != (1, cfg.vocab_size) or not np.isfinite(logits).all():
        raise RuntimeError(f"served logits not finite / wrong shape {logits.shape}")
    log(f"  prefill logits finite, shape {logits.shape}; {plan.n} prompt tokens, "
        f"recompute fraction {rfrac:.3f}")

    records = []
    for name, spec in KERNELS.items():
        r = rec[name]
        a, kw = r.args, r.kwargs
        fn = spec["fn"]
        if name == "selective_attention":
            kw = dict(kw, live=torch.as_tensor(kw["live"], dtype=torch.int32, device=dev))
            a = (a[0], torch.as_tensor(a[1], device=dev), a[2], a[3],
                 torch.as_tensor(a[4], device=dev))
        out = fn(*a, **kw)
        plain = plain_call(name, a, kw)
        torch.cuda.synchronize()
        wdt = a[0].dtype
        err = float((out.float() - plain.float()).abs().max())
        if not torch.isfinite(out).all() or err > TOL[wdt]:
            raise RuntimeError(f"{name}: max|kernel-plain| {err} > {TOL[wdt]} ({wdt})")
        a32, kw32 = to_fp32(name, a, kw)
        out32 = fn(*a32, **kw32)
        err32 = float((out32 - plain_call(name, a32, kw32)).abs().max())
        if err32 > TOL[torch.float32]:
            raise RuntimeError(f"{name}: fp32 max|kernel-plain| {err32} > {TOL[torch.float32]}")
        log(f"check {name}: {shapes(a, kw)} max|kernel-plain| {err:.3g} (tol {TOL[wdt]}, "
            f"{str(wdt).replace('torch.', '')}); fp32 {err32:.3g} (tol {TOL[torch.float32]})")

        ms = time_ms(lambda: fn(*a, **kw))
        plain_ms = time_ms(lambda: plain_call(name, a, kw))
        lib = library_call(name, a, kw)
        lib_ms = time_ms(lib) if lib is not None else None
        b, fl = work(name, a, kw, out)
        t_bytes, t_ops = b / HBM_BYTES_S * 1e3, fl / PEAK_FLOPS[wdt] * 1e3
        records.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "tol": TOL[wdt], "fp32_max_abs_err": err32,
            "shapes": shapes(a, kw), "bytes": b, "flops": fl})
        log(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({records[-1]['bound_by']})")
    del rec

    # small-input reference: the tiny rcllm model served on the card
    # (kernels) decodes the same greedy tokens as on the CPU (plain)
    tiny = {}
    model = None
    for d in (dev, torch.device("cpu")):
        tsys, treqs, tplans = SERVE.rcllm_setup(None, d, 4, 1e6, 4, model=model)
        _, tb, _, _ = SERVE.serve(tsys.model, tsys.cfg, ServeConfig(decode_steps=4),
                                  treqs, tplans)
        tiny[d.type] = {r: tb.generated[r] for r in sorted(tb.generated)}
        model = copy.deepcopy(tsys.model).to("cpu")
    if tiny["cuda"] != tiny["cpu"]:
        raise RuntimeError(f"tiny rcllm tokens differ: card {tiny['cuda']} cpu {tiny['cpu']}")
    log(f"check tiny rcllm serving: card tokens == CPU plain-version tokens {tiny['cuda']}")

    report = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s, "offline_build_s": t_build, "serving_s": t_serve,
              "peak_cuda_gb": peak_gb, "depth": cfg.n_layers, "serve": rep,
              "recompute_fraction": rfrac, "prompt_tokens": plan.n, "breakdown": breakdown,
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
