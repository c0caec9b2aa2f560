"""Host and device time of the block gather (B4) on the selective
prefill's main path, at rcllm-qwen3-8b's width: a cached-row pool of 36
layers x 2,359 rows x 8 KV heads x 128 (fp32), layer 0's Eq. 3 copy of a
512-row table, and one selective pass (layers 1..35 rotated, with their
pre-RoPE keys) over a 2,240-row table: the largest such calls of
`chip_smoke.py`'s phase 2b.

It drives whichever engine API the importable `repro_torch` has:
`engine.cache_gather` (the pools bound once, a pass in one launch), or
`engine.gather_rows` (one call per layer, each binding and checking its
operands anew).  So the same script times two trees of the package on
one card, each run with its tree's `src` first on the path:

    PYTHONPATH=<tree>/src python3 scripts/gather_host_cost.py --label <name>

and a comparison runs the trees in the order A, B, B, A on one machine.
Each call is timed by CUDA events (median of `--reps`) and by
torch.profiler's device intervals (the mean per call); host us =
events - device.  Prints one JSON line; needs a CUDA card."""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from repro_torch.core import engine as ENG
from repro_torch.core.cache_rows import ZERO_ROW, CacheRows

LAYERS, ROWS, HKV, DH, THETA = 36, 2359, 8, 128, 1_000_000.0


def event_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(statistics.median(times))


def device_ms(fn, reps):
    """-> (device ms per call, device events per call): the card's
    intervals under torch.profiler, summed over `reps` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    return sum(e.end_ns() - e.start_ns() for e in ev) / reps / 1e6, len(ev) / reps


def table(rng, n):
    """n rows of the pool, the last eighth pad rows (the zero row), as the
    engine pads a batch."""
    t = torch.randint(1, ROWS, (n,), generator=rng, dtype=torch.int32)
    t[n - n // 8:] = ZERO_ROW
    return t.cuda()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gather_host_cost: needs a CUDA card")
    rng = torch.Generator().manual_seed(0)
    rows = CacheRows(LAYERS, HKV, DH)
    rows.k = torch.randn(LAYERS, ROWS, 1, HKV, DH, generator=rng).cuda()
    rows.v = torch.randn(LAYERS, ROWS, 1, HKV, DH, generator=rng).cuda()
    rows.n_rows = ROWS
    t_copy, t_pass = table(rng, 512), table(rng, 2240)
    pos = torch.arange(2240, dtype=torch.int32, device="cuda")
    bound = hasattr(ENG, "cache_gather")
    if bound:
        g = ENG.cache_gather(rows, THETA)
        copy = lambda: g(t_copy, t_copy, 0, rotate=False)
        one_pass = lambda: g(t_pass, pos, range(1, LAYERS), rotate=True, keep_raw=True)
    else:
        copy = lambda: ENG.gather_rows(rows, 0, t_copy, t_copy, rope_theta=THETA,
                                       rotate=False)

        def one_pass():
            for layer in range(1, LAYERS):
                ENG.gather_rows(rows, layer, t_pass, pos, rope_theta=THETA, rotate=True,
                                keep_raw=True)
    out = {"label": args.label, "api": "cache_gather" if bound else "gather_rows",
           "device": torch.cuda.get_device_name(0)}
    for name, fn in (("copy", copy), ("pass", one_pass)):
        ms = event_ms(fn, args.reps)
        dev, n_ev = device_ms(fn, args.reps)
        out[name] = {"ms": ms, "device_ms": dev, "device_events_per_call": n_ev,
                     "host_us": (ms - dev) * 1e3}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
