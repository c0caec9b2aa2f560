"""Run one cell of the port's benchmark and print its result line.

    python3 rcbench/run.py --workload qwen3-8b.rank_open --seed 1 --seconds 40 --trace 0

(or `PYTHONPATH=src python -m rcbench.run ...` from the repository root).
It needs the CUDA cards the cell asks for and exits with 2, printing no
result, without them.  `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer metrics from a profiled window.  The
last line of standard output is the result as one JSON object; the last
lines of standard error give each number the correctness check compared,
beside its limit."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# modules that must not be loaded in the process that prints the result,
# compared by whole top-level names (the port, `repro_torch`, passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 4


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build under `build/kernels/` there already),
    and few host threads, so one run's host work contends less with
    itself."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "rcbench" / sub)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def metric_names(bench: dict, cell: str, trace: bool):
    """The metrics the cell reports: its end-to-end metrics (`trace` off)
    or its per-layer metrics (`trace` on)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def breakdown(run) -> dict:
    """The traced window's ten largest device consumers and ten longest
    idle gaps, each gap named by what the host was doing: no request in
    flight (`no_request`), preparing one (`prepare`), inside an engine
    tick (`engine_tick`), or in the server's loop between ticks
    (`server_loop`)."""
    tw = run.trace
    ops = sorted(tw.seconds_by_kernel().items(), key=lambda kv: -kv[1])[:10]
    out = []
    for start, sec in sorted(tw.gaps(), key=lambda g: -g[1])[:10]:
        mid = start + sec / 2
        inside = {name for name, a, b in run.spans if a <= mid < b}
        busy = any(r.submit <= mid < r.done for r in run.reqs)
        name = ("prepare" if "prepare" in inside else "engine_tick" if "tick" in inside
                else "server_loop" if busy else "no_request")
        out.append([name, sec])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


def run_cell(cell, bench: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of `cell` on `device`.  -> the result object."""
    import torch

    from rcbench import correct as CORRECT
    from rcbench import metrics as MET
    from rcbench import serve as SERVE

    sysm = SERVE.System(cell, seed, seconds, device)
    tracer = None
    if trace:
        from rcbench.trace import Tracer, is_copy

        tracer = Tracer()
    run = asyncio.run(SERVE.drive(sysm, seed, seconds, tracer))
    run.setup_s = run.t0_perf - t_start
    on_card = torch.device(device).type == "cuda"
    if tracer is not None:
        run.trace = tw = tracer.stop()
        kernels = sum(1 for n, _, _ in tw.events if not is_copy(n))
        SERVE.log(f"trace read: {len(tw.events)} device events, {kernels} kernels "
                  f"{tw.note or ''}")
        uncounted = MET.window_work(run).prefills_uncounted
        if uncounted:
            SERVE.log(f"{uncounted} prefills of the window uncounted: no recompute mask read")
    peak = torch.cuda.max_memory_allocated(torch.device(device)) if on_card else 0
    metrics = {}
    for m in metric_names(bench, cell.name, trace):
        v = MET.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    weights = sysm.weights
    sysm.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    SERVE.log("port freed; reference starts")
    verdict = CORRECT.judge(run, weights, device)
    SERVE.log(f"reference done: gaps {verdict.get('gaps')}")
    checks = {}
    limits = cell.limits or {}
    for name in ("logit_gap",):
        lim = limits.get(name, {}).get("limit")
        checks[name] = {"value": verdict[name], "limit": lim}
    correct = bool(verdict["requests"]) and all(
        c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    checks["requests_compared"] = {"value": verdict["requests"], "limit": None}
    checks["tokens_compared"] = {"value": verdict["tokens"], "limit": None}
    wr = run.window_reqs()
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(wr),
              "failed": sum(1 for r in wr if not r.finished(run.n_out)),
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None and run.trace.events:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run)
    result["checks"] = checks
    result["_run"] = run
    result["_verdict"] = verdict
    return result


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    print(json.dumps(line))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    torch.set_num_threads(HOST_THREADS)

    from rcbench import cell as C

    bench = C.read_json(ROOT / "BENCHMARK.json")
    cell = C.load(args.workload, bench)
    if not torch.cuda.is_available():
        print("rcbench: no CUDA device: the benchmark runs on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"rcbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"rcbench: the process loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
