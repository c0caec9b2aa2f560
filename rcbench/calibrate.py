"""The readings the benchmark's settings were fixed from, taken on the
card; the benchmark's own runs never run this.

    python3 rcbench/calibrate.py sweep <cell> --rates 4,6,8 --seconds 15
    python3 rcbench/calibrate.py readings <cell> --seeds 1,2,3 --seconds 8

`sweep` builds the cell's system once and offers its traffic at each
rate in turn (an open loop): the knee is the highest rate whose queue
does not grow through the window.  `readings` runs a short window at the
cell's own load for each seed, in one process, and reads the compared
number three ways: the served tokens against the float32 reference
(the lower reading), the same with the port's own recompute sets in the
reference (to see what Eq. 3's near-ties add), and the float8 control's
first tokens against the float32 reference (the upper reading).  Each
prints one JSON line per rate or seed."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def sweep(cell, rates, seconds: float, seed: int) -> None:
    import numpy as np

    from rcbench import serve as SERVE
    from rcbench import stats
    from rcbench.metrics import reader, ttfts

    top = copy.deepcopy(cell)
    top.traffic.update(rate_per_s=max(rates), warmup_s=3.0)
    sysm = SERVE.System(top, seed, seconds, "cuda")
    for rate in rates:
        sysm.cell = copy.deepcopy(top)
        sysm.cell.traffic["rate_per_s"] = rate
        run = asyncio.run(SERVE.drive(sysm, seed, seconds))
        t = np.asarray(ttfts(run))
        q = len(t) // 4
        print(json.dumps({
            "rate_per_s": rate, "attempted": len(t),
            "failed": int(np.sum(~np.isfinite(t))),
            "completed_per_s": reader("requests_per_s")(run),
            "ttft_p50_ms": stats.pct(t, 50), "ttft_p90_ms": stats.pct(t, 90),
            "tbt_p95_ms": reader("tbt_p95_ms")(run),
            "ttft_first_quarter_ms": float(np.median(t[:q])) if q else None,
            "ttft_last_quarter_ms": float(np.median(t[-q:])) if q else None,
        }), flush=True)


def readings(cell, seeds, seconds: float) -> None:
    import torch

    from rcbench import correct as CORRECT
    from rcbench import serve as SERVE

    for seed in seeds:
        sysm = SERVE.System(cell, seed, seconds, "cuda")
        run = asyncio.run(SERVE.drive(sysm, seed, seconds))
        weights = sysm.weights
        sysm.free()
        del sysm
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        own = CORRECT.judge(run, weights, "cuda")
        t_ref = time.perf_counter() - t0
        prog = CORRECT.judge(run, weights, "cuda", program_masks=True)
        ctrl = CORRECT.judge(run, weights, "cuda", precision="fp8", logits_of=own["logits"])
        print(json.dumps({
            "seed": seed, "requests": own["requests"], "tokens": own["tokens"],
            "logit_gap": own["logit_gap"], "gaps": own["gaps"],
            "logit_gap_port_masks": prog["logit_gap"], "mask_diff": own["mask_diff"],
            "control_gap": ctrl["logit_gap"], "control_gaps": ctrl["gaps"],
            "reference_s": t_ref}), flush=True)
        del weights, run, own, prog, ctrl
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("sweep", "readings"))
    ap.add_argument("workload")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    from rcbench import cell as C
    from rcbench import run as R

    R.cache_dirs()
    cell = C.load(args.workload)
    if args.what == "sweep":
        sweep(cell, [float(r) for r in args.rates.split(",")], args.seconds,
              int(args.seeds.split(",")[0]))
    else:
        readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
