"""Distributed serving demo on the port's analytic cluster simulator: K
instances, paper-scale prompts, the Fig. 6 experiment in one script.

    PYTHONPATH=src python examples/torch_serve_cluster.py [--k 40] [--qps 150]

`examples/serve_cluster.py` on `repro_torch`, priced with NVIDIA H100
SXM rates (`core.cost_model.H100_SXM`): Poisson arrivals -> Eq. 2
affinity scheduler -> paged assembly + selective recompute per instance
-> TTFT percentiles, against Prefix-Cache and Full-Recompute on the same
trace; then a node failure mid-trace and a straggler with hedging.  No
model runs: every time printed is modelled, none measured.  The
simulator is numpy only, so it takes no `--device`.
"""
import argparse

import numpy as np

from repro_torch.configs import registry as REG
from repro_torch.core import cost_model as CM
from repro_torch.core import simulator as SIM

HW = CM.H100_SXM


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=40)
    ap.add_argument("--qps", type=float, default=None)
    ap.add_argument("--requests", type=int, default=1500)
    args = ap.parse_args(argv)
    qps = args.qps if args.qps is not None else 3.0 * args.k

    cfg = REG.ARCHS["rcllm-qwen3-8b"]
    reqs, placement, _ = SIM.make_sim_setup(
        k=args.k, n_requests=args.requests, qps=qps, n_items=8000, seed=1)
    print(f"cluster: K={args.k}, qps={qps:.0f}, "
          f"median prompt={np.median([r.n_total for r in reqs]):.0f} tokens; "
          "times modelled on H100 SXM rates (cost_model.H100_SXM), not measured")

    out = {}
    for mode in ("full", "prefix", "rcllm"):
        s = SIM.simulate(cfg, HW, reqs, placement, SIM.SimConfig(mode=mode)).summary()
        out[mode] = s
        print(f"  {mode:7s} p50={s['p50']:.3f}s p90={s['p90']:.3f}s "
              f"p99={s['p99']:.3f}s  hit={s['mean_hit']:.2f} (modelled)")

    print("fault tolerance: instance 0 down for 5s mid-trace")
    faults = [SIM.NodeFault(instance=0, t_fail_s=1.0, t_repair_s=6.0)]
    res = SIM.simulate(cfg, HW, reqs, placement, SIM.SimConfig(mode="rcllm"), faults=faults)
    out["fault_p99"] = res.pct(99)
    print(f"  rcllm+fault p99={res.pct(99):.3f}s "
          f"({res.n_requests} requests, none dropped; modelled)")

    print("straggler mitigation: one 8x-slow node, hedged requests")
    slow = np.ones(args.k)
    slow[1] = 8.0
    for hedge in (None, 20.0):
        res = SIM.simulate(cfg, HW, reqs, placement,
                           SIM.SimConfig(mode="rcllm", hedge_ms=hedge),
                           straggler_factors=slow)
        tag = f"hedge={hedge}ms" if hedge else "no hedge"
        out[tag] = res.pct(99)
        print(f"  {tag:12s} p99={res.pct(99):.3f}s (modelled)")
    return out


if __name__ == "__main__":
    main()
