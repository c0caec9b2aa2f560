"""B1's and B2's small-head route against their SIMT route at the tiny
ranker's shapes (head dim 16, fp32): flash attention q (64, 64, 4, 16)
over k, v (64, 64, 2, 16), causal with a kv_valid row per batch row, and
selective attention q (3, 320, 4, 16) over k, v (3, 448, 2, 16) with
window 0 and the key validity as heavy hitters (the served call's mask),
pad rows included; inputs from a seeded numpy generator.

Each kernel is checked against its plain version, then timed in turns
(small, SIMT, SIMT, small) through the wrappers' route-taking entries
(`_flash_launch`, `_selective_launch`): CUDA-event ms (median of 20) and
device ms under torch.profiler (`chip_smoke.device_ms`).  It times the
kernels of the tree it lies in (its `chip_smoke.py` puts that tree's
`src` first on the path), so two trees of the kernels compare on one card
by running each tree's copy in turns:

    python3 <tree>/scripts/small_route_timing.py

Prints one JSON line; needs a CUDA card."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.selective_attention import ops as SO  # noqa: E402


def inputs(dev, seed=0):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
    q, k, v = g(64, 64, 4, 16), g(64, 64, 2, 16), g(64, 64, 2, 16)
    valid = torch.from_numpy(rng.random((64, 64)) < 0.9).to(dev)
    valid[:, 0] = True
    flash = ((q, k, v), dict(kv_valid=valid, causal=True))
    B, R, S = 3, 320, 448
    hh = np.zeros((B, S), np.uint8)
    pos = np.full((B, R), -1, np.int64)
    for b, n in enumerate((448, 400, 300)):
        hh[b, :n] = 1
        r = min(R, n - 20)
        pos[b, :r] = np.sort(rng.choice(n, r, replace=False))
    live = SO.block_liveness(pos, hh, window=0, q_block=64, kv_block=64)
    sel = ((g(B, R, 4, 16), torch.from_numpy(pos).to(dev, torch.int32), g(B, S, 2, 16),
            g(B, S, 2, 16), torch.from_numpy(hh).to(dev)),
           dict(live=torch.from_numpy(live).to(dev), window=0, q_block=64, kv_block=64))
    return {"flash_attention": flash, "selective_attention": sel}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("small_route_timing: needs a CUDA card")
    out = {"device": torch.cuda.get_device_name(0)}
    for name, (a, kw) in inputs(torch.device("cuda")).items():
        got, want = CS.KERNELS[name]["fn"](*a, **kw), CS.plain_call(name, a, kw)
        torch.cuda.synchronize()
        turns = []
        for route in ("small", "simt", "simt", "small"):
            fn = CS.forced_route(name, route, a, kw)
            turns.append({"route": route, "ms": CS.time_ms(fn), "device_ms": CS.device_ms(fn)["ms"]})
        b, fl = CS.work(name, a, kw, got)
        out[name] = {"route": CS.route_of(name, a, kw),
                     "max_abs_err": float((got - want).abs().max()), "turns": turns,
                     "bound_ms": max(b / CS.HBM_BYTES_S, fl / CS.PEAK_FLOPS[torch.float32]) * 1e3}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
