"""A CPU-sized cell for the tests: the configurations' code path at a tiny
width (2 layers, d 64, 4 / 2 heads of 16, float32, the kernels' plain
versions), a 40-item catalog and a short open-loop window."""
from __future__ import annotations

import copy
import time

from rcbench import cell as C

BENCH = {
    "end_to_end": [{"name": n, "unit": u} for n, u in (
        ("ttft_p50_ms", "ms"), ("ttft_p90_ms", "ms"), ("tbt_p95_ms", "ms"),
        ("requests_per_s", "req/s"), ("setup_s", "s"))],
    "per_layer": [{"name": n, "unit": "x"} for n in (
        "gen_lag_p90_ms.open", "tick_p95_ms.open",
        "decode_rows_mean.busy", "prefill_p50_ms.open", "recompute_share.open")],
}


def cell(loop: str = "open", limit: float = 1e-3) -> C.Cell:
    cfg = C.read_json(C.HERE / "configs" / "qwen3-8b.json")
    cfg.update(name="tiny", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=4096,
               torch_dtype="float32", serve={"page_size": 16, "n_pages": 256})
    tr = copy.deepcopy(C.read_json(C.HERE / "traffic" / ("rank_open.json" if loop == "open"
                                                          else "rank_busy.json")))
    tr["world"].update(n_items=40, n_clusters=6, history_requests=40, history_users=8)
    tr["requests"].update(n_users=40, n_candidates=6, reviews_per_user=2)
    tr.update(warmup_s=0.5, rate_per_s=6.0, clients=3, max_rate_per_s=20.0)
    tr["check"]["requests"] = 3
    return C.Cell(f"tiny.{tr['name']}", 1, cfg, tr, {"logit_gap": {"limit": limit}})


def run(c: C.Cell = None, seed: int = 20261018, seconds: float = 1.5) -> dict:
    """One run of the tiny cell on the CPU through the harness (its look
    for a card skipped).  -> `run.run_cell`'s result."""
    import torch

    from rcbench import run as R

    torch.set_num_threads(2)
    return R.run_cell(c or cell(), BENCH, seed, seconds, False, "cpu", time.perf_counter())
