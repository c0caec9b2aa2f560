"""Quickstart on the PyTorch port: build an RcLLM system end to end and
serve one request.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # plain versions

The pipeline of `examples/quickstart.py` on `repro_torch`: synthetic
catalog and reviews -> offline phase (LSH semantic pool + item-KV
precompute through the flash kernel + Algorithm-1 placement) -> online
phase (affinity routing -> assembly plan -> selective-recompute prefill
through the block-gather and selective kernels) -> ranked candidates,
compared against the Full-Recompute oracle.  On a CUDA device the
kernels are built from this checkout's sources at first use.  `main`
takes `model=` to serve given weights in place of the seeded init.
"""
import argparse

import numpy as np

from repro_torch.core.engine import SelectiveConfig
from repro_torch.core.metrics import ranking_agreement_ndcg
from repro_torch.core.rcllm import make_tiny_system
from repro_torch.data import synth as SY


def main(argv=None, model=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== offline phase: building RcLLM caches ==")
    system, pool, prof, hist = make_tiny_system(n_items=120, n_requests_hist=60,
                                                k_instances=4, device=args.device,
                                                model=model)
    print(f"  device              : {system.model.device}")
    print(f"  semantic prototypes : {system.semantic.n_prototypes}")
    print(f"  semantic pool bytes : {system.semantic.size_bytes():,}")
    print(f"  hot replicas        : {len(system.placement.hot_items)}")
    print(f"  placement edge cut  : {system.placement.edge_cut:.0f}")
    per_replica = [s.n_tokens() for s in system.item_store.shards]
    print(f"  item tokens/replica : {per_replica}")

    print("== online phase: one request ==")
    req = SY.make_trace(system.catalog, pool, prof, 1, qps=1.0, n_users=3,
                        n_candidates=8, reviews_per_user=2, seed=7)[0]
    inst = system.best_instance(req)
    plan = system.plan_for(req, inst)
    print(f"  routed to instance  : {inst}")
    print(f"  prompt tokens       : {plan.n}")
    print(f"  beyond-prefix reuse : {plan.reuse_fraction():.1%} "
          f"(local={plan.n_local} remote={plan.n_remote} miss={plan.n_miss})")

    sel = SelectiveConfig(r_item=0.3, r_rev=0.3, window=16)
    scores, stats = system.rank(req, "rcllm", sel)
    full, _ = system.rank(req, "full")
    ndcg = ranking_agreement_ndcg(full, scores, k=5)
    print(f"  recomputed tokens   : {stats.n_recomputed}/{stats.n_tokens} "
          f"({stats.recompute_fraction():.1%}), {stats.n_heavy_hitters} heavy hitters")
    print(f"  RcLLM ranking       : {np.argsort(-scores).tolist()}")
    print(f"  Full  ranking       : {np.argsort(-full).tolist()}")
    print(f"  fidelity NDCG@5     : {ndcg:.4f}")
    return {"scores": scores, "full": full, "ndcg5": ndcg, "stats": stats, "plan": plan}


if __name__ == "__main__":
    main()
