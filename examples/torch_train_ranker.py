"""End-to-end run on the port: train the ranking LM on the
planted-preference task, rebuild the RcLLM caches with the trained
weights, and report Table III metrics for Full vs RcLLM vs CacheBlend vs
EPIC.

    PYTHONPATH=src python examples/torch_train_ranker.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_ranker.py --device cpu --steps 20 --eval 8

`examples/train_ranker.py` on `repro_torch`.  On a CUDA device the
ranker's attention gradient runs kernel K6 (its small-head route at the
tiny model's head dim 16) and the evaluation the flash, block-gather and
selective kernels, built from this checkout's sources at first use.
"""
import argparse
import time

import numpy as np

from repro_torch.core import metrics as MET
from repro_torch.core import ranker_training as RT
from repro_torch.core.engine import SelectiveConfig
from repro_torch.core.rcllm import RcLLMSystem, make_tiny_system


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    t0 = time.time()
    system, pool, prof, hist = make_tiny_system(n_items=150, n_requests_hist=80,
                                                device=args.device)
    reqs, gold = RT.make_planted_trace(system.catalog, pool, prof,
                                       n_requests=300 + args.eval,
                                       n_candidates=8, n_users=120, seed=5)
    n_train = len(reqs) - args.eval
    print(f"training ranker on {system.model.device}: {args.steps} steps on "
          f"{n_train} requests")
    model, history = RT.train_ranker(
        system.model, system.cfg, system.catalog, system.instruction,
        reqs[:n_train], gold[:n_train], steps=args.steps)
    for s, l in history:
        print(f"  step {s:4d}  loss {l:.4f}")

    print("rebuilding RcLLM caches with trained weights")
    corpus, seen = [], set()
    for r in hist:
        if r.user_id not in seen:
            corpus.append(r.history_tokens)
            seen.add(r.user_id)
    system = RcLLMSystem.build(model, system.cfg, system.catalog, corpus,
                               hist, k_instances=4)

    sel = SelectiveConfig(r_item=0.3, r_rev=0.3, window=16)
    res = {m: [] for m in ("full", "rcllm", "cacheblend", "epic")}
    for r, g in zip(reqs[n_train:], gold[n_train:]):
        for m in res:
            sc, _ = system.rank(r, m, sel)
            res[m].append(MET.ranks_from_scores(sc)[g])
    print(f"\nTable III (planted gold, {args.eval} held-out requests):")
    print(f"{'method':12s} {'HR@1':>6s} {'HR@3':>6s} {'HR@5':>6s} "
          f"{'MRR':>6s} {'NDCG@5':>7s}")
    table = {}
    for m, v in res.items():
        v = np.asarray(v)
        table[m] = {"hr1": MET.hr_at_k(v, 1), "hr3": MET.hr_at_k(v, 3),
                    "hr5": MET.hr_at_k(v, 5), "mrr": MET.mrr(v), "ndcg5": MET.ndcg_at_k(v, 5)}
        t = table[m]
        print(f"{m:12s} {t['hr1']:6.3f} {t['hr3']:6.3f} {t['hr5']:6.3f} "
              f"{t['mrr']:6.3f} {t['ndcg5']:7.3f}")
    print(f"\ntotal: {time.time() - t0:.0f}s")
    return {"history": history, "table": table}


if __name__ == "__main__":
    main()
