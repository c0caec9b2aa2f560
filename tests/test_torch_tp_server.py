"""The asyncio session server under tensor parallelism: two gloo ranks on
the reference's tiny system (4 query / 2 kv heads), the server on rank 0
and `serving.server.follow` on rank 1, against the JAX package's
UNSHARDED server (`tests/test_torch_server.py` holds the same at tp = 1).

* A speed-0 replay decodes the closed-loop tp = 2 batcher's tokens and
  the JAX server's (each with the launchers' selective config, a 16-token
  exact window), under the wave scheduler with the store off and the
  chunked one with it on, on both ranks (the trace arrives in two waves,
  t = 0 and 1000 s, so both packages batch alike whatever their step
  times).
* The ranks agree, by digest, on every step plan and recompute mask of
  the server's run (the mesh's check, on here), and every tick the
  server decided was applied by the follower.
* Cancels from the tick boundary, mid-prefill and mid-decode: the
  cancelled sessions end "cancelled", the others complete, and every
  rank's pool is clean (no page in use, no chunk state, no store
  reference, the ownership partition intact).
* Every run leaves each rank's pool clean; each rank's arena holds its
  one kv head.

The ranks start once, on a thread, while this process runs the JAX
server (`torch_tp_ranks.server_rank_job`, which imports no JAX)."""
import threading

import jax
import numpy as np
import pytest

from repro.core import engine as JENG
from repro.serving import api as JAPI
from repro.serving import workload as JWL
from repro.serving.server import serve_trace as jax_serve_trace
from repro_torch.launch import mesh as TMESH

import torch_tp_ranks as RK

RUN_IDS = [f"{s}-{'reuse' if r else 'priv'}" for s, r in RK.SERVER_RUNS]


@pytest.fixture(scope="module")
def both():
    """(the JAX server's tokens per run, the two ranks' records)."""
    from repro.core.rcllm import make_tiny_system as jax_tiny

    jsys, pool_rv, prof, _ = jax_tiny(n_items=80, n_requests_hist=40, k_instances=1,
                                      n_layers=2, d_model=32)
    tree = jax.tree_util.tree_map(np.asarray, jsys.params)
    box = {}

    def start():
        try:
            box["ranks"] = TMESH.spawn_ranks(RK.server_rank_job, 2, "cpu", args=(tree,))
        except BaseException as e:          # raised below, in the test's thread
            box["error"] = e

    th = threading.Thread(target=start)
    th.start()
    try:
        pend, plans, reuse = RK.server_workload(JWL, jsys, pool_rv, prof)
        tokens = {}
        for sched, kv_reuse in RK.SERVER_RUNS:
            jcfg = JAPI.ServeConfig(engine="jax", sched=sched, kv_reuse=kv_reuse, n_pages=256,
                                    chunk_tokens=64)
            jeng = JAPI.build_engine(jsys.params, jsys.cfg, jcfg, sel=JENG.SelectiveConfig(
                r_item=jcfg.r_item, r_rev=jcfg.r_rev, window=16))    # the launchers' config
            done, _ = jax_serve_trace(JAPI.build_backend(jeng, jcfg), jcfg, RK.submits(
                JAPI, pend, plans, reuse if kv_reuse else None))
            tokens[sched, kv_reuse] = {rid: list(map(int, c.tokens)) for rid, c in done.items()}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return tokens, box["ranks"]


@pytest.mark.parametrize("sched, kv_reuse", RK.SERVER_RUNS, ids=RUN_IDS)
def test_replay_decodes_the_closed_loop_and_jax_tokens(both, sched, kv_reuse):
    jax_tokens, ranks = both
    for out in ranks:
        assert out["backend"] == "gloo"
        run = out["runs"][sched, kv_reuse]
        assert run["served"] == run["closed"] == jax_tokens[sched, kv_reuse], out["rank"]
        assert run["done"] == list(range(RK.N_REQ))
    assert ranks[0]["runs"][sched, kv_reuse]["extra"]["server"] is True
    assert ranks[0]["runs"][sched, kv_reuse]["extra"]["finish_reasons"] == {"length": RK.N_REQ}


@pytest.mark.parametrize("sched, kv_reuse", RK.SERVER_RUNS, ids=RUN_IDS)
def test_ranks_agree_on_every_digest(both, sched, kv_reuse):
    """The server's run: both ranks logged the same digests of every step
    plan (its clock included) and recompute mask, in one order; the
    closed loop's recompute masks are the same masks."""
    _, ranks = both
    logs = [out["runs"][sched, kv_reuse]["log"] for out in ranks]
    tags = [tag for tag, _ in logs[0]]
    assert logs[0] == logs[1]
    masks = lambda log: [d for tag, d in log if tag == "recompute mask"]
    assert masks(logs[0]) == masks(ranks[0]["runs"][sched, kv_reuse]["closed_log"])
    assert "step plan" in tags and tags.count("recompute mask") >= RK.N_REQ
    assert ranks[0]["runs"][sched, kv_reuse]["extra"]["ticks"] > 0


@pytest.mark.parametrize("sched, kv_reuse", RK.SERVER_RUNS, ids=RUN_IDS)
def test_every_run_leaves_each_rank_pool_clean(both, sched, kv_reuse):
    _, ranks = both
    for out in ranks:
        for key in ("closed_pool", "pool"):
            pool = out["runs"][sched, kv_reuse][key]
            assert pool["pages_in_use"] == 0 and not pool["prefill_states"]
            assert not pool["store_refs"] and pool["arena"][3] == 1     # 2 kv heads / 2


def test_cancels_leave_every_rank_pool_clean(both):
    """Cancelled mid-prefill and mid-decode at the server's tick
    boundary; the follower applied the same cancels: every rank's pool is
    clean, and the ranks agree on every digest of the run."""
    _, ranks = both
    rec = ranks[0]["cancel"]
    assert rec["stages"] == {"prefilling": "prefilling", "decoding": "decoding"}
    for rid, reason in rec["reasons"].items():
        want = "cancelled" if rid in rec["victims"].values() else "length"
        assert reason == want, rid
    for out in ranks:
        pool = out["cancel_pool"]
        assert pool["pages_in_use"] == 0 and not pool["prefill_states"]
        assert not pool["store_refs"]
    assert ranks[0]["cancel_log"] == ranks[1]["cancel_log"] and ranks[0]["cancel_log"]
