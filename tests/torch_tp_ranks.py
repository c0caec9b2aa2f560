"""The rank side of `test_torch_tp_lm.py` (and the session server's in
`test_torch_tp_server.py`): what each gloo rank runs.  It imports no JAX,
so a rank starts in the time torch and the port take to import."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import rows_of
from repro_torch.launch import steps as ST
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.api import MeshConfig
from repro_torch.sharding import ctx as CTX
from repro_torch.sharding import specs as SPECS
from repro_torch.training import train_loop as TTL

RUNS = {a: (a, {}) for a in TR.ARCHS if TR.family_of(a) == "lm"}
RUNS["starcoder2-15b:w16"] = ("starcoder2-15b", {"sliding_window": 16})
COMPRESSED = "rcllm-qwen3-8b"
B, S_PROMPT, S_TRAIN, EXTRA, POSITIONS = 4, 40, 24, 8, (40, 37, 40, 37)
DROP = dict(T=64, capacity_factor=0.5)


def port_config(run):
    arch, replace = RUNS[run]
    return dataclasses.replace(TR.get_config(arch, smoke=True), **replace)


def run_data(run):
    """The prompts and the two training batches of a run (numpy)."""
    cfg = port_config(run)
    rng = np.random.default_rng(sorted(RUNS).index(run))
    toks = rng.integers(0, cfg.vocab_size, (B, S_PROMPT)).astype(np.int32)
    batches = []
    for _ in range(2):
        t = rng.integers(1, cfg.vocab_size, (B, S_TRAIN + 1)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return toks, batches


def pad(cache):
    return np.pad(np.asarray(cache), ((0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0)))


def train_cfgs(run, cfg):
    out = {None: TTL.TrainConfig(steps=2, optimizer=cfg.optimizer, lr=1e-3)}
    if run == COMPRESSED:
        for c in ("int8", "topk"):
            out[c] = dataclasses.replace(out[None], grad_compression=c, topk_frac=0.3)
    return out


def moe_drop_inputs(tree, cfg):
    x = np.random.default_rng(9).standard_normal((DROP["T"], cfg.d_model)).astype(np.float32)
    moe = {k: np.asarray(v)[0] for k, v in tree["layers"]["moe"].items()}
    return x, moe


def rank_run(run, tree, mesh):
    """One run's steps on this rank (inside the mesh): prefill and two
    greedy decode steps of the rank's rows on its kv heads, the loss of
    the first training batch, and two training steps per compression."""
    cfg = port_config(run)
    toks, batches = run_data(run)
    whole = params_from_numpy(tree, cfg, device="cpu")
    d, n = mesh.coords["data"], mesh.shape["data"]
    out = {}
    serve = SPECS.shard_lm_params(whole, cfg, mesh)
    inputs = ST.rank_inputs(cfg, mesh, "prefill", {"tokens": torch.from_numpy(toks)})
    logits, cache = TT.prefill(serve, inputs["tokens"])
    out["prefill"] = (logits.numpy(), cache["k"].numpy(), cache["v"].numpy())
    cache = {k: torch.from_numpy(pad(v)) for k, v in cache.items()}
    pos = torch.tensor(rows_of(np.asarray(POSITIONS), d, n))
    nxt = logits.argmax(-1)[:, None]
    steps = []
    for _ in range(2):
        logits, cache = TT.decode_step(serve, nxt, cache, pos)
        nxt, pos = logits.argmax(-1)[:, None], pos + 1
        steps.append((logits.numpy(), nxt[:, 0].numpy()))
    out["decode"] = steps
    rows = {k: torch.from_numpy(rows_of(v, d, n)) for k, v in batches[0].items()}
    loss, nll = TT.loss_fn(serve, rows["tokens"], rows["labels"])
    out["loss"] = (float(CTX.mean_over_dp(loss.detach())), float(CTX.mean_over_dp(nll)))
    out["train"] = {}
    for comp, tcfg in train_cfgs(run, cfg).items():
        model = SPECS.shard_lm_params(whole, cfg, mesh, mode="train")
        data = iter([{k: rows_of(v, d, n) for k, v in b.items()} for b in batches])
        model, opt, hist = TTL.train(model, ST.lm_loss, data, tcfg,
                                     layout=SPECS.train_layout(cfg, mesh, tcfg.optimizer))
        params = TTL.whole_state(model, opt)["params"]
        out["train"][comp] = {"hist": hist, "params": {k: v.numpy() for k, v in params.items()}}
    return out


def lm_rank_job(rank, world, backend, device, trees, layout):
    """Every run on this rank of a (dp, tp) `layout`; at (2, 2) also the
    dropping MoE batch through `moe_route` / `moe_apply`."""
    torch.set_num_threads(1)
    dp, tp = layout
    mesh = MeshConfig(dp=dp, tp=tp).build()
    out = {"rank": rank, "backend": backend, "coords": dict(mesh.coords), "runs": {}}
    with CTX.axes(mesh):
        for run in RUNS:
            out["runs"][run] = rank_run(run, trees[RUNS[run][0]], mesh)
        if layout == (2, 2):
            cfg = port_config("moonshot-v1-16b-a3b")
            x, moe = moe_drop_inputs(trees["moonshot-v1-16b-a3b"], cfg)
            E = cfg.moe.n_experts
            e0 = E // tp * mesh.coords["model"]
            params = {k: torch.from_numpy(v[e0:e0 + E // tp] if k != "router" else v)
                      for k, v in moe.items()}
            xr = torch.from_numpy(rows_of(x, mesh.coords["data"], dp))
            kw = dict(n_experts=E, top_k=cfg.moe.top_k, capacity_factor=DROP["capacity_factor"])
            r = TL.moe_route(xr, params["router"], **kw)
            y, aux = TL.moe_apply(xr, params, mlp_type=cfg.mlp_type, **kw)
            out["drop"] = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                           for k, v in r.items()}
            out["drop"].update(y=y.numpy(), aux_apply=float(aux))
    return out


# ------------------------------------------------- the session server, tp = 2
N_REQ, WAVE1, DECODE_STEPS = 6, 3, 3
SERVER_RUNS = (("wave", False), ("chunked", True))


def server_config(sched, kv_reuse, tp=2):
    from repro_torch.serving import api as API
    return API.ServeConfig(sched=sched, kv_reuse=kv_reuse, n_pages=256, chunk_tokens=64,
                           mesh=MeshConfig(tp=tp))


def server_workload(wl, system, pool_rv, prof):
    """`test_torch_server.py`'s heavy-tail trace (repeat users, long
    prompts), restamped into two arrival waves (t = 0 and 1000 s)."""
    trace = wl.heavy_tail_trace(system.catalog, pool_rv, prof, N_REQ, qps=8.0, n_users=3,
                                long_prompt_frac=0.4, long_prompt_reviews=6, seed=5)
    pend, plans = wl.rcllm_workload(system, trace, decode_steps=DECODE_STEPS)
    pend = [type(p)(0.0 if p.rid < WAVE1 else 1e3, p.rid, p.n_tokens, p.decode_steps,
                    p.tokens) for p in pend]
    return pend, plans, wl.rcllm_reuse_info(system, trace, plans)


def submits(api, pend, plans, reuse=None, max_tokens=None):
    return [(p.arrival_s, api.SubmitRequest(
        rid=p.rid, tokens=p.tokens, max_tokens=(max_tokens or {}).get(p.rid, p.decode_steps),
        context=plans.get(p.rid), reuse=(reuse or {}).get(p.rid))) for p in pend]


def pool_clean(engine) -> dict:
    """What a cancel or a finished run must leave on a rank's pool."""
    from repro_torch.serving.block_store import check_partition
    check_partition(engine.pool, engine.store)
    return {"pages_in_use": engine.pool.stats().pages_in_use,
            "prefill_states": len(engine.prefill_states), "store_refs": len(engine.store_refs),
            "arena": tuple(engine.pool.arena_k.shape)}


def _cancel_run(system, pend, plans, reuse, mesh):
    """The chunked, store-backed trace with two sessions cancelled from a
    hook at the server's tick boundary: the longest prompt once its
    prefill has started, the first request once it has two tokens.  The
    other ranks follow the server's ticks.  -> (this rank's pool record,
    the completions' reasons and the cancelled stages on the server's
    rank)."""
    import asyncio

    from repro_torch.serving import api as API
    from repro_torch.serving.server import AsyncSessionServer, follow, replay

    from repro_torch.core.engine import SelectiveConfig

    config = server_config("chunked", True)
    engine = API.build_engine(system.model, system.cfg, config, cache=system.rows,
                              sel=SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev,
                                                  window=16))
    backend = API.build_backend(engine, config)
    victims = {"prefilling": max(pend, key=lambda p: p.n_tokens).rid,
               "decoding": min(p.rid for p in pend)}
    out = {}
    if mesh.coords["model"] != 0:
        follow(backend, config)
        return pool_clean(engine), out
    server = AsyncSessionServer(backend, config)
    stages, worker_cancel, apply_cancels = {}, server.worker.cancel, server._apply_cancels

    def recorded_cancel(rid):
        stages[rid] = worker_cancel(rid)
        return stages[rid]

    def at_boundary():
        st = engine.prefill_states.get(victims["prefilling"])
        if st is not None and st.started:
            server.cancel(victims["prefilling"])
        if victims["decoding"] in server.worker.decoding \
                and len(backend.generated.get(victims["decoding"], ())) >= 2:
            server.cancel(victims["decoding"])
        apply_cancels()

    server.worker.cancel, server._apply_cancels = recorded_cancel, at_boundary
    done = asyncio.run(replay(server, submits(API, pend, plans, reuse,
                                              {victims["decoding"]: 8}), speed=0.0))
    out = {"reasons": {rid: c.reason for rid, c in done.items()},
           "stages": {stage: stages.get(rid) for stage, rid in victims.items()},
           "victims": victims, "ticks": server.ticks}
    return pool_clean(engine), out


def server_rank_job(rank, world, backend, device, tree):
    """One rank at tp = 2 on the reference's tiny weights: per run of
    SERVER_RUNS the launcher's closed-loop tokens (`launch.serve.serve`)
    and its session server's (`rank_sessions`, a speed-0 replay: the
    server on rank 0, `follow` on rank 1), both with the launcher's
    selective config, each run's digest logs and pool records; then the
    cancel run."""
    from repro_torch.core.rcllm import make_tiny_system, tiny_config
    from repro_torch.launch import serve as SERVE
    from repro_torch.serving import api as API
    from repro_torch.serving import workload as WL

    torch.set_num_threads(1)
    mesh = MeshConfig(tp=2).build()
    mesh.check = True
    model = params_from_numpy(tree, tiny_config(2, 32), device="cpu")
    out = {"rank": rank, "backend": backend, "runs": {}}
    with CTX.axes(mesh):
        system, pool_rv, prof, _ = make_tiny_system(
            n_items=80, n_requests_hist=40, k_instances=1, n_layers=2, d_model=32,
            device="cpu", model=model, mesh=mesh)
        pend, plans, reuse = server_workload(WL, system, pool_rv, prof)
        for sched, kv_reuse in SERVER_RUNS:
            config = server_config(sched, kv_reuse)
            run = {}
            mesh.log = []
            engine, backend_, _, _ = SERVE.serve(system.model, system.cfg, config, pend, plans,
                                                 system.rows, reuse if kv_reuse else None)
            run["closed"] = {r: list(map(int, t)) for r, t in backend_.generated.items()}
            run["closed_pool"] = pool_clean(engine)
            run["closed_log"] = list(mesh.log)
            mesh.log = []
            engine, backend_, _, done, extra = SERVE.rank_sessions(
                config, system.model, system.cfg, pend, plans, system.rows,
                reuse if kv_reuse else None)
            run["served"] = {r: list(map(int, t)) for r, t in backend_.generated.items()}
            run["done"] = sorted(c.rid for c in done)
            run["log"] = list(mesh.log)
            run["pool"] = pool_clean(engine)
            run["extra"] = {k: v for k, v in extra.items() if k != "online"}
            out["runs"][sched, kv_reuse] = run
        mesh.log = []
        out["cancel_pool"], out["cancel"] = _cancel_run(system, pend, plans, reuse, mesh)
        out["cancel_log"] = list(mesh.log)
    return out


# ------------------------------------------- recsys and SchNet on a mesh
RECSYS_SHAPES = (("score", "serve_p99"), ("retrieval", "retrieval_cand"))
GNN_CELLS = ("full_graph_sm", "molecule", "minibatch_lg")
MESH_STEPS = 2


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _train(bundle):
    hist = []
    for _ in range(MESH_STEPS):
        m = bundle.fn(bundle.inputs)
        hist.append({k: float(v) for k, v in m.items()})
    return hist


def recsys_gnn_rank_job(rank, world, backend, device, cases, layout):
    """On this rank of a (dp, tp) `layout`: per recsys arch (`cases[arch]`:
    the reference's numpy tree and its score, retrieval and train
    batches) the score and retrieval steps (this data rank's rows) and
    MESH_STEPS AdamW steps of `launch.steps.build`'s train bundle (the
    history and the rank's parameters after them, tables as its blocks
    with their first rows); per SchNet cell (`cases["schnet"]`) the same
    train steps and the whole parameters after them."""
    from repro_torch.gnn.convert import schnet_params_from_numpy
    from repro_torch.recsys.convert import recsys_params_from_numpy

    torch.set_num_threads(1)
    mesh = MeshConfig(dp=layout[0], tp=layout[1]).build()
    out = {"rank": rank, "backend": backend, "coords": dict(mesh.coords), "recsys": {},
           "gnn": {}}
    for arch, case in cases.items():
        if arch == "schnet":
            continue
        tree, batches = case
        cfg = TR.get_config(arch, smoke=True)
        whole = recsys_params_from_numpy(tree, cfg, device="cpu")
        res = {}
        for step, shape in RECSYS_SHAPES:
            b = ST.build(arch, shape, mesh, "cpu", smoke=True, source=whole,
                         batch=_torch_batch(batches[step]))
            res[step] = (b.fn(b.inputs).numpy(), b.dp_batch)
        b = ST.build(arch, "train_batch", mesh, "cpu", smoke=True, source=whole,
                     batch=_torch_batch(batches["train"]))
        res["train"] = _train(b)
        res["params"] = {n: p.detach().numpy() for n, p in b.model.named_parameters()}
        res["row0"] = dict(b.model.row0)
        out["recsys"][arch] = res
    for cell, (tree, batch, graph) in cases.get("schnet", {}).items():
        cfg = TR.get_config("schnet", smoke=True)
        whole = schnet_params_from_numpy(tree, cfg, "cpu", **graph)
        b = ST.build("schnet", cell, mesh, "cpu", smoke=True, source=whole,
                     batch=_torch_batch(batch))
        hist = _train(b)
        out["gnn"][cell] = {"hist": hist, "edges": int(b.inputs["edge_src"].numel()),
                            "params": {n: p.detach().numpy()
                                       for n, p in b.model.named_parameters()}}
    return out


# ------------------------------- LM layouts whose kv heads tp does not divide
KV_LAYOUTS_4 = ((1, 4), (2, 2))          # one 4-rank job: the Dh cut, batch 1 over every axis
DECODE_ROW = 0                          # the batch-1 decode's prompt row


def kv_split_run(run, tree, mesh):
    """At (1, 4) (tp cuts the kv heads' Dh; the cache's sequence over
    ``model``): prefill of the run's prompts (the rank's logits and
    cache block), two greedy decode steps in the cache grown by EXTRA
    positions (`launch.steps.grow_cache`), the loss and two training steps
    of the port's loop with the whole parameters gathered."""
    cfg = port_config(run)
    toks, batches = run_data(run)
    whole = params_from_numpy(tree, cfg, device="cpu")
    out = {}
    serve = SPECS.shard_lm_params(whole, cfg, mesh)
    logits, cache = TT.prefill(serve, torch.from_numpy(toks))
    out["prefill"] = (logits.numpy(), cache["k"].numpy(), cache["v"].numpy())
    cache = ST.grow_cache(cache, serve, EXTRA)
    pos, nxt, steps = torch.tensor(POSITIONS), logits.argmax(-1)[:, None], []
    for _ in range(2):
        logits, cache = TT.decode_step(serve, nxt, cache, pos)
        nxt, pos = logits.argmax(-1)[:, None], pos + 1
        steps.append((logits.numpy(), nxt[:, 0].numpy()))
    out["decode"] = steps
    b0 = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    loss, nll = TT.loss_fn(serve, b0["tokens"], b0["labels"])
    out["loss"] = (float(loss), float(nll))
    tcfg = train_cfgs(run, cfg)[None]
    model = SPECS.shard_lm_params(whole, cfg, mesh, mode="train")
    model, opt, hist = TTL.train(model, ST.lm_loss, iter(batches), tcfg,
                                 layout=SPECS.train_layout(cfg, mesh, tcfg.optimizer))
    params = TTL.whole_state(model, opt)["params"]
    out["train"] = {"hist": hist, "params": {k: v.numpy() for k, v in params.items()}}
    return out


def _greedy(fn, cache, first, pos):
    steps, nxt = [], first
    for _ in range(2):
        logits, cache = fn({"tokens": nxt, "cache": cache, "positions": pos})
        nxt, pos = logits.argmax(-1)[:, None], pos + 1
        steps.append((logits.numpy(), nxt[:, 0].numpy()))
    return steps


def one_row_decode(run, tree, row, mesh):
    """A batch-1 decode (the data axis does not divide it: the cache's
    sequence over every axis), two greedy steps from `row`: the
    reference's whole cache of row DECODE_ROW's prompt ({k, v}, grown here
    by EXTRA positions) and its first greedy token (1, 1).  Then the same
    prompt's prefill on the mesh with every data rank holding the row
    (``dp_batch=False``: the rank's block of positions, every kv head) and
    two greedy steps in its cache grown by `grow_cache`."""
    cache, first, _ = row
    cfg = port_config(run)
    toks, _ = run_data(run)
    whole = params_from_numpy(tree, cfg, device="cpu")
    serve = SPECS.shard_lm_params(whole, cfg, mesh)
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.long),
             "cache": {k: torch.from_numpy(pad(v)) for k, v in cache.items()},
             "positions": torch.tensor([toks.shape[1]])}
    inputs = ST.rank_inputs(cfg, mesh, "decode", batch)
    fn, _ = ST.mesh_fn(serve, mesh, "decode", 1)
    out = {"decode": _greedy(fn, inputs["cache"], torch.from_numpy(first),
                             inputs["positions"]),
           "block": tuple(inputs["cache"]["k"].shape)}
    # every data rank holds the row (the reference's prefill cuts its rows
    # over the data axis, so `build` refuses one row there)
    logits, block = TT.prefill(serve, torch.from_numpy(toks[DECODE_ROW:DECODE_ROW + 1]),
                               dp_batch=False)
    out["prefill"] = (logits.numpy(), block["k"].numpy(), block["v"].numpy())
    grown = ST.grow_cache(block, serve, EXTRA, dp_batch=False)
    out["prefilled"] = _greedy(fn, grown, logits.argmax(-1)[:, None],
                               torch.tensor([toks.shape[1]]))
    return out


def kv_split_rank_job(rank, world, backend, device, trees, rows, layouts):
    """Every run on this rank at each (dp, tp) of `layouts` (one world):
    `kv_split_run` at (1, 4), `one_row_decode` where the data axis has two
    ranks (`rows[run]`: the reference's batch-1 cache, first token and
    logits)."""
    torch.set_num_threads(1)
    out = {"rank": rank, "backend": backend, "layouts": {}}
    for layout in layouts:
        mesh = MeshConfig(dp=layout[0], tp=layout[1]).build()
        res = {"coords": dict(mesh.coords), "runs": {}}
        with CTX.axes(mesh):
            for run in RUNS:
                tree = trees[RUNS[run][0]]
                res["runs"][run] = (kv_split_run(run, tree, mesh) if layout[0] == 1 else
                                    one_row_decode(run, tree, rows[run], mesh))
        out["layouts"][layout] = res
    return out


# ------------------------------------- the data-axis parameter cuts (MoE)
DATA_CUT_RUNS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
DATA_CUT_LAYOUTS = ((2, 1), (2, 2))


def data_cut_train_cfg(cfg, ckpt_dir=None, steps=2):
    return TTL.TrainConfig(steps=steps, optimizer=cfg.optimizer, lr=1e-3, ckpt_dir=ckpt_dir,
                           ckpt_every=1)


def data_cut_rank_job(rank, world, backend, device, trees, layout, ckpt_root):
    """On this rank of a (dp, tp) `layout`, per MoE run: its parameter
    blocks in both modes (and their bytes), prefill and two greedy decode
    steps of its rows, and two training steps on its rows with the whole
    parameters gathered after them.  At (2, 2) the training writes a
    checkpoint per run under `ckpt_root`; at (1, 2) the run resumes from
    that checkpoint of step 2 and takes step 3."""
    torch.set_num_threads(1)
    dp, tp = layout
    mesh = MeshConfig(dp=dp, tp=tp).build()
    d = mesh.coords["data"]
    out = {"rank": rank, "backend": backend, "coords": dict(mesh.coords), "runs": {}}
    with CTX.axes(mesh):
        for run in DATA_CUT_RUNS:
            cfg = port_config(run)
            toks, batches = run_data(run)
            whole = params_from_numpy(trees[run], cfg, device="cpu")
            ckpt = f"{ckpt_root}/{run}"
            res = {}
            if layout == (1, 2):
                model = SPECS.shard_lm_params(whole, cfg, mesh, mode="train")
                third = iter([{k: rows_of(v, d, dp) for k, v in batches[1].items()}])
                model, opt, hist = TTL.train(model, ST.lm_loss, third,
                                             data_cut_train_cfg(cfg, ckpt, steps=3),
                                             layout=SPECS.train_layout(cfg, mesh,
                                                                       cfg.optimizer))
                res["resumed"] = hist
                out["runs"][run] = res
                continue
            res["blocks"] = {mode: {n: p.detach().numpy().copy() for n, p in
                                    SPECS.shard_lm_params(whole, cfg, mesh,
                                                          mode=mode).named_parameters()}
                             for mode in ("serve", "train")}
            serve = SPECS.shard_lm_params(whole, cfg, mesh)
            inputs = ST.rank_inputs(cfg, mesh, "prefill", {"tokens": torch.from_numpy(toks)})
            logits, cache = TT.prefill(serve, inputs["tokens"])
            res["prefill"] = logits.numpy()
            cache = {k: torch.from_numpy(pad(v)) for k, v in cache.items()}
            pos = torch.tensor(rows_of(np.asarray(POSITIONS), d, dp))
            nxt, steps = logits.argmax(-1)[:, None], []
            for _ in range(2):
                logits, cache = TT.decode_step(serve, nxt, cache, pos)
                nxt, pos = logits.argmax(-1)[:, None], pos + 1
                steps.append((logits.numpy(), nxt[:, 0].numpy()))
            res["decode"] = steps
            model = SPECS.shard_lm_params(whole, cfg, mesh, mode="train")
            data = iter([{k: rows_of(v, d, dp) for k, v in b.items()} for b in batches])
            model, opt, hist = TTL.train(
                model, ST.lm_loss, data,
                data_cut_train_cfg(cfg, ckpt if layout == (2, 2) else None),
                layout=SPECS.train_layout(cfg, mesh, cfg.optimizer))
            res["train"] = hist
            res["params"] = {k: v.numpy() for k, v in TTL.whole_state(model, opt)["params"].items()}
            out["runs"][run] = res
    return out
