"""Serving launcher of the port: continuous batching (wave or chunked
unified-step scheduler) over the batched engine and the paged KV pool on
one device, as one instance or as a cluster of K engine workers on that
device (``--k``, `serving.cluster`).

    # rcllm serving of the tiny model on the card (kernels built at first use)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode rcllm --requests 8

    # the same on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 3

    # on the card through the kernels' plain versions, or with only the
    # decode on its kernel (the attention-backend seam)
    PYTHONPATH=src python -m repro_torch.launch.serve --attn-backend plain --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --attn-backend plain \\
        --decode-kernel paged --requests 8

    # the chunked scheduler: layer-0 chunks of 128 tokens, 512-token ticks
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --sched chunked \\
        --requests 3

    # Qwen3-8B width (random weights), depth cut to 4 layers
    PYTHONPATH=src python -m repro_torch.launch.serve --model rcllm-qwen3-8b \\
        --n-layers 4 --requests 8 --decode-steps 8

    # cross-request KV reuse through the shared block store, on a
    # repeat-user trace; int8 payloads and a 64 MB host spill tier
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --kv-reuse on \\
        --zipf-users 1.4 --requests 6 --sched chunked --kv-store-dtype int8 \\
        --spill-mb 64 --pages 120

    # two workers behind the Eq. 2 affinity router, sharded item caches
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --k 2 --requests 6

    # prefill/decode disaggregation: worker 0 prefills, worker 1 decodes
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 6 \
        --config k=2,disagg.prefill_workers=1,disagg.decode_workers=1,sched=chunked,kv_reuse=on

    # the asyncio session server: the trace as streaming sessions (--speed 0
    # replays its arrival stamps, the closed loop's tokens; > 0 is open loop)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --server \
        --sched chunked --requests 6 --speed 1

    # tensor parallelism over kv heads: two ranks (gloo processes on the
    # CPU, or ranks sharing one card), each serving its shard
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 6 \
        --config mesh.tp=2,sched=chunked,kv_reuse=on

    # the session server at tp = 2: rank 0 serves the sessions, rank 1 follows
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --server \
        --requests 6 --config mesh.tp=2,sched=chunked

    # the same ranks started by torchrun instead of the launcher
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --device cpu --config mesh.tp=2

    # the analytic cluster simulator (no model runs; H100 SXM rates)
    PYTHONPATH=src python -m repro_torch.launch.serve --engine sim --k 8 \
        --model rcllm-qwen3-8b --requests 400 --qps 20 --mode prefix

Serving knobs come from ``--config key=value,...`` (`ServeConfig.parse`)
and the per-knob flags, which override it.  The JSON printed carries the
keys of the JAX launcher's engine report (`repro/launch/serve.py:
_engine_report`, with its ``store`` settings and ``block_store`` counters
under kv_reuse) with ``"engine": "torch"``, plus the device and model
that ran; with ``k > 1`` those of its cluster report (`run_jax_cluster`,
``"engine": "torch-cluster"``, without ``mesh``), with
``"transfer_billing": "modeled"``: cross-shard pulls and migrations are
billed from the cost model, since the workers share one card.  With
``--server`` the engine report gains the JAX launcher's ``server``,
``speed``, ``finish_reasons`` and ``online`` (`run_jax_server`); with
``--engine sim`` the JSON is the simulator's summary (`run_sim`).

With ``--config mesh.tp=...`` (and ``mesh.dp``, ``mesh.mesh_shape``) the
run is tensor-parallel: the launcher starts one rank per device of the
mesh (`launch.mesh.spawn_ranks`, on a free local port), or joins the
ranks ``torchrun`` started.  Rank ``r`` runs on ``cuda:(r % device
count)``, or on the CPU with ``--device cpu``; the collectives run over
NCCL when every rank has a card of its own and over gloo when ranks share
a card or run on the CPU.  Each rank builds its shard of the system from
the seed and serves the whole trace on its heads (`run_rank`); a dp > 1
mesh repeats that on each replica.  Rank 0 prints the JSON, whose
``mesh`` says the layout, the backend and every rank's device, time and
peak memory (`_mesh_info`), and the cluster's ``"transfer_billing":
"measured"`` with ``"transfer_copies": "same device"``: a rank's workers
share its device, so the billed copies cross no link.  With ``--server``
the model axis's first rank runs the asyncio session server and the other
ranks follow its ticks (`serving.server.follow`); rank 0's JSON carries
the server's keys beside ``mesh``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.configs.rcllm_qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.core import engine as ENG
from repro_torch.launch import mesh as MESH
from repro_torch.serving import api as API
from repro_torch.serving.api import ServeConfig
from repro_torch.serving.batching import PendingRequest

SERVE_TINY = LMConfig(name="serve-tiny", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
                      mlp_type="swiglu", dtype="float32")


def model_config(name: str, n_layers: Optional[int] = None) -> Optional[LMConfig]:
    """`None` for the tiny rcllm model of `make_tiny_system`, else the
    named config with its depth optionally cut."""
    if name == "tiny":
        return None
    if name != QWEN3_8B.name:
        raise SystemExit(f"unknown --model {name!r}: tiny or {QWEN3_8B.name}")
    return QWEN3_8B if n_layers is None else dataclasses.replace(QWEN3_8B, n_layers=n_layers)


def rcllm_system(cfg: Optional[LMConfig], device, seed: int = 0, model=None,
                 k_instances: int = 1, mesh=None):
    """The rcllm serving run's system (the tiny model when `cfg` is None;
    weights from a seeded generator unless `model` is given), built as the
    JAX launcher builds its system, its placement over `k_instances`
    shards; with a `mesh`, this rank's shard of it.  -> (system, review
    pool, profile): what traces over its catalog are drawn from."""
    from repro_torch.core.rcllm import make_system, make_tiny_system

    kw = dict(n_items=80, n_requests_hist=40, k_instances=k_instances, seed=seed,
              device=device, model=model, mesh=mesh)
    if cfg is None:
        system, pool_rv, prof, _ = make_tiny_system(n_layers=2, d_model=32, **kw)
    else:
        system, pool_rv, prof, _ = make_system(cfg, **kw)
    return system, pool_rv, prof


def rcllm_requests(system, trace, decode_steps: int):
    """-> (requests, plans, reuse metadata for a store-backed engine) of a
    trace over `system`'s catalog."""
    from repro_torch.serving.workload import rcllm_reuse_info, rcllm_workload

    reqs, plans = rcllm_workload(system, trace, decode_steps=decode_steps)
    return reqs, plans, rcllm_reuse_info(system, trace, plans)


def rcllm_setup(cfg: Optional[LMConfig], device, n_requests: int, qps: float,
                decode_steps: int, seed: int = 0, model=None,
                zipf_users: Optional[float] = None, long_prompt_frac: float = 0.0):
    """The rcllm serving run's system and the JAX launcher's
    single-instance trace over it (`zipf_users` draws users Zipf(a)
    instead of uniformly, `long_prompt_frac` gives that fraction of users
    long histories).  -> (system, requests, plans, reuse)."""
    system, pool_rv, prof = rcllm_system(cfg, device, seed, model)
    trace = launcher_trace(system, pool_rv, prof, n_requests, qps, zipf_users,
                           long_prompt_frac)
    return (system, *rcllm_requests(system, trace, decode_steps))


def launcher_trace(system, pool_rv, prof, n_requests: int, qps: float,
                   zipf_users: Optional[float] = None, long_prompt_frac: float = 0.0):
    """The JAX launcher's rcllm trace over `system`."""
    from repro_torch.data import synth as SY

    return SY.make_trace(system.catalog, pool_rv, prof, n_requests, qps=qps,
                         n_users=max(3, n_requests // 2), n_candidates=8,
                         reviews_per_user=1, seed=2, user_zipf_a=zipf_users,
                         long_prompt_frac=long_prompt_frac)


def full_setup(device, n_requests: int, qps: float, decode_steps: int,
               prompt_tokens: int, seed: int = 0):
    """Full-recompute reference on random prompts.  -> (model, requests)."""
    from repro_torch.models.transformer import init_params

    if prompt_tokens < 16:
        raise SystemExit("--prompt-tokens must be >= 16")
    model = init_params(SERVE_TINY, torch.Generator(device=device).manual_seed(seed),
                        device=device)
    rng = np.random.default_rng(1)
    lo = min(48, prompt_tokens)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, n_requests))
    reqs = []
    for rid in range(n_requests):
        n = int(rng.integers(lo, prompt_tokens + 1))
        reqs.append(PendingRequest(
            arrival_s=float(arrivals[rid]), rid=rid, n_tokens=n,
            decode_steps=decode_steps,
            tokens=rng.integers(1, SERVE_TINY.vocab_size, n).astype(np.int32)))
    return model, reqs


def serve(model, cfg: LMConfig, config: ServeConfig, reqs, plans=None, cache=None,
          reuse=None):
    """One closed-loop run; rcllm mode needs the system's cached-row pool
    `cache`, and kv_reuse the requests' `reuse` metadata.  -> (engine,
    backend, batcher, completions)."""
    sel = ENG.SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev, window=16)
    engine = API.build_engine(model, cfg, config, sel=sel, cache=cache)
    backend = API.build_backend(engine, config, plans=plans,
                                reuse=reuse if config.kv_reuse else None)
    batcher = API.build_batcher(backend, config)
    done = sorted(batcher.run(list(reqs)), key=lambda c: c.rid)
    return engine, backend, batcher, done


def _percentiles(xs, qs=(50, 90, 99)) -> dict:
    xs = np.asarray(list(xs), np.float64)
    if len(xs) == 0:
        return {f"p{q}_s": None for q in qs}
    return {f"p{q}_s": float(np.percentile(xs, q)) for q in qs}


def _latency_split(done) -> dict:
    """Per-request latency attribution and its aggregates (`done` sorted
    by rid; empty when the session server rejected or cancelled every
    request before its first token)."""
    if not done:
        out = dict.fromkeys(("ttft_p50_s", "ttft_p90_s", "ttft_p99_s", "ttft_mean_s",
                             "queue_wait_mean_s", "prefill_mean_s", "decode_mean_s"))
        out["per_request"] = []
        return out
    ttft = np.asarray([c.first_token_s - c.arrival_s for c in done])
    return {
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p90_s": float(np.percentile(ttft, 90)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "ttft_mean_s": float(ttft.mean()),
        "queue_wait_mean_s": float(np.mean([c.queue_wait_s for c in done])),
        "prefill_mean_s": float(np.mean([c.prefill_s for c in done])),
        "decode_mean_s": float(np.mean([c.decode_s for c in done])),
        "per_request": [
            {"rid": c.rid,
             "ttft_s": round(float(c.first_token_s - c.arrival_s), 4),
             "queue_wait_s": round(float(c.queue_wait_s), 4),
             "prefill_s": round(float(c.prefill_s), 4),
             "decode_s": round(float(c.decode_s), 4)}
            for c in done],
    }


def _throughput(done, generated) -> dict:
    total = max((c.done_s for c in done), default=0.0)
    n_toks = sum(len(generated[c.rid]) for c in done)
    return {"decode_tokens": int(n_toks),
            "throughput_tok_s": float(n_toks / max(total, 1e-9))}


def _tbt_stats(workers) -> dict:
    tbt = [dt for w in workers for dt in w.tbt]
    out = {f"tbt_{k}": v for k, v in _percentiles(tbt).items()}
    out["tbt_samples"] = len(tbt)
    return out


def _device_info(model, cfg: LMConfig) -> dict:
    return {"device": str(model.device), "model": cfg.name, "n_layers": cfg.n_layers}


def report(config: ServeConfig, engine, backend, workers, done,
           warmup: bool, mesh_info: Optional[dict] = None) -> dict:
    """The JAX launcher's engine-report keys for one run of `workers`
    (the batcher's `WorkerState`s); `mesh_info`: the mesh of a
    tensor-parallel run (`launch.mesh.Mesh.info`, every rank's record
    added by `_mesh_info`)."""
    stats = engine.pool.stats()
    out = {
        "engine": "torch",
        "mode": config.mode,
        "sched": config.sched,
        "attn_backend": backend.attn_backend,
        "decode_kernel": backend.decode_kernel,
        "requests": len(done),
        "kv_reuse": "on" if config.kv_reuse else "off",
        "store": (dataclasses.asdict(config.store) if config.store.enabled else None),
        "mesh": mesh_info,
        "decode_steps": config.decode_steps,
        "includes_jit_compile": not warmup,
        **_latency_split(done),
        **_throughput(done, backend.generated),
        "pool_peak_pages": engine.pool.peak_pages,
        "pool_peak_utilization": round(
            engine.pool.peak_pages / max(stats.n_pages - 1, 1), 4),
        **_device_info(engine.model, engine.cfg),
    }
    if engine.store is not None:
        out["block_store"] = engine.store.stats()
    out.update(_tbt_stats(workers))
    if config.sched == "chunked":
        ticks = [t for w in workers for t in w.ticks]
        out.update({"chunk_tokens": config.chunk_tokens,
                    "step_tokens": config.resolved_step_tokens,
                    "ticks": len(ticks),
                    "oversized_ticks": sum(t.oversized for t in ticks)})
    return out


def cluster_report(config: ServeConfig, cluster, rep, warmup: bool,
                   mesh_info: Optional[dict] = None) -> dict:
    """The JAX launcher's cluster-report keys for one run (`run_jax_cluster`;
    ``mesh`` only for a tensor-parallel run, `mesh_info`)."""
    done = sorted(rep.completions, key=lambda c: c.rid)
    workers = cluster.batcher.workers
    ticks = [t for w in workers for t in w.ticks]
    out = {
        "engine": "torch-cluster",
        "k": config.k,
        "mode": config.mode,
        "sched": config.sched,
        "attn_backend": cluster.backends[0].attn_backend,
        "decode_kernel": cluster.backends[0].decode_kernel,
        "kv_reuse": "on" if config.kv_reuse else "off",
        "disagg": (dataclasses.asdict(config.disagg) if config.disagg.enabled else None),
        "store": (dataclasses.asdict(config.store) if config.store.enabled else None),
        "policy": rep.policy,
        "requests": len(done),
        "decode_steps": config.decode_steps,
        "includes_jit_compile": not warmup,
        "transfer_billing": "measured" if cluster.worker_devices else "modeled",
        "per_request_ttft_s": [round(float(x), 4) for x in rep.ttft()],
        **_latency_split(done),
        **_throughput(done, rep.generated),
        **_tbt_stats(workers),
        **({"ticks": len(ticks), "oversized_ticks": sum(t.oversized for t in ticks),
            "mean_tick_tokens": float(np.mean([t.decode_tokens + t.chunk_tokens
                                               + t.finalize_tokens for t in ticks]))}
           if ticks else {}),
        "mean_hit_rate": rep.mean_hit_rate(),
        "per_worker": [
            {"worker": w.worker,
             "role": workers[w.worker].role,
             "requests": w.n_requests,
             "mean_hit_rate": (round(w.mean_hit_rate, 4)
                               if w.mean_hit_rate is not None else None),
             "transfer_blocks": w.transfer_blocks,
             "transfer_tokens": w.transfer_tokens,
             "transfer_mbytes": round(w.transfer_bytes / 1e6, 3),
             "transfer_seconds": round(w.transfer_seconds, 6),
             "pool_peak_pages": w.pool_peak_pages,
             "busy_seconds": round(w.busy_seconds, 4),
             "preempted": w.preempted,
             "migrations": w.migrations,
             "migrated_out": w.migrated_out,
             "migrated_pages": w.migrated_pages,
             "migration_mbytes": round(w.migration_bytes / 1e6, 3),
             "migration_s": round(w.migration_s, 6),
             "migration_digest_hits": w.migration_digest_hits,
             "device_blocks": w.device_blocks,
             "spill_blocks": w.spill_blocks,
             "spill_hits": w.spill_hits,
             "prefetch_promotions": w.prefetch_promotions,
             "dequant_s": round(w.dequant_s, 6),
             "kv_reuse": w.kv_reuse}
            for w in rep.workers],
        **_device_info(cluster.system.model, cluster.system.cfg),
    }
    if mesh_info is not None:
        out["mesh"] = mesh_info
    if cluster.transfer_copies is not None:
        # measured copies within one device are not network transfers
        out["transfer_copies"] = cluster.transfer_copies
    return out


def run_cluster(config: ServeConfig, args, device) -> dict:
    """K engine workers on `device` behind the Eq. 2 router
    (`serving.cluster`), serving the launcher trace."""
    from repro_torch.serving.cluster import ClusterEngine

    system, pool_rv, prof = rcllm_system(model_config(args.model, args.n_layers), device,
                                         k_instances=config.k)
    trace = launcher_trace(system, pool_rv, prof, args.requests, args.qps,
                           args.zipf_users, args.long_prompt_frac)
    if args.warmup:
        ClusterEngine(system, config).run(trace, decode_steps=config.decode_steps)
    cluster = ClusterEngine(system, config)
    rep = cluster.run(trace, decode_steps=config.decode_steps)
    return cluster_report(config, cluster, rep, args.warmup)


def _mesh_info(ranks: Sequence[dict], i: int) -> dict:
    """The mesh run `i` of the ranks' `run_rank` records used, for its
    JSON: tp, dp, shape, axis names, the collective backend, and each
    rank's device, wall seconds and peak device GB."""
    return {**ranks[0]["runs"][i]["report"]["mesh"],
            "ranks": [{"rank": r["rank"], "device": r["device"],
                       "wall_s": r["runs"][i]["wall_s"], "peak_gb": r["runs"][i]["peak_gb"]}
                      for r in ranks]}


class Probe:
    """Hooks a caller of `run_rank` can pass into the ranks (it travels
    by pickle): `begin` before the offline build and before each run,
    `end` after it, whose value lands in the rank's record.  The default
    records nothing."""

    def begin(self, label: str) -> None:
        pass

    def end(self, label: str, mesh, **run) -> Optional[dict]:
        return None


def _peak_gb(device) -> Optional[float]:
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_rank(rank: int, world: int, backend: str, device, configs: Sequence[ServeConfig],
             args, probe: Optional[Probe] = None, check: bool = False,
             servers: Optional[Sequence[bool]] = None) -> dict:
    """One rank of a tensor-parallel run: this rank's mesh, its shard of
    the system and of the launcher trace, then each of `configs` (one
    mesh, one `k`) served over them inside ``sharding.ctx.axes(mesh)``,
    closed loop or, where `servers` says (default: ``args.server`` for
    every run), through the session server (`rank_sessions`).  `check`
    turns on the ranks' digest comparison of every step's plan and every
    recompute mask (`sharding.ctx.check`).  -> this rank's record: rank,
    device, the offline build's seconds, and per run its report, tokens,
    wall seconds, peak device GB, the mesh's digest log and what `probe`
    recorded."""
    from repro_torch.serving.cluster import ClusterEngine
    from repro_torch.sharding import ctx as CTX

    probe = probe or Probe()
    if servers is None:
        servers = [bool(getattr(args, "server", False))] * len(configs)
    mesh = configs[0].mesh.build()
    mesh.device, mesh.check = device, check
    k = configs[0].k
    out = {"rank": rank, "device": str(device), "runs": []}
    with CTX.axes(mesh):
        probe.begin("offline build")
        t0 = time.perf_counter()
        cfg = model_config(args.model, args.n_layers)
        if configs[0].mode == "rcllm" or k > 1:
            system, pool_rv, prof = rcllm_system(cfg, device, k_instances=k, mesh=mesh)
            trace = launcher_trace(system, pool_rv, prof, args.requests, args.qps,
                                   args.zipf_users, args.long_prompt_frac)
        else:
            model, reqs = full_setup(device, args.requests, args.qps,
                                     configs[0].decode_steps, args.prompt_tokens)
        _sync(device)
        out["build_s"] = time.perf_counter() - t0
        out["build_probe"] = probe.end("offline build", mesh)
        for config, server in zip(configs, servers):
            if config.mesh != configs[0].mesh or config.k != k:
                raise ValueError("one rank run serves configs of one mesh and one k")
            label = config.render()
            mesh.log = []
            probe.begin(label)
            _reset_peak(device)
            t0 = time.perf_counter()
            if k > 1:
                cluster = ClusterEngine(system, config)
                rep = cluster.run(trace, decode_steps=config.decode_steps)
                engine, backend, generated = None, cluster.backends, rep.generated
            else:
                if config.mode == "rcllm":
                    reqs, plans, reuse = rcllm_requests(system, trace, config.decode_steps)
                    model, cache = system.model, system.rows
                else:
                    plans = cache = reuse = None
                if server:
                    engine, backend, workers, done, extra = rank_sessions(
                        config, model, model.cfg, reqs, plans, cache, reuse,
                        getattr(args, "speed", 0.0))
                else:
                    engine, backend, batcher, done = serve(model, model.cfg, config, reqs,
                                                           plans, cache, reuse)
                    workers, extra = batcher.workers, {}
                generated = backend.generated
            _sync(device)
            run = {"wall_s": time.perf_counter() - t0, "peak_gb": _peak_gb(device),
                   "generated": {int(r): [int(t) for t in ts] for r, ts in generated.items()},
                   "log": list(mesh.log),
                   "probe": probe.end(label, mesh, engine=engine, backend=backend)}
            run["report"] = (cluster_report(config, cluster, rep, False, mesh.info())
                             if k > 1 else {**report(config, engine, backend, workers, done,
                                                     False, mesh.info()), **extra})
            out["runs"].append(run)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_mesh(configs: Sequence[ServeConfig], args, probe: Optional[Probe] = None,
             check: bool = False, servers: Optional[Sequence[bool]] = None) -> list:
    """Start the ranks of `configs`' mesh here (`launch.mesh.spawn_ranks`)
    on `args.device`'s kind and serve `configs` on them (`run_rank`;
    `servers`: which runs go through the session server).  -> the ranks'
    records, in rank order; each run's report carries every rank's
    device, time and peak memory under ``mesh``."""
    device_type = torch.device(args.device).type
    world = configs[0].mesh.n_devices
    ranks = MESH.spawn_ranks(run_rank, world, device_type,
                             args=(list(configs), args, probe, check, servers))
    _gather_ranks(ranks)
    return ranks


def _gather_ranks(ranks: Sequence[dict]) -> None:
    """Every rank's device, time and peak memory into each run's
    ``mesh`` of rank 0's record (each rank saw only its own)."""
    for i, run in enumerate(ranks[0]["runs"]):
        run["report"]["mesh"] = _mesh_info(ranks, i)


def _check_mesh(config: ServeConfig, args) -> None:
    """The divisibility and session-server errors before any rank starts."""
    from repro_torch.core.rcllm import tiny_config
    from repro_torch.sharding import specs as SPECS

    if args.server and config.k != 1:
        raise SystemExit("--server runs a single-worker session server (k=1); "
                         "multi-worker serving is the closed-loop cluster path")
    if config.mode == "rcllm" or config.k > 1:
        cfg = model_config(args.model, args.n_layers) or tiny_config(2, 32)
    else:
        cfg = SERVE_TINY
    try:
        SPECS.check_serving_divisibility(cfg, config.mesh)
    except ValueError as e:
        raise SystemExit(str(e))


def main_rank_under_torchrun(config: ServeConfig, args) -> None:
    """This process is one rank ``torchrun`` started: join the group, serve,
    and let rank 0 print the JSON with every rank's record."""
    import os

    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend, device = MESH.init_rank(rank, world, torch.device(args.device).type)
    try:
        mine = run_rank(rank, world, backend, device, [config], args)
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        _gather_ranks(ranks)
        print(json.dumps(ranks[0]["runs"][0]["report"], indent=1))


def run_sim(config: ServeConfig, args) -> dict:
    """The analytic cluster simulator (`core.simulator`) over `config.k`
    instances on the H100's published rates: the JAX launcher's `run_sim`
    with the port's `Hardware`.  No model runs."""
    from repro_torch.core import cost_model as CM
    from repro_torch.core import simulator as SIM
    from repro_torch.core.rcllm import tiny_config

    cfg = model_config(args.model, args.n_layers) or tiny_config(2, 32)
    reqs, placement, _ = SIM.make_sim_setup(k=config.k, n_requests=args.requests,
                                            qps=args.qps, n_items=8000, seed=1)
    res = SIM.simulate(cfg, CM.H100_SXM, reqs, placement, SIM.SimConfig(
        mode=config.mode, policy=config.policy, r_item=config.r_item,
        r_rev=config.r_rev))
    return {"engine": "sim", "k": config.k, "qps": args.qps, "mode": config.mode,
            "policy": config.policy, "model": cfg.name, "hardware": "H100_SXM",
            **res.summary()}


def submits_of(reqs, plans=None, reuse=None):
    """A closed-loop trace as the session server's ``(arrival_s,
    api.SubmitRequest)`` pairs: each request's token budget, its rcllm
    context from `plans` and its reuse metadata from `reuse`."""
    return [(r.arrival_s, API.SubmitRequest(
        rid=r.rid, tokens=r.tokens, max_tokens=r.decode_steps,
        context=(plans or {}).get(r.rid), reuse=(reuse or {}).get(r.rid)))
        for r in reqs]


def serve_sessions(model, cfg: LMConfig, config: ServeConfig, submits, cache=None,
                   speed: float = 0.0):
    """One run of ``(arrival_s, SubmitRequest)`` pairs through the asyncio
    session server (`serving.server`) over a fresh engine, built as `serve`
    builds its own.  -> (engine, backend, completions by rid, the stopped
    server)."""
    from repro_torch.serving.server import serve_trace

    sel = ENG.SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev, window=16)
    engine = API.build_engine(model, cfg, config, sel=sel, cache=cache)
    backend = API.build_backend(engine, config)
    return (engine, backend, *serve_trace(backend, config, submits, speed=speed))


def server_keys(completions, server, speed: float) -> dict:
    """The JAX launcher's ``server``, ``speed``, ``finish_reasons`` and
    ``online`` keys of a session-server run."""
    return {"server": True, "speed": speed,
            "finish_reasons": {
                reason: sum(1 for c in completions.values() if c.reason == reason)
                for reason in sorted({c.reason for c in completions.values()})},
            "online": server.metrics_snapshot()}


def rank_sessions(config: ServeConfig, model, cfg: LMConfig, reqs, plans=None, cache=None,
                  reuse=None, speed: float = 0.0):
    """One rank's session-server run under tensor parallelism (inside
    ``sharding.ctx.axes``): the model axis's first rank serves the trace's
    sessions (`serve_sessions`), every other rank follows its ticks
    (`serving.server.follow`) over an engine built alike.  -> (engine,
    backend, [worker], its completions by rid, the server's report keys:
    ``server`` and ``speed``, and on the serving rank ``finish_reasons``,
    ``online`` and the ticks sent)."""
    from repro_torch.serving.server import follow
    from repro_torch.sharding import ctx as CTX

    if CTX.current().coords["model"] == 0:
        submits = submits_of(reqs, plans, reuse if config.kv_reuse else None)
        engine, backend, completions, server = serve_sessions(model, cfg, config, submits,
                                                              cache, speed)
        done = sorted(server.worker.done, key=lambda c: c.rid)
        return (engine, backend, [server.worker], done,
                {**server_keys(completions, server, speed), "ticks": server.ticks})
    sel = ENG.SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev, window=16)
    engine = API.build_engine(model, cfg, config, sel=sel, cache=cache)
    backend = API.build_backend(engine, config)
    worker = follow(backend, config)
    return (engine, backend, [worker], sorted(worker.done, key=lambda c: c.rid),
            {"server": True, "speed": speed})


def run_server(config: ServeConfig, model, cfg: LMConfig, reqs, plans=None, cache=None,
               reuse=None, speed: float = 0.0, warmup: bool = False) -> dict:
    """The single-instance trace served through the session server:
    streaming sessions over the same scheduling loop, plus its rolling
    online metrics.  ``speed == 0`` replays the trace's arrival stamps
    (the closed loop's tokens); ``speed > 0`` is open-loop wall-clock
    traffic.  -> the engine report with the JAX launcher's ``server``,
    ``speed``, ``finish_reasons`` and ``online`` keys."""
    submits = submits_of(reqs, plans, reuse if config.kv_reuse else None)
    if warmup:
        serve_sessions(model, cfg, config, submits, cache, speed)
    engine, backend, completions, server = serve_sessions(model, cfg, config, submits,
                                                          cache, speed)
    done = sorted(server.worker.done, key=lambda c: c.rid)
    out = report(config, engine, backend, [server.worker], done, warmup)
    out.update(server_keys(completions, server, speed))
    return out


def build_config(args) -> ServeConfig:
    """``--config`` with the per-knob flags typed on top of it."""
    base = ServeConfig.parse(args.config or "")
    config = ServeConfig.from_args(args, base=base)
    store = {k: v for k, v in (("kv_store_dtype", args.kv_store_dtype),
                               ("spill_mb", args.spill_mb),
                               ("prefetch_pages_per_tick", args.prefetch_pages_per_tick))
             if v is not None}
    if store:
        config = config.replace(store=dataclasses.replace(config.store, **store))
    return config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="serving knobs as key=value[,key=value...] over "
                    "serving.api.ServeConfig, e.g. k=2,disagg.prefill_workers=1,"
                    "disagg.decode_workers=1; the flags below override it")
    ap.add_argument("--engine", default=None, choices=list(API.ENGINES),
                    help="torch: the port's engine (default); sim: the analytic "
                    "cluster simulator (no model runs)")
    ap.add_argument("--server", action="store_true",
                    help="serve the trace through the asyncio session server "
                    "(serving.server; k = 1): streaming sessions over the same "
                    "scheduling loop, online metrics under 'online'")
    ap.add_argument("--speed", type=float, default=0.0,
                    help="--server arrival pacing: 0 replays the trace's arrival "
                    "stamps; > 0 submits on the wall clock at trace time / speed")
    ap.add_argument("--k", type=int, default=None,
                    help="engine workers; k > 1 serves a cluster on the one device")
    ap.add_argument("--policy", default=None,
                    help="cluster dispatch: affinity (Eq. 2), hit_only, load_only, "
                    "round_robin, least_loaded, random")
    ap.add_argument("--mode", default=None, choices=list(API.MODES))
    ap.add_argument("--sched", default=None, choices=list(API.SCHEDS),
                    help="wave: whole-prefill batches; chunked: unified ticks of "
                    "decode + layer-0 chunks + selective finalizes (rcllm only)")
    ap.add_argument("--attn-backend", default=None, choices=list(API.ATTN_BACKENDS),
                    help="cuda: the hand-written kernels; plain: their plain PyTorch "
                    "versions on the same device; auto (default): cuda for a CUDA "
                    "model, plain for a CPU one")
    ap.add_argument("--decode-kernel", default=None, choices=list(API.DECODE_KERNELS),
                    help="auto (default): follow --attn-backend; paged / gather: pin "
                    "the paged-decode kernel / its plain version")
    ap.add_argument("--chunk-tokens", type=int, default=None)
    ap.add_argument("--step-tokens", type=int, default=None,
                    help="per-tick token budget (default max(4 * chunk, 512))")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--qps", type=float, default=8.0)
    ap.add_argument("--decode-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="tiny",
                    help=f"tiny (the tiny rcllm model) or {QWEN3_8B.name}")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the named model's depth (width is never cut)")
    ap.add_argument("--prompt-tokens", type=int, default=160)
    ap.add_argument("--pages", type=int, default=None)
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--max-batch-tokens", type=int, default=None)
    ap.add_argument("--r-item", type=float, default=None)
    ap.add_argument("--r-rev", type=float, default=None)
    ap.add_argument("--kv-reuse", default=None, choices=["on", "off"],
                    help="cross-request KV reuse through the shared block store")
    ap.add_argument("--kv-store-dtype", default=None, choices=["fp32", "int8"],
                    help="store payloads of the user and item tiers")
    ap.add_argument("--spill-mb", type=int, default=None,
                    help="host-RAM spill tier for evicted blocks (0: drop them)")
    ap.add_argument("--prefetch-pages-per-tick", type=int, default=None,
                    help="pages of router-hinted spill blocks promoted per tick")
    ap.add_argument("--zipf-users", type=float, default=None,
                    help="draw the trace's users Zipf(a) (repeat users), rcllm only")
    ap.add_argument("--long-prompt-frac", type=float, default=0.0,
                    help="rcllm trace: the fraction of users with a heavy tail of "
                    "extra reviews (long prompts)")
    ap.add_argument("--warmup", action="store_true",
                    help="run the trace once first, so reported times exclude "
                    "kernel builds and first-call set-up")
    args = ap.parse_args(argv)
    try:
        config = build_config(args)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.zipf_users is not None and config.mode != "rcllm":
        raise SystemExit("--zipf-users shapes the rcllm trace; it has no effect on "
                         "mode=full prompts")
    if config.engine == "sim":
        if args.server:
            raise SystemExit("--server drives the port's engine: engine=torch")
        print(json.dumps(run_sim(config, args), indent=1))
        return
    if config.mesh.enabled:
        _check_mesh(config, args)
        if MESH.under_torchrun():
            main_rank_under_torchrun(config, args)
            return
        ranks = run_mesh([config], args)
        print(json.dumps(ranks[0]["runs"][0]["report"], indent=1))
        return
    device = torch.device(args.device)
    if args.server and config.k != 1:
        raise SystemExit("--server runs a single-worker session server (k=1); "
                         "multi-worker serving is the closed-loop cluster path")
    if config.k > 1:
        print(json.dumps(run_cluster(config, args, device), indent=1))
        return
    plans = cache = reuse = None
    if config.mode == "rcllm":
        system, reqs, plans, reuse = rcllm_setup(
            model_config(args.model, args.n_layers), device, args.requests, args.qps,
            config.decode_steps, zipf_users=args.zipf_users,
            long_prompt_frac=args.long_prompt_frac)
        model, cfg, cache = system.model, system.cfg, system.rows
    else:
        model, reqs = full_setup(device, args.requests, args.qps,
                                 config.decode_steps, args.prompt_tokens)
        cfg = model.cfg
    if args.server:
        out = run_server(config, model, cfg, reqs, plans, cache, reuse, speed=args.speed,
                         warmup=args.warmup)
        print(json.dumps(out, indent=1))
        return
    if args.warmup:
        serve(model, cfg, config, reqs, plans, cache, reuse)
    engine, backend, batcher, done = serve(model, cfg, config, reqs, plans, cache, reuse)
    out = report(config, engine, backend, batcher.workers, done, warmup=args.warmup)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
