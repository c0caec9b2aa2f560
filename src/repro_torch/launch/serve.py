"""Serving launcher of the port: continuous batching (wave or chunked
unified-step scheduler) over the batched engine and the paged KV pool on
one device.

    # rcllm serving of the tiny model on the card (kernels built at first use)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode rcllm --requests 8

    # the same on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 3

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

The JSON printed carries the keys of the JAX launcher's engine report
(`repro/launch/serve.py:_engine_report`, with its ``store`` settings and
``block_store`` counters under kv_reuse) with ``"engine": "torch"``,
plus the device and model that ran.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.configs.rcllm_qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.core import engine as ENG
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


def rcllm_system(cfg: Optional[LMConfig], device, seed: int = 0, model=None):
    """The rcllm serving run's system (the tiny model when `cfg` is None;
    weights from a seeded generator unless `model` is given), built as the
    JAX launcher builds its single-instance system.  -> (system, review
    pool, profile): what traces over its catalog are drawn from."""
    from repro_torch.core.rcllm import make_system, make_tiny_system

    kw = dict(n_items=80, n_requests_hist=40, k_instances=1, seed=seed, device=device,
              model=model)
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
                zipf_users: Optional[float] = None):
    """The rcllm serving run's system and the JAX launcher's
    single-instance trace over it (`zipf_users` draws users Zipf(a)
    instead of uniformly).  -> (system, requests, plans, reuse)."""
    system, pool_rv, prof = rcllm_system(cfg, device, seed, model)
    trace = launcher_trace(system, pool_rv, prof, n_requests, qps, zipf_users)
    return (system, *rcllm_requests(system, trace, decode_steps))


def launcher_trace(system, pool_rv, prof, n_requests: int, qps: float,
                   zipf_users: Optional[float] = None):
    """The JAX launcher's single-instance rcllm trace over `system`."""
    from repro_torch.data import synth as SY

    return SY.make_trace(system.catalog, pool_rv, prof, n_requests, qps=qps,
                         n_users=max(3, n_requests // 2), n_candidates=8,
                         reviews_per_user=1, seed=2, user_zipf_a=zipf_users)


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


def report(config: ServeConfig, engine, backend, batcher, done,
           warmup: bool) -> dict:
    """The JAX launcher's engine-report keys for one run."""
    total = max((c.done_s for c in done), default=0.0)
    n_toks = sum(len(backend.generated[c.rid]) for c in done)
    stats = engine.pool.stats()
    ttft = np.asarray([c.first_token_s - c.arrival_s for c in done])
    dev = engine.model.device
    out = {
        "engine": "torch",
        "mode": config.mode,
        "sched": config.sched,
        "attn_backend": "cuda" if dev.type == "cuda" else "plain",
        "decode_kernel": "paged",
        "requests": len(done),
        "kv_reuse": "on" if config.kv_reuse else "off",
        "store": (dataclasses.asdict(config.store) if config.store.enabled else None),
        "mesh": None,
        "decode_steps": config.decode_steps,
        "includes_jit_compile": not warmup,
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
        "decode_tokens": int(n_toks),
        "throughput_tok_s": float(n_toks / max(total, 1e-9)),
        "pool_peak_pages": engine.pool.peak_pages,
        "pool_peak_utilization": round(
            engine.pool.peak_pages / max(stats.n_pages - 1, 1), 4),
        "device": str(dev),
        "model": engine.cfg.name,
        "n_layers": engine.cfg.n_layers,
    }
    if engine.store is not None:
        out["block_store"] = engine.store.stats()
    tbt = [dt for w in batcher.workers for dt in w.tbt]
    out.update({f"tbt_{k}": v for k, v in _percentiles(tbt).items()})
    out["tbt_samples"] = len(tbt)
    if config.sched == "chunked":
        ticks = [t for w in batcher.workers for t in w.ticks]
        out.update({"chunk_tokens": config.chunk_tokens,
                    "step_tokens": config.resolved_step_tokens,
                    "ticks": len(ticks),
                    "oversized_ticks": sum(t.oversized for t in ticks)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="rcllm", choices=list(API.MODES))
    ap.add_argument("--sched", default="wave", choices=list(API.SCHEDS),
                    help="wave: whole-prefill batches; chunked: unified ticks of "
                    "decode + layer-0 chunks + selective finalizes (rcllm only)")
    ap.add_argument("--chunk-tokens", type=int, default=128)
    ap.add_argument("--step-tokens", type=int, default=None,
                    help="per-tick token budget (default max(4 * chunk, 512))")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--qps", type=float, default=8.0)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="tiny",
                    help=f"tiny (the tiny rcllm model) or {QWEN3_8B.name}")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the named model's depth (width is never cut)")
    ap.add_argument("--prompt-tokens", type=int, default=160)
    ap.add_argument("--pages", type=int, default=512)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-batch-tokens", type=int, default=4096)
    ap.add_argument("--r-item", type=float, default=0.3)
    ap.add_argument("--r-rev", type=float, default=0.3)
    ap.add_argument("--kv-reuse", default="off", choices=["on", "off"],
                    help="cross-request KV reuse through the shared block store")
    ap.add_argument("--kv-store-dtype", default="fp32", choices=["fp32", "int8"],
                    help="store payloads of the user and item tiers")
    ap.add_argument("--spill-mb", type=int, default=0,
                    help="host-RAM spill tier for evicted blocks (0: drop them)")
    ap.add_argument("--zipf-users", type=float, default=None,
                    help="draw the trace's users Zipf(a) (repeat users), rcllm only")
    ap.add_argument("--warmup", action="store_true",
                    help="run the trace once first, so reported times exclude "
                    "kernel builds and first-call set-up")
    args = ap.parse_args(argv)
    try:
        config = ServeConfig(mode=args.mode, sched=args.sched,
                             chunk_tokens=args.chunk_tokens,
                             step_tokens=args.step_tokens,
                             decode_steps=args.decode_steps,
                             n_pages=args.pages, page_size=args.page_size,
                             max_batch_tokens=args.max_batch_tokens,
                             r_item=args.r_item, r_rev=args.r_rev,
                             kv_reuse=args.kv_reuse == "on",
                             store=API.StoreConfig(
                                 kv_store_dtype=args.kv_store_dtype,
                                 spill_mb=args.spill_mb))
    except ValueError as e:
        raise SystemExit(str(e))
    if args.zipf_users is not None and config.mode != "rcllm":
        raise SystemExit("--zipf-users shapes the rcllm trace; it has no effect on "
                         "mode=full prompts")
    device = torch.device(args.device)
    plans = cache = reuse = None
    if config.mode == "rcllm":
        system, reqs, plans, reuse = rcllm_setup(
            model_config(args.model, args.n_layers), device, args.requests, args.qps,
            config.decode_steps, zipf_users=args.zipf_users)
        model, cfg, cache = system.model, system.cfg, system.rows
    else:
        model, reqs = full_setup(device, args.requests, args.qps,
                                 config.decode_steps, args.prompt_tokens)
        cfg = model.cfg
    if args.warmup:
        serve(model, cfg, config, reqs, plans, cache, reuse)
    out = report(config, *serve(model, cfg, config, reqs, plans, cache, reuse),
                 warmup=args.warmup)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
