"""The hillclimbs: four LM cells, each a chain of hypothesis ->
change -> modelled step time, the counterpart of the JAX package's
`launch/perf_iterations.py`.

Every figure here is modelled at H100 SXM peaks (`launch.roofline`: 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, 900 GB/s NVLink) by
`roofline_analytic.lm_analytic`'s closed forms on a 16 x 16 world of
cards (256 cards, 16 of them data parallel; cell C also at 64 x 4), and
none is measured.  The cells and their iterations are the reference's:

  A nemotron-4-15b x prefill_32k: the paper's own technique (selective
    recomputation), then causal block pairing, sequence-parallel
    boundaries and overlapped collectives;
  B kimi-k2-1t-a32b x train_4k: sequence parallelism, overlap, pairing;
  C moonshot-v1-16b-a3b x train_4k: the mesh reshaped to 64 x 4, then
    sequence parallelism, overlap and pairing;
  D gemma-7b x long_500k: the paper's read set on long-context decode.

The reference chose B and C by its own chip's terms.  At H100 peaks each
cell's `selection` says whether that choice still holds, and each
iteration keeps the reference's `confirmed` test, whatever it gives.
Causal block pairing prices the reference's masked tiles: the port's
attention is banded already, so its `LMConfig` has no such flag.

Where a change alters the traced step, a probe (`probe`) runs the cell's
dry run (`launch.dryrun.trace_cell`: one rank of a fake world, fake
tensors) and records its argument and temp bytes and collectives; the
reference compiled the cell with XLA instead.  Results land in
``results/perf_torch/hillclimbs.json``.

    PYTHONPATH=src python -m repro_torch.launch.perf_iterations [--no-probe] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Optional, Sequence

from repro_torch.configs import registry as R
from repro_torch.launch import dryrun as DRY
from repro_torch.launch.roofline_analytic import lm_analytic

POD = dict(n_chips=256, data_par=16)        # the 16 x 16 world of every cell


@contextlib.contextmanager
def override(arch: str, cfg=None):
    """`cfg` installed as `registry.ARCHS[arch]` while the block runs (no
    change where it is None); the old config is back afterwards, also when
    the block raises."""
    if cfg is None:
        yield
        return
    old = R.ARCHS[arch]
    R.ARCHS[arch] = cfg
    try:
        yield
    finally:
        R.ARCHS[arch] = old


def probe(arch: str, shape: str, mesh_shape: Sequence[int] = (16, 16), cfg_override=None,
          **cut) -> dict:
    """The reference's `compile_probe`: the cell's dry run on a fake world
    of `mesh_shape` (`cut`: `layers`, `batch_size`, `seq` as
    `trace_cell` takes them), `cfg_override` standing in for the arch's
    config.  -> the rank's argument and modelled temp bytes, its
    collectives and its traced FLOPs and bytes."""
    t0 = time.time()
    with override(arch, cfg_override):
        rec = DRY.trace_cell(arch, shape, mesh_shape, **cut)
    mem, coll = rec["memory"], rec["collectives"]
    return {"trace_s": round(time.time() - t0, 1), "device": rec["device"],
            "mesh_shape": rec["mesh_shape"], "cuts": rec["cuts"],
            "temp_gb": round(mem["temp_size"] / 1e9, 2),
            "arg_gb": round(mem["argument_size"] / 1e9, 2),
            "arg_bytes": mem["argument_size"],
            "collective_counts": coll["counts"],
            "collective_bytes": coll["total_bytes"],
            "flops_per_device": rec["flops_per_device"],
            "bytes_per_device": rec["bytes_per_device"]}


def fmt(t: dict) -> str:
    """One iteration's terms in ms, four significant digits."""
    ms = {k: t[k + "_s"] * 1e3 for k in ("compute", "memory", "collective", "overlapped")}
    return (f"comp={ms['compute']:.4g}ms mem={ms['memory']:.4g}ms "
            f"coll={ms['collective']:.4g}ms -> step≈{ms['overlapped']:.4g}ms "
            f"[{t['bottleneck']}]")


def _cell(arch: str, shape: str):
    return R.ARCHS[arch], R.shapes_of(arch)[shape].dims


def _share(part: float, whole: float) -> str:
    return f"{100 * part / whole:.1f}%"


def cell_A(out: dict, probe_on: bool) -> None:
    arch, shape = "nemotron-4-15b", "prefill_32k"
    cfg, dims = _cell(arch, shape)
    L = cfg.n_layers
    log = []
    base = lm_analytic(cfg, "prefill", dims, **POD)
    log.append({"iter": 0, "name": "baseline (full prefill, masked tiles)", "terms": base})

    t1 = lm_analytic(cfg, "prefill", dims, selective_recompute=0.37, **POD)
    log.append({
        "iter": 1, "name": "RcLLM selective recomputation (paper, r=0.37)",
        "hypothesis": "layers 1..L-1 run dense + attention only for the recompute set "
                      "(instruction, heavy hitters, window and misses: r = 0.37 of the "
                      f"tokens); compute term x (1 + r (L-1)) / L = {(1 + 0.37 * (L - 1)) / L:.4f}"
                      f" at L = {L}",
        "terms": t1,
        "confirmed": t1["compute_s"] / base["compute_s"] < 0.45})

    t2 = lm_analytic(cfg, "prefill", dims, selective_recompute=0.37,
                     causal_block_pairing=True, **POD)
    paired = 1 - t2["flops_per_device"] / t1["flops_per_device"]
    log.append({
        "iter": 2, "name": "+ causal block pairing (beyond-paper)",
        "hypothesis": "the reference's baseline masks acausal tiles but computes them; "
                      "enumerating live (q, kv) tile pairs cuts attention-score FLOPs to "
                      f"0.55x, {_share(paired, 1)} of the step's FLOPs here (the port's "
                      "banded attention has made this cut already)",
        "terms": t2,
        "confirmed": t2["compute_s"] < t1["compute_s"]})

    t3 = lm_analytic(cfg, "prefill", dims, selective_recompute=0.37,
                     causal_block_pairing=True, seq_parallel=True, overlap_collectives=True,
                     **POD)
    log.append({
        "iter": 3, "name": "+ SP boundaries + comm/compute overlap",
        "hypothesis": "prefill TP all-reduces become RS/AG over seq-sharded boundaries "
                      "(0.5x wire) and overlap the per-layer matmuls; step -> the largest "
                      f"term, {t3['bottleneck']} ({1e3 * t3['overlapped_s']:.4g} ms)",
        "terms": t3,
        "confirmed": t3["overlapped_s"] < t2["serial_s"]})
    if probe_on:
        # the reference's probe config less its `causal_block_pairing=True`:
        # the port's banded attention is what that flag turns on
        cfg_bp = dataclasses.replace(cfg, attn_q_chunk=2048, attn_kv_chunk=2048)
        log.append({"iter": "evidence",
                    "name": "trace probe: banded (block-paired) attention traces (2048-tiles)",
                    "probe": probe(arch, shape, cfg_override=cfg_bp)})
    out["A_nemotron_prefill_32k"] = {
        "selection": "most representative of the paper's technique",
        "final_speedup_vs_baseline": base["serial_s"] / log[3]["terms"]["overlapped_s"],
        "iterations": log}


def _train_pod():
    """The assigned LM archs' train_4k terms on the 16 x 16 world."""
    return {a: lm_analytic(R.ARCHS[a], "train", R.LM_SHAPES["train_4k"].dims, **POD)
            for a in R.ASSIGNED if R.family_of(a) == "lm"}


def cell_B(out: dict, probe_on: bool) -> None:
    arch, shape = "kimi-k2-1t-a32b", "train_4k"
    cfg, dims = _cell(arch, shape)
    log = []
    base = lm_analytic(cfg, "train", dims, **POD)
    log.append({"iter": 0, "name": "baseline", "terms": base})

    t1 = lm_analytic(cfg, "train", dims, seq_parallel=True, **POD)
    # the tensor-parallel all-reduces' bytes: twice what sequence parallelism saves
    tp = 2 * (base["collective_bytes_per_device"] - t1["collective_bytes_per_device"])
    log.append({
        "iter": 1, "name": "sequence-parallel TP boundaries",
        "hypothesis": "4 all-reduces of (B_loc, S, D) a layer are "
                      f"{_share(tp, base['collective_bytes_per_device'])} of the wire "
                      f"({tp / 1e9:.1f} GB a device a step); RS + AG over seq-sharded "
                      "residuals halves them: collective term x"
                      f"{1 - tp / 2 / base['collective_bytes_per_device']:.3f}",
        "terms": t1,
        "confirmed": abs(t1["collective_s"] / base["collective_s"] - 0.5 - 0.0) < 0.2})

    t2 = lm_analytic(cfg, "train", dims, seq_parallel=True, overlap_collectives=True, **POD)
    log.append({
        "iter": 2, "name": "+ async collectives overlapped with compute",
        "hypothesis": f"the remaining {1e3 * t1['collective_s']:.4g} ms of wire hides "
                      f"behind {1e3 * t1['compute_s']:.4g} ms of compute (collectives on "
                      "their own stream); step -> max(comp, mem, coll) = comp, "
                      f"{_share(t1['compute_s'], t1['serial_s'])} of the serial step; the "
                      "reference's test asks for at most 0.65 of it",
        "terms": t2,
        "confirmed": t2["overlapped_s"] <= t1["serial_s"] * 0.65})

    t3 = lm_analytic(cfg, "train", dims, seq_parallel=True, overlap_collectives=True,
                     causal_block_pairing=True, **POD)
    att = (t2["flops_per_device"] - t3["flops_per_device"]) / 0.45
    log.append({
        "iter": 3, "name": "+ causal block pairing",
        "hypothesis": "with wire hidden, compute is dominant; attention-score tiles are "
                      f"{_share(att, t2['flops_per_device'])} of the train FLOPs at "
                      f"S={dims['seq']} -> expect {_share(0.45 * att, t2['flops_per_device'])}"
                      " off the compute term",
        "terms": t3,
        "confirmed": t3["compute_s"] < t2["compute_s"]})
    if probe_on:
        log.append({"iter": "evidence", "name": "trace probe: baseline collective schedule",
                    "probe": probe(arch, shape)})
    train = _train_pod()
    top = max(train, key=lambda a: train[a]["collective_s"])
    out["B_kimi_train_4k"] = {
        "selection": "the reference's pick, the most collective-bound train cell: at H100 "
                     f"peaks its collective term ({1e3 * base['collective_s']:.4g} ms) is "
                     + ("the largest" if top == arch else f"below {top}'s")
                     + " of the train_4k cells, but the cell is "
                     f"{base['bottleneck']}-bound (collectives "
                     f"{_share(base['collective_s'], base['serial_s'])} of the serial step)",
        "final_speedup_vs_baseline": base["serial_s"] / log[3]["terms"]["overlapped_s"],
        "iterations": log}


def cell_C(out: dict, probe_on: bool) -> None:
    arch, shape = "moonshot-v1-16b-a3b", "train_4k"
    cfg, dims = _cell(arch, shape)
    log = []
    base = lm_analytic(cfg, "train", dims, **POD)
    log.append({"iter": 0, "name": "baseline mesh (16,16)", "terms": base})

    wide = dict(POD, data_par=64)
    t1 = lm_analytic(cfg, "train", dims, **wide)
    log.append({
        "iter": 1, "name": "mesh reshape (16,16) -> (64,4)",
        "hypothesis": f"d_model={cfg.d_model} is narrow for TP=16 ({cfg.d_model // 16} "
                      "columns a shard, and each layer's all-reduce of (B_loc, S, D) is "
                      "paid by every model rank); TP=4/DP=64 cuts the activation wire 4x "
                      f"while the {cfg.moe.n_experts} experts still shard over model=4",
        "terms": t1,
        "confirmed": t1["collective_s"] < base["collective_s"] * 0.3})

    t2 = lm_analytic(cfg, "train", dims, seq_parallel=True, **wide)
    log.append({
        "iter": 2, "name": "+ sequence-parallel boundaries",
        "hypothesis": "remaining TP wire halves again",
        "terms": t2, "confirmed": t2["collective_s"] < t1["collective_s"]})

    t3 = lm_analytic(cfg, "train", dims, seq_parallel=True, overlap_collectives=True,
                     causal_block_pairing=True, **wide)
    log.append({
        "iter": 3, "name": "+ overlap + block pairing",
        "terms": t3,
        "confirmed": t3["overlapped_s"] < t2["serial_s"]})
    if probe_on:
        log.append({"iter": "evidence",
                    "name": "trace probe: (64,4) mesh traces + memory",
                    "probe": probe(arch, shape, mesh_shape=(64, 4))})
    train = _train_pod()
    fr = {a: t["roofline_fraction"] for a, t in train.items()}
    share = {a: t["collective_s"] / t["serial_s"] for a, t in train.items()}
    worst = min(fr.values())
    holds = fr[arch] == worst and sum(v == worst for v in fr.values()) == 1
    out["C_moonshot_train_4k"] = {
        "selection": "the reference's pick, the worst roofline fraction: at H100 peaks "
                     + (f"it holds ({fr[arch]:.3f})" if holds else
                        f"it does not hold (fraction {fr[arch]:.3f}; the train_4k cells' "
                        f"lowest is {worst:.3f}, highest {max(fr.values()):.3f})")
                     + f"; its collectives are {_share(share[arch], 1)} of the serial step, "
                     + ("the largest share" if max(share, key=share.get) == arch else
                        "not the largest share") + " of the train_4k cells",
        "final_speedup_vs_baseline": base["serial_s"] / log[3]["terms"]["overlapped_s"],
        "iterations": log}


def cell_D(out: dict) -> None:
    """The bonus cell: gemma-7b x long_500k, the paper's selective read
    set applied to long-context decode."""
    arch, shape = "gemma-7b", "long_500k"
    cfg, dims = _cell(arch, shape)
    log = []
    base = lm_analytic(cfg, "decode", dims, **POD)
    log.append({"iter": 0, "name": "baseline (full KV read)", "terms": base})
    rd = (256 + int(0.05 * dims["seq"])) / dims["seq"]   # window ∪ 5% HH
    t1 = lm_analytic(cfg, "decode", dims, selective_decode_read=rd, **POD)
    p_local = cfg.param_count() * 2 / POD["n_chips"]
    kv = base["bytes_per_device"] - p_local
    log.append({
        "iter": 1, "name": f"RcLLM selective read set (window 256 + 5% HH, rd={rd:.3f})",
        "hypothesis": f"decode at B={dims['batch']}/S={dims['seq']} is "
                      f"{base['bottleneck']}-bound (the KV read is {kv / p_local:.1f}x the "
                      "parameter read); restricting reads to window ∪ heavy hitters cuts "
                      f"the kv term {1 / rd:.1f}x, leaving the parameter-read floor",
        "terms": t1,
        "confirmed": t1["memory_s"] < base["memory_s"] * 0.5})
    out["D_gemma_long_500k"] = {
        "selection": "bonus: paper technique on the long-context decode cell",
        "final_speedup_vs_baseline": base["serial_s"] / t1["serial_s"],
        "iterations": log}


def main(probe: bool = True, out_dir: str = "results/perf_torch") -> dict:
    out: dict = {}
    cell_A(out, probe)
    cell_B(out, probe)
    cell_C(out, probe)
    cell_D(out)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hillclimbs.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print("modelled at H100 SXM peaks on 256 cards, never measured")
    for cell, rec in out.items():
        print(f"== {cell} ({rec['selection']}) ==")
        for it in rec["iterations"]:
            if "terms" in it:
                print(f"  [{it['iter']}] {it['name']}: {fmt(it['terms'])}"
                      + (f"  confirmed={it['confirmed']}" if "confirmed" in it else ""))
            else:
                print(f"  [{it['iter']}] {it['name']}: {it['probe']}")
        print(f"  final speedup vs baseline: {rec['final_speedup_vs_baseline']:.2f}x")
    return out


def _main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-probe", action="store_true", help="the analytic tables only")
    ap.add_argument("--out", default="results/perf_torch")
    args = ap.parse_args(argv)
    main(probe=not args.no_probe, out_dir=args.out)


if __name__ == "__main__":
    _main()
