"""Serving steps of the LM and recsys families: the counterparts of the
JAX package's `launch/steps.py` bundles, which the reference lowers per
cell and the port runs.  LM (`_lm_bundle`): `prefill_step` ->
`transformer.prefill`, `decode_step` -> `transformer.decode_step`.
Recsys (`_recsys_bundle`): `score_step` -> `score`, `retrieval_step` ->
`retrieval_scores`.

    # Wide&Deep at its published width, one serve_p99 batch, on the card
    PYTHONPATH=src python -m repro_torch.launch.steps --arch wide-deep --shape serve_p99

    # gemma-7b at its published width and depth: one 32,768-token prompt
    # (no full LM cell fits one card, so --batch / --seq cut it)
    PYTHONPATH=src python -m repro_torch.launch.steps --arch gemma-7b --shape prefill_32k --batch 1

    # the same paths on the CPU at reduced() size (plain versions)
    PYTHONPATH=src python -m repro_torch.launch.steps --device cpu --smoke \\
        --arch wide-deep --shape serve_p99
    PYTHONPATH=src python -m repro_torch.launch.steps --device cpu --smoke \\
        --arch moonshot-v1-16b-a3b --shape decode_32k

It prints one JSON line: arch, shape, the dims run, device, the median
time per call (host clock around a synchronised call, after one warm-up
call), tokens/s for an LM cell, peak device memory and the
embedding-bag kernel's launches.  A decode call writes its token's k / v
into the cell's cache at the same positions every time.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs import registry as R
from repro_torch.configs.base import LMConfig
from repro_torch.kernels.embedding_bag.ops import bag_sum
from repro_torch.models import transformer as TT
from repro_torch.recsys import models as RM

Model = Union[TT.Transformer, RM.RecsysModel]
ALL_SHAPES = {**R.LM_SHAPES, **R.RECSYS_SHAPES}


def prefill_step(model: TT.Transformer, batch: Dict) -> Tuple[torch.Tensor, TT.Cache]:
    return TT.prefill(model, batch["tokens"])


def decode_step(model: TT.Transformer, batch: Dict) -> Tuple[torch.Tensor, TT.Cache]:
    return TT.decode_step(model, batch["tokens"], batch["cache"], batch["positions"])


def score_step(model: RM.RecsysModel, batch: RM.Batch) -> torch.Tensor:
    return RM.score(model, batch)


def retrieval_step(model: RM.RecsysModel, batch: RM.Batch) -> torch.Tensor:
    return RM.retrieval_scores(model, batch)


STEPS: Dict[str, Callable] = {"prefill": prefill_step, "decode": decode_step,
                              "score": score_step, "retrieval": retrieval_step}


def step_of(shape: str) -> Callable:
    step = ALL_SHAPES[shape].step
    if step not in STEPS:
        raise ValueError(f"{shape}: the {step} step waits for the training slice")
    return STEPS[step]


def logits_of(out) -> torch.Tensor:
    """The step's scores: an LM step's logits (its cache aside)."""
    return out[0] if isinstance(out, tuple) else out


def time_step(fn: Callable, model: Model, batch: Dict,
              repeats: int) -> Tuple[object, List[float]]:
    """One warm-up call, then `repeats` timed calls.  -> (last output,
    seconds per timed call).  Each output is dropped before the next call
    (an LM prefill's cache is as large as the model at 32k tokens)."""
    cuda = model.device.type == "cuda"
    out, times = fn(model, batch), []
    for _ in range(repeats):
        out = None
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(model, batch)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def init_model(cfg, generator: torch.Generator, device) -> Model:
    if isinstance(cfg, LMConfig):
        return TT.init_params(cfg, generator, device)
    return RM.init_params(cfg, generator, device)


def run(arch: str, shape: str, device="cuda", smoke: bool = False,
        batch: Optional[int] = None, repeats: int = 5, seq: Optional[int] = None) -> Dict:
    """Build `arch` (published width, or reduced() with `smoke`) from a
    generator seeded with 0 on `device`, make one batch of cell `shape`
    (`batch`, and for an LM cell `seq`, replacing its dims), time its
    step.  -> the launcher's JSON record."""
    dev = torch.device(device)
    fn = step_of(shape)
    cfg = R.get_config(arch, smoke)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_model(cfg, gen, dev)
    inputs = R.make_batch(cfg, shape, gen, dev, batch, seq)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = bag_sum.launches
    out, times = time_step(fn, model, inputs, repeats)
    scores = logits_of(out)
    spec = ALL_SHAPES[shape]
    rep = {"arch": arch, "shape": shape, "step": spec.step,
           "batch": int(next(iter(inputs.values())).shape[0]), "smoke": smoke,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "ms_per_call": statistics.median(times) * 1e3, "repeats": repeats,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
           "bag_sum_launches": bag_sum.launches - before,
           "out_shape": list(scores.shape), "finite": bool(torch.isfinite(scores).all())}
    if spec.step in ("prefill", "decode"):
        s = inputs["cache"]["k"].shape[2] if spec.step == "decode" else inputs["tokens"].shape[1]
        tokens = rep["batch"] * (s if spec.step == "prefill" else 1)
        rep.update(seq=int(s), tokens_per_s=tokens / statistics.median(times))
    return rep


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="wide-deep", choices=sorted(R.ARCHS))
    ap.add_argument("--shape", default="serve_p99",
                    choices=[s for s, v in ALL_SHAPES.items() if v.step in STEPS])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced() config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=None, help="replace the cell's batch size")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace an LM cell's sequence length (prompt or cache)")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.shape not in R.shapes_of(args.arch):
        ap.error(f"--shape {args.shape} is not a cell of {args.arch} "
                 f"({', '.join(R.shapes_of(args.arch))})")
    if args.seq is not None and R.family_of(args.arch) != "lm":
        ap.error("--seq replaces an LM cell's sequence length")
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    rep = run(args.arch, args.shape, args.device, args.smoke, args.batch, args.repeats,
              args.seq)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
