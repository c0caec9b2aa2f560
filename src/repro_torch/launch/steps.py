"""Score and retrieval steps of the recsys family: the counterparts of the
JAX package's `launch/steps.py:_recsys_bundle` (`score_step` ->
`score`, `retrieval_step` -> `retrieval_scores`), which the reference
lowers per cell and the port runs.

    # Wide&Deep at its published width, one serve_p99 batch, on the card
    PYTHONPATH=src python -m repro_torch.launch.steps --arch wide-deep --shape serve_p99

    # the same path on the CPU at reduced() size (the kernel's plain version)
    PYTHONPATH=src python -m repro_torch.launch.steps --device cpu --smoke \\
        --arch wide-deep --shape serve_p99

It prints one JSON line: arch, shape, batch, device, the median time per
call (host clock around a synchronised call, after one warm-up call),
peak device memory and the embedding-bag kernel's launches.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import registry as R
from repro_torch.kernels.embedding_bag.ops import bag_sum
from repro_torch.recsys import models as RM


def score_step(model: RM.RecsysModel, batch: RM.Batch) -> torch.Tensor:
    return RM.score(model, batch)


def retrieval_step(model: RM.RecsysModel, batch: RM.Batch) -> torch.Tensor:
    return RM.retrieval_scores(model, batch)


STEPS: Dict[str, Callable] = {"score": score_step, "retrieval": retrieval_step}


def step_of(shape: str) -> Callable:
    step = R.RECSYS_SHAPES[shape].step
    if step not in STEPS:
        raise ValueError(f"{shape}: the {step} step waits for the training slice")
    return STEPS[step]


def time_step(fn: Callable, model: RM.RecsysModel, batch: RM.Batch,
              repeats: int) -> Tuple[torch.Tensor, List[float]]:
    """One warm-up call, then `repeats` timed calls.  -> (last output,
    seconds per timed call)."""
    cuda = model.device.type == "cuda"
    out, times = fn(model, batch), []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(model, batch)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def run(arch: str, shape: str, device="cuda", smoke: bool = False,
        batch: Optional[int] = None, repeats: int = 5) -> Dict:
    """Build `arch` (published width, or reduced() with `smoke`) from a
    generator seeded with 0 on `device`, make one batch of cell `shape`, time its
    step.  -> the launcher's JSON record."""
    dev = torch.device(device)
    fn = step_of(shape)
    cfg = R.get_config(arch, smoke)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = RM.init_params(cfg, gen, dev)
    inputs = R.make_batch(cfg, shape, gen, dev, batch)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = bag_sum.launches
    out, times = time_step(fn, model, inputs, repeats)
    return {"arch": arch, "shape": shape, "step": R.RECSYS_SHAPES[shape].step,
            "batch": int(next(iter(inputs.values())).shape[0]), "smoke": smoke,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "ms_per_call": statistics.median(times) * 1e3, "repeats": repeats,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
            "bag_sum_launches": bag_sum.launches - before,
            "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all())}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="wide-deep", choices=sorted(R.ARCHS))
    ap.add_argument("--shape", default="serve_p99",
                    choices=[s for s, v in R.RECSYS_SHAPES.items() if v.step in STEPS])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced() config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=None, help="replace the cell's batch size")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    rep = run(args.arch, args.shape, args.device, args.smoke, args.batch, args.repeats)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
