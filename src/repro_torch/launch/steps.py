"""Steps of the LM, recsys and GNN families: the counterparts of the JAX
package's `launch/steps.py` bundles, which the reference lowers per cell
and the port runs.  LM (`_lm_bundle`): `prefill_step` ->
`transformer.prefill`, `decode_step` -> `transformer.decode_step`, and
the train step (`transformer.loss_fn`, then `cfg.optimizer`: AdamW, or
Adafactor for kimi-k2).  Recsys (`_recsys_bundle`): `score_step` ->
`score`, `retrieval_step` -> `retrieval_scores`, the train step
(`train_loss`, AdamW).  GNN (`_gnn_bundle`): the SchNet train step
(`gnn.schnet.train_loss`, AdamW) of full_graph_sm, minibatch_lg and
molecule; ogb_products needs more than one card and is refused.

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

    # one LM train step cell on the card: published width, depth and
    # batch cut (every cut is printed under "cuts")
    PYTHONPATH=src python -m repro_torch.launch.steps --arch gemma-7b --shape train_4k \
        --layers 2 --batch 1
    PYTHONPATH=src python -m repro_torch.launch.steps --device cpu --smoke \
        --arch schnet --shape molecule

It prints one JSON line: arch, shape, the dims run and every cut, device,
the median time per call (host clock around a synchronised call, after
one warm-up call; a train cell runs `--steps` steps and reports each
step's loss, the median of the steps after the first), tokens/s for an
LM cell, peak device memory and the kernels' launches.  A decode call
writes its token's k / v into the cell's cache at the same positions
every time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs import registry as R
from repro_torch.configs.base import GNNConfig, LMConfig
from repro_torch.gnn import schnet as G
from repro_torch.kernels.embedding_bag.ops import bag_backward, bag_sum
from repro_torch.kernels.flash_attention.ops import mha_flash_bwd
from repro_torch.models import transformer as TT
from repro_torch.recsys import models as RM
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import TrainConfig, make_train_step, trainable

Model = Union[TT.Transformer, RM.RecsysModel, G.SchNet]
ALL_SHAPES = {**R.LM_SHAPES, **R.RECSYS_SHAPES, **R.GNN_SHAPES}


def prefill_step(model: TT.Transformer, batch: Dict) -> Tuple[torch.Tensor, TT.Cache]:
    return TT.prefill(model, batch["tokens"])


def decode_step(model: TT.Transformer, batch: Dict) -> Tuple[torch.Tensor, TT.Cache]:
    return TT.decode_step(model, batch["tokens"], batch["cache"], batch["positions"])


def score_step(model: RM.RecsysModel, batch: RM.Batch) -> torch.Tensor:
    return RM.score(model, batch)


def retrieval_step(model: RM.RecsysModel, batch: RM.Batch) -> torch.Tensor:
    return RM.retrieval_scores(model, batch)


def lm_loss(model: TT.Transformer, batch: Dict) -> torch.Tensor:
    return TT.loss_fn(model, batch["tokens"], batch["labels"])[0]


def loss_of(model: Model) -> Callable:
    """The family's train loss, (model, batch) -> scalar."""
    if isinstance(model, TT.Transformer):
        return lm_loss
    if isinstance(model, G.SchNet):
        return G.train_loss
    return RM.train_loss


def optimizer_of(model: Model, named) -> OPT.ClippedOptimizer:
    """The reference's choice: `cfg.optimizer` for an LM (AdamW, or
    Adafactor for kimi-k2), AdamW for recsys and GNN, default
    hyperparameters."""
    name = model.cfg.optimizer if isinstance(model, TT.Transformer) else "adamw"
    return OPT.get(name, named)


def make_train_cell(model: Model, microbatches: int = 1) -> Callable[[Dict], Dict]:
    """The reference's `train_step` for `model`: -> step(batch) ->
    {"loss", "gnorm"}, the value and gradient of the family's loss in
    `microbatches` microbatches, then one update in place by the family's
    optimizer (made here, so its state lives across the steps).  The
    parameters must take gradients (`trainable`)."""
    opt = optimizer_of(model, list(model.named_parameters()))
    return make_train_step(loss_of(model), TrainConfig(microbatches=microbatches), model, opt)


def train_step(model: Model, batch: Dict) -> Dict[str, torch.Tensor]:
    """One train step of `model` on `batch` from a fresh optimizer state
    (`make_train_cell` keeps one across steps)."""
    return make_train_cell(model)(batch)


STEPS: Dict[str, Callable] = {"prefill": prefill_step, "decode": decode_step,
                              "score": score_step, "retrieval": retrieval_step,
                              "train": train_step}


def step_of(shape: str) -> Callable:
    R.refuse_multi_card(shape)
    return STEPS[ALL_SHAPES[shape].step]


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


def init_model(cfg, generator: torch.Generator, device, shape: Optional[str] = None) -> Model:
    """A model of `cfg` with seeded random weights; a SchNet for a graph
    cell gets the cell's feature width and class count."""
    if isinstance(cfg, LMConfig):
        return TT.init_params(cfg, generator, device)
    if isinstance(cfg, GNNConfig):
        d = R.GNN_SHAPES[shape].dims
        graph = {} if "d_feat" not in d else dict(d_feat=d["d_feat"], n_classes=d["n_classes"])
        return G.init_params(cfg, generator, device, **graph)
    return RM.init_params(cfg, generator, device)


def cut_config(cfg, layers: Optional[int]):
    """`cfg` with its depth cut to `layers` (LM only)."""
    if layers is None:
        return cfg
    if not isinstance(cfg, LMConfig):
        raise ValueError("--layers cuts an LM's depth")
    return dataclasses.replace(cfg, n_layers=layers)


def run_train(model: Model, inputs: Dict, steps: int,
              microbatches: int = 1) -> Tuple[List[float], List[float], List[float]]:
    """`steps` train steps of `model` on one batch, each timed on the host
    clock with the card synchronised.  -> (losses, gradient norms,
    seconds per step); the parameters are frozen again after."""
    cuda = next(model.parameters()).is_cuda
    losses, norms, times = [], [], []
    with trainable(model):
        step = make_train_cell(model, microbatches)
        for _ in range(steps):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(inputs)
            loss, gnorm = float(m["loss"]), float(m["gnorm"])
            if cuda:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            norms.append(gnorm)
    return losses, norms, times


# the kernels a cell's step can launch, by the name its JSON counts them under
LAUNCH_COUNTS = {"bag_sum": bag_sum, "bag_backward": bag_backward,
                 "flash_bwd": mha_flash_bwd}


def run(arch: str, shape: str, device="cuda", smoke: bool = False,
        batch: Optional[int] = None, repeats: int = 5, seq: Optional[int] = None,
        layers: Optional[int] = None, steps: int = 3, microbatches: int = 1) -> Dict:
    """Build `arch` (published width, or reduced() with `smoke`; `layers`
    cuts an LM's depth) from a generator seeded with 0 on `device`, make
    one batch of cell `shape` (`batch`, and for an LM cell `seq`,
    replacing its dims), time its step (a train cell: `steps` steps on
    that batch, in `microbatches` microbatches).  -> the launcher's JSON
    record."""
    dev = torch.device(device)
    fn = step_of(shape)
    cfg = cut_config(R.get_config(arch, smoke), layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_model(cfg, gen, dev, shape)
    inputs = R.make_batch(cfg, shape, gen, dev, batch, seq)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = {k: f.launches for k, f in LAUNCH_COUNTS.items()}
    spec = ALL_SHAPES[shape]
    first = next(iter(inputs.values()))
    cuts = {k: v for k, v in (("n_layers", layers), ("batch", batch), ("seq", seq))
            if v is not None}
    rep = {"arch": arch, "shape": shape, "step": spec.step,
           "batch": int(first.shape[0]), "smoke": smoke, "cuts": cuts,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if spec.step == "train":
        losses, norms, times = run_train(model, inputs, steps, microbatches)
        rep.update(steps=steps, microbatches=microbatches, loss=losses, gnorm=norms,
                   step_ms=[t * 1e3 for t in times],
                   ms_per_call=statistics.median(times[1:] or times) * 1e3,
                   finite=all(map(math.isfinite, losses + norms)))
        if isinstance(cfg, LMConfig):
            rep.update(seq=int(inputs["tokens"].shape[1]), n_layers=cfg.n_layers,
                       optimizer=cfg.optimizer)
            rep["tokens_per_s"] = rep["batch"] * rep["seq"] / (rep["ms_per_call"] / 1e3)
    else:
        out, times = time_step(fn, model, inputs, repeats)
        scores = logits_of(out)
        rep.update(ms_per_call=statistics.median(times) * 1e3, repeats=repeats,
                   out_shape=list(scores.shape), finite=bool(torch.isfinite(scores).all()))
    rep["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    rep.update({f"{k}_launches": f.launches - before[k] for k, f in LAUNCH_COUNTS.items()})
    if spec.step in ("prefill", "decode"):
        s = inputs["cache"]["k"].shape[2] if spec.step == "decode" else inputs["tokens"].shape[1]
        tokens = rep["batch"] * (s if spec.step == "prefill" else 1)
        rep.update(seq=int(s), tokens_per_s=tokens / statistics.median(times))
    return rep



def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="wide-deep", choices=sorted(R.ARCHS))
    ap.add_argument("--shape", default="serve_p99",
                    choices=[s for s in ALL_SHAPES if s not in R.MULTI_CARD_CELLS])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced() config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=None, help="replace the cell's batch size")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace an LM cell's sequence length (prompt or cache)")
    ap.add_argument("--layers", type=int, default=None, help="cut an LM's depth")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3, help="train steps of a train cell")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="a train cell's batch in this many microbatches")
    args = ap.parse_args(argv)
    if args.shape not in R.shapes_of(args.arch):
        ap.error(f"--shape {args.shape} is not a cell of {args.arch} "
                 f"({', '.join(R.shapes_of(args.arch))})")
    if (args.seq is not None or args.layers is not None) and R.family_of(args.arch) != "lm":
        ap.error("--seq and --layers cut an LM cell")
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    rep = run(args.arch, args.shape, args.device, args.smoke, args.batch, args.repeats,
              args.seq, args.layers, args.steps, args.microbatches)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
