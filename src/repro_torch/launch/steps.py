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

`build(arch, shape, mesh, ...)` is the counterpart of the reference's
`build` on a mesh, for every family: this rank's model, its block of a
global batch and the step, which runs inside ``sharding.ctx.axes(mesh)``.
LM: the rank's shard (`lm_param_specs`, mode "train" for the train step,
"serve" otherwise; a kv head's Dh cut where tp does not divide the kv
heads), its rows and cache block (`lm_input_specs`, `lm_cache_spec`,
whose sequence may split over ``model`` or over every axis), the train
step's optimizer state as `lm_opt_state_specs` says (`train_layout`).
Recsys: the rank's rows of every split table (`shard_recsys_params` /
`init_sharded_recsys`), its rows of the batch (`recsys_input_specs`)
and AdamW on `recsys_train_layout`.  GNN: the whole model on every
rank, a graph's edges cut over every axis (`gnn_input_specs`; padded by
`gnn.schnet.pad_edges` past 1,000,000 edges the axes do not divide) or
molecules over the data axis, AdamW with replicated moments.  The
reference lowers that bundle; the port runs it on the ranks of a
`torch.distributed` group (`launch.train`, the distributed-training
example, `chip_smoke.py` phases 2m and 2n).

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
import copy
import dataclasses
import json
import math
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs import registry as R
from repro_torch.configs.base import GNNConfig, LMConfig
from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.gnn import schnet as G
from repro_torch.kernels.embedding_bag.ops import bag_backward, bag_sum
from repro_torch.kernels.flash_attention.ops import mha_flash_bwd
from repro_torch.models import transformer as TT
from repro_torch.recsys import models as RM
from repro_torch.sharding import ctx as CTX
from repro_torch.sharding import specs as SPECS
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



# ------------------------------------------------------- LM steps on a mesh
def cut_input(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of an input `x` under `spec`: a dimension over the
    data axis keeps the rank's share of its rows, one over ``model`` its
    share of the heads or positions, one over several axes (a sequence or
    edges over every axis) its block counted over them in mesh order
    (contiguous shares, in coordinate order)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, c = SPECS.block_index(mesh, ax if isinstance(ax, tuple) else (ax,))
        if x.shape[dim] % n:
            raise ValueError(f"input spec {spec}: dimension {dim} of {tuple(x.shape)} does "
                             f"not split into {n} blocks")
        step = x.shape[dim] // n
        x = x.narrow(dim, c * step, step)
    return x


def rank_inputs(cfg: LMConfig, mesh, step: str, batch: Dict) -> Dict:
    """This rank's block of a global LM batch (`lm_input_specs`): prefill and
    train rows over the data axis; a decode batch's rows where the data
    axis divides them (else every data rank holds them all), its cache's
    kv heads over the model axis, or its sequence over ``model`` (tp does
    not divide the kv heads) or over every axis (the data axis does not
    divide the batch)."""
    dims = {"batch": int(batch["tokens"].shape[0])}
    if step == "decode":
        dims["seq"] = int(batch["cache"]["k"].shape[2])
    specs = SPECS.lm_input_specs(cfg, mesh, step, dims)
    out = {}
    for k, v in batch.items():
        if k == "cache":
            out[k] = {n: cut_input(v[n], specs["cache"][n], mesh).contiguous() for n in v}
        else:
            out[k] = cut_input(v, specs[k], mesh)
    return out


def data_sharded(cfg: LMConfig, mesh, step: str, batch: int) -> bool:
    """Whether a step's rows are cut over the data axis (`rank_inputs`)."""
    spec = SPECS.lm_input_specs(cfg, mesh, step, {"batch": batch, "seq": 1})["tokens"]
    return spec[0] is not None


def grow_cache(cache: TT.Cache, model: TT.Transformer, extra: int,
               dp_batch: bool = True) -> TT.Cache:
    """A rank's prefill cache with `extra` empty positions after the
    prompt's, in the decode layout: the blocks of a sequence split over
    the ranks (`transformer.seq_axes`) are gathered, padded with zeros and
    cut again, since a longer sequence splits at other positions."""
    axes = TT.seq_axes(model, dp_batch)
    spec = (None, None, axes or None)
    out = {}
    for name, x in cache.items():
        x = CTX.all_gather(x, axes, 2)
        x = torch.cat([x, x.new_zeros(x.shape[:2] + (extra,) + x.shape[3:])], dim=2)
        out[name] = cut_input(x, spec, CTX.current()).contiguous()
    return out


@dataclasses.dataclass
class MeshBundle:
    """One cell on a mesh: the rank's `model` (shard), its `inputs` block
    and `fn(inputs)`, the step run inside the mesh (a train step keeps its
    optimizer state across calls).  ``dp_batch``: the rows are cut over
    the data axis."""

    mesh: object
    step: str
    model: Model
    inputs: Dict
    fn: Callable[[Dict], object]
    optimizer: Optional[OPT.ClippedOptimizer] = None
    dp_batch: bool = True


def rank_model(cfg: LMConfig, mesh, step: str, device, source=None,
               generator: Optional[torch.Generator] = None) -> TT.Transformer:
    """This rank's shard: cut from `source` (a whole model or the
    reference's numpy tree) or drawn from `generator` one whole parameter
    at a time, under mode "train" for the train step and "serve" else."""
    mode = "train" if step == "train" else "serve"
    if source is not None:
        return SPECS.shard_lm_params(source, cfg, mesh, device=device, mode=mode)
    return SPECS.init_sharded_params(cfg, mesh, generator, device, mode=mode,
                                     token_embed=False)[0]


def mesh_fn(model: TT.Transformer, mesh, step: str, batch_rows: int,
            train_cfg: Optional[TrainConfig] = None):
    """-> (the step as fn(rank inputs), the train step's optimizer or None)."""
    dp_batch = data_sharded(model.cfg, mesh, step, batch_rows)
    if step == "prefill":
        def fn(inputs):
            with CTX.axes(mesh):
                return TT.prefill(model, inputs["tokens"], dp_batch)
        return fn, None
    if step == "decode":
        def fn(inputs):
            with CTX.axes(mesh):
                return TT.decode_step(model, inputs["tokens"], inputs["cache"],
                                      inputs["positions"], dp_batch)
        return fn, None
    cfg = model.cfg
    # no train_cfg: the cell's optimizer at its default hyperparameters
    # (`make_train_cell`'s, the reference bundle's)
    kw = {} if train_cfg is None else {"lr": train_cfg.lr}
    train_cfg = train_cfg or TrainConfig(optimizer=cfg.optimizer)
    with CTX.axes(mesh):
        opt = OPT.get(train_cfg.optimizer, list(model.named_parameters()), **kw,
                      layout=SPECS.train_layout(cfg, mesh, train_cfg.optimizer))
    err = ([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in model.parameters()] if train_cfg.grad_compression == "topk" else None)
    step_fn = make_train_step(lm_loss, train_cfg, model, opt, err)

    def fn(inputs):
        with CTX.axes(mesh), trainable(model):
            return step_fn(inputs)
    return fn, opt


def build(arch: str, shape: str, mesh, device="cuda", smoke: bool = False, source=None,
          generator: Optional[torch.Generator] = None, batch: Optional[Dict] = None,
          batch_size: Optional[int] = None, seq: Optional[int] = None,
          layers: Optional[int] = None, train_cfg: Optional[TrainConfig] = None,
          model: Optional[Model] = None, multi_card: bool = False) -> MeshBundle:
    """The cell `shape` of `arch` on `mesh` (the module docstring): the
    model from `source` (a whole model; an LM also the reference's numpy
    tree) or `generator` (seeded 0 on `device` by default), the global
    batch `batch` or `registry.make_batch`'s (`batch_size` / `seq`
    replacing the cell's dims), cut to this rank.  A recsys or GNN cell
    may take this rank's `model` from an earlier bundle instead (one
    shard scores and trains).  `multi_card`: build a cell one card cannot
    hold (`registry.MULTI_CARD_CELLS`; the dry run's ranks), which is
    refused otherwise."""
    if not multi_card:
        R.refuse_multi_card(shape)
    dev = torch.device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    fam = R.family_of(arch)
    if fam == "recsys":
        return _recsys_bundle(R.get_config(arch, smoke), shape, mesh, dev, gen, source, batch,
                              batch_size, model)
    if fam == "gnn":
        return _gnn_bundle(R.get_config(arch, smoke), shape, mesh, dev, gen, source, batch,
                           batch_size, model, multi_card)
    spec = R.LM_SHAPES[shape]
    cfg = cut_config(R.get_config(arch, smoke), layers)
    model = rank_model(cfg, mesh, spec.step, dev, source, gen)
    if batch is None:
        batch = R.make_batch(cfg, shape, gen, dev, batch_size, seq)
    inputs = rank_inputs(cfg, mesh, spec.step, batch)
    rows = int(batch["tokens"].shape[0])
    fn, opt = mesh_fn(model, mesh, spec.step, rows, train_cfg)
    return MeshBundle(mesh, spec.step, model, inputs, fn, opt,
                      data_sharded(cfg, mesh, spec.step, rows))


# ------------------------------------------------ recsys and GNN on a mesh
REPLICATED_IDS = ("candidate_ids", "neg_samples")


def recsys_inputs(mesh, batch: Dict) -> Tuple[Dict, bool]:
    """This rank's block of a recsys batch (`recsys_input_specs`' rule at
    the batch's own size): each row-wise input over the data axis where it
    divides the batch, the candidates' and negatives' ids whole.  ->
    (inputs, whether the rows are cut)."""
    dax = data_axes(mesh)
    b = next(int(v.shape[0]) for k, v in batch.items() if k not in REPLICATED_IDS)
    cut = b % axis_size(mesh, dax) == 0
    return {k: v if k in REPLICATED_IDS or not cut else
            cut_input(v, SPECS.P(dax), mesh) for k, v in batch.items()}, cut


def _recsys_bundle(cfg, shape: str, mesh, dev, gen, source, batch, batch_size,
                   model=None) -> MeshBundle:
    """The reference's `_recsys_bundle` on this rank (the module
    docstring)."""
    step = R.RECSYS_SHAPES[shape].step
    if model is None:
        model = (SPECS.shard_recsys_params(source, cfg, mesh, device=dev) if source is not None
                 else SPECS.init_sharded_recsys(cfg, mesh, gen, dev))
    if batch is None:
        batch = R.make_batch(cfg, shape, gen, dev, batch_size)
    inputs, cut = recsys_inputs(mesh, batch)
    if step in ("score", "retrieval"):
        call = RM.score if step == "score" else RM.retrieval_scores

        def fn(inputs):
            with CTX.axes(mesh):
                return call(model, inputs, cut)
        return MeshBundle(mesh, step, model, inputs, fn, None, cut)
    with CTX.axes(mesh):
        opt = OPT.get("adamw", list(model.named_parameters()),
                      layout=SPECS.recsys_train_layout(cfg, mesh))
    train = make_train_step(lambda m, b: RM.train_loss(m, b, cut), TrainConfig(), model, opt)

    def fn(inputs):
        with CTX.axes(mesh), trainable(model):
            return train(inputs)
    return MeshBundle(mesh, step, model, inputs, fn, opt, cut)


def gnn_inputs(mesh, shape: str, batch: Dict) -> Tuple[Dict, tuple]:
    """This rank's block of a SchNet batch (`gnn_input_specs`): a graph's
    flat edges over every axis (padded first past 1,000,000 edges that do
    not divide, `schnet.pad_edges`), a molecule batch over the data axis.
    A node-feature matrix the specs split over the data axis stays whole
    (a data-axis cut, as the LM's parameter cuts are).  -> (inputs, the
    axes the edges are cut over)."""
    specs = SPECS.gnn_input_specs(mesh, shape, batch)
    edge_ax = tuple(data_axes(mesh)) + ("model",)
    esz = axis_size(mesh, edge_ax)
    e = batch["edge_src"]
    if e.dim() == 1 and e.shape[0] % esz and e.shape[0] > 1_000_000:
        batch = G.pad_edges(batch, esz, int(batch["node_feat"].shape[0]))
        specs = dict(specs, edge_src=SPECS.P(edge_ax), edge_dst=SPECS.P(edge_ax),
                     edge_mask=SPECS.P(edge_ax))
    out = {}
    for k, v in batch.items():
        spec = specs[k]
        out[k] = v if k == "node_feat" else cut_input(v, spec, mesh)
    cut = e.dim() == 1 and specs["edge_src"][0] is not None and esz > 1
    return out, (edge_ax if cut else ())


def _gnn_bundle(cfg, shape: str, mesh, dev, gen, source, batch, batch_size,
                model=None, multi_card: bool = False) -> MeshBundle:
    """The reference's `_gnn_bundle` on this rank (the module docstring):
    the molecule regime's loss is each data rank's mean over its
    molecules, a graph's is every rank's whole loss.  A `source` is
    copied (the rank trains its own)."""
    if model is None:
        model = copy.deepcopy(source) if source is not None else \
            init_model(cfg, gen, dev, shape)
    if batch is None:
        batch = R.make_batch(cfg, shape, gen, dev, batch_size, multi_card=multi_card)
    inputs, axes = gnn_inputs(mesh, shape, batch)
    molecules = "atom_types" in batch
    with CTX.axes(mesh):
        opt = OPT.get("adamw", list(model.named_parameters()),
                      layout={n: SPECS.ParamLayout() for n, _ in model.named_parameters()})
    train = make_train_step(lambda m, b: G.train_loss(m, b, axes), TrainConfig(), model, opt,
                            data_mean=molecules)

    def fn(inputs):
        with CTX.axes(mesh), trainable(model):
            return train(inputs)
    return MeshBundle(mesh, "train", model, inputs, fn, opt, molecules)


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
