"""Training launcher of the port (the JAX package's `launch/train.py`):

    # the reduced config through the fault-tolerant loop, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --smoke --device cpu \\
        --ckpt /tmp/ckpt --compression topk

    # the family's train cell on the card, at published width with the
    # stated cuts (an LM: --layers 2, --batch 1 at 4,096 tokens)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b

    # an LM on a mesh of ranks: tensor, expert and data parallelism (gloo
    # ranks on the CPU here; on the card, ranks share it or each has one)
    PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b \
        --smoke --device cpu --steps 4 --config mesh.tp=2,mesh.dp=2

`--smoke` runs `training.train_loop.train` on the reduced config
(`--steps` steps, checkpoints under `--ckpt`, gradient compression),
with the reference's synthetic data: an LM reads `lm_synthetic_batches`
through the prefetching `BatchPipeline`, a recsys model the reference's
fixed generator.  The GNN family keeps the reference's refusal there.
Without `--smoke` the reference lowers the full cell through its XLA
dry run; the port runs the family's train cell (`train_4k`,
`train_batch`, `full_graph_sm`) through `launch.steps` and prints its
JSON line.  It runs on the card unless `--device cpu`.

With ``--config mesh.tp=...,mesh.dp=...`` a model trains on a mesh: the
launcher starts one rank per device of the mesh (`launch.mesh.spawn_ranks`,
or joins the ranks ``torchrun`` started), each holding its shard of the
model drawn from the same seed (`sharding.specs.init_sharded_params`),
its rows of each batch and its block of the optimizer state
(`train_layout`).  For an LM `--smoke` runs the loop (checkpoints
gathered to rank 0, written whole), otherwise the train cell
(`launch.steps.build`).  A recsys arch or SchNet runs its family's train
cell through `launch.steps.build` (reduced() with `--smoke`, `--steps`
steps; else the published width, at most 3): a recsys rank holds its
rows of every split table and its rows of the batch (`--batch`, default
64 with `--smoke`), SchNet's ranks the whole model and their edges of
the graph.  Rank 0 prints one JSON line with the loss and gradient-norm
history and a ``mesh`` record: tp, dp, the backend and every rank's
device, wall seconds and peak device GB.

    # Wide&Deep and SchNet on two gloo ranks of the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep --smoke \
        --device cpu --steps 3 --config mesh.dp=2
    PYTHONPATH=src python -m repro_torch.launch.train --arch schnet --smoke \
        --device cpu --steps 3 --config mesh.dp=2
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from repro_torch.configs import registry as R
from repro_torch.data.pipeline import BatchPipeline, lm_synthetic_batches
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as STEPS
from repro_torch.models import transformer as TT
from repro_torch.recsys import models as RM
from repro_torch.serving.api import MeshConfig, ServeConfig
from repro_torch.sharding import ctx as CTX
from repro_torch.sharding import specs as SPECS
from repro_torch.training.train_loop import TrainConfig, train

TRAIN_CELL = {"lm": "train_4k", "recsys": "train_batch", "gnn": "full_graph_sm"}


def recsys_batches(cfg, batch: int, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """The reference launcher's synthetic recsys stream: dense ones and ids
    below 100 for the CTR models, empty histories for DIEN, a fixed MLM
    target with 16 negatives for BERT4Rec; random 0 / 1 labels."""
    rng = np.random.default_rng(seed)
    B = batch
    while True:
        if cfg.kind in ("wide_deep", "autoint"):
            yield {"dense": np.ones((B, 13), np.float32),
                   "sparse_ids": rng.integers(0, 100, (B, len(cfg.field_vocabs))).astype(np.int32),
                   "labels": rng.integers(0, 2, B).astype(np.float32)}
        elif cfg.kind == "dien":
            T = cfg.seq_len
            yield {"hist_items": np.zeros((B, T), np.int32),
                   "hist_cates": np.zeros((B, T), np.int32),
                   "hist_mask": np.ones((B, T), bool),
                   "target_item": np.zeros((B,), np.int32),
                   "target_cate": np.zeros((B,), np.int32),
                   "labels": rng.integers(0, 2, B).astype(np.float32)}
        else:
            T = cfg.seq_len
            yield {"item_seq": np.zeros((B, T), np.int32),
                   "seq_mask": np.ones((B, T), bool),
                   "mlm_positions": np.zeros((B, 2), np.int32),
                   "mlm_labels": np.ones((B, 2), np.int32),
                   "neg_samples": np.arange(16, dtype=np.int32)}


def mesh_config(spec: str) -> MeshConfig:
    """The mesh of a ``--config`` string, which may name ``mesh.*`` keys
    only."""
    try:
        config = ServeConfig.parse(spec)
    except ValueError as e:
        raise SystemExit(str(e))
    if config.replace(mesh=MeshConfig()) != ServeConfig():
        raise SystemExit(f"--config {spec!r}: training takes mesh.* keys only")
    return config.mesh


def _peak_gb(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def train_rank(rank: int, world: int, backend: str, device, args, mesh_cfg: MeshConfig) -> Dict:
    """One rank of an LM trained on a mesh (the module docstring).  -> its
    record: rank, device, wall seconds, peak GB and the step history."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_cfg.build()
    mesh.device = device
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    fam = R.family_of(args.arch)
    with CTX.axes(mesh):
        if fam != "lm":
            bundle = STEPS.build(args.arch, TRAIN_CELL[fam], mesh, device, smoke=args.smoke,
                                 generator=gen,
                                 batch_size=args.batch or (64 if args.smoke and
                                                           fam == "recsys" else None))
            hist = []
            for _ in range(args.steps if args.smoke else min(args.steps, 3)):
                m = bundle.fn(bundle.inputs)
                hist.append({k: float(v) for k, v in m.items()})
        elif args.smoke:
            cfg = R.get_config(args.arch, smoke=True)
            model = STEPS.rank_model(cfg, mesh, "train", device, generator=gen)
            pipe = BatchPipeline(lm_synthetic_batches(cfg.vocab_size, args.batch or 8,
                                                      args.seq or 64),
                                 dp=(mesh.coords["data"], mesh.shape["data"]))
            try:
                _, _, hist = train(model, STEPS.lm_loss, iter(pipe), TrainConfig(
                    steps=args.steps, ckpt_dir=args.ckpt, optimizer=cfg.optimizer, lr=1e-3,
                    grad_compression=args.compression),
                    layout=SPECS.train_layout(cfg, mesh, cfg.optimizer))
            finally:
                pipe.close()
        else:
            bundle = STEPS.build(args.arch, "train_4k", mesh, device, generator=gen,
                                 batch_size=args.batch or 1, seq=args.seq, layers=args.layers,
                                 train_cfg=TrainConfig(optimizer=R.ARCHS[args.arch].optimizer,
                                                       grad_compression=args.compression))
            hist = []
            for _ in range(min(args.steps, 3)):
                m = bundle.fn(bundle.inputs)
                hist.append({k: float(v) for k, v in m.items()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"rank": rank, "device": str(device), "backend": backend,
            "wall_s": time.perf_counter() - t0, "peak_gb": _peak_gb(device), "history": hist,
            "mesh": mesh.info()}


def mesh_report(args, ranks: List[Dict]) -> Dict:
    """Rank 0's JSON of a mesh run: its history and every rank's record."""
    hist = ranks[0]["history"]
    return {"arch": args.arch, "smoke": args.smoke, "steps": len(hist),
            "loss": [h["loss"] for h in hist], "gnorm": [h["gnorm"] for h in hist],
            "compression": args.compression,
            "mesh": {**ranks[0]["mesh"],
                     "ranks": [{k: r[k] for k in ("rank", "device", "wall_s", "peak_gb")}
                               for r in ranks]}}


def run_mesh(args, mesh_cfg: MeshConfig) -> Dict:
    """Train on `mesh_cfg`'s ranks (spawned here, or the ranks ``torchrun``
    started); rank 0 prints the JSON and returns it."""
    if R.family_of(args.arch) == "lm":
        try:
            SPECS._check_shardable(R.get_config(args.arch, smoke=args.smoke), mesh_cfg)
        except ValueError as e:
            raise SystemExit(str(e))
    device_type = torch.device(args.device).type
    if MESH.under_torchrun():
        import os

        import torch.distributed as dist

        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        backend, device = MESH.init_rank(rank, world, device_type)
        try:
            mine = train_rank(rank, world, backend, device, args, mesh_cfg)
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
        finally:
            dist.destroy_process_group()
        if rank != 0:
            return None
    else:
        ranks = MESH.spawn_ranks(train_rank, mesh_cfg.n_devices, device_type,
                                 args=(args, mesh_cfg))
    rep = mesh_report(args, ranks)
    print(json.dumps(rep))
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(R.ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config through the loop")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (smoke default 8; a full cell's batch is cut to it)")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM sequence length (smoke default 64; the full cell's 4,096)")
    ap.add_argument("--layers", type=int, default=2, help="depth of a full LM cell")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compression", default=None, choices=["int8", "topk"])
    ap.add_argument("--config", default=None,
                    help="mesh.tp=N,mesh.dp=M: train on a mesh of ranks")
    args = ap.parse_args(argv)
    return run(args)


def run(args):
    """`main` on parsed arguments (the distributed-training example calls
    it with its own flags)."""
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    fam = R.family_of(args.arch)
    if args.config:
        mesh_cfg = mesh_config(args.config)
        if mesh_cfg.enabled:
            return run_mesh(args, mesh_cfg)

    if not args.smoke:
        lm = fam == "lm"
        rep = STEPS.run(args.arch, TRAIN_CELL[fam], args.device,
                        batch=args.batch if args.batch is not None else (1 if lm else None),
                        seq=args.seq if lm else None, layers=args.layers if lm else None,
                        steps=min(args.steps, 3))
        print(json.dumps(rep))
        return rep

    if fam == "gnn":
        raise SystemExit("use tests/examples for GNN training demos")
    cfg = R.get_config(args.arch, smoke=True)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = 8 if args.batch is None else args.batch
    pipe = None
    if fam == "lm":
        model = TT.init_params(cfg, gen, dev)
        pipe = BatchPipeline(lm_synthetic_batches(cfg.vocab_size, batch,
                                                  64 if args.seq is None else args.seq))
        data = iter(pipe)
        loss_fn = STEPS.lm_loss
    else:
        model = RM.init_params(cfg, gen, dev)
        data = recsys_batches(cfg, batch)
        loss_fn = RM.train_loss
    try:
        _, _, hist = train(model, loss_fn, data,
                           TrainConfig(steps=args.steps, ckpt_dir=args.ckpt,
                                       optimizer=getattr(cfg, "optimizer", "adamw"),
                                       lr=1e-3, grad_compression=args.compression))
    finally:
        if pipe is not None:
            pipe.close()
    print(f"{args.arch}: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
