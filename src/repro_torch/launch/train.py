"""Training launcher of the port (the JAX package's `launch/train.py`):

    # the reduced config through the fault-tolerant loop, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --smoke --device cpu \\
        --ckpt /tmp/ckpt --compression topk

    # the family's train cell on the card, at published width with the
    # stated cuts (an LM: --layers 2, --batch 1 at 4,096 tokens)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b

`--smoke` runs `training.train_loop.train` on the reduced config
(`--steps` steps, checkpoints under `--ckpt`, gradient compression),
with the reference's synthetic data: an LM reads `lm_synthetic_batches`
through the prefetching `BatchPipeline`, a recsys model the reference's
fixed generator.  The GNN family keeps the reference's refusal there.
Without `--smoke` the reference lowers the full cell through its XLA
dry run; the port runs the family's train cell (`train_4k`,
`train_batch`, `full_graph_sm`) through `launch.steps` and prints its
JSON line.  It runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs import registry as R
from repro_torch.data.pipeline import BatchPipeline, lm_synthetic_batches
from repro_torch.launch import steps as STEPS
from repro_torch.models import transformer as TT
from repro_torch.recsys import models as RM
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
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    fam = R.family_of(args.arch)

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
