"""Distributed LM training on the port: any assigned architecture (reduced
or full), the production sharding rules, the fault-tolerant loop, and
gradient compression on the data-parallel axis.

    # CPU-feasible reduced config, one process
    PYTHONPATH=src python examples/torch_train_lm_distributed.py \
        --arch gemma-7b --smoke --steps 20 --device cpu

    # the same cell on a mesh of four gloo ranks: tensor (and, for an MoE,
    # expert) parallelism over two, data parallelism over two, int8
    # compression of the data axis's averaged gradients
    PYTHONPATH=src python examples/torch_train_lm_distributed.py \
        --arch moonshot-v1-16b-a3b --smoke --steps 20 --device cpu \
        --config mesh.tp=2,mesh.dp=2 --compression int8

`examples/train_lm_distributed.py` on `repro_torch`, with its flags
(``--arch --smoke --steps --batch --seq --ckpt --compression
--lower-only``).  The reference's ``--lower-only`` compiles the full
cell's train step for a 256-chip pod through its XLA dry run and never
executes it; the port has no counterpart of that dry run, so the flag
exits with an error.  The port instead RUNS the train step of the same
cell on a mesh of ranks (``--config mesh.tp=...,mesh.dp=...``): each rank
holds its shard of the parameters under the production rules
(`sharding.specs.lm_param_specs`, mode "train") and its block of the
optimizer state (`lm_opt_state_specs`: ZeRO moments for AdamW, factored
statistics on the parameter's layout for Adafactor), and rank 0 writes
the whole checkpoint.  Without ``--smoke`` that is the published-width
``train_4k`` cell, cut to ``--batch`` (default 1) and two layers.
"""
import argparse

from repro_torch.launch import train as TRAIN
from repro_torch.configs import registry as R


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b",
                    choices=[a for a in R.ARCHS if R.family_of(a) == "lm"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compression", default=None, choices=["int8", "topk"])
    ap.add_argument("--lower-only", action="store_true")
    ap.add_argument("--config", default=None,
                    help="mesh.tp=N,mesh.dp=M: train on a mesh of ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.lower_only:
        raise SystemExit("--lower-only compiles the train step for a 256-chip pod through "
                         "the reference's XLA dry run (repro.launch.dryrun), which has no "
                         "one-card counterpart in the port; run the step on a mesh of "
                         "ranks instead (--config mesh.tp=...,mesh.dp=...)")
    if not args.smoke:
        args.batch, args.seq = (1 if args.batch == 8 else args.batch), None
    args.layers = 2
    return TRAIN.run(args)


if __name__ == "__main__":
    main()
