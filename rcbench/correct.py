"""How `correct` is decided: a sample of the window's finished requests,
drawn from the seed with the longest prompt in it, served again by the
plain reference from the benchmark's own inputs, and the widest gap by
which a served token's reference logit lies below the reference's best
(`logit_gap`), held to the cell's limit (`rcbench/limits/<cell>.json`).

The reference runs once the window has closed, the device memory peak
has been read and the port's state is freed; it imports nothing of the
port and takes nothing the port made: only the drawn weights, the
world's inputs and the served tokens, which it judges."""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import numpy as np
import torch

from rcbench.reference import semantic as SEM


def sample(run, k: int) -> List:
    """`k` finished requests of the window: the longest prompt, and the
    rest drawn from the run's seed."""
    done = [r for r in run.window_reqs() if r.finished(run.n_out)]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.n, -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(run.seed), 7]).generate_state(1)[0])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_module(config: dict):
    return importlib.import_module(f"rcbench.reference.{config['reference']}")


def build_requests(run, reqs, weights, program_masks: bool = False):
    """The reference's view of the sampled requests: its own plan of each
    prompt over its own prototypes, and the served tokens."""
    world = run.world
    ref = reference_module(run.cell.config)
    vocab = run.cell.traffic["world"]["vocab_size"]
    embed = weights["embed"][:vocab].float().cpu().numpy()
    protos = SEM.build_prototypes(world.corpus, embed, world.lsh_seed)
    out = []
    for r in reqs:
        pl = SEM.plan(world.requests[r.rid], world.catalog, world.instruction, protos, embed)
        out.append(ref.Request(plan=pl, served=np.asarray(r.tokens, np.int64),
                               mask=r.recompute if program_masks else None))
    return out, protos


def judge(run, weights, device, precision: str = "fp32", program_masks: bool = False,
          k: Optional[int] = None, logits_of: Optional[list] = None) -> Dict:
    """Serve the sample through the reference (in `precision`) and compare.
    -> {"logit_gap": the widest gap of the served tokens, "tokens": how
    many were compared, "requests": how many requests, "logits": the
    reference's rows (for a control to compare with)}; with `logits_of`
    (a float32 reference's rows of the same sample) the gap is that of
    the tokens this precision puts first instead."""
    k = k or run.cell.traffic["check"]["requests"]
    reqs = sample(run, k)
    if not reqs:
        return {"logit_gap": None, "tokens": 0, "requests": 0}
    mod = reference_module(run.cell.config)
    rq, protos = build_requests(run, reqs, weights, program_masks)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = mod.Reference(run.cell.config, weights, device, precision=precision)
        t = run.cell.traffic["serve"]
        res = ref.serve(rq, run.world.catalog, run.world.corpus, protos, t["r_item"], t["r_rev"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if logits_of is None:
        gaps = [mod.gap(o["logits"], r.tokens) for o, r in zip(res, reqs)]
    else:
        gaps = [mod.gap(ref32, o["logits"].argmax(dim=-1).tolist())
                for o, ref32 in zip(res, logits_of)]
    mask_diff = [int(np.sum(o["own_mask"] != r.recompute)) if r.recompute is not None else None
                 for o, r in zip(res, reqs)]
    return {"logit_gap": max(gaps), "gaps": gaps, "tokens": sum(len(r.tokens) for r in reqs),
            "requests": len(reqs), "mask_diff": mask_diff,
            "logits": [o["logits"] for o in res]}
