#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--n-layers N] [--requests N] [--decode-steps N]

Run from the repository root; needs one CUDA GPU, `nvcc` and nothing
else (no network, no JAX).  Phases:

1. set-up: the card's name and power limit, TF32 off, and a build of
   every CUDA kernel of the serving path from the sources in this
   checkout (one `nvcc` per source, all at once);
2. wave serving: the rcllm system at the full width of `rcllm-qwen3-8b`
   (random weights from a seeded generator; the offline KV build runs
   the flash kernel and packs the cached rows into a device pool)
   serves a few requests through the wave-scheduled continuous batcher
   (block-gather kernel assembling and realigning the cached KV,
   selective kernel in prefill, paged-decode kernel in decode).  Every
   kernel must have launched in this run, the flash and selective
   kernels on their tensor-core (bf16) routes.  A warm rerun of the same
   prefill and decode, without the batcher, splits the time by stage
   (host clock, card synchronised at each span) and reads the card's
   busy share and host<->card copy time under torch.profiler;
2c. chunked serving: the same system and trace through the chunked
   (unified-step) scheduler at full depth; the block-gather, selective
   (tensor-core route) and paged-decode kernels must each have launched
   in this run;
2g. the session server (`serving.server`) over the phase-2 system: the
   same trace replayed at speed 0, wave then chunked, must decode the
   tokens of phases 2 and 2c (the token gate: a request may part only at
   a near-tie, since batches form on measured step times) with the
   selective, paged-decode and block-gather kernels launched and the pool
   back to capacity; then open loop at speed 1 (chunked, block store on),
   one session cancelled while queued, one mid-prefill and one
   mid-decode: those end "cancelled", the rest pass the gate, and the
   pool, the store's partition and its blocks' arena bytes are clean;
2h. ranking accuracy: `RcLLMSystem.rank` over the phase-2 system with
   Full-Recompute, RcLLM, CacheBlend and EPIC, and RcLLM over the cached
   rows' int8 round trip, under `benchmarks/bench_accuracy.py`'s fidelity
   protocol (NDCG@10 against Full-Recompute, reported: the weights are
   random); the flash, selective and block-gather kernels must launch, and
   CacheBlend's block gathers rotate keys to the blocks' original
   positions.  The tiny model then ranks on the card as on the CPU (fp32,
   1e-4), and its int8 fidelity drop on the card is at most 0.02;
2d. recsys scoring and retrieval: Wide&Deep, AutoInt, DIEN and BERT4Rec
   at their published widths (random weights from a seeded generator)
   score a serve_p99 batch (512) and one retrieval_cand query against
   1,000,000 candidates, and Wide&Deep also a serve_bulk batch (262,144);
   Wide&Deep's wide sum must have launched the embedding-bag kernel.
   It runs after the rcllm kernels' checks and times of phases 3 and 4,
   so that no recsys model is on the card while the rcllm path runs;
2i. LM serving steps: gemma-7b, nemotron-4-15b, starcoder2-15b and
   moonshot-v1-16b-a3b at their published widths and depths (bf16,
   random weights from a seeded generator; one model on the card at a
   time, after every rcllm and recsys model is gone): a 32,768-token
   prefill (batch cut to 1), decode_32k steps with the batch cut to what
   leaves ~8 GB free (cache capacity 32,768 from the generator, per-row
   positions staggered near the end), and a greedy generation of 8
   tokens after a 4,608-token prompt; logits finite, tokens in the
   vocabulary, the decode step's memory under a layer's cache above
   weights + cache.  Then all five assigned LM archs at reduced() size
   (fp32) and starcoder2's with an 8-token window: the card against a CPU
   copy within 1e-4, greedy tokens and MoE routing equal.  This path
   launches none of the port's kernels (the reference's LM attention is
   jnp): it is plain torch, and its counts must stay 0;
2j. training (after every serving model is gone; the counts are reset
   before, and read after, each of its runs): rcllm-qwen3-8b, gemma-7b,
   nemotron-4-15b, starcoder2-15b and moonshot-v1-16b-a3b at published
   width, depth cut to 2 layers, 3 AdamW steps on one batch of 1 x 4,096
   tokens (the loss finite and falling; the attention backward, kernel
   K6, launched in every arch), kimi-k2 at reduced() size with
   Adafactor; the four recsys archs' train_batch at 65,536 rows
   (DIEN and BERT4Rec in 4 and 8 microbatches; Wide&Deep's wide sum on
   B5 forward and K7, its gradient, backward); SchNet's full_graph_sm,
   molecule and minibatch_lg (the 232,965-node, 114,615,892-edge
   power-law graph built on a host thread, then the port's sampler);
   `train()` with checkpoints and an injected failure, whose history
   must equal an uninterrupted run's; `bench_accuracy.py --planted` (the
   tiny ranker trained 200 steps, its first 10 losses equal to the CPU's,
   the system rebuilt on the trained weights, NDCG@10 of rcllm,
   CacheBlend and EPIC against Full-Recompute at r = 0.1 / 0.3 / 0.5,
   reported; B1, B2 and B4 must launch); then one train step of every
   LM, recsys and SchNet cell at reduced() size on the card against the
   CPU.  K6 is held to its plain version on the five archs' recorded
   calls and the ranker's, K7 at Wide&Deep's call, both timed beside
   their bounds, SDPA's backward and one `index_add_`;
3. checks: each kernel against its plain PyTorch version on the inputs
   one of its serving calls saw, in the working dtypes and in fp32 (the
   block gather bitwise where it copies); the served logits finite; and
   the tiny rcllm model served on the card, wave and chunked, decodes
   the same tokens as on the CPU (the plain versions).  The flash and
   selective kernels have two routes each: the tensor-core route is
   held to its plain version at the largest served call (the records
   "flash_attention" and "selective_attention"), the SIMT kernel at the
   largest fp32 call of the tiny runs (the records "...:fp32", whose
   launches are those runs') and at the served call cast to fp32.  The
   paged-decode kernel also against its split-K plain version at the
   split it chose, and it must run at least two blocks per SM.  The
   embedding bag on its serve_p99 and serve_bulk inputs, also with a bf16 and a d = 32
   table; and each recsys model at full width scores and retrieves the
   same on the card as a CPU copy of it;
4. kernel times (CUDA events, median of 20 after warm-up; and the
   device time alone under torch.profiler; for the paged-decode kernel
   also with the L2 flushed before each call) beside the plain version, one
   library call computing the same function where there is one, and the
   card's bound for the work.

The line before the last is the per-kernel JSON record; the last line is
`{"ok": true, "device": {...}}`.  A fuller report goes to
`chiprun_out/chip_smoke_report.json`.
"""
from __future__ import annotations

import argparse
import asyncio
import copy
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import registry as RREG  # noqa: E402
from repro_torch.configs.rcllm_qwen3_8b import CONFIG as QWEN3_8B  # noqa: E402
from repro_torch.core import engine as ENG  # noqa: E402
from repro_torch.core import metrics as MET  # noqa: E402
from repro_torch.data import synth as SY  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.block_gather import ops as BO  # noqa: E402
from repro_torch.kernels.block_gather.ref import block_gather_ref, gather_pages  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as EO  # noqa: E402
from repro_torch.kernels.embedding_bag import ref as EREF  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FREF  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mask_rows, mha_flash_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as PO  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_ref,
    paged_decode_split_ref,
)
from repro_torch.kernels.selective_attention import ops as SO  # noqa: E402
from repro_torch.kernels.selective_attention.ref import selective_mha_ref  # noqa: E402
from repro_torch.launch import serve as SERVE  # noqa: E402
from repro_torch.launch import steps as STEPS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.recsys import models as RM  # noqa: E402
from repro_torch.serving import api as API  # noqa: E402
from repro_torch.serving import batch_engine as BE  # noqa: E402
from repro_torch.serving import block_store as BS  # noqa: E402
from repro_torch.serving import workload as WL  # noqa: E402
from repro_torch.serving.api import ServeConfig, StoreConfig  # noqa: E402
from repro_torch.serving.batching import TorchEngineBackend  # noqa: E402
from repro_torch.serving.cluster import ClusterEngine  # noqa: E402
from repro_torch.serving.kv_pool import PagedKVPool  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: no TF32
# max |kernel - plain|: bf16 outputs carry one bf16 rounding (2^-8
# relative) plus probabilities rounded at another point; fp32 differs
# only by summation order over <= 512 keys of O(1) terms
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# block gather, relative to max(1, max|plain|): copies are exact; rotated
# keys see the same angles (the kernel takes the plain version's
# frequencies) and differ only by a sin/cos ulp, plus one bf16 rounding
GATHER_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
# embedding bag, relative to max(1, max|plain|): both sum in fp32, so fp32
# outputs differ only by summation order and bf16 ones by the one rounding
BAG_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
# recsys models on the card against a CPU copy (fp32, TF32 off): only the
# order of sums differs, carried through DIEN's 2 x 100 GRU steps
RECSYS_TOL = 1e-4
# the recsys cells run at full width on one card; the other archs'
# serve_bulk cells were sized for a pod (BERT4Rec's attention scores alone
# ~84 GB in fp32) and wait for the tensor-parallel slice
RECSYS_CELLS = {"wide-deep": ("serve_p99", "serve_bulk", "retrieval_cand"),
                "autoint": ("serve_p99", "retrieval_cand"),
                "dien": ("serve_p99", "retrieval_cand"),
                "bert4rec": ("serve_p99", "retrieval_cand")}
RCLLM_KERNELS = ("flash_attention", "selective_attention", "paged_decode_attention",
                 "block_gather")
# phase 2e: the repeat-user trace (12 requests over 4 users, Zipf), and the
# int8 run's store: a page budget small enough to force evictions and a
# host spill tier.  In the int8 run the trace's second half arrives
# INT8_WAVE_GAP_S later on the batcher's clock, after the first half has
# released its blocks: returning users and items then find their blocks
# evicted to the spill tier and promote them back (with all 12 requests in
# flight at once every block stays referenced, so nothing can be evicted)
KV_REQUESTS, KV_USERS = 12, 4
INT8_STORE_PAGES, INT8_SPILL_MB = 96, 256
INT8_WAVE_GAP_S = 60.0
# a greedy pick whose top-1 minus top-2 logit gap is at most this many bf16
# ulps of the top-1 logit counts as a near-tie in the reuse on/off gate
# (twice the largest top-1 logit difference seen before a divergence, 2
# ulps, in the first runs on the card).  Phase 2e serves the reuse-off
# trace twice and prints the same reading for that pair: the control
# for what timing-dependent batching alone changes
GAP_ULPS = 4
# phase 2f: the cluster (k = 2 workers on the card) serves the launcher trace
# of CLUSTER_REQUESTS requests in five runs.  In the int8 run the second
# half arrives INT8_WAVE_GAP_S later, after the first has churned the
# stores, and each worker has a pool of CLUSTER_INT8_PAGES pages and a
# store budget of CLUSTER_INT8_STORE_PAGES (the pinned prefix block takes
# 13): a request that cannot be admitted at once waits while the router's
# prefetch hints promote its spilled blocks (one admitted at once promotes
# them on demand instead).  On the CPU with the tiny model (the same
# catalog, so the same page counts) these sizes promote under any step
# time tried, 0 to 0.4 s a tick
CLUSTER_REQUESTS = 12
CLUSTER_INT8_PAGES, CLUSTER_INT8_STORE_PAGES = 64, 24

# phase 2i: the LM archs that fit one card run at published width and
# depth in bf16: one prefill_32k prompt (batch cut to 1), then a
# decode_32k batch cut to what leaves LM_FREE_GB of the card free (cache
# capacity 32,768, filled from the generator) for LM_DECODE_STEPS steps at
# per-row positions staggered near the end, then a greedy generation of
# LM_GEN_TOKENS tokens after an LM_GEN_PROMPT-token prompt (both past
# starcoder2's 4,096-token window).  Then every assigned LM arch (kimi-k2
# too) at reduced() size in fp32: the card against the CPU within LM_TOL.
# Before it at most LM_RESIDENT_GB may be allocated: no rcllm or recsys
# model is resident
LM_ARCHS = ("gemma-7b", "nemotron-4-15b", "starcoder2-15b", "moonshot-v1-16b-a3b")
LM_PREFILL_SEQ = 32768
LM_DECODE_STEPS = 8
LM_FREE_GB = 8.0
LM_GEN_PROMPT, LM_GEN_TOKENS = 4608, 8
LM_TOL = 1e-4
LM_RESIDENT_GB = 2.0

# kernels with two routes: "<name>" counts and records the tensor-core route
# (bf16, the served path at full width), "<name>:fp32" the SIMT kernel
# (fp32, the tiny card == CPU path)
TWO_ROUTES = ("flash_attention", "selective_attention")

KERNELS = {
    "flash_attention": dict(
        fn=FO.mha_flash, source="src/repro_torch/kernels/flash_attention/flash.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:83"),
    "selective_attention": dict(
        fn=SO.selective_mha,
        source="src/repro_torch/kernels/selective_attention/selective.cu",
        replaces="src/repro/kernels/selective_attention/kernel.py:129"),
    "paged_decode_attention": dict(
        fn=PO.paged_decode_mha,
        source="src/repro_torch/kernels/paged_attention/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:112"),
    "block_gather": dict(
        fn=BO.assemble_kv, source="src/repro_torch/kernels/block_gather/gather.cu",
        replaces="src/repro/kernels/block_gather/kernel.py:41"),
    "embedding_bag": dict(
        fn=EO.bag_sum, source="src/repro_torch/kernels/embedding_bag/bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:35"),
    # the training path's kernels (phase 2j): the attention backward (K6)
    # for the reference's hand-written `_flash_bwd`, and the wide bag sum's
    # gradient (K7) for autodiff of its take + sum
    "flash_bwd": dict(
        fn=FO.mha_flash_bwd, source="src/repro_torch/kernels/flash_attention/flash_bwd.cu",
        replaces="src/repro/models/layers.py:249"),
    "bag_backward": dict(
        fn=EO.bag_backward, source="src/repro_torch/kernels/embedding_bag/bag.cu",
        replaces="src/repro/recsys/models.py:65"),
}


# seconds by phase of this run (and, summed over device_busy's calls, the
# profiled spans and the reading of the profiler's events)
PHASE_S = {}


def log(*a):
    print(*a, flush=True)


def reset_counts():
    for name, spec in KERNELS.items():
        spec["fn"].launches = 0
        if name in TWO_ROUTES:
            spec["fn"].tc_launches = 0
    BO.assemble_kv.pool2_launches = 0


# ------------------------------------------------------------- recording
def _snapshot(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


class Recorder:
    """Wraps a kernel wrapper where the engine calls it and keeps the
    inputs of its largest call (by query size) for the checks."""

    def __init__(self, fn, snapshot=None):
        self.fn = fn
        self.snapshot = snapshot
        self.size = -1
        self.args = self.kwargs = None

    def __call__(self, *args, **kwargs):
        size = args[0].numel()
        if args[0].is_cuda and size > self.size:
            self.size = size
            if self.snapshot is not None:
                self.args, self.kwargs = self.snapshot(args, kwargs)
            else:
                self.args = tuple(_snapshot(a) for a in args)
                self.kwargs = {k: _snapshot(v) for k, v in kwargs.items()}
        return self.fn(*args, **kwargs)


def _paged_snapshot(args, kwargs):
    """Decode reads only the pages in its view: keep those (renumbered),
    not the whole arena, so later decode steps cannot change them."""
    q, ak, av, pg, sp = args
    used, inv = torch.unique(pg.long(), return_inverse=True)
    return ((q.clone(), ak[used].clone(), av[used].clone(),
             inv.to(torch.int32).contiguous(), sp.clone()), dict(kwargs))


def store_view(pg, sp):
    """How a decode view lays rows over store-shared pages.  -> (physical
    pages read by two or more rows, rows with a dead (-1) slot in a page
    before their last); a private, page-aligned view has neither."""
    pg, sp = pg.cpu().numpy(), sp.cpu().numpy()
    live = (sp >= 0).any(-1)
    seen = np.concatenate([np.unique(pg[i][live[i]]) for i in range(len(pg))])
    _, per_page = np.unique(seen, return_counts=True)
    dead_inside = sum(bool((sp[i, np.where(live[i])[0][:-1]] < 0).any())
                      for i in range(len(pg)))
    return int((per_page >= 2).sum()), int(dead_inside)


class StoreDecodeRecorder(Recorder):
    """The paged-decode wrapper in the reuse-on runs: keeps the largest call
    (by query size) whose view has a page shared by two rows and a dead
    slot inside a row (`store_view`)."""

    def __init__(self, fn):
        super().__init__(fn, _paged_snapshot)
        self.view = None

    def __call__(self, *args, **kwargs):
        if args[0].is_cuda and args[0].numel() > self.size:
            view = store_view(args[3], args[4])
            if min(view) > 0:
                self.size, self.view = args[0].numel(), view
                self.args, self.kwargs = self.snapshot(args, kwargs)
        return self.fn(*args, **kwargs)


class GatherRecorder:
    """Keeps the inputs of the largest rotated (the selective layers') and
    the largest unrotated (layer 0's Eq. 3 rows) block-gather call, and of
    the largest rotated call that also reads the second pool (store-shared
    prefix rows, "prefix").  The pools are planes of the read-only
    cached-row pool, or of the arena at store-owned slots that no request
    writes, and the tables are never written after the call, so
    references suffice."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {}

    def __call__(self, *args, **kwargs):
        mode = "rotate" if kwargs.get("rotate", True) else "copy"
        if kwargs.get("pool2_k") is not None:
            mode = "prefix" if mode == "rotate" else "prefix_copy"
        size = args[2].numel()
        if size > self.calls.get(mode, (-1,))[0]:
            self.calls[mode] = (size, args, dict(kwargs))
        return self.fn(*args, **kwargs)


class BagRecorder:
    """Keeps the inputs of the latest embedding-bag call per batch size
    (serve_p99, serve_bulk, retrieval).  The table is a model parameter
    and the ids are made anew for each call, so references suffice."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {}

    def __call__(self, table, ids):
        self.calls[ids.shape[0]] = (table, ids)
        return self.fn(table, ids)


def install_recorders():
    rec = {"flash_attention": Recorder(FO.mha_flash),
           "selective_attention": Recorder(SO.selective_mha),
           "paged_decode_attention": Recorder(PO.paged_decode_mha, _paged_snapshot),
           "block_gather": GatherRecorder(BO.assemble_kv)}
    patches = [(ENG, "mha_flash", rec["flash_attention"]),
               (TT, "mha_flash", rec["flash_attention"]),
               (ENG, "selective_mha", rec["selective_attention"]),
               (BE, "paged_decode_mha", rec["paged_decode_attention"]),
               (ENG, "assemble_kv", rec["block_gather"])]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, r in patches:
        setattr(mod, name, r)
    return rec, saved


# ------------------------------------------- plain versions, library, bound
def plain_call(name, args, kw):
    if name == "embedding_bag":
        return embedding_bag_ref(*args)
    if name == "block_gather":
        k2, v2 = kw.get("pool2_k"), kw.get("pool2_v")
        k, v = block_gather_ref(*args, rope_theta=kw.get("rope_theta", 1e4),
                                rotate=kw.get("rotate", True), pool2_k=k2, pool2_v=v2)
        if not kw.get("keep_raw"):
            return k, v
        return k, v, gather_pages(args[0], args[2].long(), k2)
    if name == "flash_attention":
        return mha_flash_ref(*args, **kw)
    if name == "selective_attention":
        q, qp, k, v, hh = args
        return selective_mha_ref(q, torch.as_tensor(qp, device=q.device),
                                 k, v, torch.as_tensor(hh, device=q.device),
                                 window=kw.get("window", 256))
    return paged_decode_ref(*args, **kw)


def to_fp32(name, args, kw):
    f = lambda t: t.float() if torch.is_tensor(t) and t.is_floating_point() else t
    if name == "paged_decode_attention":
        return (f(args[0]),) + tuple(args[1:]), kw
    if name == "selective_attention":
        q, qp, k, v, hh = args
        return (f(q), qp, f(k), f(v), hh), kw
    return tuple(f(a) for a in args), kw


def library_call(name, args, kw):
    """One PyTorch call computing the same function (a yardstick timed
    here; the port never calls it), or None."""
    if name == "paged_decode_attention":
        return None
    if name == "embedding_bag":
        table, ids = args
        return lambda: F.embedding_bag(ids, table, mode="sum")
    if name == "block_gather":
        if kw.get("rotate", True) or kw.get("pool2_k") is not None:
            return None           # no one PyTorch call gathers and rotates, or
                                  # gathers from two pools
        pk, pv, bt = args[0], args[1], args[2].long()
        return lambda: (torch.index_select(pk, 0, bt), torch.index_select(pv, 0, bt))
    q = args[0]
    B, Sq, Hq, D = q.shape
    if name == "flash_attention":
        k, v = args[1], args[2]
        Skv = k.shape[1]
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if kw.get("causal", True):
            mask = torch.tril(mask)
        mask = mask[None, None].expand(B, Hq, Sq, Skv)
        if kw.get("kv_valid") is not None:
            kvv = kw["kv_valid"].bool()
            mask = mask & kvv[mask_rows(kvv.shape[0], B, Hq, q.device)][:, :, None, :]
    else:
        qp, k, v, hh = args[1], args[2], args[3], args[4]
        k = k.to(q.dtype)
        v = v.to(q.dtype)
        qp = torch.as_tensor(qp, device=q.device).long()
        hh = torch.as_tensor(hh, device=q.device) > 0
        kpos = torch.arange(k.shape[1], device=q.device)
        window = kw.get("window", 256)
        m = (qp[:, :, None] >= kpos) & ((qp[:, :, None] - kpos < window) | hh[:, None, :])
        rows = mask_rows(m.shape[0], B, Hq, q.device)
        mask = m[rows]                                         # (B, Hq, R, S)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def work(name, args, kw, out):
    """(bytes, flops) the function needs on these inputs: each input read
    once, the output written once, operations over live (query, key)
    pairs only (4*D per pair per head: QK^T and PV)."""
    if name == "embedding_bag":
        # ids read once, each bag's rows read once, the sums written once;
        # one add per row element
        table, ids = args
        rows = ids.numel() * table.shape[1]
        return nbytes(ids) + rows * table.element_size() + nbytes(out), rows
    if name == "block_gather":
        # each selected K and V row read once, every output written once;
        # a rotation is 4 products and 2 sums per key pair (3 per element)
        pk, pv, bt, pos = args
        rows = bt.numel() * pk[0].numel()
        reads = rows * (pk.element_size() + pv.element_size()) + nbytes(bt)
        rot = kw.get("rotate", True)
        return reads + (nbytes(pos) if rot else 0) + nbytes(*out), 3 * rows if rot else 0
    q = args[0]
    D = q.shape[-1]
    if name == "flash_attention":
        k, v = args[1], args[2]
        B, Sq, Hq, _ = q.shape
        Skv = k.shape[1]
        live = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if kw.get("causal", True):
            live = torch.tril(live)
        live = live[None, None].expand(B, Hq, Sq, Skv)
        if kw.get("kv_valid") is not None:
            kvv = kw["kv_valid"].bool()
            live = live & kvv[mask_rows(kvv.shape[0], B, Hq, q.device)][:, :, None, :]
        pairs = int(live.sum())
        return nbytes(q, k, v, kw.get("kv_valid"), out), 4 * D * pairs
    if name == "selective_attention":
        qp, k, v, hh = args[1], args[2], args[3], args[4]
        B, R, Hq, _ = q.shape
        qp_t = torch.as_tensor(qp, device=q.device).long()
        hh_t = torch.as_tensor(hh, device=q.device) > 0
        kpos = torch.arange(k.shape[1], device=q.device)
        window = kw.get("window", 256)
        m = (qp_t[:, :, None] >= kpos) & ((qp_t[:, :, None] - kpos < window)
                                          | hh_t[:, None, :])
        pairs = int(m[mask_rows(m.shape[0], B, Hq, q.device)].sum())
        live = torch.as_tensor(kw["live"]) if kw.get("live") is not None else None
        extra = nbytes(qp_t.int(), hh_t.to(torch.uint8), live)
        return nbytes(q, k, v, out) + extra, 4 * D * pairs
    ak, av, pg, sp = args[1], args[2], args[3], args[4]
    N, Hq, _ = q.shape
    Hkv = ak.shape[3]
    live = sp >= 0
    live_slots = int(live.sum())
    # K/V bytes: each physical slot a live position reads, once (rows that
    # share a store page need its bytes once); operations per (row, slot)
    slot_ids = pg.long()[:, :, None] * sp.shape[2] + torch.arange(sp.shape[2],
                                                                  device=sp.device)
    read_slots = int(torch.unique(slot_ids[live]).numel())
    kv_bytes = 2 * read_slots * Hkv * D * ak.element_size()
    flops = 4 * D * Hq * live_slots + 3 * D * Hkv * live_slots   # + rotation
    return nbytes(q, pg, sp, out) + kv_bytes, flops


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(statistics.median(times))


def device_ms(fn, reps=20, flush=None):
    """Mean device time per call: the card's kernel and copy intervals
    under torch.profiler, so the wrapper's host work between launches
    (which a CUDA-event time of one short call includes) is left out.
    With `flush` (a buffer larger than the 50 MB L2), the buffer is
    written before each call, so the call finds its inputs out of L2;
    the writes themselves are not counted."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def run(cold):
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(reps):
                if cold:
                    flush.fill_(i & 0xFF)
                fn()
            torch.cuda.synchronize()
        return device_events(prof)

    warm = run(False)
    if flush is None:
        return sum(e - s for _, s, e in warm) / reps / 1e6
    names = {n for n, _, _ in warm}
    return sum(e - s for n, s, e in run(True) if n in names) / reps / 1e6


class Spans:
    """Inclusive host-clock seconds per wrapped function.  The card is
    synchronised at entry and exit, so device work lands in the span
    that issued it (this slows the run: the spans are taken in a run of
    their own, never in the served one)."""

    def __init__(self):
        self.s, self.saved = {}, []

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
            return out
        self.saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, timed)

    def restore(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)


def warm_run(engine, plans, steps, reuse=None):
    """The serving path without the batcher: one rcllm prefill of every
    request's plan in one batch (with its `reuse` metadata for a
    store-backed engine), then `steps` greedy decode steps and the release
    of every request.  -> (prefill, decode), to be called in that order."""
    rids = sorted(plans)
    brs = [BE.BatchRequest(rid=rid, tokens=plans[rid][0].tokens, plan=plans[rid][0],
                           block_table=plans[rid][1], positions=plans[rid][2],
                           have=plans[rid][3], n_reserve=steps,
                           reuse=None if reuse is None else reuse[rid]) for rid in rids]
    state = {}

    def prefill():
        state["toks"] = engine.prefill(brs, "rcllm").argmax(-1)

    def decode():
        toks = state.pop("toks")
        for _ in range(steps):
            toks = engine.decode(rids, toks).argmax(-1)
        for rid in rids:
            engine.release(rid)
    return prefill, decode


def device_events(prof):
    """The card's kernel, copy and set intervals of a finished
    torch.profiler run: [(name, start ns, end ns)].  Read from the raw
    Kineto events: `prof.events()` would first build the host op tree,
    tens of seconds for one profiled decode of a 36-layer model."""
    cuda = torch.autograd.DeviceType.CUDA
    skip = getattr(torch.autograd.profiler, "_filter_name", lambda name: False)
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_hidden_event() and not skip(e.name())]


def device_busy(fn):
    """Run `fn` under torch.profiler.  -> (wall s, device-busy s as the
    union of the card's kernel and copy intervals, top device consumers
    [(name, ms)], host<->card copy s, number of those copies); busy is
    None when the profiler saw no device event."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_post = time.perf_counter()
    spans, by_name, memcpy_ns, n_memcpy = [], {}, 0, 0
    for name, s, e in device_events(prof):
        spans.append((s, e))
        by_name[name] = by_name.get(name, 0) + e - s
        if "memcpy" in name.lower() and "dtod" not in name.lower():
            memcpy_ns += e - s
            n_memcpy += 1
    busy, end = 0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    PHASE_S["profiler_total"] = PHASE_S.get("profiler_total", 0.0) + time.perf_counter() - t0
    PHASE_S["profiler_events"] = (PHASE_S.get("profiler_events", 0.0)
                                  + time.perf_counter() - t_post)
    return (wall, (busy / 1e9 if spans else None), [(n[:60], ns / 1e6) for n, ns in top],
            memcpy_ns / 1e9, n_memcpy)


def shapes(args, kw):
    out = []
    for a in list(args) + [kw.get("kv_valid"), kw.get("live"), kw.get("pool2_k")]:
        if torch.is_tensor(a) or isinstance(a, np.ndarray):
            out.append(f"{tuple(a.shape)}:{str(a.dtype).replace('torch.', '')}")
    return out


def counts():
    """Launches per kernel since the last reset_counts(), the two routes of
    TWO_ROUTES apart."""
    out = {}
    for n, spec in KERNELS.items():
        fn = spec["fn"]
        if n in TWO_ROUTES:
            out[n] = fn.tc_launches
            out[f"{n}:fp32"] = fn.launches - fn.tc_launches
        else:
            out[n] = fn.launches
    out["block_gather:prefix"] = BO.assemble_kv.pool2_launches
    return out


def route_of(name, a, kw):
    """The route ("tc" or "simt") the wrapper takes for this call."""
    if name == "flash_attention":
        kvv = kw.get("kv_valid")
        return FO._route(a[0], a[1], a[2], 1 if kvv is None else kvv.shape[0])
    qp = torch.as_tensor(a[1])
    return SO._route(a[0], a[2], a[3], qp.shape[0] if qp.dim() == 2 else 1)


def check_route(name, a, kw, want):
    route = route_of(name, a, kw)
    if route != want:
        raise RuntimeError(f"{name}: the recorded call took the {route} route, want {want}")
    return route


def log_serve(label, rep, peak_gb):
    log(f"  {label}: TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f} ms p99 "
        f"{rep['ttft_p99_s'] * 1e3:.1f} ms; TBT p50 {rep['tbt_p50_s'] * 1e3:.1f} ms; "
        f"decode {rep['throughput_tok_s']:.1f} tok/s"
        + ("" if peak_gb is None else f"; peak CUDA memory {peak_gb:.1f} GB"))


def check_served(label, launched, required, done, backend, args, config, cfg):
    """Every required kernel launched in the run, every request completed
    with its full output of valid token ids."""
    missing = [n for n in required if launched[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {label} serving path: {missing}")
    if len(done) != args.requests:
        raise RuntimeError(f"{label}: {len(done)} of {args.requests} requests completed")
    for c in done:
        toks = backend.generated[c.rid]
        if len(toks) != config.decode_steps or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"{label}: request {c.rid} generated {toks}")


def timed_record(name, spec, launches, a, kw, out, err, wdt, extra, label=None):
    """Kernel, plain and library times plus the bound for one call."""
    fn = spec["fn"]
    ms = time_ms(lambda: fn(*a, **kw))
    dev_ms = device_ms(lambda: fn(*a, **kw))
    plain_ms = time_ms(lambda: plain_call(name, a, kw))
    lib = library_call(name, a, kw)
    lib_ms = time_ms(lib) if lib is not None else None
    b, fl = work(name, a, kw, out)
    t_bytes, t_ops = b / HBM_BYTES_S * 1e3, fl / PEAK_FLOPS[wdt] * 1e3
    label = label or (name if kw.get("rotate", True) else f"{name}:copy")
    rec = {"name": label, "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "device_ms": dev_ms, "shapes": shapes(a, kw), "bytes": b,
           "flops": fl, **extra}
    log(f"time {label}: kernel {ms:.4f} ms (device only {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({rec['bound_by']}; {b / 1e6:.1f} MB)")
    return rec


def gather_records(calls, spec, launches, modes=("rotate", "copy")):
    """The block gather against its plain version on the inputs of its
    largest rotated call (the selective layers'), its largest copy (layer
    0's Eq. 3 rows) or, for mode "prefix", its largest rotated call with
    the second pool (store-shared prefix rows): in the pool's serving dtype
    (fp32) and cast to the model's bf16.  Copies (values, unrotated and raw
    keys) must be bitwise; rotated keys within GATHER_TOL of max(1,
    max|plain|)."""
    fn = spec["fn"]
    records = []
    for mode in modes:
        if mode not in calls:
            raise RuntimeError(f"block_gather: no {mode} call was recorded")
        _, a, kw = calls[mode]
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            ad = (a[0].to(dt), a[1].to(dt), a[2], a[3])
            kwd = dict(kw)
            if kw.get("pool2_k") is not None:
                kwd.update(pool2_k=kw["pool2_k"].to(dt), pool2_v=kw["pool2_v"].to(dt))
            got, want = fn(*ad, **kwd), plain_call("block_gather", ad, kwd)
            torch.cuda.synchronize()
            exact = [torch.equal(g, w) for g, w in zip(got, want)]
            if mode in ("rotate", "prefix"):
                exact = exact[1:]                    # values and raw keys
                scale = max(1.0, float(want[0].float().abs().max()))
                err = float((got[0].float() - want[0].float()).abs().max())
                if not torch.isfinite(got[0]).all() or err > GATHER_TOL[dt] * scale:
                    raise RuntimeError(f"block_gather {dt}: rotated keys max|kernel-plain| "
                                       f"{err} > {GATHER_TOL[dt]} x {scale}")
            else:
                err = 0.0
            if not all(exact):
                raise RuntimeError(f"block_gather {mode} {dt}: copies not bitwise {exact}")
            errs[dt] = err
        log(f"check block_gather {mode}: {shapes(a, kw)} copies bitwise; rotated keys "
            f"max|kernel-plain| fp32 {errs[torch.float32]:.3g}, bf16 "
            f"{errs[torch.bfloat16]:.3g} (tol {GATHER_TOL} x max(1, max|k|))")
        out = fn(*a, **kw)
        label = {"copy": "block_gather:copy", "prefix": "block_gather:prefix"}.get(
            mode, "block_gather")
        records.append(timed_record("block_gather", spec, launches[mode], a, kw, out,
                                    errs[torch.float32], torch.float32,
                                    {"tol": GATHER_TOL[torch.float32],
                                     "bf16_max_abs_err": errs[torch.bfloat16]},
                                    label=label))
    return records


def device_inputs(name, a, kw, dev):
    """A recorded call's inputs with the selective kernel's mask operands
    on the card, as the engine passes them."""
    if name == "selective_attention":
        kw = dict(kw, live=torch.as_tensor(kw["live"], dtype=torch.int32, device=dev))
        a = (a[0], torch.as_tensor(a[1], device=dev), a[2], a[3],
             torch.as_tensor(a[4], device=dev))
    return a, kw


def selective_host_inputs_ms(a, kw):
    """CUDA-event ms of the selective wrapper when its mask operands arrive
    as the engine passed them before it made them once per call: int64
    positions, int8 validity and the liveness map in host memory, which
    the wrapper copies and converts on every call."""
    q, qp, k, v, hh = a
    qp64, hh8 = qp.long(), hh.to(torch.int8)
    live = kw["live"].cpu().numpy()
    return time_ms(lambda: SO.selective_mha(q, qp64, k, v, hh8, **dict(kw, live=live)))


def paged_split_record(a, kw):
    """B3 at the served call: the kernel's split choice (pages per split,
    splits, blocks: at least two per SM), the kernel against the split-K
    plain version at the same split (within TOL), and its device time with
    the L2 flushed before each call by writing a 256 MB buffer (a decode
    step reaches each layer's K/V after the other layers' weights)."""
    fn = PO.paged_decode_mha
    q, ak = a[0], a[1]
    out = fn(*a, **kw)
    pps, splits = fn.last_splits
    blocks = q.shape[0] * ak.shape[3] * splits
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if blocks < 2 * sms:
        raise RuntimeError(f"paged_decode_attention: {blocks} blocks at the served call, "
                           f"fewer than two per SM ({sms} SMs)")
    split = paged_decode_split_ref(*a, **kw, pages_per_split=pps)
    torch.cuda.synchronize()
    err = float((out.float() - split.float()).abs().max())
    if not torch.isfinite(out).all() or err > TOL[q.dtype]:
        raise RuntimeError(f"paged_decode_attention: max|kernel - split plain| {err} > "
                           f"{TOL[q.dtype]}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=q.device)
    cold = device_ms(lambda: fn(*a, **kw), flush=flush)
    del flush
    log(f"check paged_decode_attention split-K: {splits} splits of {pps} pages, {blocks} "
        f"blocks on {sms} SMs; max|kernel - split plain| {err:.3g}; device time with the "
        f"L2 flushed {cold:.4f} ms")
    return {"pages_per_split": pps, "splits": splits, "blocks": blocks,
            "split_ref_max_abs_err": err, "device_cold_ms": cold, "flush_mb": 256}


def checked_record(name, spec, launches, a, kw, extra, fp32_too=False, label=None):
    """The kernel against its plain version on these inputs (within
    TOL of their working dtype; with `fp32_too` also the same call cast to
    fp32, which takes the SIMT route), then its timed record."""
    fn = spec["fn"]
    out = fn(*a, **kw)
    plain = plain_call(name, a, kw)
    torch.cuda.synchronize()
    wdt = a[0].dtype
    err = float((out.float() - plain.float()).abs().max())
    if not torch.isfinite(out).all() or err > TOL[wdt]:
        raise RuntimeError(f"{label or name}: max|kernel-plain| {err} > {TOL[wdt]} ({wdt})")
    extra = dict(extra, tol=TOL[wdt])
    msg = ""
    if fp32_too:
        a32, kw32 = to_fp32(name, a, kw)
        out32 = fn(*a32, **kw32)
        err32 = float((out32 - plain_call(name, a32, kw32)).abs().max())
        if err32 > TOL[torch.float32]:
            raise RuntimeError(f"{name}: fp32 max|kernel-plain| {err32} > {TOL[torch.float32]}")
        extra["fp32_max_abs_err"] = err32
        msg = f"; same call in fp32 {err32:.3g} (tol {TOL[torch.float32]})"
    route = f" ({extra['kernel_route']} route)" if "kernel_route" in extra else ""
    log(f"check {label or name}{route}: {shapes(a, kw)} max|kernel-plain| {err:.3g} "
        f"(tol {TOL[wdt]}, {str(wdt).replace('torch.', '')}){msg}")
    return timed_record(name, spec, launches, a, kw, out, err, wdt, extra, label=label)


# ---------------------------------------------------------------- recsys
def recsys_phase(dev, repeats=5):
    """Every recsys cell of RECSYS_CELLS at its published width, through
    the launcher's step functions.  -> (cells, models, recorded
    embedding-bag calls); the models stay on the card for the checks."""
    bag = BagRecorder(EO.bag_sum)
    saved, RM.bag_sum = RM.bag_sum, bag
    cells, models = [], {}
    try:
        for arch, shapes in RECSYS_CELLS.items():
            cfg = RREG.get_config(arch)
            base = torch.cuda.memory_allocated()
            gen = torch.Generator(device=dev).manual_seed(0)
            t0 = time.perf_counter()
            model = models[arch] = RM.init_params(cfg, gen, dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            param_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
            for shape in shapes:
                torch.cuda.reset_peak_memory_stats()
                batch = RREG.make_batch(cfg, shape, gen, dev)
                fn = STEPS.step_of(shape)
                out, times = STEPS.time_step(fn, model, batch, repeats)
                wall, busy, top, _, _ = device_busy(lambda: fn(model, batch))
                n = batch[next(iter(batch))].shape[0]
                want = (n, RREG.RECSYS_SHAPES[shape].dims["n_candidates"]) \
                    if shape == "retrieval_cand" else (n,)
                finite = bool(torch.isfinite(out).all())
                cell = {"arch": arch, "shape": shape, "batch": int(n),
                        "ms_per_call": statistics.median(times) * 1e3,
                        "ms_min": min(times) * 1e3, "repeats": repeats,
                        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                        "param_gb": param_gb, "init_s": init_s,
                        "profiled_wall_ms": wall * 1e3,
                        "device_busy_ms": None if busy is None else busy * 1e3,
                        "device_idle_share": None if busy is None else 1 - busy / wall,
                        "top_device": top, "out_shape": list(out.shape), "finite": finite}
                cells.append(cell)
                log(f"  recsys {arch} {shape}: batch {n}, {cell['ms_per_call']:.3f} ms per call "
                    f"(median of {repeats}), peak {cell['peak_gb']:.2f} GB above the phase's "
                    f"start (params {param_gb:.3f} GB), output {tuple(out.shape)} "
                    f"{'finite' if finite else 'NOT finite'}; profiled call: wall "
                    f"{wall * 1e3:.3f} ms, device busy "
                    f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms'}; top device: "
                    + "; ".join(f"{k} {ms:.3f} ms" for k, ms in top[:4]))
                if tuple(out.shape) != want or not finite:
                    raise RuntimeError(f"recsys {arch} {shape}: output {tuple(out.shape)} "
                                       f"(want {want}), finite {finite}")
                del batch, out
    finally:
        RM.bag_sum = saved
    return cells, models, bag.calls


def bag_records(calls, spec, launches, models):
    """The embedding bag against its plain version on the inputs of
    Wide&Deep's serve_bulk and serve_p99 calls: the wide table in fp32 and
    in bf16, and the same ids into the (rows, 32) deep table.  Each within
    BAG_TOL of max(1, max|plain|)."""
    fn = spec["fn"]
    records = []
    deep_table = models["wide-deep"].table
    for shape in ("serve_bulk", "serve_p99"):
        b = RREG.RECSYS_SHAPES[shape].dims["batch"]
        if b not in calls:
            raise RuntimeError(f"embedding_bag: no call of batch {b} ({shape}) was recorded")
        table, ids = calls[b]
        errs = {}
        for label, t in (("fp32 d=1", table), ("bf16 d=1", table.to(torch.bfloat16)),
                         ("fp32 d=32", deep_table)):
            got, want = fn(t, ids), embedding_bag_ref(t, ids)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.float().abs().max()))
            err = float((got.float() - want.float()).abs().max())
            tol = BAG_TOL[t.dtype] * scale
            if got.dtype != t.dtype or not torch.isfinite(got).all() or err > tol:
                raise RuntimeError(f"embedding_bag {shape} {label}: max|kernel-plain| "
                                   f"{err} > {tol}")
            errs[label] = err
            del got, want
        log(f"check embedding_bag {shape}: ids {tuple(ids.shape)} into {tuple(table.shape)}; "
            "max|kernel-plain| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {BAG_TOL} x max(1, max|plain|))")
        a = (table, ids)
        out = fn(*a)
        # rows narrower than a 32-byte sector cost the card a whole sector
        row = table.shape[1] * table.element_size()
        sector_bytes = nbytes(ids) + ids.numel() * max(32, -(-row // 32) * 32) + nbytes(out)
        extra = {"tol": BAG_TOL[torch.float32], "bf16_max_abs_err": errs["bf16 d=1"],
                 "d32_max_abs_err": errs["fp32 d=32"],
                 "sector_bound_ms": sector_bytes / HBM_BYTES_S * 1e3}
        records.append(timed_record("embedding_bag", spec, launches, a, {}, out,
                                    errs["fp32 d=1"], torch.float32, extra,
                                    label="embedding_bag" if shape == "serve_bulk"
                                    else f"embedding_bag:{shape}"))
    return records


def recsys_card_vs_cpu(models, dev, batch=64, n_candidates=4096):
    """Each model at full width scores a batch of `batch` and retrieves
    against `n_candidates` candidates on the card (kernel) and on a CPU
    copy of itself (plain versions): allclose within RECSYS_TOL."""
    out = {}
    for arch, model in models.items():
        cpu = copy.deepcopy(model).to("cpu")
        gen = torch.Generator(device=dev).manual_seed(1)
        errs = {}
        for shape in ("serve_p99", "retrieval_cand"):
            b = RREG.make_batch(model.cfg, shape, gen, dev, batch=batch)
            if shape == "retrieval_cand":
                b["candidate_ids"] = b["candidate_ids"][:n_candidates]
            fn = STEPS.step_of(shape)
            got = fn(model, b).cpu()
            want = fn(cpu, {k: v.cpu() for k, v in b.items()})
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=RECSYS_TOL, atol=RECSYS_TOL):
                raise RuntimeError(f"recsys {arch} {shape}: card vs CPU max abs diff {err} "
                                   f"beyond rtol=atol={RECSYS_TOL}")
            errs[shape] = err
        out[arch] = errs
        log(f"check recsys {arch} at full width, card == CPU copy: max abs diff "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (batch {batch}, {n_candidates} candidates; rtol=atol={RECSYS_TOL})")
        del cpu
    return out


# ------------------------------------------------------------- kv reuse
class LogitTap:
    """Per request, for every logits row the backend picks a token from:
    (greedy token, top-1 logit, top-1 minus top-2 gap)."""

    def __init__(self):
        self.rows = {}
        self.saved = TorchEngineBackend._pick

    def __enter__(self):
        tap, pick = self, self.saved

        def tapped(backend, rid, lg):
            lg = np.asarray(lg, np.float64)
            top = np.partition(lg, -2)[-2:]
            tap.rows.setdefault(rid, []).append((int(np.argmax(lg)), float(top[1]),
                                                 float(top[1] - top[0])))
            return pick(backend, rid, lg)
        TorchEngineBackend._pick = tapped
        return self

    def __exit__(self, *exc):
        TorchEngineBackend._pick = self.saved


class PrefixRowTap:
    """Keeps each request's first `n` arena rows (the instruction's KV as
    the request wrote it privately) when the engine releases it."""

    def __init__(self, n):
        self.n, self.rows = n, {}
        self.saved = BE.BatchEngine.release

    def __enter__(self):
        tap, release = self, self.saved

        def tapped(engine, rid):
            table = engine.pool.slot_tables.get(rid)
            if table is not None and rid not in tap.rows:
                sl = torch.from_numpy(table[:tap.n]).to(engine.pool.device)
                p, o = sl // engine.pool.page_size, sl % engine.pool.page_size
                tap.rows[rid] = (engine.pool.arena_k[p, o].clone(),
                                 engine.pool.arena_v[p, o].clone())
            return release(engine, rid)
        BE.BatchEngine.release = tapped
        return self

    def __exit__(self, *exc):
        BE.BatchEngine.release = self.saved


def gap_tol(top1):
    """Logit gap under which a greedy pick counts as a tie: GAP_ULPS bf16
    ulps at the top-1 logit (the bf16 model's logits are bf16)."""
    e = np.floor(np.log2(max(abs(top1), 2.0 ** -126)))
    return GAP_ULPS * 2.0 ** (e - 7)


def token_gate(on, off, on_rows, off_rows, strict=True, label="kv_reuse"):
    """Greedy tokens with reuse on must equal those with reuse off until a
    position where the off run's top-1 minus top-2 gap is at most
    `gap_tol` (a near-tie that summation order may flip; after it the
    contexts differ).  -> report; with `strict`, raises on a diverging
    request whose first difference is not such a near-tie (the control,
    two reuse-off runs, only reports them under "above_tol").  The other
    gates pass their runs as `on` and their reference run as `off`."""
    under = sum(gap <= gap_tol(t1) for rows in off_rows.values() for _, t1, gap in rows)
    diverged, bad, noise = [], [], 0.0
    for rid in sorted(off):
        j = next((i for i, (a, b) in enumerate(zip(on[rid], off[rid])) if a != b), None)
        stop = len(off[rid]) if j is None else j
        for (_, t_on, _), (_, t_off, _) in zip(on_rows[rid][:stop], off_rows[rid][:stop]):
            noise = max(noise, abs(t_on - t_off))
        if j is not None:
            _, top1, gap = off_rows[rid][j]
            diverged.append({"rid": rid, "position": j, "gap": gap, "tol": gap_tol(top1)})
            if gap > gap_tol(top1):
                bad.append(rid)
    rep = {"positions": sum(len(r) for r in off_rows.values()),
           "positions_under_gap": int(under), "diverged": diverged,
           "max_top1_logit_diff_before_divergence": noise, "gap_ulps": GAP_ULPS,
           "above_tol": bad}
    if bad and strict:
        raise RuntimeError(f"{label} token gate: requests {bad} decode other tokens than "
                           f"the reference run where its gap exceeds its tolerance: "
                           f"{diverged}")
    return rep


class AdmitTap:
    """Copies, on the card, the fp32 bytes the store writes for each block
    at its admission (an fp32 block keeps no payload of its own: its arena
    slots are its bytes), for `store_checks` to hold the arena against."""

    def __init__(self):
        self.bytes = {}
        self.saved = BS.SharedBlockStore._admit

    def __enter__(self):
        tap, admit = self, self.saved

        def tapped(store, key, kind, data_k, data_v, scale_k, scale_v, *a, **kw):
            blk = admit(store, key, kind, data_k, data_v, scale_k, scale_v, *a, **kw)
            if blk is not None:
                tap.bytes[key] = tuple(
                    (d if s is None else BS.dequantize_rows(d, s)).to(
                        store.pool.device, torch.float32, copy=True)
                    for d, s in ((data_k, scale_k), (data_v, scale_v)))
            return blk
        BS.SharedBlockStore._admit = tapped
        return self

    def __exit__(self, *exc):
        BS.SharedBlockStore._admit = self.saved


def store_checks(label, engine, admitted):
    """No page leaked, no reference held, the ownership partition intact,
    and every resident block's arena slots still hold the bytes the store
    wrote at its admission (`admitted`, from `AdmitTap`)."""
    pool, store = engine.pool, engine.store
    if pool.stats().pages_in_use or engine.prefill_states:
        raise RuntimeError(f"{label}: {pool.stats().pages_in_use} pages still held after "
                           "the run")
    if any(b.refcount for b in store.blocks.values()):
        raise RuntimeError(f"{label}: store references still held after the run")
    BS.check_partition(pool, store)
    for blk in store.blocks.values():
        sl = torch.from_numpy(blk.slots).to(pool.device)
        p, o = sl // pool.page_size, sl % pool.page_size
        want_k, want_v = admitted[blk.key]
        if not (torch.equal(pool.arena_k[p, o], want_k)
                and torch.equal(pool.arena_v[p, o], want_v)):
            raise RuntimeError(f"{label}: store block {blk.key} overwritten in the arena")


def prefix_rows_vs_private(engine, plans, reuse, private):
    """The prefix tier's stored rows against the rows each request of the
    same key wrote privately in the reuse-off run.  -> (pairs compared,
    pairs bitwise equal, max abs diff)."""
    store = engine.store
    pairs = equal = 0
    diff = 0.0
    for rid, (plan, _, _, have) in plans.items():
        ru = reuse[rid]
        key = ru.prefix_key + BS.shape_bucket(plan, have, engine.sel, engine.bucket)
        blk = store.peek(key)
        if blk is None or rid not in private:
            continue
        sl = torch.from_numpy(blk.slots).to(engine.pool.device)
        p, o = sl // engine.pool.page_size, sl % engine.pool.page_size
        for arena, mine in zip((engine.pool.arena_k, engine.pool.arena_v), private[rid]):
            stored = arena[p, o]
            pairs += 1
            equal += bool(torch.equal(stored, mine))
            diff = max(diff, float((stored - mine).abs().max()))
    return pairs, equal, diff


def kv_reuse_phase(system, pool_rv, prof, cfg, dev, args):
    """Phase 2e: the shared block store on the serving path at full width
    and depth.  A repeat-user Zipf trace is served with reuse off twice
    (the control) and on, wave then chunked (fp32 store), then chunked
    with int8 payloads, a spill tier and a store page budget that forces
    evictions.  -> (report, block-gather recorder, B3 recorder of the
    reuse-on runs, launches per run)."""
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    trace = WL.zipf_repeat_trace(system.catalog, pool_rv, prof, KV_REQUESTS, qps=args.qps,
                                 n_users=KV_USERS, n_candidates=8)
    reqs, plans, reuse = SERVE.rcllm_requests(system, trace, args.decode_steps)
    n_instr = len(system.instruction)
    log(f"kv_reuse (phase 2e): {len(reqs)} requests over {len(set(r.user_id for r in trace))} "
        f"of {KV_USERS} users (Zipf), 8 candidates each from the {system.catalog.n_items}-item "
        f"catalog, {args.decode_steps} output tokens, prompts "
        f"{min(r.n_tokens for r in reqs)}-{max(r.n_tokens for r in reqs)} tokens; pool "
        f"512 pages x 16 slots; depth {cfg.n_layers}")
    lap("trace")
    gather_rec = GatherRecorder(BO.assemble_kv)
    store_rec = StoreDecodeRecorder(PO.paged_decode_mha)
    saved = [(ENG, "assemble_kv", ENG.assemble_kv), (BE, "paged_decode_mha", BE.paged_decode_mha)]
    ENG.assemble_kv = gather_rec
    out, launches = {"runs": {}}, {}
    try:
        for sched in ("wave", "chunked"):
            gen, rows = {}, {}
            for kind in ("off", "off2", "on"):
                kv = kind == "on"
                config = ServeConfig(decode_steps=args.decode_steps, sched=sched, kv_reuse=kv)
                # B3 is recorded over store-shared pages only: in the reuse-on runs
                BE.paged_decode_mha = store_rec if kv else saved[1][2]
                reset_counts()
                t0 = time.perf_counter()
                with LogitTap() as tap, PrefixRowTap(n_instr) as ptap, AdmitTap() as admitted:
                    engine, backend, batcher, done = SERVE.serve(
                        system.model, cfg, config, reqs, plans, system.rows, reuse)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                label = f"kv_reuse_{sched}_{kind}"
                launches[label] = counts()
                rep = SERVE.report(config, engine, backend, batcher.workers, done, warmup=True)
                log_serve(f"{sched} reuse {kind} ({wall:.1f} s)", rep, None)
                check_served(label, launches[label], RCLLM_KERNELS[1:], done, backend,
                             argparse.Namespace(requests=len(reqs)), config, cfg)
                gen[kind], rows[kind] = dict(backend.generated), tap.rows
                run = {"serve": rep, "wall_s": wall, "launches": launches[label]}
                if kv:
                    st = engine.store.stats()
                    store_checks(label, engine, admitted.bytes)
                    if not (st["hits_user"] and st["hits_item"] and st["hits_prefix"]):
                        raise RuntimeError(f"{label}: a tier saw no hit: {st}")
                    run["store"] = st
                    run["gate"] = token_gate(gen["on"], gen["off"], rows["on"], rows["off"])
                    pairs, equal, diff = prefix_rows_vs_private(engine, plans, reuse,
                                                                private)
                    run["prefix_rows"] = {"pairs": pairs, "bitwise_equal": equal,
                                          "max_abs_diff": diff}
                    log(f"  store: {st}")
                    log(f"  kernel launches: {launches[label]}")
                    log_gate("token gate (reuse on vs off)", run["gate"], len(reqs))
                    log(f"  prefix rows: {equal} of {pairs} (stored block, private rows of "
                        f"the off run) K/V pairs bitwise equal; max abs diff {diff:.3g}")
                elif kind == "off":
                    private = ptap.rows
                else:
                    run["control"] = token_gate(gen["off2"], gen["off"], rows["off2"],
                                                rows["off"], strict=False)
                    log_gate("control (reuse off twice)", run["control"], len(reqs))
                out["runs"][label] = run
                del engine, backend, batcher
                torch.cuda.empty_cache()
                lap(label)
        # int8 payloads, a host spill tier, a small store budget
        store = StoreConfig(kv_store_dtype="int8", spill_mb=INT8_SPILL_MB)
        config = ServeConfig(decode_steps=args.decode_steps, sched="chunked", kv_reuse=True,
                             store=store)
        BE.paged_decode_mha = store_rec
        reset_counts()
        t0 = time.perf_counter()
        late = [dataclasses.replace(r, arrival_s=r.arrival_s + INT8_WAVE_GAP_S)
                if r.rid >= len(reqs) // 2 else r for r in reqs]
        with AdmitTap() as admitted:
            engine, backend, batcher, done = serve_store_budget(system, cfg, config, late,
                                                                plans, reuse, INT8_STORE_PAGES)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = "kv_reuse_chunked_int8"
        launches[label] = counts()
        rep = SERVE.report(config, engine, backend, batcher.workers, done, warmup=True)
        st = engine.store.stats()
        log_serve(f"chunked reuse on, int8 + spill {INT8_SPILL_MB} MB, store budget "
                  f"{INT8_STORE_PAGES} pages, second half {INT8_WAVE_GAP_S:.0f} s later on "
                  f"the batcher's clock ({wall:.1f} s)", rep, None)
        log(f"  store: {st}")
        check_served(label, launches[label], RCLLM_KERNELS[1:], done, backend,
                     argparse.Namespace(requests=len(reqs)), config, cfg)
        store_checks(label, engine, admitted.bytes)
        if not st["spills"] or not st["spill_hits"]:
            raise RuntimeError(f"{label}: no spill or no promotion from the spill tier: {st}")
        same = sum(backend.generated[r] == gen["off"][r] for r in gen["off"])
        out["runs"][label] = {"serve": rep, "wall_s": wall, "store": st,
                              "launches": launches[label], "tokens_equal_off": same}
        log(f"  {same}/{len(reqs)} requests decoded the reuse-off tokens (int8 payloads "
            "change the cached bytes)")
        del engine, backend, batcher
        torch.cuda.empty_cache()
        lap(label)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if not sum(launches[f"kv_reuse_{s}_on"]["block_gather:prefix"] for s in ("wave", "chunked")):
        raise RuntimeError("no prefix-tier hit reached the selective layers through the "
                           "block gather's second pool")
    if store_rec.args is None:
        raise RuntimeError("no paged-decode call of the reuse-on runs read a view with a "
                           "page shared by two rows and a dead slot inside a row")

    # where the time goes: prefill then decode of every request in one batch,
    # reuse off, reuse on over a cold store (every block inserted, the item
    # inserts copies on the card) and over the warm store it left
    steps = args.decode_steps - 1
    sel = ENG.SelectiveConfig(window=16)
    profiles = {}
    for label, kv in (("off", False), ("on_cold", True)):
        engine = API.build_engine(system.model, cfg, ServeConfig(kv_reuse=kv), sel=sel,
                                        cache=system.rows)
        passes = [(label, kv)] + ([("on_warm", True)] if kv else [])
        for name, _ in passes:
            for phase, fn in zip(("prefill", "decode"),
                                 warm_run(engine, plans, steps, reuse if kv else None)):
                wall, busy, top, memcpy_s, n_memcpy = device_busy(fn)
                profiles[f"{name}_{phase}"] = {
                    "wall_s": wall, "device_busy_s": busy,
                    "device_busy_share": None if busy is None else busy / wall,
                    "host_card_memcpy_s": memcpy_s, "host_card_memcpy_count": n_memcpy,
                    "top_device": top}
        if kv:
            profiles["on_store"] = engine.store.stats()
        del engine
        torch.cuda.empty_cache()
    lap("profiles")
    for name in ("off", "on_cold", "on_warm"):
        for phase in ("prefill", "decode"):
            p = profiles[f"{name}_{phase}"]
            busy = p["device_busy_s"]
            log(f"  profiled {phase}, reuse {name} ({len(plans)} requests, one batch): wall "
                f"{p['wall_s']:.3f} s, device busy "
                f"{'not measured' if busy is None else f'{busy:.3f} s'}, busy share "
                f"{p['device_busy_share']}; host<->card memcpy "
                f"{p['host_card_memcpy_s'] * 1e3:.3f} ms in {p['host_card_memcpy_count']} "
                "copies")
    out["profiles"] = profiles
    out["seconds"] = laps
    log("  phase 2e seconds by step: " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()))
    return out, gather_rec, store_rec, launches


def log_gate(title, g, n_req):
    where = "; ".join(f"rid {d['rid']} at {d['position']} (gap {d['gap']:.4g}, tol "
                      f"{d['tol']:.4g})" for d in g["diverged"])
    log(f"  {title}: {len(g['diverged'])} of {n_req} requests diverge"
        f"{', ' + str(len(g['above_tol'])) + ' above the tolerance' if g['above_tol'] else ''}"
        f" [{where}]; {g['positions_under_gap']} of {g['positions']} positions under the "
        f"{GAP_ULPS}-bf16-ulp gap; max |top-1 logit difference| before divergence "
        f"{g['max_top1_logit_diff_before_divergence']:.4g}")


def serve_store_budget(system, cfg, config, reqs, plans, reuse, max_pages):
    """`SERVE.serve` with the store's page budget cut to `max_pages`."""
    sel = ENG.SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev, window=16)
    engine = API.build_engine(system.model, cfg, config, sel=sel, cache=system.rows)
    engine.store.max_pages = max_pages
    backend = API.build_backend(engine, config, plans=plans, reuse=reuse)
    batcher = API.build_batcher(backend, config)
    done = sorted(batcher.run(list(reqs)), key=lambda c: c.rid)
    return engine, backend, batcher, done


# ---------------------------------------------------------------- cluster
class CopyTimer:
    """CUDA events around every migration's pool export (the private
    pages gathered on the card) and import (scattered into the other
    worker's arena), as served: the card is synchronised before each call,
    so the events bracket that call alone, its host bookkeeping and any
    allocation included.  Also keeps the pages each export moved."""

    def __init__(self):
        self.ms, self.calls, self.pages = 0.0, 0, []
        self.saved = [(PagedKVPool, n, getattr(PagedKVPool, n))
                      for n in ("export_request", "import_request")]

    def __enter__(self):
        tap = self
        for cls, name, fn in self.saved:
            def timed(pool, *a, _fn=fn, **kw):
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = _fn(pool, *a, **kw)
                ev[1].record()
                torch.cuda.synchronize()
                tap.ms += ev[0].elapsed_time(ev[1])
                tap.calls += 1
                if _fn.__name__ == "export_request":
                    tap.pages.append(out.n_pages)
                return out
            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


def copy_kernels_ms(pool, n_pages):
    """The page copies of one migration of `n_pages` pages alone, warm
    (CUDA events, median of 20): the export's gather of both arenas and
    the import's scatter of them, here back into the same pages (a
    drained pool: the bytes do not change)."""
    pages = list(range(1, n_pages + 1))
    idx = torch.tensor(pages, device=pool.device)
    slots = pool.page_slots(pages)

    def one():
        k, v = pool.arena_k.index_select(0, idx), pool.arena_v.index_select(0, idx)
        tail = tuple(k.shape[2:])
        pool.write_slots(slots, k.reshape(-1, *tail), v.reshape(-1, *tail))
    return time_ms(one)


def cluster_checks(label, cluster, admitted):
    """Every worker: no page held, the partition intact, each store
    block's slots still its admission bytes, nothing the cluster bound
    kept alive."""
    for w, backend in enumerate(cluster.backends):
        engine = backend.engine
        if engine.store is not None:
            store_checks(f"{label} worker {w}", engine, admitted)
        elif engine.pool.stats().pages_in_use or engine.prefill_states:
            raise RuntimeError(f"{label} worker {w}: pages still held after the run")
        else:
            BS.check_partition(engine.pool)
        if backend.plans or backend.reuse or backend.pending_transfer_s:
            raise RuntimeError(f"{label} worker {w}: plans kept after the run")


def cluster_phase(system2, pool_rv, prof, cfg, args):
    """Phase 2f: the multi-instance cluster at full width and depth.  Two
    engine workers over the same model object and cached rows, the item
    caches sharded by the placement, serve the launcher trace five times:
    wave under the Eq. 2 affinity router and under round robin (reuse
    off), chunked with the fp32 block store unified and disaggregated (one
    prefill, one decode worker: every request's KV migrates), and chunked
    with int8 payloads, a spill tier and prefetch, the trace's second half
    60 s later on the batcher's clock.  -> (report, launches per run)."""
    trace = SERVE.launcher_trace(system2, pool_rv, prof, CLUSTER_REQUESTS, args.qps)
    half = len(trace) // 2
    late = [dataclasses.replace(r, arrival_s=r.arrival_s + INT8_WAVE_GAP_S) if i >= half
            else r for i, r in enumerate(trace)]
    base = ServeConfig(k=2, decode_steps=args.decode_steps)
    runs = [
        ("wave_affinity", base, trace),
        ("wave_round_robin", base.replace(policy="round_robin"), trace),
        ("chunked_reuse", base.replace(sched="chunked", kv_reuse=True), trace),
        ("chunked_reuse_disagg", base.replace(
            sched="chunked", kv_reuse=True,
            disagg=API.DisaggConfig(prefill_workers=1, decode_workers=1)), trace),
        ("chunked_int8_prefetch", base.replace(
            sched="chunked", kv_reuse=True, n_pages=CLUSTER_INT8_PAGES,
            store=StoreConfig(kv_store_dtype="int8", spill_mb=INT8_SPILL_MB,
                              prefetch_pages_per_tick=8)), late),
    ]
    log(f"cluster (phase 2f): k = 2 workers on one card, {len(trace)} requests of the "
        f"launcher trace at {args.qps:g}/s, {args.decode_steps} output tokens, prompts "
        f"{min(len(r.history_tokens) for r in trace)}+ history tokens; depth {cfg.n_layers}; "
        "transfers and migrations billed from the cost model (H100 SXM rates, 100 Gbps "
        "network), the on-card migration copies timed with CUDA events")
    out, launches, gen, rows = {"runs": {}}, {}, {}, {}
    hot = set(int(h) for h in system2.placement.hot_items)
    for label, config, tr in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with LogitTap() as tap, AdmitTap() as admitted, CopyTimer() as copies:
            cluster = ClusterEngine(system2, config)
            if label == "chunked_int8_prefetch":
                for b in cluster.backends:
                    b.engine.store.max_pages = CLUSTER_INT8_STORE_PAGES
            crep = cluster.run(tr, decode_steps=config.decode_steps)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        rep = SERVE.cluster_report(config, cluster, crep, warmup=True)
        if rep["requests"] != len(tr) or any(
                len(crep.generated[r]) != config.decode_steps for r in range(len(tr))):
            raise RuntimeError(f"cluster {label}: {rep['requests']} of {len(tr)} requests "
                               "completed with their full output")
        cluster_checks(f"cluster {label}", cluster, admitted.bytes)
        gen[label], rows[label] = dict(crep.generated), tap.rows
        ws = crep.workers
        line = {
            "ttft_p50_ms": rep["ttft_p50_s"] * 1e3, "ttft_p99_ms": rep["ttft_p99_s"] * 1e3,
            "tbt_p50_ms": (None if rep["tbt_p50_s"] is None else rep["tbt_p50_s"] * 1e3),
            "tok_s": rep["throughput_tok_s"], "mean_hit_rate": rep["mean_hit_rate"],
            "transfer_blocks": sum(w.transfer_blocks for w in ws),
            "transfer_mb": sum(w.transfer_bytes for w in ws) / 1e6,
            "transfer_billed_s": sum(w.transfer_seconds for w in ws),
            "migrations": sum(w.migrations for w in ws),
            "migration_mb": sum(w.migration_bytes for w in ws) / 1e6,
            "migration_billed_s": sum(w.migration_s for w in ws),
            "migration_digest_hits": sum(w.migration_digest_hits for w in ws),
            "migration_copy_ms_measured": copies.ms, "migration_copy_calls": copies.calls,
            "migration_pages_exported": sum(copies.pages),
            "prefetch_promotions": sum(w.prefetch_promotions for w in ws),
            "spill_hits": sum(w.spill_hits for w in ws),
            "transfers_avoided": sum((w.kv_reuse or {}).get("transfers_avoided", 0)
                                     for w in ws),
            "peak_gb": peak, "wall_s": wall, "assigned_per_worker": [w.n_requests for w in ws]}
        log(f"  {label} ({wall:.1f} s): TTFT p50 {line['ttft_p50_ms']:.1f} ms p99 "
            f"{line['ttft_p99_ms']:.1f} ms; TBT p50 {line['tbt_p50_ms']:.1f} ms; "
            f"{line['tok_s']:.1f} tok/s; hit rate {line['mean_hit_rate']:.3f}; transfers "
            f"{line['transfer_blocks']} blocks {line['transfer_mb']:.2f} MB billed "
            f"{line['transfer_billed_s'] * 1e3:.3f} ms; migrations {line['migrations']} "
            f"({line['migration_mb']:.2f} MB billed {line['migration_billed_s'] * 1e3:.3f} ms, "
            f"{line['migration_digest_hits']} digest hits; measured on-card copy "
            f"{copies.ms:.3f} ms in {copies.calls} calls); prefetch promotions "
            f"{line['prefetch_promotions']}, spill hits {line['spill_hits']}, transfers "
            f"avoided {line['transfers_avoided']}; peak {peak:.1f} GB; per worker "
            f"{line['assigned_per_worker']}")
        log(f"    kernel launches: {launches[label]}")
        out["runs"][label] = {"line": line, "serve": rep}
        if label == "wave_round_robin":
            recs = [(w, t) for w, b in enumerate(cluster.backends) for t in b.shard.transfers]
            bad = [(w, t) for w, t in recs if t.item_id in hot or t.src_instance == w]
            if not recs or bad:
                raise RuntimeError(f"cluster {label}: transfer ledger {len(recs)} records, "
                                   f"naming hot items or the worker's own shard: {bad}")
        if label == "chunked_reuse_disagg":
            pre, dec = ws
            decode_ticks = sum(t.decode_tokens > 0 for t in cluster.batcher.workers[1].ticks)
            if not (pre.migrated_out > 0 and dec.migrations == pre.migrated_out
                    and dec.migration_digest_hits > 0 and decode_ticks > 0):
                raise RuntimeError(f"cluster {label}: migrated_out {pre.migrated_out}, "
                                   f"migrations {dec.migrations}, digest hits "
                                   f"{dec.migration_digest_hits}, decode ticks on the decode "
                                   f"worker {decode_ticks}")
            line["decode_worker_decode_ticks"] = decode_ticks
            n = round(float(np.mean(copies.pages)))
            line["copy_kernels_ms_per_migration"] = copy_kernels_ms(
                cluster.backends[1].engine.pool, n)
            line["copy_kernels_pages"] = n
            log(f"    the page copies alone at the mean migration's {n} pages "
                f"({n * cluster.backends[1].engine.pool.page_size} slots), warm: "
                f"{line['copy_kernels_ms_per_migration']:.4f} ms per migration "
                f"(gather + scatter, both arenas)")
        if label == "chunked_int8_prefetch" and not line["prefetch_promotions"]:
            raise RuntimeError(f"cluster {label}: no prefetch promotion: "
                               f"{[w.kv_reuse for w in ws]}")
        del cluster, crep
    first, second = out["runs"]["wave_affinity"]["line"], out["runs"]["wave_round_robin"]["line"]
    if first["mean_hit_rate"] < second["mean_hit_rate"]:
        raise RuntimeError(f"affinity hit rate {first['mean_hit_rate']} below round robin's "
                           f"{second['mean_hit_rate']}")
    for on, off in (("wave_round_robin", "wave_affinity"),
                    ("chunked_reuse_disagg", "chunked_reuse")):
        g = token_gate(gen[on], gen[off], rows[on], rows[off])
        out["runs"][on]["gate_vs_" + off] = g
        log_gate(f"token gate ({on} vs {off})", g, len(trace))
    used = {n: sum(run[n] for run in launches.values())
            for n in ("selective_attention", "paged_decode_attention", "block_gather",
                      "block_gather:prefix")}
    missing = [n for n, c in used.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched in the cluster phase: {missing}")
    return out, launches


# ---------------------------------------------------------------- server
def pool_at_capacity(label, engine):
    """No page held and every page back on the free list, less the pages
    the block store keeps resident (none without a store)."""
    pool = engine.pool
    held = sum(len(b.pages) for b in engine.store.blocks.values()) if engine.store else 0
    if pool.stats().pages_in_use or engine.prefill_states \
            or pool.free_pages != pool.n_pages - 1 - held:
        raise RuntimeError(f"{label}: {pool.free_pages} pages free of {pool.n_pages - 1} "
                           f"({held} held by the store) after the drain")


def server_phase(system, reqs, plans, reuse, cfg, args, closed):
    """Phase 2g: the asyncio session server over the phase-2 system at full
    width and depth.  The launcher trace replayed at speed 0, wave then
    chunked, must decode phase 2's and 2c's closed-loop tokens (`closed`:
    sched -> (tokens, logit rows); the strict token gate, since the worker's
    clock adds measured seconds and batches may form otherwise), with B2,
    B3 and B4 launched and the pool back to capacity.  Then open loop at
    speed 1, chunked with the block store on: one session is cancelled
    while queued, one mid-prefill and one mid-decode, at tick boundaries;
    the rest must pass the gate against the chunked replay, and the pool,
    the store's partition and its blocks' arena bytes must be clean.
    -> (report, launches per run)."""
    need = ("selective_attention", "paged_decode_attention", "block_gather")
    report, launches, replayed = {}, {}, {}
    submits = SERVE.submits_of(reqs, plans)
    for sched in ("wave", "chunked"):
        config = ServeConfig(decode_steps=args.decode_steps, sched=sched)
        reset_counts()
        t0 = time.perf_counter()
        with LogitTap() as tap:
            engine, backend, done, server = SERVE.serve_sessions(system.model, cfg, config,
                                                                 submits, system.rows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"server_{sched}"] = run = counts()
        missing = [n for n in need if run[n] == 0]
        if missing:
            raise RuntimeError(f"server replay ({sched}): kernels never launched: {missing}")
        tokens = {rid: list(c.tokens) for rid, c in done.items()}
        bad = [rid for rid, c in done.items()
               if c.reason != "length" or len(c.tokens) != args.decode_steps]
        if bad or sorted(tokens) != sorted(closed[sched][0]):
            raise RuntimeError(f"server replay ({sched}): sessions {bad} did not complete")
        gate = token_gate(tokens, closed[sched][0], tap.rows, closed[sched][1],
                          label=f"server replay ({sched})")
        pool_at_capacity(f"server replay ({sched})", engine)
        replayed[sched] = (tokens, tap.rows)
        # TTFT on the worker's clock, as the closed loop reports it (the
        # replay stamps arrivals in trace time, so the online TTFT is not one)
        rep = SERVE.report(config, engine, backend, [server.worker],
                           sorted(server.worker.done, key=lambda c: c.rid), warmup=True)
        report[f"replay_{sched}"] = {"wall_s": wall, "gate": gate, "serve": rep,
                                     "launches": run}
        log(f"server replay, speed 0, {sched}: {wall:.1f} s; {len(done)} sessions, "
            f"{len(gate['diverged'])} part from the closed loop (each at a near-tie: "
            f"{gate['diverged']}); launches {run}")
        log_serve(f"replay {sched}", rep, None)
        del engine, backend, server

    # open loop: the first arrival is cancelled mid-decode, the last while
    # queued, the longest prompt between them mid-prefill
    from repro_torch.serving.server import AsyncSessionServer, replay

    config = ServeConfig(decode_steps=args.decode_steps, sched="chunked", kv_reuse=True)
    order = sorted(reqs, key=lambda r: (r.arrival_s, r.rid))
    victims = {"decoding": order[0].rid, "waiting": order[-1].rid,
               "prefilling": max(order[1:-1], key=lambda r: r.n_tokens).rid}
    engine = API.build_engine(system.model, cfg, config, cache=system.rows,
                              sel=ENG.SelectiveConfig(r_item=config.r_item,
                                                      r_rev=config.r_rev, window=16))
    backend = API.build_backend(engine, config)
    server = AsyncSessionServer(backend, config)
    stages = {}
    worker_cancel, apply_cancels = server.worker.cancel, server._apply_cancels

    def recorded_cancel(rid):
        stages[rid] = worker_cancel(rid)
        return stages[rid]

    def at_boundary():
        w = server.worker
        if any(r.rid == victims["waiting"] for r in w.waiting):
            server.cancel(victims["waiting"])
        st = engine.prefill_states.get(victims["prefilling"])
        if st is not None and st.started:
            server.cancel(victims["prefilling"])
        if victims["decoding"] in w.decoding \
                and len(backend.generated.get(victims["decoding"], ())) >= 2:
            server.cancel(victims["decoding"])
        apply_cancels()

    server.worker.cancel, server._apply_cancels = recorded_cancel, at_boundary
    reset_counts()
    t0 = time.perf_counter()
    with LogitTap() as tap, AdmitTap() as admitted:
        done = asyncio.run(replay(server, SERVE.submits_of(reqs, plans, reuse), speed=1.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["server_open_loop"] = counts()
    want = {rid: stage for stage, rid in victims.items()}
    if stages != want or any(done[rid].reason != "cancelled" for rid in want):
        raise RuntimeError(f"server open loop: cancels landed at {stages}, want {want}; "
                           f"reasons {({rid: done[rid].reason for rid in want})}")
    rest = [rid for rid in done if rid not in want]
    if any(done[rid].reason != "length" for rid in rest):
        raise RuntimeError(f"server open loop: {({r: done[r].reason for r in rest})}")
    gate = token_gate({r: list(done[r].tokens) for r in rest},
                      {r: replayed["chunked"][0][r] for r in rest},
                      {r: tap.rows[r] for r in rest},
                      {r: replayed["chunked"][1][r] for r in rest},
                      label="server open loop")
    store_checks("server open loop", engine, admitted.bytes)
    pool_at_capacity("server open loop", engine)
    snap = server.metrics_snapshot()
    report["open_loop"] = {"wall_s": wall, "victims": victims, "stages": stages,
                           "gate": gate, "online": snap,
                           "block_store": engine.store.stats(),
                           "launches": launches["server_open_loop"],
                           "cancelled_tokens": {r: len(done[r].tokens) for r in want}}
    log(f"server open loop, speed 1, chunked, kv_reuse on: {wall:.1f} s; cancelled "
        f"{stages} (tokens streamed before: "
        f"{report['open_loop']['cancelled_tokens']}); {len(rest)} sessions completed, "
        f"{len(gate['diverged'])} part from the replay (near-ties: {gate['diverged']}); "
        f"pool and store clean")
    log(f"  open loop: online TTFT p50 {snap['ttft_p50_s'] * 1e3:.1f} ms p99 "
        f"{snap['ttft_p99_s'] * 1e3:.1f} ms; TBT p50 {snap['tbt_p50_s'] * 1e3:.1f} ms; "
        f"completed {snap['completed']}, cancelled {snap['cancelled']}")
    return report, launches


# --------------------------------------------------------------- ranking
# phase 2h: `benchmarks/bench_accuracy.py`'s fidelity protocol
RANK_TRACE = dict(n_requests=8, qps=5.0, n_users=12, n_candidates=10, reviews_per_user=2,
                  seed=99)
RANK_SEL = dict(r_item=0.3, r_rev=0.3, window=16)
RANK_METHODS = ("full", "rcllm", "cacheblend", "epic")
# the reference's gate on the int8 store's fidelity drop (its tiered-store
# benchmark), held on the tiny model; fp32 card vs CPU scores: summation
# order only (TF32 off)
INT8_DROP_MAX = 0.02
RANK_TOL = 1e-4


def rank_all(system, reqs, sel):
    """-> ({method or "int8": scores per request}, {the same: recompute
    fractions, but "full"}); "int8" is rcllm over the cached rows' int8
    round trip."""
    scores = {m: [] for m in RANK_METHODS}
    fracs = {m: [] for m in RANK_METHODS[1:]}
    for r in reqs:
        for m in RANK_METHODS:
            sc, st = system.rank(r, m, sel)
            if sc.shape != (len(r.candidate_items),) or not np.isfinite(sc).all():
                raise RuntimeError(f"rank {m}: scores {sc}")
            scores[m].append(sc)
            if st is not None:
                fracs[m].append(st.recompute_fraction())
    q = dataclasses.replace(system, rows=BS.int8_roundtrip_rows(system.rows))
    scores["int8"], fracs["int8"] = [], []
    for r in reqs:
        sc, st = q.rank(r, "rcllm", sel)
        scores["int8"].append(sc)
        fracs["int8"].append(st.recompute_fraction())
    return scores, fracs


def fidelities(scores):
    """Mean NDCG@10 of each method's ranking against Full-Recompute's."""
    return {m: float(np.mean([MET.ranking_agreement_ndcg(f, s, k=10)
                              for f, s in zip(scores["full"], scores[m])]))
            for m in scores if m != "full"}


def ranking_phase(system, pool_rv, prof, dev):
    """Phase 2h: `RcLLMSystem.rank` over the phase-2 system at full width
    and depth (random weights: NDCG is reported, not gated), under the
    fidelity protocol; B1, B2 and B4 must launch, and some B4 call must
    rotate cached keys to positions other than the request's (CacheBlend's
    original positions).  Then the tiny model: its card scores must equal
    its CPU scores within RANK_TOL, and its int8 fidelity drop on the card
    stay within INT8_DROP_MAX.  -> (report, launches per run)."""
    sel = ENG.SelectiveConfig(**RANK_SEL)
    reqs = SY.make_trace(system.catalog, pool_rv, prof, **RANK_TRACE)
    moved = [0, 0]     # rotated B4 calls, and those off the request positions
    gather = ENG.assemble_kv

    def tap(pool_k, pool_v, table, positions, **kw):
        if kw.get("rotate", True):
            moved[0] += 1
            ar = torch.arange(positions.shape[0], device=positions.device,
                              dtype=positions.dtype)
            moved[1] += bool((positions[:, 0] != ar).any())
        return gather(pool_k, pool_v, table, positions, **kw)

    reset_counts()
    t0 = time.perf_counter()
    ENG.assemble_kv = tap
    try:
        scores, fracs = rank_all(system, reqs, sel)
    finally:
        ENG.assemble_kv = gather
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rank": counts()}
    need = ("flash_attention", "selective_attention", "block_gather")
    missing = [n for n in need if launches["rank"][n] == 0]
    if missing or moved[1] == 0:
        raise RuntimeError(f"ranking: kernels never launched {missing}, or no block gather "
                           f"rotated off the request positions ({moved})")
    fid = fidelities(scores)
    report = {"requests": len(reqs), "prompt_tokens": [int(system.plan_for(r).n) for r in reqs],
              "wall_s": wall, "fidelity_ndcg10": fid,
              "recompute_frac": {m: float(np.mean(v)) for m, v in fracs.items()},
              "int8_fidelity_drop": fid["rcllm"] - fid["int8"],
              "rotated_gathers": moved[0], "rotated_off_request_positions": moved[1],
              "launches": launches["rank"]}
    log(f"ranking (phase 2h, full width, depth {system.cfg.n_layers}): {len(reqs)} requests "
        f"x 10 candidates, prompts {min(report['prompt_tokens'])}-"
        f"{max(report['prompt_tokens'])} tokens, {wall:.1f} s; NDCG@10 vs full: "
        + ", ".join(f"{m} {v:.4f}" for m, v in fid.items())
        + "; recompute fraction: "
        + ", ".join(f"{m} {v:.3f}" for m, v in report["recompute_frac"].items())
        + f"; int8 drop {report['int8_fidelity_drop']:.4f} (reported, not gated: random "
        f"weights); {moved[1]} of {moved[0]} rotated gathers off the request positions; "
        f"launches {launches['rank']}")

    # the tiny model (bench_accuracy's system) on the card and on the CPU
    from repro_torch.core.rcllm import make_tiny_system

    reset_counts()
    tiny, model = {}, None
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        tsys, tpool, tprof, _ = make_tiny_system(n_items=100, n_requests_hist=60,
                                                 k_instances=4, device=d, model=model)
        tiny[where] = rank_all(tsys, SY.make_trace(tsys.catalog, tpool, tprof,
                                                   **RANK_TRACE), sel)[0]
        model = copy.deepcopy(tsys.model).to("cpu")
    launches["rank_tiny"] = counts()
    err = max(float(np.abs(a - b).max()) for m in tiny["card"]
              for a, b in zip(tiny["card"][m], tiny["cpu"][m]))
    for m in tiny["card"]:
        for a, b in zip(tiny["card"][m], tiny["cpu"][m]):
            if not np.allclose(a, b, atol=RANK_TOL, rtol=RANK_TOL):
                raise RuntimeError(f"tiny rank {m}: card {a} vs CPU {b}")
    tfid = fidelities(tiny["card"])
    drop = tfid["rcllm"] - tfid["int8"]
    if drop > INT8_DROP_MAX:
        raise RuntimeError(f"tiny rank: int8 fidelity drop {drop:.4f} > {INT8_DROP_MAX}")
    report["tiny"] = {"max_abs_err_card_vs_cpu": err, "fidelity_ndcg10": tfid,
                      "int8_fidelity_drop": drop, "launches": launches["rank_tiny"]}
    log(f"  tiny model: card scores == CPU plain-version scores within {RANK_TOL} (max "
        f"{err:.2e}) for {', '.join(tiny['card'])}; NDCG@10 vs full "
        + ", ".join(f"{m} {v:.4f}" for m, v in tfid.items())
        + f"; int8 drop {drop:.4f} <= {INT8_DROP_MAX}")
    return report, launches


# ------------------------------------------------------------ LM steps
def _sync_s(fn):
    """(fn(), host seconds with the card synchronised before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _busy(label, fn):
    """device_busy of fn as a record (the output is dropped)."""
    wall, busy, top, _, _ = device_busy(fn)
    return {f"{label}_profiled_wall_s": wall, f"{label}_device_busy_s": busy,
            f"{label}_device_busy_share": None if busy is None else busy / wall,
            f"{label}_top_device": top}


def _check_logits(label, logits, cfg, rows):
    if tuple(logits.shape) != (rows, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"{label}: logits {tuple(logits.shape)} not finite or not "
                           f"({rows}, {cfg.vocab_size})")


def lm_prefill_cell(model, cfg, gen, dev, seq):
    """prefill_32k at batch 1: a profiled call (the warm-up), then a timed
    one."""
    tokens = RREG.make_batch(cfg, "prefill_32k", gen, dev, batch=1, seq=seq)
    cell = {"batch": 1, "seq": seq}
    cell.update(_busy("prefill", lambda: STEPS.prefill_step(model, tokens)))
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), wall = _sync_s(lambda: STEPS.prefill_step(model, tokens))
    _check_logits(f"{cfg.name} prefill", logits, cfg, 1)
    cell.update(wall_s=wall, tokens_per_s=seq / wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                cache_gb=2 * cache["k"].numel() * cache["k"].element_size() / 1e9)
    return cell


def lm_decode_cell(model, cfg, gen, dev, seq):
    """decode_32k with the batch cut to what leaves LM_FREE_GB free:
    LM_DECODE_STEPS greedy steps at staggered positions, then one more
    under the profiler.  The step's peak above what was allocated before
    it (scores and probabilities, a few per cent of a layer's cache) must
    stay under one layer's k cache: a copy of a layer's cache would not."""
    per_seq = 2 * cfg.n_layers * seq * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    b = max(1, min(RREG.LM_SHAPES["decode_32k"].dims["batch"],
                   int((free - LM_FREE_GB * 1e9) // per_seq)))
    batch = RREG.make_batch(cfg, "decode_32k", gen, dev, batch=b, seq=seq)
    # rows 37 positions apart in the cache's second half, with room for
    # every step below the capacity
    stagger = (37 * torch.arange(b, device=dev, dtype=torch.int32)) % (seq // 2)
    pos = seq - LM_DECODE_STEPS - 2 - stagger
    batch["positions"] = pos
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LM_DECODE_STEPS):
        (logits, _), t = _sync_s(lambda: STEPS.decode_step(model, batch))
        _check_logits(f"{cfg.name} decode", logits, cfg, b)
        times.append(t)
        batch["tokens"] = logits.argmax(-1).to(torch.int32)[:, None]
        batch["positions"] = batch["positions"] + 1
    extra = torch.cuda.max_memory_allocated() - before
    layer_k = b * seq * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    if extra > layer_k:
        raise RuntimeError(f"{cfg.name} decode: the step allocated {extra / 1e9:.3f} GB above "
                           f"weights + cache, over a layer's k cache ({layer_k / 1e9:.3f} GB)")
    cell = {"batch": b, "seq": seq, "steps": LM_DECODE_STEPS, "step_ms": [t * 1e3 for t in times],
            "ms_per_step": statistics.median(times[1:]) * 1e3,
            "cache_gb": b * per_seq / 1e9, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "step_extra_gb": extra / 1e9, "first_positions": pos[:4].tolist()}
    cell["tokens_per_s"] = b / (cell["ms_per_step"] / 1e3)
    cell.update(_busy("decode", lambda: STEPS.decode_step(model, batch)))
    return cell


def lm_generate(model, cfg, gen, dev):
    """Greedy generation at batch 1: an LM_GEN_PROMPT-token prefill, its
    cache copied into capacity LM_GEN_PROMPT + LM_GEN_TOKENS, then
    LM_GEN_TOKENS decode steps.  -> the generated tokens."""
    tokens = RREG.make_batch(cfg, "prefill_32k", gen, dev, batch=1, seq=LM_GEN_PROMPT)
    logits, cache = TT.prefill(model, tokens["tokens"])
    _check_logits(f"{cfg.name} generation prefill", logits, cfg, 1)
    shape = RREG.lm_kv_cache_shape(cfg, 1, LM_GEN_PROMPT + LM_GEN_TOKENS)
    full = {n: cache[n].new_zeros(shape) for n in "kv"}
    for n in "kv":
        full[n][:, :, :LM_GEN_PROMPT] = cache[n]
    del cache
    toks = [int(logits.argmax(-1))]
    pos = torch.full((1,), LM_GEN_PROMPT, dtype=torch.int32, device=dev)
    for _ in range(LM_GEN_TOKENS):
        logits, full = TT.decode_step(model, torch.tensor([[toks[-1]]], device=dev), full, pos)
        _check_logits(f"{cfg.name} generation", logits, cfg, 1)
        toks.append(int(logits.argmax(-1)))
        pos += 1
    if not all(0 <= t < cfg.vocab_size for t in toks):
        raise RuntimeError(f"{cfg.name} generation: tokens out of the vocabulary {toks}")
    return toks


def _lm_close(label, got, want):
    err = float((got.float().cpu() - want.float()).abs().max())
    if not torch.allclose(got.float().cpu(), want.float(), rtol=LM_TOL, atol=LM_TOL):
        raise RuntimeError(f"{label}: card vs CPU max abs diff {err} beyond "
                           f"rtol=atol={LM_TOL}")
    return err


def lm_card_vs_cpu(dev):
    """Every assigned LM arch at reduced() size (fp32), and starcoder2's
    with an 8-token window: prefill of 2 x 40 tokens, then 4 greedy decode
    steps at positions 40 and 37 (capacity 48), on the card and on a CPU
    copy; logits and caches within LM_TOL, greedy tokens equal, and an
    MoE's routing (expert ids, kept routes, slot tokens) of the embedded
    prompt and of its last tokens equal."""
    cases = [(a, RREG.get_config(a, smoke=True)) for a in RREG.ARCHS
             if RREG.family_of(a) == "lm" and a != "rcllm-qwen3-8b"]
    cases.append(("starcoder2-15b:window8", dataclasses.replace(
        RREG.get_config("starcoder2-15b", smoke=True), sliding_window=8)))
    out = {}
    for label, cfg in cases:
        gen = torch.Generator(device=dev).manual_seed(0)
        model = TT.init_params(cfg, gen, dev)
        cpu = copy.deepcopy(model).to("cpu")
        toks = RREG.make_batch(cfg, "prefill_32k", gen, dev, batch=2, seq=40)["tokens"]
        errs = {}
        lg, cache = TT.prefill(model, toks)
        lc, cc = TT.prefill(cpu, toks.cpu())
        errs["prefill_logits"] = _lm_close(f"{label} prefill logits", lg, lc)
        errs["prefill_cache"] = max(_lm_close(f"{label} prefill cache {n}", cache[n], cc[n])
                                    for n in "kv")
        shape = RREG.lm_kv_cache_shape(cfg, 2, 48)
        big = {n: cache[n].new_zeros(shape) for n in "kv"}
        bigc = {n: cc[n].new_zeros(shape) for n in "kv"}
        for n in "kv":
            big[n][:, :, :40], bigc[n][:, :, :40] = cache[n], cc[n]
        pos = torch.tensor([40, 37], dtype=torch.int32)
        nxt = lc.argmax(-1)
        tokens = []
        for step in range(4):
            lg, big = TT.decode_step(model, nxt[:, None].to(dev), big, pos.to(dev))
            lc, bigc = TT.decode_step(cpu, nxt[:, None], bigc, pos)
            errs[f"decode{step}"] = _lm_close(f"{label} decode {step}", lg, lc)
            if not torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)):
                raise RuntimeError(f"{label} decode {step}: greedy tokens differ")
            nxt, pos = lc.argmax(-1), pos + 1
            tokens.append(nxt.tolist())
        errs["decode_cache"] = max(_lm_close(f"{label} decode cache {n}", big[n], bigc[n])
                                   for n in "kv")
        if cfg.moe is not None:
            # the embedded prompt (T = 80) and its last tokens (T = 2: C = 1, routes drop)
            dropped = []
            for rows in (slice(None), slice(-1, None)):
                routes = []
                for m, t in ((model, toks), (cpu, toks.cpu())):
                    x = TL.rms_norm(m.embed_tokens(t[:, rows]), m.layers[0].mlp_norm,
                                    cfg.norm_eps).reshape(-1, cfg.d_model)
                    routes.append(TL.moe_route(x, m.layers[0].moe["router"],
                                               n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                                               capacity_factor=cfg.moe.capacity_factor))
                for k in ("expert_idx", "keep_tk", "slot_tok", "slot_valid"):
                    if not torch.equal(routes[0][k].cpu(), routes[1][k]):
                        raise RuntimeError(f"{label}: MoE {k} differ between the card and the CPU")
                dropped.append(int((~routes[1]["keep_tk"]).sum()))
            errs["moe_dropped_routes_prompt"], errs["moe_dropped_routes_decode"] = dropped
        out[label] = {"max_abs_diff": errs, "greedy_tokens": tokens}
        log(f"check {label} at reduced() size (fp32), card == CPU copy: max abs diff "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (rtol=atol={LM_TOL}); greedy tokens equal {tokens}")
        del model, cpu
    return out


def lm_phase(dev):
    """Phase 2i: each of LM_ARCHS at published width and depth (bf16,
    random weights from a seeded generator, built alone on the card and
    freed after), then the reduced() card == CPU checks.  No kernel of
    the port runs here (the reference's LM attention is jnp): the counts
    must stay 0."""
    reset_counts()
    cells = []
    decode_seq = RREG.LM_SHAPES["decode_32k"].dims["seq"]
    for arch in LM_ARCHS:
        cfg = RREG.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        model, init_s = _sync_s(lambda: TT.init_params(cfg, gen, dev))
        param_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
        cell = {"arch": arch, "param_gb": param_gb, "init_s": init_s,
                "active_params": cfg.active_param_count()}
        t0 = time.perf_counter()
        cell["prefill"] = pre = lm_prefill_cell(model, cfg, gen, dev, LM_PREFILL_SEQ)
        gc.collect()
        cell["decode"] = dec = lm_decode_cell(model, cfg, gen, dev, decode_seq)
        gc.collect()
        cell["generated"] = lm_generate(model, cfg, gen, dev)
        cell["wall_s"] = time.perf_counter() - t0
        kind = f"MoE top-{cfg.moe.top_k} of {cfg.moe.n_experts}" if cfg.moe else cfg.mlp_type
        log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.resolved_head_dim}, {kind}, window "
            f"{cfg.sliding_window}; {param_gb:.2f} GB bf16 weights (init {init_s:.1f} s)")
        log(f"    prefill batch 1 x {pre['seq']}: {pre['wall_s']:.3f} s, "
            f"{pre['tokens_per_s']:.0f} tok/s, peak {pre['peak_gb']:.2f} GB (cache "
            f"{pre['cache_gb']:.2f} GB); profiled {pre['prefill_profiled_wall_s']:.3f} s, device "
            f"busy share {pre['prefill_device_busy_share']}; top device: "
            + "; ".join(f"{n} {ms:.1f} ms" for n, ms in pre["prefill_top_device"][:4]))
        log(f"    decode batch {dec['batch']} x {dec['seq']} (cache {dec['cache_gb']:.2f} GB): "
            f"{dec['ms_per_step']:.2f} ms/step (median of steps 2-{LM_DECODE_STEPS}), "
            f"{dec['tokens_per_s']:.1f} tok/s, peak {dec['peak_gb']:.2f} GB, step extra "
            f"{dec['step_extra_gb']:.4f} GB; profiled step {dec['decode_profiled_wall_s'] * 1e3:.2f}"
            f" ms, device busy share {dec['decode_device_busy_share']}; top device: "
            + "; ".join(f"{n} {ms:.2f} ms" for n, ms in dec["decode_top_device"][:4]))
        log(f"    greedy generation ({LM_GEN_PROMPT}-token prompt, {LM_GEN_TOKENS} steps): "
            f"{cell['generated']}")
        cells.append(cell)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    checks = lm_card_vs_cpu(dev)
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise RuntimeError(f"phase 2i launched port kernels {launched}: its attention is plain")
    return {"cells": cells, "card_vs_cpu": checks}


# ------------------------------------------------------------ training (2j)
# phase 2j: LM train steps at published width, depth cut to TRAIN_LAYERS,
# one fixed batch of 1 x TRAIN_SEQ tokens, TRAIN_STEPS AdamW steps; kimi-k2
# at reduced() with Adafactor
TRAIN_LM_ARCHS = ("rcllm-qwen3-8b", "gemma-7b", "nemotron-4-15b", "starcoder2-15b",
                  "moonshot-v1-16b-a3b")
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 3
# recsys train_batch at its published 65,536, each in this many
# microbatches (their gradients summed and divided by the count, the
# reference's accumulation): one BERT4Rec block's scores alone are 21 GB
# at the full batch, and DIEN keeps 2 x 100 GRU steps' activations
RECSYS_MICROBATCHES = {"wide-deep": 1, "autoint": 1, "dien": 4, "bert4rec": 8}
# the planted protocol: `benchmarks/bench_accuracy.py --planted`'s parameters
PLANTED = dict(n_requests=300, n_candidates=8, seed=5)
PLANTED_TRAIN, PLANTED_STEPS, PLANTED_CPU_STEPS = 240, 200, 10
PLANTED_EVAL = dict(n_requests=20, qps=5.0, n_users=12, n_candidates=10, reviews_per_user=2,
                    seed=99)
PLANTED_RATIOS = (0.1, 0.3, 0.5)
PLANTED_METHODS = ("rcllm", "cacheblend", "epic")
# card vs CPU (fp32, TF32 off): summation order only
TRAIN_TOL = 1e-4
TRAIN_KERNELS = ("flash_bwd", "bag_backward")


class BwdRecorder:
    """Wraps the attention backward where the training path calls it
    (`models.layers.mha_flash_bwd`) and keeps a copy of the inputs of
    the first CUDA call after each `arm(label)`."""

    def __init__(self, fn):
        self.fn, self.label, self.calls = fn, None, {}

    def arm(self, label):
        self.label = label

    def __call__(self, *args, **kwargs):
        if self.label is not None and args[0].is_cuda and self.label not in self.calls:
            self.calls[self.label] = (tuple(_snapshot(a) for a in args), dict(kwargs))
        return self.fn(*args, **kwargs)


class BagBwdRecorder:
    """Keeps the (ids, d_out, rows) of the latest CUDA bag-gradient call
    while armed (the recsys cells' run)."""

    def __init__(self, fn):
        self.fn, self.call, self.armed = fn, None, False

    def __call__(self, ids, d_out, rows):
        if self.armed and d_out.is_cuda:
            self.call = (ids, d_out.detach().clone(), rows)
        return self.fn(ids, d_out, rows)


def _graph_builder():
    """minibatch_lg's power-law graph and its CSR adjacency, built on a
    host thread (numpy's sort and search release the interpreter lock)
    while the LM and recsys cells run.  -> (thread, result dict)."""
    import threading

    from repro_torch.gnn import sampler as GS

    d = RREG.GNN_SHAPES["minibatch_lg"].dims
    out = {}

    def build():
        t0 = time.perf_counter()
        try:
            src, dst = GS.make_powerlaw_graph(d["n_nodes"], d["n_edges"], seed=0)
            out["graph"] = GS.CSRGraph(d["n_nodes"], src, dst)
        except Exception as e:     # re-raised by the phase that needs the graph
            out["error"] = e
        out["build_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=build, daemon=True)
    thread.start()
    return thread, out


def minibatch_inputs(graph, dev, seed=0):
    """One minibatch_lg batch from the real sampler: 1,024 seeds, fanout
    15-10 (169,984 nodes, 168,960 edges), node features standard normal
    and positions normal x 2 (drawn for the whole graph from a numpy
    generator, then gathered), the seeds' labels uniform over the 41
    classes."""
    from repro_torch.gnn import sampler as GS

    d = RREG.GNN_SHAPES["minibatch_lg"].dims
    rng = np.random.default_rng(seed)
    seeds = rng.choice(d["n_nodes"], d["batch_nodes"], replace=False)
    sub = GS.sample_subgraph(graph, seeds, d["fanout"], rng)
    ids = torch.from_numpy(sub["node_ids"].astype(np.int64)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(d["n_nodes"], d["d_feat"], device=dev, generator=gen)
    coords = torch.randn(d["n_nodes"], 3, device=dev, generator=gen) * 2.0
    batch = {"node_feat": feats[ids], "positions": coords[ids],
             "edge_src": torch.from_numpy(sub["edge_src"]).to(dev),
             "edge_dst": torch.from_numpy(sub["edge_dst"]).to(dev),
             "seed_labels": torch.randint(0, d["n_classes"], (d["batch_nodes"],),
                                          device=dev, generator=gen, dtype=torch.int32)}
    del feats, coords
    return batch


def train_cell(label, model, batch, steps=TRAIN_STEPS, microbatches=1, gate_fall=True):
    """`steps` train steps of `model` on one batch through the launcher's
    train step; peak memory above what was allocated before.  Gates: the
    losses and gradient norms finite, and (with `gate_fall`) the loss
    lower at the last step than at the first."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = STEPS.run_train(model, batch, steps, microbatches)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses + norms)):
        raise RuntimeError(f"train {label}: losses {losses}, gradient norms {norms}")
    if gate_fall and not losses[-1] < losses[0]:
        raise RuntimeError(f"train {label}: the loss did not fall, {losses}")
    return {"loss": losses, "gnorm": norms, "step_ms": [t * 1e3 for t in times],
            "ms_per_step": statistics.median(times[1:]) * 1e3,
            "peak_gb": peak / 1e9, "peak_above_start_gb": (peak - base) / 1e9,
            "microbatches": microbatches,
            "param_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9}


def lm_train_cells(dev, bwd_rec):
    """Each of TRAIN_LM_ARCHS at published width, TRAIN_LAYERS layers,
    TRAIN_STEPS AdamW steps on one batch of 1 x TRAIN_SEQ; K6 must launch
    in every arch.  Then kimi-k2 at reduced() size with Adafactor."""
    cells = {}
    for arch in TRAIN_LM_ARCHS:
        cfg = dataclasses.replace(RREG.get_config(arch), n_layers=TRAIN_LAYERS)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = TT.init_params(cfg, gen, dev)
        batch = RREG.make_batch(cfg, "train_4k", gen, dev, batch=1, seq=TRAIN_SEQ)
        before = FO.mha_flash_bwd.launches
        bwd_rec.arm(arch)
        cell = train_cell(arch, model, batch)
        bwd_rec.arm(None)
        cell.update(cuts={"n_layers": TRAIN_LAYERS, "batch": 1, "seq": TRAIN_SEQ},
                    optimizer=cfg.optimizer, flash_bwd_launches=FO.mha_flash_bwd.launches - before,
                    tokens_per_s=TRAIN_SEQ / (cell["ms_per_step"] / 1e3),
                    heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
                    window=cfg.sliding_window)
        if cell["flash_bwd_launches"] == 0:
            raise RuntimeError(f"train {arch}: the attention backward (K6) never launched")
        cells[arch] = cell
        log(f"  train {arch}: width {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
            f"{cfg.resolved_head_dim}, window {cfg.sliding_window}, cut to {TRAIN_LAYERS} "
            f"layers, batch 1 x {TRAIN_SEQ}; {cfg.optimizer} losses "
            + ", ".join(f"{x:.4f}" for x in cell["loss"])
            + f"; {cell['ms_per_step']:.1f} ms/step (median of steps 2-{TRAIN_STEPS}), peak "
            f"{cell['peak_gb']:.2f} GB ({cell['param_gb']:.2f} GB bf16 weights); K6 launches "
            f"{cell['flash_bwd_launches']}")
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
    cfg = RREG.get_config("kimi-k2-1t-a32b", smoke=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = TT.init_params(cfg, gen, dev)
    batch = RREG.make_batch(cfg, "train_4k", gen, dev, batch=2, seq=256)
    cell = train_cell("kimi-k2-1t-a32b reduced", model, batch)
    cell.update(cuts={"reduced": True, "batch": 2, "seq": 256}, optimizer=cfg.optimizer)
    if cfg.optimizer != "adafactor":
        raise RuntimeError(f"kimi-k2 trains with {cfg.optimizer}, want adafactor")
    cells["kimi-k2-1t-a32b:reduced"] = cell
    log(f"  train kimi-k2-1t-a32b at reduced() size (batch 2 x 256, {cfg.optimizer}): losses "
        + ", ".join(f"{x:.4f}" for x in cell["loss"]))
    return cells


def recsys_train_cells(dev, bag_rec):
    """The four recsys archs' train_batch at published width (65,536 rows,
    RECSYS_MICROBATCHES), TRAIN_STEPS AdamW steps; Wide&Deep must launch
    B5 in the forward and K7 in the backward."""
    cells = {}
    bag_rec.armed = True
    for arch, mb in RECSYS_MICROBATCHES.items():
        cfg = RREG.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = RM.init_params(cfg, gen, dev)
        batch = RREG.make_batch(cfg, "train_batch", gen, dev)
        before = (EO.bag_sum.launches, EO.bag_backward.launches)
        cell = train_cell(arch, model, batch, microbatches=mb, gate_fall=False)
        cell.update(batch=int(next(iter(batch.values())).shape[0]),
                    bag_sum_launches=EO.bag_sum.launches - before[0],
                    bag_backward_launches=EO.bag_backward.launches - before[1])
        if arch == "wide-deep" and min(cell["bag_sum_launches"],
                                       cell["bag_backward_launches"]) == 0:
            raise RuntimeError(f"train wide-deep: B5 {cell['bag_sum_launches']} / K7 "
                               f"{cell['bag_backward_launches']} launches")
        cells[arch] = cell
        log(f"  train {arch} train_batch: batch {cell['batch']} in {mb} microbatch(es); "
            "losses " + ", ".join(f"{x:.4f}" for x in cell["loss"])
            + f"; {cell['ms_per_step']:.1f} ms/step (median of steps 2-{TRAIN_STEPS}), peak "
            f"{cell['peak_gb']:.2f} GB; B5 / K7 launches {cell['bag_sum_launches']} / "
            f"{cell['bag_backward_launches']}")
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
    bag_rec.armed = False
    if bag_rec.call is None:
        raise RuntimeError("train wide-deep: no K7 call was recorded")
    return cells


def schnet_train_cells(dev, graph_job):
    """SchNet's full_graph_sm, molecule and minibatch_lg (the real power-law
    graph through the port's sampler) at published size, TRAIN_STEPS
    AdamW steps each."""
    cfg = RREG.get_config("schnet")
    cells = {}
    for shape in ("full_graph_sm", "molecule", "minibatch_lg"):
        gen = torch.Generator(device=dev).manual_seed(0)
        extra = {}
        if shape == "minibatch_lg":
            thread, job = graph_job
            t0 = time.perf_counter()
            thread.join()
            if "error" in job:
                raise job["error"]
            t1 = time.perf_counter()
            batch = minibatch_inputs(job["graph"], dev)
            extra = {"graph_build_s": job["build_s"], "graph_wait_s": t1 - t0,
                     "sample_s": time.perf_counter() - t1,
                     "sub_nodes": int(batch["node_feat"].shape[0]),
                     "sub_edges": int(batch["edge_src"].shape[0])}
            dims = RREG.GNN_SHAPES[shape].dims
            if (extra["sub_nodes"], extra["sub_edges"]) != (dims["sub_nodes"], dims["sub_edges"]):
                raise RuntimeError(f"minibatch_lg: sampled {extra['sub_nodes']} nodes / "
                                   f"{extra['sub_edges']} edges")
        else:
            batch = RREG.make_batch(cfg, shape, gen, dev)
        model = STEPS.init_model(cfg, gen, dev, shape)
        cell = train_cell(f"schnet {shape}", model, batch, gate_fall=False)
        cell.update(extra)
        cells[shape] = cell
        log(f"  train schnet {shape}: losses " + ", ".join(f"{x:.4f}" for x in cell["loss"])
            + f"; {cell['ms_per_step']:.2f} ms/step, peak {cell['peak_gb']:.2f} GB"
            + ("" if not extra else f"; graph built in {extra['graph_build_s']:.1f} s on a host "
               f"thread (waited {extra['graph_wait_s']:.1f} s), sampled "
               f"{extra['sub_nodes']} nodes / {extra['sub_edges']} edges in "
               f"{extra['sample_s']:.1f} s"))
        del model, batch
    return cells


def train_loop_check(dev):
    """`train()` at tiny size (gemma reduced, fp32) with checkpoints every 2
    steps: uninterrupted, then with step 5 failing past the retries, which
    restores the step-4 checkpoint; the second history must be the first
    with step 4 run twice (the card within 1e-6 of it; printed whether
    bitwise)."""
    import shutil

    from repro_torch.training.train_loop import TrainConfig, train

    cfg = RREG.get_config("gemma-7b", smoke=True)
    batch = RREG.make_batch(cfg, "train_4k", torch.Generator(device=dev).manual_seed(3), dev,
                            batch=2, seq=64)

    def data():
        while True:
            yield batch

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    hist = {}
    fails = {"n": 0}

    def inject(step):
        if step == 5 and fails["n"] < 4:
            fails["n"] += 1
            raise RuntimeError("injected node failure")

    for name, fi in (("clean", None), ("faulty", inject)):
        model = TT.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        hist[name] = train(model, STEPS.lm_loss, data(),
                           TrainConfig(steps=8, ckpt_dir=str(root / name), ckpt_every=2,
                                       max_retries=3), fail_injector=fi)[2]
    shutil.rmtree(root, ignore_errors=True)
    want = hist["clean"][:5] + hist["clean"][4:]
    got = hist["faulty"]
    err = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for a, b in zip(got, want) for k in a)
    if len(got) != len(want) or fails["n"] != 4 or err > 1e-6:
        raise RuntimeError(f"train loop: faulty history {got} vs {want} (failures {fails})")
    log(f"  train loop (tiny, checkpoints every 2, step 5 failing 4 times past 3 retries): "
        f"history equals the uninterrupted run's with step 4 repeated (max rel diff {err:.2e}, "
        f"bitwise {got == want})")
    return {"history": got, "max_rel_diff": err, "bitwise": got == want}


def planted_protocol(dev, bwd_rec):
    """`bench_accuracy.py --planted` on the card: the tiny system, the
    planted trace, `train_ranker` (the first PLANTED_CPU_STEPS losses also
    on a CPU copy, within TRAIN_TOL), the system rebuilt on the trained
    weights, and NDCG@10 against Full-Recompute of each method at each
    recompute ratio over PLANTED_EVAL's requests (B1, B2 and B4 must
    launch in that evaluation)."""
    from repro_torch.core import ranker_training as RT
    from repro_torch.core.rcllm import RcLLMSystem, make_tiny_system

    t0 = time.perf_counter()
    system, pool, prof, hist = make_tiny_system(n_items=150, n_requests_hist=60,
                                                k_instances=4, device=dev)
    reqs_t, gold_t = RT.make_planted_trace(system.catalog, pool, prof, **PLANTED)
    args = (system.cfg, system.catalog, system.instruction, reqs_t[:PLANTED_TRAIN],
            gold_t[:PLANTED_TRAIN])
    cpu_model = copy.deepcopy(system.model).to("cpu")
    t1 = time.perf_counter()
    _, cpu_hist = RT.train_ranker(cpu_model, *args, steps=PLANTED_CPU_STEPS, log_every=1)
    t2 = time.perf_counter()
    del cpu_model
    bwd_rec.arm("ranker")
    k6 = FO.mha_flash_bwd.launches
    model, card_hist = RT.train_ranker(system.model, *args, steps=PLANTED_STEPS, log_every=1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    k6 = FO.mha_flash_bwd.launches - k6
    bwd_rec.arm(None)
    card_l = np.array([v for _, v in card_hist])
    cpu_l = np.array([v for _, v in cpu_hist])
    err = float(np.abs(card_l[:PLANTED_CPU_STEPS] - cpu_l).max())
    if not np.allclose(card_l[:PLANTED_CPU_STEPS], cpu_l, rtol=TRAIN_TOL, atol=TRAIN_TOL):
        raise RuntimeError(f"planted: card losses {card_l[:PLANTED_CPU_STEPS]} vs CPU {cpu_l}")
    if not card_l[-1] < card_l[0] or k6 == 0:
        raise RuntimeError(f"planted: loss {card_l[0]} -> {card_l[-1]}, K6 launches {k6}")
    corpus, seen = [], set()
    for r in hist:
        if r.user_id not in seen:
            corpus.append(r.history_tokens)
            seen.add(r.user_id)
    trained = RcLLMSystem.build(model, system.cfg, system.catalog, corpus, hist, k_instances=4)
    reqs = SY.make_trace(trained.catalog, pool, prof, **PLANTED_EVAL)
    zero_div = layer0_divergence_zero(trained, reqs[:3])
    t4 = time.perf_counter()
    before = counts()
    full = [trained.rank(r, "full")[0] for r in reqs]
    ndcg, frac = {}, {}
    for ratio in PLANTED_RATIOS:
        sel = ENG.SelectiveConfig(r_item=ratio, r_rev=ratio, window=16)
        for m in PLANTED_METHODS:
            f, fr = [], []
            for r, fs in zip(reqs, full):
                sc, st = trained.rank(r, m, sel)
                if sc.shape != fs.shape or not np.isfinite(sc).all():
                    raise RuntimeError(f"planted rank {m}: scores {sc}")
                f.append(MET.ranking_agreement_ndcg(fs, sc, k=10))
                fr.append(st.recompute_fraction())
            ndcg[f"r={ratio}/{m}"] = float(np.mean(f))
            frac[f"r={ratio}/{m}"] = float(np.mean(fr))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    missing = [n for n in ("flash_attention", "selective_attention", "block_gather")
               if launched[n] + launched.get(f"{n}:fp32", 0) == 0]
    if missing:
        raise RuntimeError(f"planted evaluation: kernels never launched {missing}")
    rep = {"train_losses": card_l.tolist(), "cpu_losses": cpu_l.tolist(),
           "card_vs_cpu_max_abs": err, "flash_bwd_launches": k6,
           "fidelity_ndcg10": ndcg, "recompute_frac": frac, "eval_launches": launched,
           "setup_s": t1 - t0, "cpu_train_s": t2 - t1, "card_train_s": t3 - t2,
           "rebuild_s": t4 - t3, "eval_s": time.perf_counter() - t4,
           "requests": len(reqs), "layer0_zero_divergence_tokens": zero_div}
    log(f"  planted protocol: train_ranker {PLANTED_STEPS} steps on the card, loss "
        f"{card_l[0]:.4f} -> {card_l[-1]:.4f} ({rep['card_train_s']:.1f} s; K6 launches {k6}); "
        f"first {PLANTED_CPU_STEPS} == CPU within {TRAIN_TOL} (max {err:.2e}); layer-0 "
        f"divergence of the trained system exactly 0 on {zero_div} cached item tokens")
    log("    NDCG@10 vs full (trained weights, reported): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ndcg.items()))
    log("    recompute fraction: " + ", ".join(f"{k} {v:.3f}" for k, v in frac.items())
        + f"; evaluation launches {launched}")
    del trained, system, model
    return rep


def layer0_divergence_zero(system, reqs):
    """Eq. 3 after training (ROADMAP C's standing hazard): against the
    system's own cache, rebuilt on the trained weights, every cached item
    token's layer-0 divergence must be exactly 0, or the selection turns
    into rounding noise.  -> the number of such tokens checked."""
    from repro_torch.core.assembly import FROM_ITEM

    checked = 0
    for r in reqs:
        inst = system.best_instance(r)
        plan = system.plan_for(r, inst)
        table, _, have = system.cached_kv(plan, inst)
        n = plan.n
        pad = -(-n // 64) * 64
        toks = np.concatenate([plan.tokens.astype(np.int32), np.zeros(pad - n, np.int32)])
        t = torch.from_numpy(np.concatenate([np.asarray(table, np.int32),
                                             np.zeros(pad - n, np.int32)])).to(system.model.device)
        ck0, cv0 = ENG.gather_rows(system.rows, 0, t, t, rope_theta=system.cfg.rope_theta,
                                   rotate=False)
        div = ENG.layer0(system.model, toks, np.arange(pad) < n, ck0, cv0)[2]
        items = (plan.source == FROM_ITEM) & have
        d = div.cpu().numpy()[:n][items]
        if not items.any() or (d != 0).any():
            raise RuntimeError(f"layer-0 divergence of cached items after training: "
                               f"{int((d != 0).sum())} of {int(items.sum())} nonzero")
        checked += int(items.sum())
    return checked


def train_card_vs_cpu(dev):
    """One train step of every LM arch, each recsys arch and each SchNet
    mode at reduced() size (fp32, TF32 off) on the card and on a CPU copy:
    loss and gradient norm within TRAIN_TOL."""
    out = {}
    cases = [(a, "train_4k") for a in RREG.ARCHS if RREG.family_of(a) == "lm"]
    cases += [(a, "train_batch") for a in RECSYS_MICROBATCHES]
    cases += [("schnet", s) for s in ("full_graph_sm", "molecule", "minibatch_lg")]
    for arch, shape in cases:
        cfg = RREG.get_config(arch, smoke=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = STEPS.init_model(cfg, gen, dev, shape)
        fam = RREG.family_of(arch)
        kw = dict(batch=2, seq=64) if fam == "lm" else (
            dict(batch=64) if fam == "recsys" else ({"batch": 8} if shape == "molecule" else {}))
        batch = RREG.make_batch(cfg, shape, gen, dev, **kw)
        if shape == "minibatch_lg":          # the sampled subgraph's shapes are large: cut
            n = 2000
            batch = {"node_feat": batch["node_feat"][:n], "positions": batch["positions"][:n],
                     "edge_src": batch["edge_src"][:4000] % n,
                     "edge_dst": batch["edge_dst"][:4000] % n,
                     "seed_labels": batch["seed_labels"][:64]}
        cpu = copy.deepcopy(model).to("cpu")
        card, host = ([x[0] for x in STEPS.run_train(m, b, 1)[:2]]
                      for m, b in ((model, batch),
                                   (cpu, {k: v.cpu() for k, v in batch.items()})))
        errs = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, host)]
        if max(errs) > TRAIN_TOL:
            raise RuntimeError(f"train {arch} {shape} card vs CPU: loss / gnorm {card} vs {host}")
        out[f"{arch}:{shape}"] = {"card": card, "cpu": host, "rel_diff": errs}
        del model, cpu
    log(f"  card == CPU at reduced() size, one train step each (fp32): {len(out)} cells, "
        f"loss and gradient norm within {TRAIN_TOL} (max rel diff "
        f"{max(max(v['rel_diff']) for v in out.values()):.2e})")
    return out


def device_ms_counted(fn, reps=10):
    """`device_ms` of `fn` (warm), with the number of device events the
    profiler saw per call beside it (K6 launches 3 kernels a call, K7 a
    fill and 1 kernel; fewer events per call than that flags a device
    time that left some out)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    return sum(e - s for _, s, e in ev) / reps / 1e6, len(ev) / reps


def _bwd_work(a, kw):
    """(bytes, flops) of the attention backward: q, k, v, out, dout, lse
    and positions read once, dq, dk, dv written once; 5 products of 2*D
    operations per live (query, key) pair and query head."""
    q, k, v, out, lse, dout, qpos, kpos = a
    live = int(FREF.band_mask(qpos.long(), kpos.long(), kw.get("causal", True),
                              kw.get("window")).sum())
    B, _, Hq, D = q.shape
    return nbytes(q, k, v, out, lse, dout, qpos, kpos) + nbytes(q, k, v), \
        10 * D * live * B * Hq


def _sdpa_bwd(a, kw):
    """The backward of `F.scaled_dot_product_attention` through autograd at
    the same call (causal, no window), or None."""
    if kw.get("window") is not None or not kw.get("causal", True):
        return None
    q, k, v, _, _, dout, _, _ = a
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), g, retain_graph=True)


def flash_bwd_records(calls, launches):
    """K6 against its plain version on each recorded call (the five
    full-width archs' first backward call, bf16, and the tiny ranker's,
    fp32): max |kernel - plain| within TOL of the output's max |plain|
    (the recorded output gradients are small); timed at the
    rcllm-qwen3-8b call and at the ranker's."""
    fn = FO.mha_flash_bwd
    spec = KERNELS["flash_bwd"]
    checks, records = {}, []
    for label, (a, kw) in calls.items():
        got, want = fn(*a, **kw), FREF.flash_bwd_ref(*a, **kw)
        torch.cuda.synchronize()
        wdt = a[0].dtype
        errs = []
        for g, w in zip(got, want):
            scale = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            if not torch.isfinite(g).all() or err > TOL[wdt] * max(scale, 1e-30):
                raise RuntimeError(f"flash_bwd {label}: max|kernel-plain| {err} > {TOL[wdt]} x "
                                   f"max|plain| {scale}")
            errs.append(err / max(scale, 1e-30))
        checks[label] = {"shapes": shapes(a, {}), "rel_err": errs,
                         "window": kw.get("window")}
        log(f"check flash_bwd {label}: {shapes(a, {})} window {kw.get('window')}; "
            f"max|kernel-plain| / max|plain| dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} "
            f"(tol {TOL[wdt]}, {str(wdt).replace('torch.', '')})")
        del got, want
    for label, rec_name in (("rcllm-qwen3-8b", "flash_bwd"), ("ranker", "flash_bwd:fp32")):
        a, kw = calls[label]
        wdt = a[0].dtype
        ms = time_ms(lambda: fn(*a, **kw), reps=10, warmup=2)
        dev_ms, dev_events = device_ms_counted(lambda: fn(*a, **kw))
        plain_ms = time_ms(lambda: FREF.flash_bwd_ref(*a, **kw), reps=5, warmup=1)
        lib = _sdpa_bwd(a, kw)
        lib_ms = time_ms(lib, reps=10, warmup=2) if lib is not None else None
        b, fl = _bwd_work(a, kw)
        t_bytes, t_ops = b / HBM_BYTES_S * 1e3, fl / PEAK_FLOPS[wdt] * 1e3
        rec = {"name": rec_name, "route": "cuda", "source": spec["source"],
               "replaces": spec["replaces"], "launches": launches[rec_name],
               "max_abs_err": max(checks[label]["rel_err"]), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms, "device_ms": dev_ms, "device_events_per_call": dev_events,
               "shapes": shapes(a, {}), "bytes": b,
               "flops": fl, "err_is_relative_to_max_plain": True, "tol": TOL[wdt],
               "checks": checks if rec_name == "flash_bwd" else None,
               "fp32_simt_bound_ms": fl / PEAK_FLOPS[torch.float32] * 1e3}
        records.append(rec)
        log(f"time {rec_name}: kernel {ms:.3f} ms (device only {dev_ms:.3f} ms over "
            f"{dev_events:g} device events a call), plain "
            f"{plain_ms:.3f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms (SDPA backward)'}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {fl / 1e9:.1f} GFLOP; fp32 CUDA-core "
            f"rate {rec['fp32_simt_bound_ms']:.3f} ms)")
    return records


def bag_backward_record(call, launches):
    """K7 against its plain version at Wide&Deep's train_batch call (the
    wide table's gradient, fp32, and the same call in bf16): max |kernel
    - plain| within BAG_TOL of max(1, max|plain|); then timed."""
    ids, d_out, rows = call
    fn = EO.bag_backward
    spec = KERNELS["bag_backward"]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        g = d_out.to(dt)
        got, want = fn(ids, g, rows), EREF.bag_backward_ref(ids, g, rows)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.float().abs().max()))
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != dt or not torch.isfinite(got).all() or err > BAG_TOL[dt] * scale:
            raise RuntimeError(f"bag_backward {dt}: max|kernel-plain| {err} > {BAG_TOL[dt]} x "
                               f"{scale}")
        errs[dt] = err
        del got, want
    log(f"check bag_backward: ids {tuple(ids.shape)} into {rows} rows x {d_out.shape[1]}; "
        f"max|kernel-plain| fp32 {errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g} "
        f"(tol {BAG_TOL} x max(1, max|plain|))")
    ms = time_ms(lambda: fn(ids, d_out, rows))
    dev_ms, dev_events = device_ms_counted(lambda: fn(ids, d_out, rows), reps=20)
    plain_ms = time_ms(lambda: EREF.bag_backward_ref(ids, d_out, rows), reps=5, warmup=1)
    flat = ids.reshape(-1).long()
    F_ = ids.shape[1]
    lib_ms = time_ms(lambda: torch.zeros((rows, d_out.shape[1]), device=d_out.device)
                     .index_add_(0, flat, d_out.repeat_interleave(F_, 0)))
    grad_bytes = rows * d_out.shape[1] * 4
    b = nbytes(ids, d_out) + grad_bytes
    sector = nbytes(ids, d_out) + grad_bytes + 2 * ids.numel() * 32
    rec = {"name": "bag_backward", "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "launches": launches, "max_abs_err": errs[torch.float32],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b / HBM_BYTES_S * 1e3, "bound_by": "bytes",
           "library_ms": lib_ms, "device_ms": dev_ms, "device_events_per_call": dev_events,
           "bytes": b, "flops": ids.numel() * d_out.shape[1], "tol": BAG_TOL[torch.float32],
           "bf16_max_abs_err": errs[torch.bfloat16],
           "sector_bound_ms": sector / HBM_BYTES_S * 1e3,
           "shapes": [f"{tuple(ids.shape)}:int32", f"{tuple(d_out.shape)}:float32",
                      f"rows {rows}"],
           "library_call": "zeros + index_add_ of the flattened ids (after repeat_interleave)"}
    log(f"time bag_backward: kernel {ms:.4f} ms (device only {dev_ms:.4f} ms over "
        f"{dev_events:g} device events a call, zero fill included), plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms (bytes; {b / 1e6:.1f} MB; counting 32-byte sectors "
        f"{rec['sector_bound_ms']:.4f} ms)")
    return rec


def training_phase(dev):
    """Phase 2j (see the module docstring).  -> (report, kernel records)."""
    graph_job = _graph_builder()
    bwd_rec = BwdRecorder(TL.mha_flash_bwd)
    bag_rec = BagBwdRecorder(RM.bag_backward)
    saved = (TL.mha_flash_bwd, RM.bag_backward)
    TL.mha_flash_bwd, RM.bag_backward = bwd_rec, bag_rec
    report, launches, laps = {}, {}, {}
    try:
        for key, label, fn in (("lm", "LM train steps", lambda: lm_train_cells(dev, bwd_rec)),
                               ("recsys", "recsys train_batch",
                                lambda: recsys_train_cells(dev, bag_rec)),
                               ("schnet", "SchNet", lambda: schnet_train_cells(dev, graph_job)),
                               ("train_loop", "train loop", lambda: train_loop_check(dev)),
                               ("planted", "planted protocol",
                                lambda: planted_protocol(dev, bwd_rec))):
            log(f"training (phase 2j): {label}")
            reset_counts()
            t0 = time.perf_counter()
            report[key] = fn()
            torch.cuda.synchronize()
            laps[key] = time.perf_counter() - t0
            launches[key] = counts()
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["card_vs_cpu"] = train_card_vs_cpu(dev)
        laps["card_vs_cpu"] = time.perf_counter() - t0
    finally:
        TL.mha_flash_bwd, RM.bag_backward = saved
    k6 = {"flash_bwd": launches["lm"]["flash_bwd"],
          "flash_bwd:fp32": launches["planted"]["flash_bwd"]}
    if launches["recsys"]["bag_backward"] == 0 or min(k6.values()) == 0:
        raise RuntimeError(f"training: kernels never launched {launches}")
    t0 = time.perf_counter()
    records = flash_bwd_records(bwd_rec.calls, k6)
    records.append(bag_backward_record(bag_rec.call, launches["recsys"]["bag_backward"]))
    laps["kernel_records"] = time.perf_counter() - t0
    report.update(launches=launches, seconds=laps,
                  graph_build_s=graph_job[1].get("build_s"))
    log("  phase 2j seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + f"; launches by run {launches}")
    return report, records


def serving_phases(args, dev):
    """Phases 2-4 and 2d: rcllm serving at Qwen3-8B width, its kernels'
    checks and times, recsys scoring, and the tiny card == CPU runs.
    -> (report, kernel records).  Every model they build is gone when
    this returns."""
    # ---- phase 2: wave rcllm serving at Qwen3-8B width ----
    cfg = dataclasses.replace(QWEN3_8B, n_layers=args.n_layers)
    config = ServeConfig(decode_steps=args.decode_steps)
    rec, saved = install_recorders()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system, pool_rv, prof = SERVE.rcllm_system(cfg, dev)
    reqs, plans, reuse = SERVE.rcllm_requests(
        system, SERVE.launcher_trace(system, pool_rv, prof, args.requests, args.qps),
        config.decode_steps)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    with LogitTap() as wave_tap:
        engine, backend, batcher, done = SERVE.serve(system.model, cfg, config, reqs, plans,
                                                     system.rows)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0 - t_build
    launches = {"wave": counts()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rep = SERVE.report(config, engine, backend, batcher.workers, done, warmup=False)
    log(f"serving: {cfg.name} d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim {cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
        f"depth {cfg.n_layers} of {QWEN3_8B.n_layers} layers, "
        f"{cfg.param_count() / 1e9:.2f} B params bf16; cached-row pool "
        f"{system.rows.n_rows} rows, {system.rows.nbytes / 1e9:.2f} GB on the card")
    PHASE_S.update({"2 offline build + workload": t_build, "2 wave": t_serve})
    log(f"  offline build + workload {t_build:.1f} s, wave serving {t_serve:.1f} s, "
        f"{len(done)} requests x {config.decode_steps} tokens")
    log_serve("wave", rep, peak_gb)
    log(f"  kernel launches in the wave run: {launches['wave']}")
    check_served("wave", launches["wave"], RCLLM_KERNELS, done, backend, args, config, cfg)

    # ---- phase 2c: the same trace through the chunked scheduler ----
    cconfig = ServeConfig(decode_steps=args.decode_steps, sched="chunked")
    reset_counts()
    t0 = time.perf_counter()
    with LogitTap() as chunked_tap:
        c_engine, c_backend, c_batcher, c_done = SERVE.serve(system.model, cfg, cconfig,
                                                             reqs, plans, system.rows)
    torch.cuda.synchronize()
    t_chunked = time.perf_counter() - t0
    PHASE_S["2c"] = t_chunked
    launches["chunked"] = counts()
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    crep = SERVE.report(cconfig, c_engine, c_backend, c_batcher.workers, c_done, warmup=True)
    ticks = c_batcher.workers[0].ticks
    same = sum(c_backend.generated[r] == backend.generated[r] for r in backend.generated)
    log(f"chunked serving (chunk {cconfig.chunk_tokens} tokens, step budget "
        f"{cconfig.resolved_step_tokens}; depth {cfg.n_layers}): {t_chunked:.1f} s, "
        f"{len(ticks)} ticks ({sum(t.oversized for t in ticks)} oversized); "
        f"{same}/{len(backend.generated)} requests decoded the wave run's tokens")
    log_serve("chunked", crep, None)
    log(f"  kernel launches in the chunked run: {launches['chunked']}")
    check_served("chunked", launches["chunked"],
                 ("block_gather", "selective_attention", "paged_decode_attention"),
                 c_done, c_backend, args, cconfig, cfg)
    # the closed loop's greedy tokens and logit rows, for phase 2g's gate
    closed = {"wave": (dict(backend.generated), wave_tap.rows),
              "chunked": (dict(c_backend.generated), chunked_tap.rows)}
    del c_engine, c_backend, c_batcher

    # ---- phase 2b: where the time goes (warm wave prefill and decode) ----
    t_2b = time.perf_counter()
    spans = Spans()
    spans.wrap(BE.BatchEngine, "prefill", "prefill")
    spans.wrap(ENG, "layer0", "layer0")
    spans.wrap(ENG, "select_recompute", "select_recompute")
    spans.wrap(ENG, "selective_layers_batch", "selective_layers_batch")
    spans.wrap(ENG, "selective_layers", "selective_layers")
    spans.wrap(PagedKVPool, "write_at_batch", "pool_writes")
    spans.wrap(BE.BatchEngine, "decode", "decode")
    spans.wrap(BE, "decode_step", "decode_step")
    for f in warm_run(engine, plans, config.decode_steps - 1):
        f()
    spans.restore()
    s = spans.s
    steps = config.decode_steps - 1
    breakdown = {
        "requests": len(plans), "decode_steps": steps,
        "prefill_s": s["prefill"],
        "prefill": {"layer0_eq3": s["layer0"], "select_recompute_host": s["select_recompute"],
                    "selective_layers_device": s["selective_layers"],
                    "selective_batch_setup": s["selective_layers_batch"] - s["selective_layers"],
                    "pool_writes": s["pool_writes"]},
        "decode_step_ms": s["decode"] / steps * 1e3,
        "decode": {"model_step_ms": s["decode_step"] / steps * 1e3,
                   "page_tables_host_ms": (s["decode"] - s["decode_step"]) / steps * 1e3},
    }
    known = sum(breakdown["prefill"].values())
    breakdown["prefill"]["other"] = s["prefill"] - known
    pre, dec = warm_run(engine, plans, steps)
    for phase, fn in (("prefill", pre), ("decode", dec)):
        wall, busy, top, memcpy_s, n_memcpy = device_busy(fn)
        breakdown[f"{phase}_profiled_wall_s"] = wall
        breakdown[f"{phase}_device_busy_s"] = busy
        breakdown[f"{phase}_device_busy_share"] = None if busy is None else busy / wall
        breakdown[f"{phase}_device_idle_share"] = None if busy is None else 1 - busy / wall
        breakdown[f"{phase}_host_card_memcpy_s"] = memcpy_s
        breakdown[f"{phase}_host_card_memcpy_count"] = n_memcpy
        breakdown[f"{phase}_top_device"] = top
    log(f"breakdown (warm, {len(plans)} requests in one prefill batch, then {steps} "
        f"decode steps; host clock, card synchronised at each span):")
    log("  prefill " + f"{s['prefill']:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in breakdown["prefill"].items()))
    log(f"  decode step {breakdown['decode_step_ms']:.2f} ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in breakdown["decode"].items()))
    log("  device-busy / idle share of the profiled wall: " + "; ".join(
        f"{phase} {breakdown[f'{phase}_device_busy_share']} / "
        f"{breakdown[f'{phase}_device_idle_share']}" for phase in ("prefill", "decode")))
    for phase in ("prefill", "decode"):
        busy = breakdown[f"{phase}_device_busy_s"]
        log(f"  profiled {phase}: wall {breakdown[f'{phase}_profiled_wall_s']:.3f} s, device busy "
            f"{'not measured (no device events)' if busy is None else f'{busy:.3f} s'}, idle share "
            f"{breakdown[f'{phase}_device_idle_share']}; host<->card memcpy "
            f"{breakdown[f'{phase}_host_card_memcpy_s'] * 1e3:.3f} ms in "
            f"{breakdown[f'{phase}_host_card_memcpy_count']} copies; top device: "
            + "; ".join(f"{n} {ms:.2f} ms" for n, ms in breakdown[f"{phase}_top_device"]))

    PHASE_S["2b"] = time.perf_counter() - t_2b

    # ---- phase 2e: the shared block store (kv_reuse) at full width and depth ----
    t0 = time.perf_counter()
    kv_report, kv_gather, kv_decode, kv_launches = kv_reuse_phase(system, pool_rv, prof,
                                                                   cfg, dev, args)
    t_kv = time.perf_counter() - t0
    launches.update(kv_launches)
    log(f"  kv_reuse phase {t_kv:.1f} s")
    PHASE_S["2e"] = t_kv

    # ---- phase 2f: the cluster (k = 2 workers) at full width and depth ----
    t0 = time.perf_counter()
    system2, _, _ = SERVE.rcllm_system(cfg, dev, model=system.model, k_instances=2)
    torch.cuda.synchronize()
    t_build2 = time.perf_counter() - t0
    log(f"cluster system: the same model object and 80-item catalog, placement over 2 "
        f"shards, offline build {t_build2:.1f} s")
    cluster_report, cluster_launches = cluster_phase(system2, pool_rv, prof, cfg, args)
    del system2
    torch.cuda.empty_cache()
    t_cluster = time.perf_counter() - t0
    launches.update(cluster_launches)
    log(f"  cluster phase {t_cluster:.1f} s")
    PHASE_S["2f"] = t_cluster

    # ---- phase 2g: the session server (replay, then open loop with cancels) ----
    t0 = time.perf_counter()
    server_report, server_launches = server_phase(system, reqs, plans, reuse, cfg, args,
                                                  closed)
    launches.update(server_launches)
    PHASE_S["2g"] = t_server = time.perf_counter() - t0
    log(f"  server phase {t_server:.1f} s")

    # ---- phase 2h: ranking accuracy (Full-Recompute, RcLLM, CacheBlend, EPIC) ----
    t0 = time.perf_counter()
    rank_report, rank_launches = ranking_phase(system, pool_rv, prof, dev)
    launches.update(rank_launches)
    torch.cuda.empty_cache()
    PHASE_S["2h"] = t_rank = time.perf_counter() - t0
    log(f"  ranking phase {t_rank:.1f} s")
    t_3 = time.perf_counter()

    # ---- phase 3: checks ----
    plan, table, positions, have = plans[min(plans)]
    br = BE.BatchRequest(rid=-1, tokens=plan.tokens, plan=plan, block_table=table,
                         positions=positions, have=have)
    logits = engine.prefill([br], "rcllm")
    rfrac = engine.last_stats[br.rid].recompute_fraction()
    engine.release(br.rid)
    if logits.shape != (1, cfg.vocab_size) or not np.isfinite(logits).all():
        raise RuntimeError(f"served logits not finite / wrong shape {logits.shape}")
    log(f"  prefill logits finite, shape {logits.shape}; {plan.n} prompt tokens, "
        f"recompute fraction {rfrac:.3f}")

    total = {n: sum(run[n] for run in launches.values()) for n in launches["wave"]}
    records = []
    for name, spec in KERNELS.items():
        if name == "block_gather":
            records += gather_records(rec[name].calls, spec,
                                      {"rotate": total[name], "copy": total[name]})
            continue
        if name == "embedding_bag":
            continue    # recorded after the recsys phase below
        if name in TRAIN_KERNELS:
            continue    # recorded in phase 2j
        a, kw = device_inputs(name, rec[name].args, rec[name].kwargs, dev)
        extra = {}
        if name in TWO_ROUTES:
            extra["kernel_route"] = check_route(name, a, kw, "tc")
        if name == "selective_attention":
            extra["ms_host_inputs"] = selective_host_inputs_ms(a, kw)
        if name == "paged_decode_attention":
            extra.update(paged_split_record(a, kw))
        records.append(checked_record(name, spec, total[name], a, kw, extra, fp32_too=True))
    # the store path's B4 call with store-shared prefix rows and its
    # largest B3 call (rows over interleaved store-shared pages)
    records += gather_records(kv_gather.calls, KERNELS["block_gather"],
                              {"prefix": total["block_gather:prefix"]}, modes=("prefix",))
    spec = KERNELS["paged_decode_attention"]
    a, kw = kv_decode.args, kv_decode.kwargs
    extra = dict(paged_split_record(a, kw), shared_pages=kv_decode.view[0],
                 rows_with_dead_slots=kv_decode.view[1])
    log(f"  B3 store call: {kv_decode.view[0]} pages read by two or more rows, "
        f"{kv_decode.view[1]} of {a[0].shape[0]} rows with a dead slot inside")
    records.append(checked_record(
        "paged_decode_attention", spec,
        sum(run["paged_decode_attention"] for label, run in kv_launches.items()
            if label.endswith(("_on", "_int8"))), a, kw, extra,
        fp32_too=True, label="paged_decode_attention:store"))
    del kv_gather, kv_decode
    PHASE_S["3-4 rcllm checks and times"] = time.perf_counter() - t_3
    # ---- phase 2d: recsys scoring and retrieval at published widths ----
    # (after the rcllm checks and times, so that no recsys model is on the
    # card while the rcllm path runs)
    log("recsys scoring and retrieval (published widths, seeded random weights):")
    reset_counts()
    t0 = time.perf_counter()
    recsys_cells, recsys_models, bag_calls = recsys_phase(dev)
    torch.cuda.synchronize()
    t_recsys = time.perf_counter() - t0
    launches["recsys"] = counts()
    PHASE_S["2d"] = t_recsys
    log(f"  recsys phase {t_recsys:.1f} s; kernel launches: {launches['recsys']}")
    if launches["recsys"]["embedding_bag"] == 0:
        raise RuntimeError("embedding_bag never launched on the recsys path")
    t_tiny = time.perf_counter()
    bag_total = sum(run["embedding_bag"] for run in launches.values())
    records += bag_records(bag_calls, KERNELS["embedding_bag"], bag_total, recsys_models)
    del rec, bag_calls
    recsys_checks = recsys_card_vs_cpu(recsys_models, dev)
    del recsys_models

    # small-input reference: the tiny rcllm model served on the card
    # (kernels) decodes the same greedy tokens as on the CPU (plain), under
    # both schedulers.  Its fp32 calls are the SIMT routes of B1 and B2.
    reset_counts()
    tiny_rec, tiny_saved = install_recorders()
    try:
        for sched in ("wave", "chunked"):
            tiny = {}
            model = None
            tconfig = ServeConfig(decode_steps=4, sched=sched, chunk_tokens=64)
            for d in (dev, torch.device("cpu")):
                tsys, treqs, tplans, _ = SERVE.rcllm_setup(None, d, 4, 1e6, 4, model=model)
                _, tb, _, _ = SERVE.serve(tsys.model, tsys.cfg, tconfig, treqs, tplans,
                                          tsys.rows)
                tiny[d.type] = {r: tb.generated[r] for r in sorted(tb.generated)}
                model = copy.deepcopy(tsys.model).to("cpu")
            if tiny["cuda"] != tiny["cpu"]:
                raise RuntimeError(f"tiny rcllm {sched} tokens differ: card {tiny['cuda']} "
                                   f"cpu {tiny['cpu']}")
            log(f"check tiny rcllm {sched} serving: card tokens == CPU plain-version tokens "
                f"{tiny['cuda']}")
    finally:
        for mod, name, fn in tiny_saved:
            setattr(mod, name, fn)
    launches["tiny"] = counts()
    log(f"  kernel launches in the tiny card runs (wave + chunked): {launches['tiny']}")
    for name in TWO_ROUTES:
        label = f"{name}:fp32"
        if launches["tiny"][label] == 0:
            raise RuntimeError(f"the SIMT route of {name} never launched on the tiny fp32 path")
        a, kw = device_inputs(name, tiny_rec[name].args, tiny_rec[name].kwargs, dev)
        extra = {"kernel_route": check_route(name, a, kw, "simt")}
        records.append(checked_record(name, KERNELS[name],
                                      sum(run[label] for run in launches.values()), a, kw,
                                      extra, label=label))
    del tiny_rec
    PHASE_S["recsys records and tiny runs"] = time.perf_counter() - t_tiny

    report = {"offline_build_s": t_build, "serving_s": t_serve,
              "chunked_serving_s": t_chunked, "kv_reuse_s": t_kv, "kv_reuse": kv_report,
              "cluster_s": t_cluster, "cluster": cluster_report,
              "server_s": t_server, "server": server_report,
              "ranking_s": t_rank, "ranking": rank_report,
              "recsys_s": t_recsys, "peak_cuda_gb": peak_gb,
              "depth": cfg.n_layers, "serve": rep, "serve_chunked": crep,
              "chunked_ticks": [dataclasses.asdict(t) for t in ticks],
              "chunked_tokens_equal_wave": same, "launches": launches,
              "cache_rows": system.rows.n_rows, "cache_rows_gb": system.rows.nbytes / 1e9,
              "recompute_fraction": rfrac, "prompt_tokens": plan.n, "breakdown": breakdown,
              "recsys_cells": recsys_cells, "recsys_card_vs_cpu": recsys_checks,
              "kernels": records}
    return report, records


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-layers", type=int, default=QWEN3_8B.n_layers,
                    help="depth to run (width is never cut)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--qps", type=float, default=8.0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on a GPU")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: build every kernel from this checkout's sources ----
    build_s = PHASE_S["1 build"] = _build.build()
    log(f"kernel build: {build_s:.1f} s (parallel nvcc, sm_90a)")
    for name in _build.SOURCES:
        text = _build.library_path(name).with_suffix(".log")
        for line in (text.read_text().splitlines() if text.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    report, records = serving_phases(args, dev)

    # ---- phase 2i: the LM architectures' prefill and decode steps ----
    gc.collect()
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    log(f"LM serving steps (phase 2i): {resident_gb:.3f} GB resident on the card before it")
    if resident_gb > LM_RESIDENT_GB:
        raise RuntimeError(f"{resident_gb:.2f} GB still allocated before phase 2i: an rcllm "
                           "or recsys model outlived its phases")
    t0 = time.perf_counter()
    report["lm"] = lm_phase(dev)
    report["lm"]["resident_gb_before"] = resident_gb
    PHASE_S["2i"] = time.perf_counter() - t0

    # ---- phase 2j: training (LM, recsys, SchNet, the loop, the planted protocol) ----
    gc.collect()
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    log(f"training (phase 2j): {resident_gb:.3f} GB resident on the card before it")
    if resident_gb > LM_RESIDENT_GB:
        raise RuntimeError(f"{resident_gb:.2f} GB still allocated before phase 2j: an LM "
                           "model outlived phase 2i")
    t0 = time.perf_counter()
    report["training"], train_records = training_phase(dev)
    report["training"]["resident_gb_before"] = resident_gb
    records = records + train_records
    report["kernels"] = records
    PHASE_S["2j"] = time.perf_counter() - t0
    report.update({"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_s": build_s, "phase_s": PHASE_S,
                   "total_s": time.perf_counter() - t_start})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_S.items()))
    log(f"total {report['total_s']:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
