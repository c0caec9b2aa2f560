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
   (host clock, card synchronised at each span), counts the block
   gather's launches (one per selective pass, all of its layers, and one
   per request for layer 0) and reads the card's busy share and
   host<->card copy time under torch.profiler;
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
2k. the attention-backend seam over the phase-2 system: phase 2's
   requests built by `rcllm_batch_requests`, one `BatchEngine.prefill`
   and 8 greedy decode steps under (a) attn_backend "cuda", (b) "plain"
   (the kernels' plain versions on the card), (c) "plain" with the decode
   pinned to the paged-decode kernel and (d) "cuda" with the per-request
   rcllm prefill, then (b) and (a) again in turns for the times.  The
   tokens of every run pass the token gate against (a)'s and, in each
   prefill row, the logit at (a)'s greedy pick lies within 2e-2 of (a)'s;
   (b)'s and (c)'s prefill logits are bitwise equal; (b) launches no
   kernel, (c) only the paged-decode kernel, (a) and (d) the counts their
   selective passes and decode steps make.  The whole rows are held on
   the same weights cast to fp32, where (a) and (b) run again: tokens
   through the token gate, every logit within 1e-4 of the row max, and
   the fp32 routes' launch counts.  Each request's
   `reuse_fraction`, each distinct B2 call's `flop_reduction` beside its
   live-tile share, and the pool's utilization and fragmentation after
   prefill are printed.  Then the port's two examples that run a model
   run on the card at small sizes (`examples/torch_quickstart.py` and
   `torch_train_ranker.py --steps 20 --eval 8`, whose training launches
   K6's small-head route and whose evaluation B1's and B2's);
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
   reported; B1, B2 and B4 must launch, B1 and B2 on their small-head
   routes only, whose largest calls there are recorded as
   "...:small:planted"); then one train step of every
   LM, recsys and SchNet cell at reduced() size on the card against the
   CPU.  K6 takes its tensor-core route on every backward call of the
   five archs (bf16, D 128 / 256) and its small-head route (D <= 32) on
   kimi-k2's and the ranker's; it is held to its plain version on the
   five archs' recorded calls and the ranker's, a second call bitwise
   equal, and timed at each of them (each of its kernels apart) beside its
   bound and SDPA's backward, at the ranker's call in turns with its SIMT
   route; K7 at Wide&Deep's call beside one `index_add_`, each of its
   device events apart, and on the same call's 8 fields of each
   vocabulary size (1 M, 100 K, 10 K, 1 K rows) and in field-major order
   (its field-group probe);
2l. tensor parallelism on one card (after every other phase; the
   parent holds no model): `launch/serve.py`'s mesh path at tp = 2,
   two ranks sharing the card over gloo, each building its shard of the
   phase-2 system from the seed (16 query / 4 kv heads, half the MLP and
   vocabulary, drawn one whole parameter at a time; the kernels loaded
   from phase 1's build) and serving phase 2's trace wave with reuse
   off, chunked with reuse off and chunked with reuse on, with the
   ranks' digest check of every step's plan and recompute mask on.  It
   fails unless each rank launched B1 and B2 on their tensor-core
   routes, B3 and B4, held 4 kv heads in its arena, logged the same
   digests as the other rank, and decoded tokens that pass the token
   gate against phases 2 and 2c (the all-reduces reorder bf16 sums).
   After each run's counts are read, each rank holds B1 (offline build),
   B2, B3 and B4 (each kind of gather) at the largest call it made, on
   the shard's 16 query / 4 kv heads, against their plain versions with
   phase 3's tolerances (those launches are not counted).  A fourth run
   serves the same trace through the session server (`--server --speed
   0`, chunked, reuse off): the server on rank 0, rank 1 following its
   ticks (`serving.server.follow`), under the same gates against phase
   2c.  Per rank: wall time, TTFT p50, TBT p50, peak GB, launches by
   kernel, the collective backend, the checks' max|kernel - plain| and
   the largest call's shapes per kernel;
2m. the LM archs on a mesh (after phase 2l): two ranks sharing the card
   over gloo.  At tp = 2, first every assigned LM arch at reduced() size
   in fp32 (and starcoder2 with an 8-token window): prefill, 2 greedy
   decode steps and 3 train steps on the card, held against this
   process's tp = 1 run on the CPU (logits within 1e-4, greedy tokens
   equal, losses and gradient norms within 1e-4); then phase 2j's five
   archs at published width, depth 2: a prefill of 1 x 4,096 tokens, 4
   decode steps, 3 train steps of its optimizer on the rank's heads, MLP
   columns, experts and vocabulary rows (K6 on the rank's heads, every
   call on its tensor-core route), and kimi-k2 at reduced() size (K6's
   small-head route, Adafactor).  Then dp = 2 on gemma-7b (the arch with
   the fewest parameters at 2 layers): 3 AdamW steps on 2 x 4,096 tokens,
   a row a rank, the moments ZeRO-cut over the data axis and the
   gradients averaged.  After its counts are read each rank holds K6 at
   its largest recorded call of each arch against the plain version (TOL
   of max|plain|, a second call bitwise equal).  Per rank: step times,
   peak GB, K6 launches, and the host ms of one gloo all-reduce of a
   step's (4,096, d_model) bf16 activation.  Two ranks share one card's
   SMs and HBM and their collectives go through the host: none of these
   is a multi-card speed;
2n. the recsys and SchNet steps on a mesh and the LM layouts whose kv
   heads tp does not divide (after phase 2m; the parent holds no model
   while ranks run).  First one unsharded run of each case on the card
   (seed 0), to the host and freed.  (a) Two ranks at dp = 2, each
   holding its half of the rows of every table of 4,096 rows or more:
   Wide&Deep, AutoInt, DIEN and BERT4Rec at published width score a
   serve_p99 batch (a rank its 256 rows) and one retrieval_cand query
   (1 x 1,000,000 candidates, the same on both ranks), and Wide&Deep takes
   3 AdamW steps of train_batch (32,768 rows a rank): scores and losses
   within 1e-5 of max|x| of the unsharded run (gradient norms, sums of
   65,536 rows' terms regrouped by rank, within 1e-4); each rank must
   launch B5 and K7 on its window and, after its counts are read, holds
   them at its largest windowed call against their plain versions
   (1e-5 of max(1, max|plain|); B5's second call bitwise equal).  (b)
   SchNet at dp = 2 (full_graph_sm and minibatch_lg's padded subgraph
   with their edges split over the ranks, molecule's molecules), 3 AdamW
   steps each: losses within 1e-5.  Then long_500k: starcoder2 at
   published width, depth 2, one row of 524,288 cached positions split
   over the two ranks, 4 greedy decode steps (flash-decoding merged by
   log-sum-exp) against the unsharded decode: logits within 2e-2 of the
   row max (bf16), tokens equal unless a near-tie.  (c) Four ranks: every
   assigned LM arch at reduced() size in fp32 (and starcoder2 with an
   8-token window) at (dp, tp) = (1, 4), each kv head's Dh cut over the
   model axis and the cache's sequence over it: prefill, 2 greedy decode
   steps, 3 train steps; and at (2, 2) a batch-1 prefill and decode whose
   cache splits over every axis (2 decode steps from the mesh's prefill
   and 2 from the whole model's cache): against this process's tp = 1 run on the CPU (logits
   within 1e-4, greedy tokens equal, losses and norms within 1e-4).  (d)
   Eight ranks: starcoder2-15b (4 kv heads) at tp = 8, depth 2: prefill
   1 x 4,096, 4 decode steps, 3 AdamW steps; the prefill's and decode
   steps' logits and greedy tokens against one unsharded run of the same
   seed on the card (long_500k's gate); K6 on each rank's (1, 4096,
   6, 128) query and (1, 4096, 1, 128) kv heads on its tensor-core route,
   held to its plain version after the counts are read.  Per rank: step
   times, peak GB, launches by kernel and the largest call's shapes.  As
   in 2l and 2m, ranks share one card over gloo: no multi-card speed;
2o. the data-axis parameter cuts (after phase 2n): four ranks at (dp, tp)
   = (2, 2) sharing the card over gloo.  (a) kimi-k2 at published width,
   depth 1, serve mode: each rank draws the whole model in turn (seed 0)
   and keeps 192 experts' halves of the expert-ff dimension and half of
   the attention's d_model (~10.9 GB a rank), prefills its row of 2 x
   1,024 tokens and takes 4 greedy decode steps, gathering the experts a
   chunk at a time over the data axis (a decode step only those a token
   reaches); then, after the ranks exit, the same model whole on the card
   (~38.8 GB): logits within 2e-2 of the row max, tokens equal.  Each
   rank's max_memory_allocated, parameter bytes and expert-ff bytes (1 /
   2 of the whole-over-data layout's) are printed, and what it holds
   beside its shards and cache after the layer must stay under 1 GB.
   (c) The dry run (`launch.dryrun.trace_cell`) of that cell at (2, 2) on
   fake tensors: its parameter bytes must equal each rank's in (a).  (b)
   moonshot at published width, depth 4: 3 AdamW steps on 2 x 2,048
   tokens (a row a data rank, K6 on a rank's 8 heads on its tensor-core
   route, held to its plain version after the counts are read), losses
   within 1e-2 relative of the same model trained whole on the card; the
   reduced() moonshot and kimi-k2 (Adafactor) cases against one process
   on the CPU (2m's gate); and reduced() moonshot trained 2 steps at (2,
   2) with a checkpoint each step, its third step at (1, 2) from that
   checkpoint, against the CPU's 3 steps (a published-width checkpoint
   is not written: `train_loop.whole_state` gathers the whole state on
   every rank, ~30 GB a rank at depth 4).  Gloo's host staging sets the
   times, as in 2l-2n;
2p. the hillclimbs of `launch.perf_iterations` (after phase 2o; no model on the card):
   `launch.perf_iterations.main` prints its four cells' tables,
   modelled at H100 SXM peaks on 256 cards and never measured, and
   traces its three probes (nemotron-4-15b prefill_32k with 2,048-token
   tiles and kimi-k2 train_4k at 16 x 16, moonshot train_4k at 64 x 4,
   uncut) as rank 0 of a fake world on fake cuda tensors, the train
   cells through their backward.  Each probe is held against the
   committed CPU record (`results/perf_torch/hillclimbs.json`, whose
   argument bytes `tests/test_torch_perf_iterations.py` holds against
   the JAX package's specs): the same argument bytes, FLOPs, collectives
   and modelled temp, traced bytes within 0.1% (ops that decompose by
   device); the analytic terms equal the record's;
3. checks: each kernel against its plain PyTorch version on the inputs
   one of its serving calls saw, in the working dtypes and in fp32 (the
   block gather bitwise where it copies, at its largest all-layer call of
   a selective pass and its largest layer-0 copy, each also timed as one
   launch per layer through the one-plane wrapper, with host and device
   time apart, the copy in turns with two `index_select`s); the served
   logits finite; and
   the tiny rcllm model served on the card, wave and chunked, decodes
   the same tokens as on the CPU (the plain versions).  The flash and
   selective kernels have three routes each: the tensor-core route is
   held to its plain version at the largest served call (the records
   "flash_attention" and "selective_attention"), the small-head route
   (D <= 32) at the largest call of the tiny runs (the records
   "...:small", a second call bitwise equal; the tiny runs must launch no
   SIMT kernel), and the SIMT kernel at the served call cast to fp32 and
   forced onto the tiny call, where it is timed in turns with the
   small-head route (the small records' "simt_route").  The
   paged-decode kernel also against its split-K plain version at the
   split it chose, and it must run at least two blocks per SM.  The
   embedding bag on its serve_p99 and serve_bulk inputs, also with a bf16 and a d = 32
   table, a second call bitwise equal, and timed in turns with its first
   design (built from `scripts/bag_designs.cu` and held to the same plain
   version: port, first, first, port; warm and with the L2 flushed); and each
   recsys model at full width scores and retrieves the same on the card
   as a CPU copy of it;
4. kernel times (CUDA events, median of 20 after warm-up; and the
   device time alone under torch.profiler, every device event counted,
   with the number a call saw beside it; for the paged-decode kernel and
   the embedding bag also with the L2 flushed before each call) beside
   the plain version, one
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
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import bag_designs as BD  # noqa: E402
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
from repro_torch.launch.mesh import collective_backend  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks as MESH_SPAWN  # noqa: E402
from repro_torch.launch import steps as STEPS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.recsys import models as RM  # noqa: E402
from repro_torch.serving import api as API  # noqa: E402
from repro_torch.serving import batch_engine as BE  # noqa: E402
from repro_torch.serving import block_store as BS  # noqa: E402
from repro_torch.serving import workload as WL  # noqa: E402
from repro_torch.serving.api import MeshConfig, ServeConfig, StoreConfig  # noqa: E402
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

# kernels with three routes, each with the suffix of its SIMT route's
# count: "<name>" counts and records the tensor-core route (bf16, the
# served and trained paths at full width), "<name>:small" the small-head
# route (D <= 32: the tiny card == CPU models, the planted ranker's
# evaluation and backward, kimi-k2's bf16 backward at reduced()), and
# "<name><suffix>" the SIMT kernels, which take what no other route takes
# (none of these paths: the served call cast to fp32 is held to its plain
# version on them, and each small-head record times them in turns)
OTHER_ROUTE = {"flash_attention": ":fp32", "selective_attention": ":fp32", "flash_bwd": ":simt"}
# the forward kernels whose small-head route the tiny model's calls take
SMALL_FWD = ("flash_attention", "selective_attention")

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
        fn=BO.PoolGather, source="src/repro_torch/kernels/block_gather/gather.cu",
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
        if name in OTHER_ROUTE:
            spec["fn"].tc_launches = 0
            spec["fn"].small_launches = 0
    BO.PoolGather.layer_launches = 0
    BO.PoolGather.pool2_launches = 0


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
    """Keeps the inputs of the largest block-gather call (by table size) of
    each kind: "layers" (a selective pass: layers 1..L-1 rotated, with
    their pre-RoPE base, in one launch), "copy" (layer 0's Eq. 3 rows),
    and the same with the second pool (store-shared prefix rows):
    "prefix" and "prefix_copy".  Called before every `PoolGather` call
    (`patch_gather`) with the binding and the call's arguments.  The pools
    are the read-only cached-row pool, or the arena at store-owned slots
    that no request writes, and the tables are never written after the
    call, so references suffice."""

    def __init__(self):
        self.calls = {}

    def __call__(self, g, table, positions, layers, rotate, keep_raw):
        mode = "layers" if rotate else "copy"
        if g.two:
            mode = "prefix" if rotate else "prefix_copy"
        size = table.numel()
        if size > self.calls.get(mode, (-1,))[0]:
            self.calls[mode] = (size, (g, table, positions, layers, rotate, keep_raw))


def patch_gather(before):
    """Make every block-gather call (`PoolGather.__call__`) first call
    before(binding, table, positions, layers, rotate, keep_raw).  -> the
    original method, to restore."""
    orig = BO.PoolGather.__call__

    def call(self, table, positions=None, layers=0, *, rotate=True, keep_raw=False):
        before(self, table, positions, layers, rotate, keep_raw)
        return orig(self, table, positions, layers, rotate=rotate, keep_raw=keep_raw)
    BO.PoolGather.__call__ = call
    return orig


class BagRecorder:
    """Keeps the inputs (table, ids, row0) of the latest embedding-bag call
    per batch size (serve_p99, serve_bulk, retrieval; on a row window, the
    ids gathered over the data axis).  The table is a model parameter and
    the ids are made anew for each call, so references suffice."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {}

    def __call__(self, table, ids, row0=0):
        self.calls[ids.shape[0]] = (table, ids, row0)
        return self.fn(table, ids, row0=row0)

    def largest(self):
        """The recorded call with the most ids, or None."""
        return max(self.calls.values(), key=lambda c: c[1].numel(), default=None)


def install_recorders():
    rec = {"flash_attention": Recorder(FO.mha_flash),
           "selective_attention": Recorder(SO.selective_mha),
           "paged_decode_attention": Recorder(PO.paged_decode_mha, _paged_snapshot),
           "block_gather": GatherRecorder()}
    patches = [(ENG, "mha_flash", rec["flash_attention"]),
               (TT, "mha_flash", rec["flash_attention"]),
               (ENG, "selective_mha", rec["selective_attention"]),
               (BE, "paged_decode_mha", rec["paged_decode_attention"])]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, r in patches:
        setattr(mod, name, r)
    saved.append((BO.PoolGather, "__call__", patch_gather(rec["block_gather"])))
    return rec, saved


# ------------------------------------------- plain versions, library, bound
def plain_call(name, args, kw):
    if name == "embedding_bag":
        return embedding_bag_ref(*args)
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


def queued_ms(fn, reps=10, cycles=200_000):
    """CUDA-event ms of one call enqueued while the card still runs a spin
    kernel (`torch.cuda._sleep`), so the events time the launch and the
    kernel but not the wrapper's host work; median of `reps`."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(statistics.median(times))


def kernel_name(name):
    """A device event's kernel name without return type, namespace and
    arguments (e.g. "dq_tc_kernel<128>")."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:60]


# torch.cuda._sleep's spin kernel brackets the timed calls of `device_ms`
MARK_CYCLES = 1000
_MARK = {}


def _marker_name():
    """The device event name of `torch.cuda._sleep`'s kernel."""
    if "name" not in _MARK:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(8):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        names = {ev[0] for ev in device_events(prof)}
        if len(names) != 1:
            raise RuntimeError(f"torch.cuda._sleep gave the device events {names}")
        _MARK["name"] = names.pop()
    return _MARK["name"]


def device_ms(fn, reps=20, flush=None, pad=3, lead=256):
    """Device time per call: the card's kernel and copy intervals under
    torch.profiler, so the wrapper's host work between launches (which a
    CUDA-event time of one short call includes) is left out.  Late in a
    long run the profiler drops the first few device events of a session,
    so the `reps` timed calls sit between two marker kernels
    (`torch.cuda._sleep`) after `lead` one-element adds and `pad` untimed
    calls, and only the events between the markers count.  With `flush`
    (a buffer larger than the 50 MB L2), the buffer is written before
    each call, so the call finds its inputs out of L2; the writes
    themselves are not counted.  -> {"ms": ms per call, "events_per_call":
    device events per call (a wrapper's kernels and fills: compare with
    what it launches), "by_kernel": {kernel: ms per call}}; "ms" sums
    "by_kernel", and is None (with the reason in "note") when the profiler
    lost a marker."""
    fn()
    torch.cuda.synchronize()
    mark = _marker_name()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    one = torch.zeros(1, device="cuda")

    def run(cold):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(lead):
                one.add_(1)
            for _ in range(pad):
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            for i in range(reps):
                if cold:
                    flush.fill_(i & 0xFF)
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        events = device_events(prof)
        marks = sorted((s, e) for n, s, e in events if n == mark)
        if len(marks) != 2:
            return None, len(marks)
        return [ev for ev in events if ev[0] != mark and marks[0][1] <= ev[1] <= marks[1][0]], 2

    events, n_marks = run(False)
    if events is not None and flush is not None:
        names = {ev[0] for ev in events}
        events, n_marks = run(True)
        events = None if events is None else [ev for ev in events if ev[0] in names]
    if events is None:
        return {"ms": None, "events_per_call": None, "by_kernel": {},
                "note": f"the profiler kept {n_marks} of the 2 marker kernels"}
    # each kernel's mean over its events, times the launches a call makes of it
    by_kernel, seen = {}, {}
    for name, s, e in events:
        k = kernel_name(name)
        by_kernel[k] = by_kernel.get(k, 0.0) + (e - s) / 1e6
        seen[k] = seen.get(k, 0) + 1
    for k, n in seen.items():
        by_kernel[k] *= max(1, round(n / reps)) / n
    return {"ms": sum(by_kernel.values()), "events_per_call": len(events) / reps,
            "by_kernel": by_kernel}


class Spans:
    """Inclusive host-clock seconds (`s`) and calls (`n`) per wrapped
    function.  The card is synchronised at entry and exit, so device work
    lands in the span that issued it (this slows the run: the spans are
    taken in a run of their own, never in the served one)."""

    def __init__(self):
        self.s, self.n, self.saved = {}, {}, []

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
            self.n[label] = self.n.get(label, 0) + 1
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
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


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
    """Launches per kernel since the last reset_counts(): the three routes
    of OTHER_ROUTE's kernels apart ("<name>" tensor cores, "<name>:small",
    "<name><suffix>" SIMT), and of all the block gather's launches those
    that gathered a range of layers ("block_gather:layers") and those that
    read the second pool ("block_gather:prefix")."""
    out = {}
    for n, spec in KERNELS.items():
        fn = spec["fn"]
        if n in OTHER_ROUTE:
            out[n] = fn.tc_launches
            out[n + ":small"] = fn.small_launches
            out[n + OTHER_ROUTE[n]] = fn.launches - fn.tc_launches - fn.small_launches
        else:
            out[n] = fn.launches
    out["block_gather:layers"] = BO.PoolGather.layer_launches
    out["block_gather:prefix"] = BO.PoolGather.pool2_launches
    return out


def route_of(name, a, kw):
    """The route ("small", "tc" or "simt") the wrapper takes for this call."""
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
    dev = device_ms(lambda: fn(*a, **kw))
    dev_ms = dev["ms"]
    plain_ms = time_ms(lambda: plain_call(name, a, kw))
    lib = library_call(name, a, kw)
    lib_ms = time_ms(lib) if lib is not None else None
    b, fl = work(name, a, kw, out)
    t_bytes, t_ops = b / HBM_BYTES_S * 1e3, fl / PEAK_FLOPS[wdt] * 1e3
    label = label or name
    rec = {"name": label, "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "device_ms": dev_ms,
           "device_events_per_call": dev["events_per_call"], "device_note": dev.get("note"),
           "shapes": shapes(a, kw), "bytes": b,
           "flops": fl, **extra}
    dev_s = ("n/a: " + dev["note"] if dev_ms is None else
             f"{dev_ms:.4f} ms over {dev['events_per_call']:g} device events a call")
    log(f"time {label}: kernel {ms:.4f} ms (device only {dev_s}), plain "
        f"{plain_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({rec['bound_by']}; {b / 1e6:.1f} MB)")
    return rec


def gather_work(call, out):
    """(bytes, flops) of a block-gather call: the K and V page of each
    distinct table entry read once per layer (pad entries all name the zero
    row, and rows that several requests of a batch share are named again;
    an entry past both pools reads nothing), the table (and positions)
    once, every output written once; a rotation is 4 products and 2 sums
    per key pair (3 per output element)."""
    g, table, positions, layers, rotate, _ = call
    n_layers = 1 if isinstance(layers, int) else len(layers)
    page_elems = g.page * int(np.prod(g.tail))
    n_entries = g.pool_k.shape[1] + (g.pool2_k.shape[1] if g.two else 0)
    distinct = torch.unique(table)
    n_read = int(((distinct >= 0) & (distinct < n_entries)).sum())
    reads = (n_read * page_elems * n_layers * (g.pool_k.element_size() + g.pool_v.element_size())
             + nbytes(table))
    return (reads + (nbytes(positions) if rotate else 0) + nbytes(*out),
            3 * table.numel() * page_elems * n_layers if rotate else 0)


def retyped(call, dt):
    """A recorded block-gather call with its pools cast to `dt`: the second
    pool cut to the arena slots the table reads (the table renumbered), so
    the arena is not copied whole."""
    g, table, positions, layers, rotate, keep_raw = call
    if dt == g.pool_k.dtype:
        return call
    extra = ()
    if g.two:
        n1 = g.pool_k.shape[1]
        t = table.long()
        in2 = t >= n1
        used, inv = torch.unique(t[in2] - n1, return_inverse=True)
        extra = (g.pool2_k[:, used].to(dt), g.pool2_v[:, used].to(dt))
        t[in2] = n1 + inv
        table = t.int()
    h = BO.PoolGather(g.pool_k.to(dt), g.pool_v.to(dt), *extra, rope_theta=g.rope_theta)
    return h, table, positions, layers, rotate, keep_raw


def run_gather(call):
    g, table, positions, layers, rotate, keep_raw = call
    return g(table, positions, layers, rotate=rotate, keep_raw=keep_raw)


def per_layer_gather(call):
    """The same gather as one launch per layer through the one-plane
    wrapper `assemble_kv`, which binds the pools and checks every operand
    on each call: the launch count of the design before one launch took
    every layer, but this package's wrapper, not the earlier one (that
    comparison is `scripts/gather_host_cost.py`'s).  -> (function,
    launches a call)."""
    g, table, positions, layers, rotate, keep_raw = call
    ls = [layers] if isinstance(layers, int) else list(layers)
    n = table.shape[0]
    pos = positions.reshape(n, g.page) if rotate else table.reshape(n, g.page)
    kw = dict(rope_theta=g.rope_theta, rotate=rotate, keep_raw=keep_raw)

    def run():
        for layer in ls:
            two = dict(pool2_k=g.pool2_k[layer], pool2_v=g.pool2_v[layer]) if g.two else {}
            BO.assemble_kv(g.pool_k[layer], g.pool_v[layer], table, pos, **kw, **two)
    return run, len(ls)


def in_turns(fn, lib, rounds=2):
    """CUDA-event ms of `fn` and `lib` in turns, K L L K per round.  ->
    {"pairs": [(fn ms, lib ms)] of adjacent turns, "verdict": "no slower"
    or "slower" when every pair agrees, else "unresolved"}."""
    pairs = []
    for _ in range(rounds):
        k1, l1, l2, k2 = time_ms(fn), time_ms(lib), time_ms(lib), time_ms(fn)
        pairs += [(k1, l1), (k2, l2)]
    wins = [k <= lb for k, lb in pairs]
    verdict = "no slower" if all(wins) else "slower" if not any(wins) else "unresolved"
    return {"pairs": pairs, "verdict": verdict}


def gather_err(call, label):
    """A recorded block-gather call against its plain version: copies
    (values, unrotated and raw keys) bitwise, rotated keys within
    GATHER_TOL of max(1, max|plain|) in the pools' dtype.  -> max|kernel -
    plain| of the rotated keys (0.0 for a copy)."""
    rotate, dt = call[4], call[0].pool_k.dtype
    got, want = run_gather(call), call[0].plain(*call[1:4], rotate=rotate, keep_raw=call[5])
    torch.cuda.synchronize()
    exact = [torch.equal(x, w) for x, w in zip(got, want)]
    err = 0.0
    if rotate:
        exact = exact[1:]                    # values and raw keys
        scale = max(1.0, float(want[0].float().abs().max()))
        err = float((got[0].float() - want[0].float()).abs().max())
        if not torch.isfinite(got[0]).all() or err > GATHER_TOL[dt] * scale:
            raise RuntimeError(f"{label}: rotated keys max|kernel-plain| {err} > "
                               f"{GATHER_TOL[dt]} x {scale}")
    if not all(exact):
        raise RuntimeError(f"{label}: copies not bitwise {exact}")
    return err


def gather_records(calls, spec, launches, modes):
    """The block gather against its plain version on the inputs of its
    largest call of each mode (`GatherRecorder`): "layers" (a selective
    pass, every layer in one launch), "copy" (layer 0's Eq. 3 rows) and
    "prefix" (a selective pass over store-shared prefix rows too), in the
    pools' serving dtype (fp32) and cast to the model's bf16.  Copies
    (values, unrotated and raw keys) must be bitwise; rotated keys within
    GATHER_TOL of max(1, max|plain|).  Each record also times the same
    work as one launch per layer through the one-plane wrapper
    (`per_layer`), and splits each time into device and host work.  The
    copy is timed against its library call (two `index_select`s) in turns,
    K L L K K L L K, and called no slower or slower only if every adjacent
    pair agrees (`vs_library`)."""
    records = []
    for mode in modes:
        if mode not in calls:
            raise RuntimeError(f"block_gather: no {mode} call was recorded")
        _, call = calls[mode]
        rotate = call[4]
        errs = {dt: gather_err(retyped(call, dt), f"block_gather {mode} {dt}")
                for dt in (torch.float32, torch.bfloat16)}
        g, table, positions, layers, _, keep_raw = call
        desc = [f"{tuple(table.shape)}:int32", f"layers {layers}",
                f"pools {tuple(g.pool_k.shape)}:{str(g.pool_k.dtype)[6:]}"]
        if g.two:
            desc.append(f"second pools {tuple(g.pool2_k.shape)} strides {g.pool2_k.stride()}")
        log(f"check block_gather {mode}: {desc} copies bitwise; rotated keys "
            f"max|kernel-plain| fp32 {errs[torch.float32]:.3g}, bf16 "
            f"{errs[torch.bfloat16]:.3g} (tol {GATHER_TOL} x max(1, max|k|))")
        fn = lambda: run_gather(call)
        out = fn()
        ms = time_ms(fn)
        dev = device_ms(fn)
        plain_ms = time_ms(lambda: g.plain(*call[1:4], rotate=rotate, keep_raw=keep_raw))
        lib_ms = vs_lib = None
        if mode == "copy":       # one PyTorch call per output gathers the rows
            pk, pv, bt = g.pool_k[layers], g.pool_v[layers], table.long()
            lib = lambda: (torch.index_select(pk, 0, bt), torch.index_select(pv, 0, bt))
            lib_ms = time_ms(lib)
            vs_lib = in_turns(fn, lib)
        per_layer, n_pl = per_layer_gather(call)
        pl_ms = time_ms(per_layer)
        pl_dev = device_ms(per_layer)
        b, fl = gather_work(call, out)
        t_bytes, t_ops = b / HBM_BYTES_S * 1e3, fl / PEAK_FLOPS[torch.float32] * 1e3
        host = lambda ms_, d: None if d["ms"] is None else (ms_ - d["ms"]) * 1e3
        label = {"layers": "block_gather:layers", "copy": "block_gather:copy",
                 "prefix": "block_gather:prefix"}[mode]
        rec = {"name": label, "route": "cuda", "source": spec["source"],
               "replaces": spec["replaces"], "launches": launches[mode],
               "max_abs_err": errs[torch.float32], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms, "device_ms": dev["ms"],
               "device_events_per_call": dev["events_per_call"], "device_note": dev.get("note"),
               "shapes": desc, "bytes": b, "flops": fl, "tol": GATHER_TOL[torch.float32],
               "bf16_max_abs_err": errs[torch.bfloat16],
               "host_us": host(ms, dev), "vs_library": vs_lib,
               "per_layer": {"launches": n_pl, "ms": pl_ms, "device_ms": pl_dev["ms"],
                             "device_events_per_call": pl_dev["events_per_call"],
                             "host_us": host(pl_ms, pl_dev),
                             "host_us_per_launch": None if pl_dev["ms"] is None else
                             host(pl_ms, pl_dev) / n_pl}}
        dev_s = ("n/a: " + dev["note"] if dev["ms"] is None else
                 f"{dev['ms']:.4f} ms over {dev['events_per_call']:g} device events a call")
        us = lambda x: "n/a" if x is None else f"{x:.1f} us"
        bdev = pl_dev["ms"]
        log(f"time {label}: kernel {ms:.4f} ms (device only {dev_s}; host {us(rec['host_us'])}),"
            f" plain {plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({rec['bound_by']}; {b / 1e6:.1f} MB); as "
            f"{n_pl} launches through the one-plane wrapper: {pl_ms:.4f} ms, device "
            f"{'n/a' if bdev is None else f'{bdev:.4f} ms'}, host "
            f"{us(rec['per_layer']['host_us'])}")
        if vs_lib is not None:
            log(f"  {label} vs two index_selects in turns (kernel, library ms): "
                + "; ".join(f"{k:.4f} / {lb:.4f}" for k, lb in vs_lib["pairs"])
                + f": {vs_lib['verdict']}")
        records.append(rec)
        del out
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
    cold_s = "n/a: " + cold["note"] if cold["ms"] is None else f"{cold['ms']:.4f} ms"
    cold = cold["ms"]
    log(f"check paged_decode_attention split-K: {splits} splits of {pps} pages, {blocks} "
        f"blocks on {sms} SMs; max|kernel - split plain| {err:.3g}; device time with the "
        f"L2 flushed {cold_s}")
    return {"pages_per_split": pps, "splits": splits, "blocks": blocks,
            "split_ref_max_abs_err": err, "device_cold_ms": cold, "flush_mb": 256}


def plain_err(fn, name, a, kw, label):
    """The kernel wrapper `fn` at a recorded call against its plain version
    on the same inputs, within TOL of their working dtype.  -> (kernel
    output, max|kernel - plain|)."""
    out = fn(*a, **kw)
    plain = plain_call(name, a, kw)
    torch.cuda.synchronize()
    wdt = a[0].dtype
    err = float((out.float() - plain.float()).abs().max())
    if not torch.isfinite(out).all() or err > TOL[wdt]:
        raise RuntimeError(f"{label}: max|kernel-plain| {err} > {TOL[wdt]} ({wdt})")
    return out, err


def checked_record(name, spec, launches, a, kw, extra, fp32_too=False, label=None):
    """The kernel against its plain version on these inputs (within
    TOL of their working dtype; with `fp32_too` also the same call cast to
    fp32, which takes the SIMT route at D > 32, held to the plain version
    and timed), then its timed record."""
    fn = spec["fn"]
    out, err = plain_err(fn, name, a, kw, label or name)
    wdt = a[0].dtype
    extra = dict(extra, tol=TOL[wdt])
    msg = ""
    if fp32_too:
        a32, kw32 = to_fp32(name, a, kw)
        out32 = fn(*a32, **kw32)
        err32 = float((out32 - plain_call(name, a32, kw32)).abs().max())
        if err32 > TOL[torch.float32]:
            raise RuntimeError(f"{name}: fp32 max|kernel-plain| {err32} > {TOL[torch.float32]}")
        call32 = lambda: fn(*a32, **kw32)
        extra.update(fp32_max_abs_err=err32, fp32_ms=time_ms(call32),
                     fp32_device_ms=device_ms(call32)["ms"])
        msg = (f"; same call in fp32 {err32:.3g} (tol {TOL[torch.float32]}), "
               f"{extra['fp32_ms']:.4f} ms (device {extra['fp32_device_ms']})")
        if name in OTHER_ROUTE:
            extra["fp32_route"] = route_of(name, a32, kw32)
            msg += f" on the {extra['fp32_route']} route"
    route = f" ({extra['kernel_route']} route)" if "kernel_route" in extra else ""
    log(f"check {label or name}{route}: {shapes(a, kw)} max|kernel-plain| {err:.3g} "
        f"(tol {TOL[wdt]}, {str(wdt).replace('torch.', '')}){msg}")
    return timed_record(name, spec, launches, a, kw, out, err, wdt, extra, label=label)


def forced_route(name, route, a, kw):
    """B1 or B2 at a recorded call, launched on `route` through the
    wrapper's route-taking entry (`_flash_launch` / `_selective_launch`,
    the wrapper after its CPU check), so two routes pay the same host
    work."""
    if name == "flash_attention":
        return lambda: FO._flash_launch(route, *a, kv_valid=kw.get("kv_valid"),
                                        causal=kw.get("causal", True))
    return lambda: SO._selective_launch(route, *a, live=kw.get("live"),
                                        window=kw.get("window", 256),
                                        q_block=kw.get("q_block", 64),
                                        kv_block=kw.get("kv_block", 64))


def simt_vs_small_fwd(name, a, kw):
    """The SIMT route at a small-head call of B1 or B2: within TOL of the
    plain version, then both routes timed in turns (small, SIMT, SIMT,
    small) by CUDA events and device time.  -> {"max_abs_err", "ms" and
    "device_ms" (the SIMT turns' medians), "turns"}."""
    simt, small = forced_route(name, "simt", a, kw), forced_route(name, "small", a, kw)
    got, want = simt(), plain_call(name, a, kw)
    torch.cuda.synchronize()
    wdt = a[0].dtype
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got).all() or err > TOL[wdt]:
        raise RuntimeError(f"{name} SIMT route at a small-head call: max|kernel-plain| {err} > "
                           f"{TOL[wdt]}")
    turns = []
    for route, fn in (("small", small), ("simt", simt), ("simt", simt), ("small", small)):
        turns.append({"route": route, "ms": time_ms(fn), "device_ms": device_ms(fn)["ms"]})
    simt_turns = [t for t in turns if t["route"] == "simt"]
    dev = [t["device_ms"] for t in simt_turns if t["device_ms"] is not None]
    log(f"  {name} at a small-head call, small vs SIMT route in turns: " + "; ".join(
        f"{t['route']} {t['ms']:.4f} ms (device "
        f"{'n/a' if t['device_ms'] is None else format(t['device_ms'], '.4f')})" for t in turns)
        + f"; SIMT max|kernel-plain| {err:.3g}")
    return {"max_abs_err": err, "ms": statistics.median(t["ms"] for t in simt_turns),
            "device_ms": statistics.median(dev) if dev else None, "turns": turns}


def small_route_record(name, a, kw, launches, label):
    """B1 or B2 at a recorded call of the tiny model (D <= 32), which must
    take the small-head route: within TOL of its plain version, a second
    call bitwise equal, timed beside its bound and library call
    (`checked_record`), and the SIMT route at the same call held to the
    plain version and timed in turns with it ("simt_route")."""
    spec = KERNELS[name]
    extra = {"kernel_route": check_route(name, a, kw, "small")}
    first, again = spec["fn"](*a, **kw), spec["fn"](*a, **kw)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise RuntimeError(f"{label}: two calls on the same inputs differ")
    del first, again
    extra["bitwise_repeat"] = True
    rec = checked_record(name, spec, launches, a, kw, extra, label=label)
    rec["simt_route"] = simt_vs_small_fwd(name, a, kw)
    return rec


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


def bag_turns(table, ids, flush, first):
    """B5 (`bag_sum`) and its first design (`first`, a `BD.Designs`; held
    to the plain version within BAG_TOL first) at one call, in turns port,
    first, first, port: CUDA-event ms (host work included), the same with
    the host work hidden behind a spin kernel (`queued_ms`), and device ms
    warm and with the L2 flushed before each call (`flush`; None where the
    profiler saw another number of device events than one a call).  ->
    {"turns", "first_max_abs_err", and per design the medians "ms",
    "queued_ms", "device_ms", "device_cold_ms"; "verdict": the port's
    design "no slower" or "slower" when both pairs of turns agree on the
    host-hidden time and on every device time both turns of a pair have,
    else "unresolved"}."""
    def one_event(dev):
        return dev["ms"] if dev["events_per_call"] == 1 else None

    want = embedding_bag_ref(table, ids)
    got = first.bag("first", table, ids)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if err > BAG_TOL[table.dtype] * max(1.0, float(want.float().abs().max())):
        raise RuntimeError(f"embedding_bag's first design: max|kernel-plain| {err}")
    del got, want
    calls = {"port": lambda: EO.bag_sum(table, ids),
             "first": lambda: first.bag("first", table, ids)}
    turns = []
    for design in ("port", "first", "first", "port"):
        fn = calls[design]
        turns.append({"design": design, "ms": time_ms(fn), "queued_ms": queued_ms(fn),
                      "device_ms": one_event(device_ms(fn)),
                      "device_cold_ms": one_event(device_ms(fn, flush=flush))})
    out = {"turns": turns, "first_max_abs_err": err}
    keys = ("ms", "queued_ms", "device_ms", "device_cold_ms")
    for design in calls:
        got = {k: [t[k] for t in turns if t["design"] == design and t[k] is not None]
               for k in keys}
        out[design] = {k: statistics.median(v) if v else None for k, v in got.items()}
    wins = [turns[i][k] <= turns[j][k] for i, j in ((0, 1), (3, 2))
            for k in ("queued_ms", "device_ms", "device_cold_ms")
            if turns[i][k] is not None and turns[j][k] is not None]
    out["verdict"] = ("no slower" if wins and all(wins) else
                      "slower" if wins and not any(wins) else "unresolved")
    log("  embedding_bag vs its first design in turns: " + "; ".join(
        f"{t['design']} {t['ms']:.4f} ms (host hidden {t['queued_ms']:.4f}, device "
        f"{t['device_ms']}, L2 flushed {t['device_cold_ms']})" for t in turns)
        + f"; the port's {out['verdict']}")
    return out


def bag_records(calls, spec, launches, models):
    """The embedding bag against its plain version on the inputs of
    Wide&Deep's serve_bulk and serve_p99 calls: the wide table in fp32 and
    in bf16, and the same ids into the (rows, 32) deep table, each within
    BAG_TOL of max(1, max|plain|), a second call bitwise equal; then timed
    (`timed_record`, also with the L2 flushed) and in turns with its first
    design (`bag_turns`)."""
    records = []
    deep_table = models["wide-deep"].table
    first = BD.Designs(deep_table.device)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=deep_table.device)
    for shape in ("serve_bulk", "serve_p99"):
        b = RREG.RECSYS_SHAPES[shape].dims["batch"]
        if b not in calls:
            raise RuntimeError(f"embedding_bag: no call of batch {b} ({shape}) was recorded")
        table, ids, _ = calls[b]
        errs = {}
        for label, t in (("fp32 d=1", table), ("bf16 d=1", table.to(torch.bfloat16)),
                         ("fp32 d=32", deep_table)):
            want = embedding_bag_ref(t, ids)
            tol = BAG_TOL[t.dtype] * max(1.0, float(want.float().abs().max()))
            got, again = spec["fn"](t, ids), spec["fn"](t, ids)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if got.dtype != t.dtype or not torch.isfinite(got).all() or err > tol:
                raise RuntimeError(f"embedding_bag {shape} {label}: max|kernel-plain| {err} "
                                   f"> {tol}")
            if not torch.equal(got, again):
                raise RuntimeError(f"embedding_bag {shape} {label}: two calls differ")
            errs[label] = err
            del got, want, again
        log(f"check embedding_bag {shape}: ids {tuple(ids.shape)} into {tuple(table.shape)}; "
            "max|kernel-plain| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {BAG_TOL} x max(1, max|plain|)); a second call bitwise equal")
        a = (table, ids)
        out = spec["fn"](*a)
        elt = table.element_size()
        g = EO.staged_geometry(*ids.shape, table.shape[1], elt, table.shape[1] % (16 // elt) == 0,
                               torch.cuda.get_device_properties(0).multi_processor_count)
        # rows narrower than a 32-byte sector cost the card a whole sector
        row = table.shape[1] * table.element_size()
        sector_bytes = nbytes(ids) + ids.numel() * max(32, -(-row // 32) * 32) + nbytes(out)
        cold = device_ms(lambda: spec["fn"](*a), flush=flush)
        extra = {"tol": BAG_TOL[torch.float32], "bf16_max_abs_err": errs["bf16 d=1"],
                 "d32_max_abs_err": errs["fp32 d=32"],
                 "bitwise_repeat": True, "geometry": g._asdict(),
                 "device_cold_ms": cold["ms"], "device_cold_note": cold.get("note"),
                 "flush_mb": 256, "sector_bound_ms": sector_bytes / HBM_BYTES_S * 1e3,
                 "vs_first_design": bag_turns(table, ids, flush, first)}
        rec = timed_record("embedding_bag", spec, launches, a, {}, out,
                           errs["fp32 d=1"], torch.float32, extra,
                           label="embedding_bag" if shape == "serve_bulk"
                           else f"embedding_bag:{shape}")
        log(f"  embedding_bag {shape}: device time with the L2 flushed "
            f"{cold['ms'] if cold['ms'] is not None else 'n/a: ' + cold['note']}; "
            f"tiles of {g.TB} bags, {g.FC} fields a chunk")
        records.append(rec)
    del flush
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
    gather_rec = GatherRecorder()
    store_rec = StoreDecodeRecorder(PO.paged_decode_mha)
    saved = [(BE, "paged_decode_mha", BE.paged_decode_mha)]
    saved.append((BO.PoolGather, "__call__", patch_gather(gather_rec)))
    out, launches = {"runs": {}}, {}
    try:
        for sched in ("wave", "chunked"):
            gen, rows = {}, {}
            for kind in ("off", "off2", "on"):
                kv = kind == "on"
                config = ServeConfig(decode_steps=args.decode_steps, sched=sched, kv_reuse=kv)
                # B3 is recorded over store-shared pages only: in the reuse-on runs
                BE.paged_decode_mha = store_rec if kv else saved[0][2]
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
        out["runs"][label] = {"line": line, "serve": rep, "summary": crep.summary()}
        log(f"    ClusterReport.summary(): {out['runs'][label]['summary']}")
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

    def tap(g, table, positions, layers, rotate, keep_raw):
        if rotate:
            moved[0] += 1
            ar = torch.arange(positions.shape[0], device=positions.device,
                              dtype=positions.dtype)
            moved[1] += bool((positions != ar).any())

    reset_counts()
    t0 = time.perf_counter()
    orig = patch_gather(tap)
    try:
        scores, fracs = rank_all(system, reqs, sel)
    finally:
        BO.PoolGather.__call__ = orig
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
# ------------------------------------------------------ attention-backend seam
# phase 2k: phase 2's requests straight through the engine
# (`rcllm_batch_requests`, one `BatchEngine.prefill(mode="rcllm")`, then
# SEAM_STEPS greedy decode steps) under four configurations of the
# attention-backend seam: (a) the kernels, (b) their plain versions on the
# card, (c) plain with the decode pinned to the paged-decode kernel, (d) the
# kernels with the per-request rcllm prefill.  Then (b) and (a) once more,
# in turns, for the times (prefill s; decode ms per step, the median of
# steps 2..SEAM_STEPS).  Each run's tokens pass the token gate against
# (a)'s, and at each last position the logit of (a)'s greedy pick lies
# within SEAM_TOL of (a)'s, relative to max(1, |(a)'s|).  The whole rows
# of the bf16 runs are reported; they are gated on a second witness, the
# same weights cast to fp32, where (a) and (b) run again (a32, b32) and
# every logit of b32 lies within SEAM_TOL_FP32 of a32's, relative to
# max(1, the row's largest |logit|)
SEAM_STEPS = 8
SEAM_TOL = TOL[torch.bfloat16]
SEAM_TOL_FP32 = TOL[torch.float32]
SEAM_RUNS = (("a", dict(attn_backend="cuda"), True),
             ("b", dict(attn_backend="plain"), True),
             ("c", dict(attn_backend="plain", decode_kernel="paged"), True),
             ("d", dict(attn_backend="cuda"), False),
             ("b_2", dict(attn_backend="plain"), True),
             ("a_2", dict(attn_backend="cuda"), True))
SEAM_KERNELS = ("flash_attention", "flash_attention:small", "flash_attention:fp32",
                "selective_attention", "selective_attention:small",
                "selective_attention:fp32", "paged_decode_attention", "block_gather")
# the examples on the card: (file, arguments, kernels that must launch)
EXAMPLES = (("torch_quickstart", [], ("flash_attention:small", "selective_attention:small",
                                      "block_gather")),
            ("torch_train_ranker", ["--steps", "20", "--eval", "8"],
             ("flash_bwd:small", "flash_attention:small", "selective_attention:small",
              "block_gather")))


class SelectiveTap:
    """Wraps the engine's selective-attention wrapper: one entry per
    distinct call of a selective pass (its layers share shapes and the
    liveness map) with its `flop_reduction` and the live-tile share of its
    `block_liveness` map."""

    def __init__(self):
        self.calls = {}
        self.fn = ENG.selective_mha

    def __call__(self, q, qp, k, v, hh, **kw):
        live = kw.get("live")
        key = (tuple(q.shape), tuple(k.shape), None if live is None else live.data_ptr())
        if key not in self.calls:
            n_hh = float(torch.as_tensor(hh).float().sum(-1).mean())
            self.calls[key] = {
                "q": list(q.shape), "k": list(k.shape), "calls": 0,
                "flop_reduction": SO.flop_reduction(q.shape[1], k.shape[1], round(n_hh),
                                                    kw.get("window", 0)),
                "live_tile_share": None if live is None else float(live.float().mean())}
        self.calls[key]["calls"] += 1
        return self.fn(q, qp, k, v, hh, **kw)

    def __enter__(self):
        ENG.selective_mha = self
        return self

    def __exit__(self, *exc):
        ENG.selective_mha = self.fn


def _rows_of(logits):
    """(greedy token, top-1 logit, top-1 minus top-2 gap) per row."""
    out = []
    for lg in np.asarray(logits, np.float64):
        top = np.partition(lg, -2)[-2:]
        out.append((int(np.argmax(lg)), float(top[1]), float(top[1] - top[0])))
    return out


def seam_run(model, cfg, rows, brs, knobs, batched):
    """One configuration: a fresh engine over `model` and the phase-2
    system's cached rows, one rcllm prefill of every request, SEAM_STEPS
    greedy decode steps, every request released.  The counts are set to 0
    just before and read just after."""
    config = ServeConfig(decode_steps=SEAM_STEPS, **knobs)
    sel = ENG.SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev, window=16)
    engine = API.build_engine(model, cfg, config, sel=sel, cache=rows,
                              batched_selective=batched)
    rids = [r.rid for r in brs]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = engine.prefill(brs, "rcllm")
    prefill_s = time.perf_counter() - t0
    stats = engine.pool.stats()
    toks = {rid: [int(np.argmax(lg))] for rid, lg in zip(rids, logits)}
    rows = {rid: [row] for rid, row in zip(rids, _rows_of(logits))}
    step_ms = []
    for _ in range(SEAM_STEPS):
        t0 = time.perf_counter()
        out = engine.decode(rids, [toks[r][-1] for r in rids])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for rid, row in zip(rids, _rows_of(out)):
            toks[rid].append(row[0])
            rows[rid].append(row)
    torch.cuda.synchronize()
    launched = counts()
    recompute = {rid: engine.last_stats[rid].recompute_fraction() for rid in rids}
    for rid in rids:
        engine.release(rid)
    res = {"tokens": toks, "rows": rows, "logits": logits, "prefill_s": prefill_s,
           "decode_step_ms": step_ms,
           "decode_ms_median_steps_2_on": statistics.median(step_ms[1:]),
           "launches": launched, "utilization": stats.utilization,
           "internal_fragmentation": stats.internal_fragmentation,
           "resolved": (engine.attn_kernels, engine.paged), "recompute": recompute}
    del engine
    gc.collect()                # the engine's cycles hold its arena and model
    torch.cuda.empty_cache()
    return res


def logits_diff(got, want):
    """How far `got`'s rows lie from `want`'s: at the index of want's
    largest logit, the largest |difference| over max(1, |want's logit|);
    of whole rows the largest |difference|, that over max(1, max |want|),
    and the L2 norm of the difference over want's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rows = np.arange(len(want))
    top = want.argmax(axis=1)
    d = np.abs(got - want)
    return {"at_argmax_rel": float((d[rows, top]
                                    / np.maximum(1.0, np.abs(want[rows, top]))).max()),
            "max_abs": float(d.max()),
            "max_rel_row_max": float((d.max(axis=1)
                                      / np.maximum(1.0, np.abs(want).max(axis=1))).max()),
            "l2_rel": float((np.linalg.norm(got - want, axis=1)
                             / np.linalg.norm(want, axis=1)).max()),
            "bitwise": bool(np.array_equal(got, want))}


def fp32_copy(model, cfg):
    """The model's weights cast to fp32, in a model of their own beside
    it (the bf16 model is untouched).  -> (model, cfg)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = TT.Transformer(cfg32, device=model.device)
    with torch.no_grad():
        for (n32, p32), (n, p) in zip(m32.named_parameters(), model.named_parameters()):
            assert n32 == n and p32.shape == p.shape, (n32, n)
            p32.copy_(p)
    return m32, cfg32


def seam_launches_want(cfg, run, n_req, suffix=""):
    """The launches a kernel run of phase 2k makes: one B4 launch a
    selective pass and a layer-0 copy a request, (n_layers - 1) B2
    launches a pass on the route `suffix` names, n_layers B3 launches a
    decode step; no other attention route."""
    passes = run["block_gather:layers"]
    want = {n: 0 for n in SEAM_KERNELS}
    want.update({"selective_attention" + suffix: (cfg.n_layers - 1) * passes,
                 "paged_decode_attention": cfg.n_layers * SEAM_STEPS,
                 "block_gather": passes + n_req})
    return want, passes


def run_example(name, argv):
    """One `examples/<name>.py` on the card through its `main(argv)`, the
    counts set to 0 just before and read just after."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    reset_counts()
    t0 = time.perf_counter()
    out = mod.main(argv)
    torch.cuda.synchronize()
    return out, counts(), time.perf_counter() - t0


def seam_phase(system, pool_rv, prof, cfg, args, wave_tokens):
    """Phase 2k: the attention-backend seam at full width and depth (the
    phase-2 system), its fp32 witness, then the two examples that run a
    model, on the card at small sizes.  -> (report, launches per run)."""
    trace = SERVE.launcher_trace(system, pool_rv, prof, args.requests, args.qps)
    brs = WL.rcllm_batch_requests(system, trace, n_reserve=SEAM_STEPS)
    log(f"attention-backend seam (phase 2k): {len(brs)} requests (phase 2's) through "
        f"`rcllm_batch_requests` and one `BatchEngine.prefill`, then {SEAM_STEPS} greedy "
        f"decode steps; depth {cfg.n_layers}; (a) cuda, (b) plain, (c) plain + paged "
        "decode, (d) cuda with the per-request prefill; then (b), (a) again in turns")
    log("  reuse_fraction per request: " + ", ".join(
        f"{r.rid} {r.plan.reuse_fraction():.4f}" for r in brs))
    runs, launches = {}, {}
    for label, knobs, batched in SEAM_RUNS:
        if label == "a":
            with SelectiveTap() as tap:
                runs[label] = seam_run(system.model, cfg, system.rows, brs, knobs, batched)
            runs[label]["b2_calls"] = list(tap.calls.values())
        else:
            runs[label] = seam_run(system.model, cfg, system.rows, brs, knobs, batched)
        r = runs[label]
        launches["2k_" + label] = r["launches"]
        log(f"  ({label}) {knobs}{'' if batched else ', batched_selective=False'}: resolved "
            f"kernels / paged {r['resolved']}; prefill {r['prefill_s']:.4f} s, decode "
            f"{r['decode_ms_median_steps_2_on']:.2f} ms a step (median of steps 2-"
            f"{SEAM_STEPS}; all {['%.2f' % t for t in r['decode_step_ms']]}); pool after "
            f"prefill: utilization {r['utilization']:.4f}, internal fragmentation "
            f"{r['internal_fragmentation']:.4f}")
        log(f"    launches: { {k: r['launches'][k] for k in SEAM_KERNELS} }, "
            f"block_gather:layers {r['launches']['block_gather:layers']}")
    for c in runs["a"]["b2_calls"]:
        log(f"  B2 call q {c['q']} k {c['k']} x {c['calls']} (one a layer): flop_reduction "
            f"{c['flop_reduction']:.4f}, live-tile share {c['live_tile_share']:.4f}")
    # ---- gates ----
    a = runs["a"]
    n_req = len(brs)
    gates = {}
    for label in ("b", "c", "d", "b_2", "a_2"):
        r = runs[label]
        g = token_gate(r["tokens"], a["tokens"], r["rows"], a["rows"],
                       label=f"phase 2k ({label} vs a)")
        g["logits"] = diff = logits_diff(r["logits"], a["logits"])
        gates[label] = g
        log_gate(f"token gate ({label} vs a)", g, n_req)
        log(f"    last-position logits ({label} vs a): at (a)'s argmax "
            f"{diff['at_argmax_rel']:.4g} of max(1, |(a)'s|) (tol {SEAM_TOL}); whole rows "
            f"(reported; gated in fp32 below): max |diff| {diff['max_abs']:.4g}, "
            f"{diff['max_rel_row_max']:.4g} of the row max, L2 {diff['l2_rel']:.4g} of (a)'s"
            f"{', bitwise equal' if diff['bitwise'] else ''}")
        if not np.isfinite(r["logits"]).all() or diff["at_argmax_rel"] > SEAM_TOL:
            raise RuntimeError(f"phase 2k ({label}): prefill logits at (a)'s argmax {diff} "
                               f"from (a)'s, tol {SEAM_TOL}")
    if not np.array_equal(runs["b"]["logits"], runs["c"]["logits"]):
        raise RuntimeError("phase 2k: (b) and (c) prefill logits differ: the decode pin "
                           "must not touch prefill")
    log("  (b) and (c) prefill logits bitwise equal")
    la, lb, lc, ld = (runs[k]["launches"] for k in ("a", "b", "c", "d"))
    kernel_counts = {k: {n: runs[k]["launches"][n] for n in SEAM_KERNELS}
                     for k in ("a", "b", "c", "d")}
    if any(lb[n] for n in SEAM_KERNELS) or any(runs["b_2"]["launches"][n]
                                               for n in SEAM_KERNELS):
        raise RuntimeError(f"phase 2k (b) launched kernels: {kernel_counts['b']}")
    if lc["paged_decode_attention"] == 0 or any(lc[n] for n in SEAM_KERNELS
                                                if n != "paged_decode_attention"):
        raise RuntimeError(f"phase 2k (c) launches {kernel_counts['c']}: want B3 only")
    decode_launches = cfg.n_layers * SEAM_STEPS
    for label, run in (("a", la), ("d", ld)):
        want, passes = seam_launches_want(cfg, run, n_req)
        got = {n: run[n] for n in want}
        if got != want or passes < 1 or (label == "d" and passes != n_req):
            raise RuntimeError(f"phase 2k ({label}) launches {got}, {passes} selective "
                               f"passes: want {want}")
    log(f"  launches as predicted: (a) {la['block_gather:layers']} selective passes (one "
        f"B4 launch each + {n_req} layer-0 copies, {cfg.n_layers - 1} B2 launches each), "
        f"(d) {n_req} passes; B3 {decode_launches} in each")
    same = sum(a["tokens"][rid][:len(t)] == t for rid, t in wave_tokens.items())
    log(f"  (a) decodes phase 2's wave tokens for {same} of {len(wave_tokens)} requests "
        "(phase 2's batches formed on measured step times)")
    turns = {k: {"prefill_s": runs[k]["prefill_s"],
                 "decode_ms": runs[k]["decode_ms_median_steps_2_on"]}
             for k in ("a", "b", "b_2", "a_2")}
    log("  in turns a, b, ..., b, a: " + "; ".join(
        f"({k}) prefill {v['prefill_s']:.4f} s, decode {v['decode_ms']:.2f} ms"
        for k, v in turns.items()))
    # ---- the fp32 witness: (a) and (b) again on the weights cast to fp32 ----
    before = torch.cuda.memory_allocated()
    m32, cfg32 = fp32_copy(system.model, cfg)
    log(f"  fp32 witness: the phase-2 weights cast to fp32 "
        f"({sum(p.numel() for p in m32.parameters()) * 4 / 1e9:.2f} GB beside the bf16 "
        f"model; {before / 1e9:.1f} GB allocated before it); (a32) cuda, (b32) plain")
    for label, knobs in (("a32", dict(attn_backend="cuda")),
                         ("b32", dict(attn_backend="plain"))):
        runs[label] = r = seam_run(m32, cfg32, system.rows, brs, knobs, True)
        launches["2k_" + label] = r["launches"]
        log(f"  ({label}) {knobs}: resolved kernels / paged {r['resolved']}; prefill "
            f"{r['prefill_s']:.4f} s, decode {r['decode_ms_median_steps_2_on']:.2f} ms a "
            f"step (median of steps 2-{SEAM_STEPS}); launches "
            f"{ {k: r['launches'][k] for k in SEAM_KERNELS} }")
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  fp32 model freed: {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    a32, b32 = runs["a32"], runs["b32"]
    g = token_gate(b32["tokens"], a32["tokens"], b32["rows"], a32["rows"],
                   label="phase 2k (b32 vs a32)")
    g["logits"] = diff = logits_diff(b32["logits"], a32["logits"])
    gates["b32"] = g
    log_gate("token gate (b32 vs a32)", g, n_req)
    log(f"    last-position logits (b32 vs a32), whole rows: max |diff| "
        f"{diff['max_abs']:.4g}, {diff['max_rel_row_max']:.4g} of the row max (tol "
        f"{SEAM_TOL_FP32}), L2 {diff['l2_rel']:.4g} of (a32)'s; at (a32)'s argmax "
        f"{diff['at_argmax_rel']:.4g}")
    if (not np.isfinite(b32["logits"]).all() or not np.isfinite(a32["logits"]).all()
            or diff["max_rel_row_max"] > SEAM_TOL_FP32):
        raise RuntimeError(f"phase 2k (b32 vs a32): whole-row prefill logits {diff}, tol "
                           f"{SEAM_TOL_FP32} of the row max")
    if any(b32["launches"][n] for n in SEAM_KERNELS):
        raise RuntimeError(f"phase 2k (b32) launched kernels: "
                           f"{ {n: b32['launches'][n] for n in SEAM_KERNELS} }")
    want, passes = seam_launches_want(cfg, a32["launches"], n_req, ":fp32")
    got = {n: a32["launches"][n] for n in want}
    if got != want or passes < 1:
        raise RuntimeError(f"phase 2k (a32) launches {got}, {passes} selective passes: "
                           f"want {want}")
    # the bf16 runs against the fp32 result: how far each rounding lands
    to_fp32 = {k: logits_diff(runs[k]["logits"], a32["logits"]) for k in ("a", "b")}
    gates["bf16_vs_fp32"] = to_fp32
    kernel_counts.update({k: {n: runs[k]["launches"][n] for n in SEAM_KERNELS}
                          for k in ("a32", "b32")})
    log("  bf16 against fp32 (a32), whole rows: " + "; ".join(
        f"({k}) max |diff| {v['max_abs']:.4g}, {v['max_rel_row_max']:.4g} of the row max, "
        f"L2 {v['l2_rel']:.4g}" for k, v in to_fp32.items()))
    # ---- the examples, on the card at small sizes ----
    examples = {}
    for name, argv, required in EXAMPLES:
        out, ran, secs = run_example(name, argv)
        launches["example_" + name] = ran
        missing = [n for n in required if ran[n] == 0]
        simt = {n: ran[n + ":fp32"] for n in SMALL_FWD if ran[n + ":fp32"]}
        if missing or simt:
            raise RuntimeError(f"example {name}: kernels never launched {missing}, SIMT "
                               f"launches {simt}")
        examples[name] = {"argv": argv, "seconds": secs,
                          "launches": {k: v for k, v in ran.items() if v}}
        if name == "torch_quickstart":
            if not (np.isfinite(out["scores"]).all() and np.isfinite(out["full"]).all()):
                raise RuntimeError(f"example {name}: scores {out['scores']}")
            examples[name].update(ndcg5=out["ndcg5"],
                                  reuse_fraction=out["plan"].reuse_fraction())
        else:
            losses = [l for _, l in out["history"]]
            if not np.isfinite(losses).all():
                raise RuntimeError(f"example {name}: losses {losses}")
            examples[name].update(losses=losses, table=out["table"])
        log(f"  example {name} {' '.join(argv)} on the card: {secs:.1f} s, launches "
            f"{examples[name]['launches']}")
    report = {"requests": n_req, "decode_steps": SEAM_STEPS,
              "reuse_fraction": {r.rid: r.plan.reuse_fraction() for r in brs},
              "b2_calls": runs["a"]["b2_calls"], "kernel_launches": kernel_counts,
              "turns": turns, "gates": gates, "wave_tokens_equal": same,
              "fp32_witness": {k: {"prefill_s": runs[k]["prefill_s"],
                                   "decode_ms": runs[k]["decode_ms_median_steps_2_on"]}
                               for k in ("a32", "b32")},
              "pool_after_prefill": {k: {"utilization": runs[k]["utilization"],
                                         "internal_fragmentation":
                                         runs[k]["internal_fragmentation"]}
                                     for k in ("a", "d")},
              "decode_step_ms": {k: r["decode_step_ms"] for k, r in runs.items()},
              "examples": examples}
    return report, launches


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
    """Keeps the (ids, d_out, rows, row0) of the largest CUDA bag-gradient
    call (by ids; of equal ones the latest) while armed (the recsys cells'
    run)."""

    def __init__(self, fn):
        self.fn, self.call, self.armed = fn, None, False

    def __call__(self, ids, d_out, rows, row0=0):
        if (self.armed and d_out.is_cuda
                and (self.call is None or ids.numel() >= self.call[0].numel())):
            self.call = (ids, d_out.detach().clone(), rows, row0)
        return self.fn(ids, d_out, rows, row0=row0)


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
        before = (FO.mha_flash_bwd.launches, FO.mha_flash_bwd.tc_launches)
        bwd_rec.arm(arch)
        cell = train_cell(arch, model, batch)
        bwd_rec.arm(None)
        cell.update(cuts={"n_layers": TRAIN_LAYERS, "batch": 1, "seq": TRAIN_SEQ},
                    optimizer=cfg.optimizer,
                    flash_bwd_launches=FO.mha_flash_bwd.launches - before[0],
                    flash_bwd_tc_launches=FO.mha_flash_bwd.tc_launches - before[1],
                    tokens_per_s=TRAIN_SEQ / (cell["ms_per_step"] / 1e3),
                    heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
                    window=cfg.sliding_window)
        if cell["flash_bwd_launches"] == 0 or (cell["flash_bwd_tc_launches"]
                                               != cell["flash_bwd_launches"]):
            raise RuntimeError(f"train {arch}: the attention backward (K6) launched "
                               f"{cell['flash_bwd_launches']} times, "
                               f"{cell['flash_bwd_tc_launches']} on its tensor-core route: "
                               "every call must take that route")
        cells[arch] = cell
        log(f"  train {arch}: width {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
            f"{cfg.resolved_head_dim}, window {cfg.sliding_window}, cut to {TRAIN_LAYERS} "
            f"layers, batch 1 x {TRAIN_SEQ}; {cfg.optimizer} losses "
            + ", ".join(f"{x:.4f}" for x in cell["loss"])
            + f"; {cell['ms_per_step']:.1f} ms/step (median of steps 2-{TRAIN_STEPS}), peak "
            f"{cell['peak_gb']:.2f} GB ({cell['param_gb']:.2f} GB bf16 weights); K6 launches "
            f"{cell['flash_bwd_launches']}, all on the tensor-core route")
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
    cfg = RREG.get_config("kimi-k2-1t-a32b", smoke=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = TT.init_params(cfg, gen, dev)
    batch = RREG.make_batch(cfg, "train_4k", gen, dev, batch=2, seq=256)
    before = (FO.mha_flash_bwd.launches, FO.mha_flash_bwd.tc_launches,
              FO.mha_flash_bwd.small_launches)
    cell = train_cell("kimi-k2-1t-a32b reduced", model, batch)
    cell.update(cuts={"reduced": True, "batch": 2, "seq": 256}, optimizer=cfg.optimizer,
                flash_bwd_launches=FO.mha_flash_bwd.launches - before[0],
                flash_bwd_tc_launches=FO.mha_flash_bwd.tc_launches - before[1],
                flash_bwd_small_launches=FO.mha_flash_bwd.small_launches - before[2])
    if cfg.optimizer != "adafactor":
        raise RuntimeError(f"kimi-k2 trains with {cfg.optimizer}, want adafactor")
    if cell["flash_bwd_launches"] == 0 or cell["flash_bwd_small_launches"] != \
            cell["flash_bwd_launches"]:
        raise RuntimeError(f"train kimi-k2 reduced (head dim {cfg.resolved_head_dim}): K6 "
                           f"launched {cell['flash_bwd_launches']} times, "
                           f"{cell['flash_bwd_small_launches']} on the small-head route; want "
                           "every call on that route")
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
    launch in that evaluation, B1 and B2 only on their small-head routes;
    the inputs of their largest calls go to the report's "attn_calls", for
    `small_route_record`)."""
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
    k6, k6_small = FO.mha_flash_bwd.launches, FO.mha_flash_bwd.small_launches
    model, card_hist = RT.train_ranker(system.model, *args, steps=PLANTED_STEPS, log_every=1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    k6, k6_small = FO.mha_flash_bwd.launches - k6, FO.mha_flash_bwd.small_launches - k6_small
    bwd_rec.arm(None)
    if k6_small != k6:
        raise RuntimeError(f"planted: {k6 - k6_small} of the ranker's {k6} fp32 K6 calls "
                           "took another route than the small-head route")
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
    rec, saved = install_recorders()
    try:
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
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    launched = {k: v - before[k] for k, v in counts().items()}
    missing = [n for n in ("flash_attention:small", "selective_attention:small",
                           "block_gather") if launched[n] == 0]
    simt = {n: launched[n + ":fp32"] for n in SMALL_FWD if launched[n + ":fp32"]}
    if missing or simt:
        raise RuntimeError(f"planted evaluation: kernels never launched {missing}, SIMT "
                           f"launches {simt} (want none: the ranker's D 16 takes the "
                           "small-head routes)")
    rep = {"train_losses": card_l.tolist(), "cpu_losses": cpu_l.tolist(),
           "card_vs_cpu_max_abs": err, "flash_bwd_launches": k6,
           "fidelity_ndcg10": ndcg, "recompute_frac": frac, "eval_launches": launched,
           "setup_s": t1 - t0, "cpu_train_s": t2 - t1, "card_train_s": t3 - t2,
           "rebuild_s": t4 - t3, "eval_s": time.perf_counter() - t4,
           "requests": len(reqs), "layer0_zero_divergence_tokens": zero_div,
           "attn_calls": {n: (rec[n].args, rec[n].kwargs) for n in SMALL_FWD}}
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
        ck0, cv0 = ENG.cache_gather(system.rows, system.cfg.rope_theta, None,
                                    kernels=True)(t, t, 0, rotate=False)
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


def counted_device_ms(fn, want, reps=10):
    """`device_ms` of a call that launches `want` device events (kernels
    and fills).  -> (ms or None, the device_ms dict): None, with the
    reason in the dict's "note", when the profiler saw another number."""
    dev = device_ms(fn, reps=reps)
    if dev["events_per_call"] == want:
        return dev["ms"], dev
    if dev["ms"] is not None:
        dev["note"] = (f"the profiler saw {dev['events_per_call']:g} device events a call of "
                       f"the {want} the call launches: its device time is left out")
    return None, dev


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


# the route each recorded K6 call must take: the five full-width LM archs'
# (bf16, D 128 or 256) the tensor cores, the tiny ranker's (fp32, D 16)
# the small-head route
K6_ROUTES = {**{arch: "tc" for arch in TRAIN_LM_ARCHS}, "ranker": "small"}


def k6_timing(a, kw, plain=False, route=None):
    """K6 at one recorded call, on the route `_bwd_route` names (or
    `route`): CUDA-event ms of the whole call (median of 10), its device ms
    under torch.profiler with each kernel's share (None if the profiler
    saw another number of events than the call launches), the bound,
    SDPA's backward where there is one, and with `plain` the plain
    version's ms.  Both routes are timed through `_flash_bwd_launch`, the
    wrapper after its CPU check, so their host work is the same."""
    route = route or FO._bwd_route(*a[:3])
    mask = dict(causal=kw.get("causal", True), window=kw.get("window"))
    fn = lambda: FO._flash_bwd_launch(route, *a, **mask)
    # kernels a call launches: delta / prep, dq, dk-dv (tc at D 256: dv, dk;
    # small heads: dq with delta, dk-dv)
    n_kernels = 4 if route == "tc" and a[0].shape[3] > 128 else 2 if route == "small" else 3
    ms = time_ms(fn, reps=10, warmup=2)
    dev_ms, dev = counted_device_ms(fn, n_kernels)
    lib = _sdpa_bwd(a, kw)
    b, fl = _bwd_work(a, kw)
    wdt = a[0].dtype
    t_bytes, t_ops = b / HBM_BYTES_S * 1e3, fl / PEAK_FLOPS[wdt] * 1e3
    return {"kernel_route": route, "kernels_per_call": n_kernels, "ms": ms, "device_ms": dev_ms,
            "device_events_per_call": dev["events_per_call"],
            "device_ms_by_kernel": dev["by_kernel"], "device_note": dev.get("note"),
            "plain_ms": (time_ms(lambda: FREF.flash_bwd_ref(*a, **kw), reps=5, warmup=1)
                         if plain else None),
            "library_ms": time_ms(lib, reps=10, warmup=2) if lib is not None else None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": b, "flops": fl,
            "shapes": shapes(a, {}), "window": kw.get("window")}


def simt_vs_small(a, kw, small):
    """The SIMT route at a small-head call: within TOL of the plain version
    (relative to max|plain|), then timed in turns with the small-head
    route, whose first timing `small` (`k6_timing`) already holds.  -> the
    SIMT route's timing, with both routes' event and device ms per turn."""
    wdt = a[0].dtype
    got = FO._flash_bwd_launch("simt", *a, causal=kw.get("causal", True),
                               window=kw.get("window"))
    want = FREF.flash_bwd_ref(*a, **kw)
    torch.cuda.synchronize()
    errs = [float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]
    if max(errs) > TOL[wdt]:
        raise RuntimeError(f"flash_bwd SIMT route at a small-head call: max|kernel-plain| / "
                           f"max|plain| {errs} > {TOL[wdt]}")
    del got, want
    simt = k6_timing(a, kw, route="simt")
    simt2 = k6_timing(a, kw, route="simt")
    small2 = k6_timing(a, kw)
    turns = [("small", small), ("simt", simt), ("simt", simt2), ("small", small2)]
    simt.update(rel_err=errs, turns=[{"route": r, "ms": t["ms"], "device_ms": t["device_ms"]}
                                     for r, t in turns])
    log("  flash_bwd at the ranker's call, small-head vs SIMT route in turns: " + "; ".join(
        f"{r} {t['ms']:.4f} ms (device "
        f"{'n/a' if t['device_ms'] is None else format(t['device_ms'], '.4f')})"
        for r, t in turns) + f"; SIMT max|kernel-plain| / max|plain| {max(errs):.2e}")
    return simt


def flash_bwd_records(calls, launches):
    """K6 on each recorded call (the five full-width archs' first backward
    call, bf16, and the tiny ranker's, fp32): the route K6_ROUTES names,
    max |kernel - plain| within TOL of the output's max |plain| (the
    recorded output gradients are small), a second call bitwise equal;
    then timed at every call (the plain version at rcllm-qwen3-8b's and
    the ranker's).  At the ranker's call the SIMT route (which took it
    before the small-head route existed) is also held to the plain version
    and timed, in turns with the small-head route (small, SIMT, SIMT,
    small).  -> the records "flash_bwd" (the tensor-core route at
    rcllm-qwen3-8b's call, the other archs under "per_arch") and
    "flash_bwd:small" (the small-head route at the ranker's, the SIMT
    route's times under "simt_route")."""
    fn = FO.mha_flash_bwd
    spec = KERNELS["flash_bwd"]
    missing = sorted(set(K6_ROUTES) - set(calls))
    if missing:
        raise RuntimeError(f"flash_bwd: no backward call was recorded for {missing}")
    per = {}
    for label, (a, kw) in calls.items():
        route = FO._bwd_route(*a[:3])
        if route != K6_ROUTES[label]:
            raise RuntimeError(f"flash_bwd {label}: the {route} route, want {K6_ROUTES[label]}")
        got, want = fn(*a, **kw), FREF.flash_bwd_ref(*a, **kw)
        again = fn(*a, **kw)
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
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            raise RuntimeError(f"flash_bwd {label}: two calls on the same inputs differ")
        log(f"check flash_bwd {label} ({route}): {shapes(a, {})} window {kw.get('window')}; "
            f"max|kernel-plain| / max|plain| dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} "
            f"(tol {TOL[wdt]}, {str(wdt).replace('torch.', '')}); a second call bitwise equal")
        del got, want, again
        rec = {"rel_err": errs, "bitwise_repeat": True,
               **k6_timing(a, kw, plain=label in ("rcllm-qwen3-8b", "ranker"))}
        per[label] = rec
        if label == "ranker":
            rec["simt_route"] = simt_vs_small(a, kw, rec)
        dev = ("n/a: " + rec["device_note"] if rec["device_ms"] is None else
               f"{rec['device_ms']:.4f} ms over {rec['device_events_per_call']:g} device events "
               f"a call")
        plain = "n/a" if rec["plain_ms"] is None else f"{rec['plain_ms']:.3f} ms"
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms (SDPA backward)"
        by_dev = ", ".join(f"{k} {v:.4f}" for k, v in rec["device_ms_by_kernel"].items())
        log(f"time flash_bwd {label} ({route}): kernel {rec['ms']:.4f} ms; device {dev}: "
            f"{by_dev}; plain {plain}, library {lib}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {rec['flops'] / 1e9:.1f} GFLOP)")
    records = []
    for label, rec_name in (("rcllm-qwen3-8b", "flash_bwd"), ("ranker", "flash_bwd:small")):
        rec = per[label]
        records.append({
            "name": rec_name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[rec_name],
            "max_abs_err": max(rec["rel_err"]), "err_is_relative_to_max_plain": True,
            "tol": TOL[calls[label][0][0].dtype], **{k: v for k, v in rec.items() if k != "rel_err"},
            "tc_launches": launches[rec_name] if rec["kernel_route"] == "tc" else 0,
            "per_arch": ({k: v for k, v in per.items() if k != "ranker"}
                         if rec_name == "flash_bwd" else None),
            "fp32_simt_bound_ms": rec["flops"] / PEAK_FLOPS[torch.float32] * 1e3})
    return records


def bag_field_probe(ids, d_out, rows):
    """K7 (`bag_backward`, zero fill + kernel) on one recorded call's ids
    cut to the first 8 fields of each of Wide&Deep's vocabulary sizes (the
    same B x 8 updates each: into a region of 8 x 1 M, 100 K, 10 K or 1 K
    rows), and on all its fields in field-major order (ids transposed,
    d_out repeated: the same gradient, its atomics issued field by field).
    -> {label: {"device_ms", "by_kernel", "updates", "rows_spanned"}}."""
    vocabs = RREG.get_config("wide-deep").field_vocabs
    if ids.shape[1] != len(vocabs):
        return {}
    out = {}
    for v in dict.fromkeys(vocabs):
        cols = [f for f, n in enumerate(vocabs) if n == v][:8]
        sub = ids[:, cols].contiguous()
        dev = device_ms(lambda: EO.bag_backward(sub, d_out, rows))
        out[f"fields_{v}_rows"] = {"device_ms": dev["ms"], "by_kernel": dev["by_kernel"],
                                   "updates": sub.numel(), "rows_spanned": 8 * v}
    fm_ids = ids.t().contiguous().reshape(-1, 1)
    fm_out = d_out.repeat(ids.shape[1], 1)
    dev = device_ms(lambda: EO.bag_backward(fm_ids, fm_out, rows))
    out["all_fields_field_major"] = {"device_ms": dev["ms"], "by_kernel": dev["by_kernel"],
                                     "updates": fm_ids.numel(), "rows_spanned": rows}
    log("  bag_backward field-group probe (device ms, fill + kernel): " + "; ".join(
        f"{k} {v['device_ms']}" for k, v in out.items()))
    return out


def bag_backward_record(call, launches):
    """K7 against its plain version at Wide&Deep's train_batch call (the
    wide table's gradient, fp32, and the same call in bf16): max |kernel
    - plain| within BAG_TOL of max|plain| (no floor of 1: the rows of a
    mean loss's gradient are ~1e-5); then timed, each device event apart,
    and probed by field group (`bag_field_probe`)."""
    ids, d_out, rows, _ = call
    fn = EO.bag_backward
    spec = KERNELS["bag_backward"]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        g = d_out.to(dt)
        got, want = fn(ids, g, rows), EREF.bag_backward_ref(ids, g, rows)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != dt or not torch.isfinite(got).all() or err > BAG_TOL[dt] * scale:
            raise RuntimeError(f"bag_backward {dt}: max|kernel-plain| {err} > {BAG_TOL[dt]} x "
                               f"{scale}")
        errs[dt] = err
        del got, want
    log(f"check bag_backward: ids {tuple(ids.shape)} into {rows} rows x {d_out.shape[1]}; "
        f"max|kernel-plain| fp32 {errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g} "
        f"(tol {BAG_TOL} x max|plain| {scale:.3g})")
    ms = time_ms(lambda: fn(ids, d_out, rows))
    # two device events a call: the gradient's zero fill and the kernel
    dev_ms, dev = counted_device_ms(lambda: fn(ids, d_out, rows), 2, reps=20)
    plain_ms = time_ms(lambda: EREF.bag_backward_ref(ids, d_out, rows), reps=5, warmup=1)
    flat = ids.reshape(-1).long()
    F_ = ids.shape[1]
    lib_ms = time_ms(lambda: torch.zeros((rows, d_out.shape[1]), device=d_out.device)
                     .index_add_(0, flat, d_out.repeat_interleave(F_, 0)))
    grad_bytes = rows * d_out.shape[1] * 4
    b = nbytes(ids, d_out) + grad_bytes
    sector = nbytes(ids, d_out) + grad_bytes + 2 * ids.numel() * 32
    probe = bag_field_probe(ids, d_out, rows)
    rec = {"name": "bag_backward", "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "launches": launches, "max_abs_err": errs[torch.float32],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b / HBM_BYTES_S * 1e3, "bound_by": "bytes",
           "library_ms": lib_ms, "device_ms": dev_ms,
           "device_events_per_call": dev["events_per_call"],
           "device_ms_by_kernel": dev["by_kernel"], "device_note": dev.get("note"),
           "bytes": b, "flops": ids.numel() * d_out.shape[1], "tol": BAG_TOL[torch.float32],
           "bf16_max_abs_err": errs[torch.bfloat16],
           "sector_bound_ms": sector / HBM_BYTES_S * 1e3,
           "shapes": [f"{tuple(ids.shape)}:int32", f"{tuple(d_out.shape)}:float32",
                      f"rows {rows}"],
           "library_call": "zeros + index_add_ of the flattened ids (after repeat_interleave)",
           "field_groups": probe}
    dev_s = ("n/a: " + dev["note"] if dev_ms is None else
             f"{dev_ms:.4f} ms over {dev['events_per_call']:g} device events a call: "
             + ", ".join(f"{k} {v:.4f}" for k, v in dev["by_kernel"].items()))
    log(f"time bag_backward: kernel {ms:.4f} ms (device {dev_s}), plain {plain_ms:.4f} ms, "
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
          "flash_bwd:small": sum(run["flash_bwd:small"] for run in launches.values())}
    if launches["recsys"]["bag_backward"] == 0 or min(k6.values()) == 0:
        raise RuntimeError(f"training: kernels never launched {launches}")
    t0 = time.perf_counter()
    records = flash_bwd_records(bwd_rec.calls, k6)
    records.append(bag_backward_record(bag_rec.call, launches["recsys"]["bag_backward"]))
    # B1 and B2 at the planted evaluation's largest calls (the shapes it
    # launches them at 80 and 540 times)
    for name, (a, kw) in report["planted"].pop("attn_calls").items():
        a, kw = device_inputs(name, a, kw, dev)
        records.append(small_route_record(name, a, kw,
                                          report["planted"]["eval_launches"][name + ":small"],
                                          label=f"{name}:small:planted"))
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
    before = counts()
    for f in warm_run(engine, plans, config.decode_steps - 1):
        f()
    spans.restore()
    s = spans.s
    steps = config.decode_steps - 1
    b4 = {k: v - before[k] for k, v in counts().items() if k.startswith("block_gather")}
    passes = spans.n["selective_layers"]
    b4 = {"selective_passes": passes, "launches": b4["block_gather"],
          "all_layer_launches": b4["block_gather:layers"],
          "layer0_copy_launches": b4["block_gather"] - b4["block_gather:layers"],
          "launches_per_selective_pass": b4["block_gather:layers"] / passes}
    if b4["launches_per_selective_pass"] != 1:
        raise RuntimeError(f"phase 2b: the block gather launched {b4} (want one launch per "
                           "selective pass)")
    breakdown = {
        "requests": len(plans), "decode_steps": steps, "block_gather": b4,
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
    log(f"  block gather in the prefill: {b4}")
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

    # ---- phase 2k: the attention-backend seam, then the examples ----
    t0 = time.perf_counter()
    seam_report, seam_launches = seam_phase(system, pool_rv, prof, cfg, args,
                                            closed["wave"][0])
    launches.update(seam_launches)
    torch.cuda.empty_cache()
    PHASE_S["2k"] = t_seam = time.perf_counter() - t0
    log(f"  seam phase and examples {t_seam:.1f} s")
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
            layers = total["block_gather:layers"]
            records += gather_records(rec[name].calls, spec,
                                      {"layers": layers, "copy": total[name] - layers},
                                      modes=("layers", "copy"))
            continue
        if name == "embedding_bag":
            continue    # recorded after the recsys phase below
        if name in TRAIN_KERNELS:
            continue    # recorded in phase 2j
        a, kw = device_inputs(name, rec[name].args, rec[name].kwargs, dev)
        extra = {}
        if name in OTHER_ROUTE:
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
    # both schedulers.  Its fp32 D 16 calls take the small-head routes of
    # B1 and B2, and none their SIMT routes.
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
    for name in SMALL_FWD:
        if launches["tiny"][name + ":small"] == 0 or launches["tiny"][name + ":fp32"] != 0:
            raise RuntimeError(f"{name} on the tiny fp32 path: {launches['tiny'][name + ':small']}"
                               f" small-head and {launches['tiny'][name + ':fp32']} SIMT "
                               "launches (want some and none)")
        a, kw = device_inputs(name, tiny_rec[name].args, tiny_rec[name].kwargs, dev)
        records.append(small_route_record(
            name, a, kw, sum(run[name + ":small"] for run in launches.values()),
            label=name + ":small"))
    del tiny_rec
    PHASE_S["recsys records and tiny runs"] = time.perf_counter() - t_tiny

    report = {"offline_build_s": t_build, "serving_s": t_serve,
              "chunked_serving_s": t_chunked, "kv_reuse_s": t_kv, "kv_reuse": kv_report,
              "cluster_s": t_cluster, "cluster": cluster_report,
              "server_s": t_server, "server": server_report,
              "ranking_s": t_rank, "ranking": rank_report,
              "seam_s": t_seam, "seam": seam_report,
              "recsys_s": t_recsys, "peak_cuda_gb": peak_gb,
              "depth": cfg.n_layers, "serve": rep, "serve_chunked": crep,
              "chunked_ticks": [dataclasses.asdict(t) for t in ticks],
              "chunked_tokens_equal_wave": same, "launches": launches,
              "cache_rows": system.rows.n_rows, "cache_rows_gb": system.rows.nbytes / 1e9,
              "recompute_fraction": rfrac, "prompt_tokens": plan.n, "breakdown": breakdown,
              "recsys_cells": recsys_cells, "recsys_card_vs_cpu": recsys_checks,
              "kernels": records}
    return report, records, closed


# ------------------------------------------------------------------ phase 2l
# phase 2l: tensor parallelism over kv heads, TP_RANKS ranks on the one card
TP_RANKS = 2
# (sched, kv_reuse, through the session server)
TP_RUNS = (("wave", False, False), ("chunked", False, False), ("chunked", True, False),
           ("chunked", False, True))


def all_reduce_ms(rows, reps=20):
    """Host ms of one model-axis all-reduce of a (rows, d_model) bf16
    activation on the card (the layer's wo / w_down sums), mean of
    `reps` after one untimed call; the collectives block the host, so the
    host clock with the card synchronised times them."""
    from repro_torch.sharding import ctx as CTX

    x = torch.zeros((rows, QWEN3_8B.d_model), dtype=torch.bfloat16, device="cuda")
    CTX.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        CTX.all_reduce(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


TP_KERNELS = ("flash_attention", "selective_attention", "paged_decode_attention")


def rank_kernel_checks(rec, label):
    """Inside a phase-2l rank: each kernel at the largest call the rank's
    run made (its shard's shapes, `install_recorders`) against its plain
    version on those inputs, as phase 3 holds them: B1 and B2 on their
    tensor-core routes and B3 within TOL, B4's copies bitwise and its
    rotated keys within GATHER_TOL, once per call kind.  -> ({kernel:
    max|kernel - plain|}, {kernel: (query heads, kv heads)})."""
    errs, heads = {}, {}
    for name in TP_KERNELS:
        r = rec[name]
        if r.args is None:
            continue
        a, kw = device_inputs(name, r.args, r.kwargs, r.args[0].device)
        if name in OTHER_ROUTE:
            check_route(name, a, kw, "tc")
        errs[name] = plain_err(KERNELS[name]["fn"], name, a, kw,
                               f"phase 2l ({label}) {name}")[1]
        heads[name] = (a[0].shape[-2], a[2 if name == "selective_attention" else 1].shape[-2])
    for mode, (_, call) in sorted(rec["block_gather"].calls.items()):
        errs[f"block_gather:{mode}"] = gather_err(call, f"phase 2l ({label}) block_gather {mode}")
        heads[f"block_gather:{mode}"] = (None, call[0].pool_k.shape[-2])
    return errs, heads


class TPProbe(SERVE.Probe):
    """Phase 2l's hooks inside each rank (`launch.serve.run_rank`): the
    kernels must be phase 1's build (a rank only loads them); per run
    the wrappers' launch counts, the inputs of each kernel's largest call
    (`install_recorders`), held against the plain versions after the
    counts are read (`rank_kernel_checks`: those launches are not
    counted), the arena's shape and each request's logit rows
    (`LogitTap`); after the offline build, the all-reduce's host time at
    a decode step's 8 rows and a selective pass's 1,600 (`all_reduce_ms`)."""

    def begin(self, label):
        missing = [n for n in _build.SOURCES if not _build.library_path(n).exists()]
        if missing:
            raise RuntimeError(f"rank found no library for {missing}: phase 1 builds every "
                               "kernel before the ranks start")
        reset_counts()
        self.rec, self.saved = install_recorders()
        self.logits = LogitTap().__enter__()

    def end(self, label, mesh, engine=None, backend=None):
        self.logits.__exit__()
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        torch.cuda.synchronize()
        calls = self.rec["block_gather"].calls
        out = {"launches": counts(), "rows": self.logits.rows,
               "shapes": {n: shapes(self.rec[n].args, self.rec[n].kwargs)
                          for n in TP_KERNELS if self.rec[n].args is not None},
               "gather_pools": sorted({tuple(c[0].pool_k.shape) for _, c in calls.values()}),
               "arena": None if engine is None else tuple(engine.pool.arena_k.shape)}
        out["max_abs_err"], out["heads"] = rank_kernel_checks(self.rec, label)
        self.rec = None
        if label == "offline build":
            out["all_reduce_ms"] = {rows: all_reduce_ms(rows) for rows in (8, 1600)}
        return out


def tp_phase(args, closed, smi):
    """Phase 2l (the module docstring).  -> its report."""
    cfg = dataclasses.replace(QWEN3_8B, n_layers=args.n_layers)
    mesh = MeshConfig(tp=TP_RANKS)
    configs = [ServeConfig(decode_steps=args.decode_steps, sched=sched, kv_reuse=reuse,
                           mesh=mesh) for sched, reuse, _ in TP_RUNS]
    rank_args = argparse.Namespace(
        model=QWEN3_8B.name, n_layers=args.n_layers, requests=args.requests, qps=args.qps,
        zipf_users=None, long_prompt_frac=0.0, prompt_tokens=160, device="cuda", speed=0.0)
    log(f"tensor parallelism (phase 2l): launch.serve's mesh path, tp = {TP_RANKS} ranks on "
        f"one card over {collective_backend(TP_RANKS, 'cuda')}; {cfg.name} width, depth "
        f"{cfg.n_layers}, {cfg.n_heads // TP_RANKS}/{cfg.n_kv_heads // TP_RANKS} heads, d_ff "
        f"{cfg.d_ff // TP_RANKS} and vocab {cfg.vocab_size // TP_RANKS} a rank; phase 2's "
        f"trace ({args.requests} requests): "
        + ", ".join(f"{'server ' if v else ''}{s} reuse {'on' if r else 'off'}"
                    for s, r, v in TP_RUNS))
    t0 = time.perf_counter()
    ranks = SERVE.run_mesh(configs, rank_args, probe=TPProbe(), check=True,
                           servers=[v for *_, v in TP_RUNS])
    wall = time.perf_counter() - t0
    want_heads = cfg.n_kv_heads // TP_RANKS
    want = {n: (cfg.n_heads // TP_RANKS, want_heads) for n in TP_KERNELS}

    def held(label, rank, probe, need):
        """The rank's kernel checks of this run: every kernel in `need`
        checked against its plain version, on the shard's heads."""
        errs, heads = probe["max_abs_err"], probe["heads"]
        if [n for n in need if n not in errs]:
            raise RuntimeError(f"phase 2l ({label}) rank {rank}: no checked call of "
                               f"{[n for n in need if n not in errs]}")
        wrong = {n: h for n, h in heads.items() if h[1] != want_heads
                 or (n in want and h != want[n])}
        if wrong:
            raise RuntimeError(f"phase 2l ({label}) rank {rank}: heads {wrong}, want "
                               f"{cfg.n_heads // TP_RANKS} query / {want_heads} kv heads")
        log(f"  check {label}, rank {rank}: max|kernel-plain| "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f" (tol {TOL[torch.bfloat16]} bf16 / {TOL[torch.float32]} fp32; B4 copies "
            f"bitwise, rotated keys {GATHER_TOL[torch.float32]} x max(1, max|k|)); heads "
            f"{heads}")
        return errs

    out = {"tp": TP_RANKS, "wall_s": wall, "nvidia_smi": smi, "runs": [],
           "build": [{"rank": r["rank"], "build_s": r["build_s"],
                      "launches": r["build_probe"]["launches"],
                      "b1_shapes": r["build_probe"]["shapes"]["flash_attention"],
                      "max_abs_err": held("offline build", r["rank"], r["build_probe"],
                                          ["flash_attention"]),
                      "all_reduce_ms": r["build_probe"]["all_reduce_ms"]}
                     for r in ranks]}
    for out_rank in ranks:
        b = out_rank["build_probe"]["launches"]
        log(f"  rank {out_rank['rank']} ({out_rank['device']}): offline build "
            f"{out_rank['build_s']:.1f} s, launches {b}; largest B1 call "
            f"{out_rank['build_probe']['shapes']['flash_attention']}; one bf16 all-reduce "
            f"of (rows, {cfg.d_model}) over {collective_backend(TP_RANKS, 'cuda')}, host ms: "
            f"{out_rank['build_probe']['all_reduce_ms']} ({smi})")
        if b["flash_attention"] == 0 or b["flash_attention:fp32"] or b["flash_attention:small"]:
            raise RuntimeError(f"phase 2l rank {out_rank['rank']}: the offline build launched "
                               f"B1 {b}: want its tensor-core route only")
    for i, (sched, reuse, server) in enumerate(TP_RUNS):
        label = f"{'server (speed 0), ' if server else ''}{sched}, reuse {'on' if reuse else 'off'}"
        runs = [r["runs"][i] for r in ranks]
        rep0 = runs[0]["report"]
        if rep0["mesh"]["backend"] != "gloo" or rep0["mesh"]["tp"] != TP_RANKS:
            raise RuntimeError(f"phase 2l ({label}): mesh {rep0['mesh']}")
        if server and (not rep0.get("server") or rep0["finish_reasons"] != {
                "length": args.requests} or not rep0.get("ticks")):
            raise RuntimeError(f"phase 2l ({label}): the server's report {rep0.get('server')}, "
                               f"{rep0.get('finish_reasons')}, ticks {rep0.get('ticks')}")
        per_rank = []
        for rank, run in zip(ranks, runs):
            p, rep = run["probe"], run["report"]
            la = p["launches"]
            need = {"selective_attention": la["selective_attention"],
                    "paged_decode_attention": la["paged_decode_attention"],
                    "block_gather": la["block_gather"]}
            if min(need.values()) == 0 or la["selective_attention:fp32"] \
                    or la["selective_attention:small"]:
                raise RuntimeError(f"phase 2l ({label}) rank {rank['rank']} launched {la}: "
                                   "want B2 (tensor-core route only), B3 and B4")
            if p["arena"][3] != want_heads:
                raise RuntimeError(f"phase 2l ({label}) rank {rank['rank']}: arena "
                                   f"{p['arena']}, want {want_heads} kv heads")
            if run["log"] != runs[0]["log"] or not run["log"]:
                raise RuntimeError(f"phase 2l ({label}): rank {rank['rank']}'s digest log "
                                   "differs from rank 0's")
            if run["generated"] != runs[0]["generated"]:
                raise RuntimeError(f"phase 2l ({label}): the ranks decoded other tokens")
            need = ["selective_attention", "paged_decode_attention", "block_gather:layers",
                    "block_gather:copy"] + (["block_gather:prefix"]
                                            if la["block_gather:prefix"] else [])
            errs = held(label, rank["rank"], p, need)
            per_rank.append({"rank": rank["rank"], "device": rank["device"],
                             "backend": rep["mesh"]["backend"], "wall_s": run["wall_s"],
                             "ttft_p50_s": rep["ttft_p50_s"], "tbt_p50_s": rep["tbt_p50_s"],
                             "peak_gb": run["peak_gb"], "launches": la, "max_abs_err": errs,
                             "shapes": p["shapes"], "gather_pools": p["gather_pools"],
                             "arena": p["arena"]})
            log(f"  {label}, rank {rank['rank']} ({smi}): wall {run['wall_s']:.2f} s, TTFT "
                f"p50 {rep['ttft_p50_s'] * 1e3:.1f} ms, TBT p50 {rep['tbt_p50_s'] * 1e3:.1f} "
                f"ms, peak {run['peak_gb']:.2f} GB, backend {rep['mesh']['backend']}; "
                f"launches {la}")
        tags = [t for t, _ in runs[0]["log"]]
        log(f"  {label}: the ranks' digests agree ({tags.count('step plan')} step plans, "
            f"{tags.count('recompute mask')} recompute masks); largest calls "
            f"{per_rank[0]['shapes']}; B4 pools {per_rank[0]['gather_pools']}; arena "
            f"{per_rank[0]['arena']}")
        ref = closed["wave" if sched == "wave" else "chunked"]
        gate = token_gate({int(k): v for k, v in runs[0]["generated"].items()}, ref[0],
                          runs[0]["probe"]["rows"], ref[1],
                          label=f"phase 2l ({label}) vs phase {'2' if sched == 'wave' else '2c'}")
        same = sum(runs[0]["generated"][r] == ref[0][r] for r in ref[0])
        log(f"  {label}: {same}/{len(ref[0])} requests decode phase "
            f"{'2' if sched == 'wave' else '2c'}'s tokens; token gate {gate['diverged'] or 'clean'}"
            f", max top-1 logit difference before a divergence "
            f"{gate['max_top1_logit_diff_before_divergence']:.4g}")
        out["runs"].append({"label": label, "per_rank": per_rank, "token_gate": gate,
                            "digests": len(runs[0]["log"]), "same_tokens": same,
                            "mesh": rep0["mesh"], "server": server,
                            "ticks": rep0.get("ticks"), "online": rep0.get("online")})
    log(f"  phase 2l {wall:.1f} s (ranks' start, shard build and the four runs)")
    return out


# ------------------------------------------------------------------ phase 2m
# phase 2m: the LM archs' steps on a mesh, two ranks sharing the card
TP_LM_LAYOUT, DP_LM_LAYOUT, DP_LM_ARCH = (1, 2), (2, 1), "gemma-7b"
TP_LM_PREFILL, TP_LM_DECODE = 4096, 4
# the reduced() cases of the card == CPU gate (phase 2i's, with its window)
TP_LM_REDUCED = tuple(a for a in RREG.ARCHS if RREG.family_of(a) == "lm") + (
    "starcoder2-15b:window8",)


def _reduced_case(label):
    """A phase-2m reduced() case: the config, the whole model on the CPU
    (seed 0), two 40-token prompts and one 2 x 64 training batch (numpy
    draws, the same in every process)."""
    arch, _, window = label.partition(":window")
    cfg = RREG.get_config(arch, smoke=True)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=int(window))
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int64))
    t = rng.integers(1, cfg.vocab_size, (2, 65)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(t[:, :-1]), "labels": torch.from_numpy(t[:, 1:])}
    return cfg, model, toks, batch


def _sync_dev(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _lm_steps(model, mesh, toks, batch, decode_steps, train_steps, dev):
    """Prefill `toks`, `decode_steps` greedy steps in a cache 8 slots
    longer, then `train_steps` steps of the arch's optimizer on `batch`
    (a fresh "train" shard when `model` is a whole model's `source`),
    each timed on the host clock with the card synchronised.  -> results
    (numpy logits and tokens, losses, norms, times)."""
    cfg = model.cfg
    serve = STEPS.rank_model(cfg, mesh, "prefill", dev, source=model)
    inputs = STEPS.rank_inputs(cfg, mesh, "prefill", {"tokens": toks.to(dev)})
    fn, _ = STEPS.mesh_fn(serve, mesh, "prefill", toks.shape[0])
    t0 = time.perf_counter()
    logits, cache = fn(inputs)
    _sync_dev(dev)
    out = {"prefill_s": time.perf_counter() - t0, "prefill": logits.float().cpu().numpy()}
    cache = STEPS.grow_cache(cache, serve, 8)
    del logits
    dec, _ = STEPS.mesh_fn(serve, mesh, "decode", toks.shape[0])
    pos = torch.full((inputs["tokens"].shape[0],), toks.shape[1], device=dev)
    nxt = torch.from_numpy(out["prefill"]).argmax(-1)[:, None].to(dev)
    steps, times = [], []
    for _ in range(decode_steps):
        _sync_dev(dev)
        t0 = time.perf_counter()
        lg, cache = dec({"tokens": nxt, "cache": cache, "positions": pos})
        _sync_dev(dev)
        times.append(time.perf_counter() - t0)
        nxt, pos = lg.argmax(-1)[:, None], pos + 1
        steps.append((lg.float().cpu().numpy(), nxt[:, 0].cpu().numpy()))
    out.update(decode=steps, decode_ms=[t * 1e3 for t in times])
    del serve, cache, dec
    gc.collect()
    train = STEPS.rank_model(cfg, mesh, "train", dev, source=model)
    rows = STEPS.rank_inputs(cfg, mesh, "train", {k: v.to(dev) for k, v in batch.items()})
    step, _ = STEPS.mesh_fn(train, mesh, "train", batch["tokens"].shape[0])
    losses, norms, times = [], [], []
    for _ in range(train_steps):
        _sync_dev(dev)
        t0 = time.perf_counter()
        m = step(rows)
        losses.append(float(m["loss"]))
        norms.append(float(m["gnorm"]))
        _sync_dev(dev)
        times.append(time.perf_counter() - t0)
    out.update(loss=losses, gnorm=norms, step_ms=[t * 1e3 for t in times])
    return out


def _k6_rank_checks(calls):
    """Inside a phase-2m rank, after its counts are read: K6 at each
    recorded call against its plain version (TOL of max|plain|), a second
    call bitwise equal.  -> {label: {route, shapes, rel_err}}."""
    out = {}
    for label, (a, kw) in calls.items():
        got, want = FO.mha_flash_bwd(*a, **kw), FREF.flash_bwd_ref(*a, **kw)
        again = FO.mha_flash_bwd(*a, **kw)
        torch.cuda.synchronize()
        wdt = a[0].dtype
        errs = []
        for g, w in zip(got, want):
            scale = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            if not torch.isfinite(g).all() or err > TOL[wdt] * max(scale, 1e-30):
                raise RuntimeError(f"phase 2m K6 {label}: max|kernel-plain| {err} > {TOL[wdt]} "
                                   f"x max|plain| {scale}")
            errs.append(err / max(scale, 1e-30))
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            raise RuntimeError(f"phase 2m K6 {label}: two calls on the same inputs differ")
        out[label] = {"route": FO._bwd_route(*a[:3]), "shapes": shapes(a, {}),
                      "window": kw.get("window"), "rel_err": errs, "tol": TOL[wdt]}
        del got, want, again
    return out


def lm_mesh_rank(rank, world, backend, device, layout):
    """One rank of phase 2m (the module docstring) on a (dp, tp) `layout`.
    -> its record: the reduced() cases' results (tp = 2 only), each
    cell's times, peak GB and K6 launches, the K6 checks, and the host ms
    of one all-reduce of a step's activation."""
    from repro_torch.sharding import ctx as CTX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshConfig(dp=layout[0], tp=layout[1]).build()
    mesh.device = device
    rec = BwdRecorder(TL.mha_flash_bwd)
    TL.mha_flash_bwd = rec
    out = {"rank": rank, "device": str(device), "backend": backend,
           "coords": dict(mesh.coords), "reduced": {}, "cells": {}}
    try:
        with CTX.axes(mesh):
            archs = TRAIN_LM_ARCHS if layout == TP_LM_LAYOUT else (DP_LM_ARCH,)
            if layout == TP_LM_LAYOUT:
                for label in TP_LM_REDUCED:
                    cfg, whole, toks, batch = _reduced_case(label)
                    out["reduced"][label] = _lm_steps(whole, mesh, toks, batch, 2, 3, device)
            for arch in archs:
                cfg = dataclasses.replace(RREG.get_config(arch), n_layers=TRAIN_LAYERS)
                gen = torch.Generator(device=device).manual_seed(0)
                rows = layout[0]
                torch.cuda.reset_peak_memory_stats(device)
                before = (FO.mha_flash_bwd.launches, FO.mha_flash_bwd.tc_launches)
                model = STEPS.rank_model(cfg, mesh, "train", device, generator=gen)
                batch = RREG.make_batch(cfg, "train_4k", gen, device, batch=rows,
                                        seq=TP_LM_PREFILL)
                cell = {}
                if layout == TP_LM_LAYOUT:
                    serve_fn, _ = STEPS.mesh_fn(model, mesh, "prefill", rows)
                    toks = STEPS.rank_inputs(cfg, mesh, "prefill",
                                             {"tokens": batch["tokens"]})
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, cache = serve_fn(toks)
                    torch.cuda.synchronize()
                    cell["prefill_s"] = time.perf_counter() - t0
                    if not torch.isfinite(logits).all():
                        raise RuntimeError(f"phase 2m {arch}: prefill logits not finite")
                    cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (8,) + v.shape[3:])], 2)
                             for k, v in cache.items()}
                    cell["cache_shape"] = list(cache["k"].shape)
                    dec, _ = STEPS.mesh_fn(model, mesh, "decode", rows)
                    pos = torch.full((rows,), TP_LM_PREFILL, device=device)
                    nxt, times = logits.argmax(-1)[:, None], []
                    for _ in range(TP_LM_DECODE):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        lg, cache = dec({"tokens": nxt, "cache": cache, "positions": pos})
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        nxt, pos = lg.argmax(-1)[:, None], pos + 1
                    cell["decode_ms"] = [t * 1e3 for t in times]
                    del logits, cache, lg
                    gc.collect()
                    torch.cuda.empty_cache()
                step, _ = STEPS.mesh_fn(model, mesh, "train", rows)
                inputs = STEPS.rank_inputs(cfg, mesh, "train", batch)
                rec.arm(arch)
                losses, norms, times = [], [], []
                for _ in range(TRAIN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = step(inputs)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["gnorm"]))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                rec.arm(None)
                if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
                    raise RuntimeError(f"phase 2m {arch} {layout}: losses {losses}, "
                                       f"norms {norms}")
                cell.update(loss=losses, gnorm=norms, step_ms=[t * 1e3 for t in times],
                            peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                            k6_launches=FO.mha_flash_bwd.launches - before[0],
                            k6_tc_launches=FO.mha_flash_bwd.tc_launches - before[1],
                            heads=[model.layers[0].wq.shape[1], model.layers[0].wk.shape[1],
                                   cfg.resolved_head_dim],
                            param_gb=sum(p.numel() * p.element_size()
                                         for p in model.parameters()) / 1e9)
                if cell["k6_launches"] == 0 or cell["k6_tc_launches"] != cell["k6_launches"]:
                    raise RuntimeError(f"phase 2m {arch}: K6 launched {cell['k6_launches']} "
                                       f"times, {cell['k6_tc_launches']} on its tensor-core "
                                       "route: every call must take it")
                out["cells"][arch] = cell
                del model, batch, step, inputs
                gc.collect()
                torch.cuda.empty_cache()
            if layout == TP_LM_LAYOUT:
                cfg = RREG.get_config("kimi-k2-1t-a32b", smoke=True)
                gen = torch.Generator(device=device).manual_seed(0)
                model = STEPS.rank_model(cfg, mesh, "train", device, generator=gen)
                batch = RREG.make_batch(cfg, "train_4k", gen, device, batch=2, seq=256)
                before = (FO.mha_flash_bwd.launches, FO.mha_flash_bwd.small_launches)
                step, opt = STEPS.mesh_fn(model, mesh, "train", 2)
                inputs = STEPS.rank_inputs(cfg, mesh, "train", batch)
                rec.arm("kimi-k2-1t-a32b:reduced")
                losses = [float(step(inputs)["loss"]) for _ in range(TRAIN_STEPS)]
                rec.arm(None)
                k6 = (FO.mha_flash_bwd.launches - before[0],
                      FO.mha_flash_bwd.small_launches - before[1])
                if type(opt).__name__ != "Adafactor" or k6[0] == 0 or k6[1] != k6[0] \
                        or not all(np.isfinite(losses)):
                    raise RuntimeError(f"phase 2m kimi-k2 reduced: {type(opt).__name__}, K6 "
                                       f"{k6}, losses {losses}")
                out["cells"]["kimi-k2-1t-a32b:reduced"] = {
                    "loss": losses, "k6_launches": k6[0], "k6_small_launches": k6[1]}
                del model, batch, step, inputs, opt
            x = torch.zeros((TP_LM_PREFILL, QWEN3_8B.d_model), dtype=torch.bfloat16,
                            device=device)
            axis = "model" if layout == TP_LM_LAYOUT else "data"
            CTX.reduce_(x, axis)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                CTX.reduce_(x, axis)
            torch.cuda.synchronize()
            out["all_reduce_ms"] = (time.perf_counter() - t0) / 10 * 1e3
            out["all_reduce_axis"] = axis
        out["k6"] = _k6_rank_checks(rec.calls)
    finally:
        TL.mha_flash_bwd = rec.fn
    return out


def lm_mesh_phase(smi):
    """Phase 2m (the module docstring).  -> its report."""
    t0 = time.perf_counter()
    log(f"LM steps on a mesh (phase 2m): {TP_LM_LAYOUT[1]} ranks at tp = 2, then "
        f"{DP_LM_LAYOUT[0]} at dp = 2, sharing one card over "
        f"{collective_backend(2, 'cuda')} ({smi}); times and all-reduces are gloo's host "
        "staging on one card, not a multi-card speed")
    ranks = MESH_SPAWN(lm_mesh_rank, 2, "cuda", args=(TP_LM_LAYOUT,))
    wall_tp = time.perf_counter() - t0
    # gate 1: the reduced() cases on the card at tp = 2 against the CPU at tp = 1
    from repro_torch.serving.api import MeshConfig as _MC
    errs = {}
    one = _MC(mesh_shape=(1, 1)).build()
    for label in TP_LM_REDUCED:
        cfg, whole, toks, batch = _reduced_case(label)
        want = _lm_steps_cpu(whole, one, toks, batch)
        e = {}
        for r in ranks:
            got = r["reduced"][label]
            e["prefill"] = max(e.get("prefill", 0.0), _np_close(
                f"phase 2m {label} prefill", got["prefill"], want["prefill"]))
            for i, ((gl, gt), (wl, wt)) in enumerate(zip(got["decode"], want["decode"])):
                e[f"decode{i}"] = max(e.get(f"decode{i}", 0.0), _np_close(
                    f"phase 2m {label} decode {i}", gl, wl))
                if not np.array_equal(gt, wt):
                    raise RuntimeError(f"phase 2m {label} decode {i}: greedy tokens {gt} vs "
                                       f"the CPU's {wt}")
            for k in ("loss", "gnorm"):
                d = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got[k], want[k]))
                if d > TRAIN_TOL:
                    raise RuntimeError(f"phase 2m {label}: {k} {got[k]} vs the CPU's {want[k]}")
                e[k] = max(e.get(k, 0.0), d)
        errs[label] = e
    logit_err = max(v[k] for v in errs.values() for k in v if k.startswith(("prefill", "decode")))
    log(f"  check: {len(errs)} reduced() cases (fp32) at tp = 2 on the card == tp = 1 on the "
        f"CPU: logits within rtol=atol={LM_TOL} (max {logit_err:.2e}), "
        f"greedy tokens equal, losses and gradient norms within {TRAIN_TOL} (max "
        f"{max(max(v['loss'], v['gnorm']) for v in errs.values()):.2e})")
    t1 = time.perf_counter()
    dp_ranks = MESH_SPAWN(lm_mesh_rank, 2, "cuda", args=(DP_LM_LAYOUT,))
    wall_dp = time.perf_counter() - t1
    report = {"nvidia_smi": smi, "wall_s": {"tp": wall_tp, "dp": wall_dp},
              "reduced_vs_cpu": errs, "tp": [], "dp": []}
    for key, rs, layout in (("tp", ranks, TP_LM_LAYOUT), ("dp", dp_ranks, DP_LM_LAYOUT)):
        losses = [{a: c["loss"] for a, c in r["cells"].items()} for r in rs]
        if any(l != losses[0] for l in losses):
            raise RuntimeError(f"phase 2m {key}: the ranks report other losses {losses}")
        for r in rs:
            for label, k6 in r["k6"].items():
                want = "small" if label.endswith(":reduced") else "tc"
                if k6["route"] != want:
                    raise RuntimeError(f"phase 2m {key} rank {r['rank']} K6 {label}: the "
                                       f"{k6['route']} route, want {want}")
            missing = sorted(set(r["cells"]) - set(r["k6"]))
            if missing:
                raise RuntimeError(f"phase 2m {key} rank {r['rank']}: no K6 call recorded "
                                   f"for {missing}")
            for arch, c in r["cells"].items():
                k6 = r["k6"][arch]
                log(f"  {key} {layout} rank {r['rank']} {arch}: "
                    + (f"prefill 1 x {TP_LM_PREFILL} {c['prefill_s']:.3f} s, decode ms "
                       + ", ".join(f"{t:.1f}" for t in c["decode_ms"]) + "; "
                       if "prefill_s" in c else "")
                    + "train losses " + ", ".join(f"{x:.4f}" for x in c["loss"])
                    + (f", step ms " + ", ".join(f"{t:.1f}" for t in c["step_ms"])
                       + f", peak {c['peak_gb']:.2f} GB ({c['param_gb']:.2f} GB of weights, "
                       f"heads {c['heads']})" if "step_ms" in c else "")
                    + f"; K6 launches {c['k6_launches']}, checked at q, k {k6['shapes'][:2]}, "
                    f"max|kernel-plain| / max|plain| dq {k6['rel_err'][0]:.2e} dk "
                    f"{k6['rel_err'][1]:.2e} dv {k6['rel_err'][2]:.2e} (tol {k6['tol']}; "
                    f"{k6['route']} route, a second call bitwise equal)")
            log(f"  {key} rank {r['rank']} ({r['device']}, {r['backend']}): one bf16 "
                f"all-reduce of ({TP_LM_PREFILL}, {QWEN3_8B.d_model}) over the "
                f"{r['all_reduce_axis']} axis, host {r['all_reduce_ms']:.2f} ms ({smi})")
            report[key].append({k: v for k, v in r.items() if k != "reduced"})
    log(f"  phase 2m {time.perf_counter() - t0:.1f} s (tp {wall_tp:.1f} s, dp {wall_dp:.1f} s, "
        "each with its ranks' start)")
    return report


def _np_close(label, got, want):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    if not np.allclose(got, want, rtol=LM_TOL, atol=LM_TOL):
        raise RuntimeError(f"{label}: card vs CPU max abs diff {err} beyond rtol=atol={LM_TOL}")
    return err


def _lm_steps_cpu(whole, mesh, toks, batch):
    """`_lm_steps` of a reduced() case on the CPU at tp = 1 (the gate's
    reference; plain versions, no card)."""
    from repro_torch.sharding import ctx as CTX

    with CTX.axes(mesh):
        return _lm_steps(whole, mesh, toks, batch, 2, 3, torch.device("cpu"))


# ---------------------------------------------------------------- phase 2n
# the recsys and SchNet steps on a mesh, and the LM layouts whose kv heads
# tp does not divide (the module docstring's 2n)
MESH_RECSYS = ("wide-deep", "autoint", "dien", "bert4rec")
MESH_GNN = ("full_graph_sm", "molecule", "minibatch_lg")
MESH_TOL = 1e-5                       # of max|x| (scores, losses): order of sums only
LONG_ARCH, LONG_STEPS, LONG_TOL = "starcoder2-15b", 4, 2e-2
KV_LAYOUTS = ((1, 4), (2, 2))         # one 4-rank world: the Dh cut; batch 1 over every axis
WIDE_TP = 8                           # starcoder2-15b's 4 kv heads at tp = 8


def _window_checks(b5, k7):
    """Inside a phase-2n rank, after its counts are read: B5 and K7 at the
    largest windowed call (`BagRecorder.largest`, `BagBwdRecorder.call`)
    against their plain versions, B5 within MESH_TOL of max(1, max|plain|)
    and K7 within MESH_TOL of max|plain| (no floor: its rows are ~1e-5, so
    a floor of 1 would pass dropped atomics); B5's second call bitwise
    equal (K7's atomics add a row's terms in a varying order).  ->
    {kernel: record}."""
    out = {}
    table, ids, r0 = b5.largest()
    got, again = EO.bag_sum(table, ids, row0=r0), EO.bag_sum(table, ids, row0=r0)
    want = EREF.embedding_bag_ref(table, ids, r0)
    ids_k, d_out, rows, r0k = k7.call
    grad = EO.bag_backward(ids_k, d_out, rows, row0=r0k)
    gwant = EREF.bag_backward_ref(ids_k, d_out, rows, r0k)
    torch.cuda.synchronize()
    for name, g, w, call, floor in (("bag_sum", got, want, (table, ids, r0), 1.0),
                                    ("bag_backward", grad, gwant, (ids_k, d_out, rows, r0k),
                                     0.0)):
        scale = max(floor, float(w.float().abs().max()))
        err = float((g.float() - w.float()).abs().max())
        if not torch.isfinite(g).all() or err > MESH_TOL * scale:
            raise RuntimeError(f"phase 2n {name} on a row window: max|kernel-plain| {err} > "
                               f"{MESH_TOL} x {scale}")
        out[name] = {"max_abs_err": err, "scale": scale, "row0": int(call[-1]),
                     "shapes": [list(t.shape) if isinstance(t, torch.Tensor) else t
                                for t in call[:-1]]}
    if not torch.equal(got, again):
        raise RuntimeError("phase 2n bag_sum on a row window: two calls differ")
    out["bag_sum"]["second_call_bitwise"] = True
    # timed: CUDA events, the device events alone (B5 one kernel; K7 the
    # gradient's zero fill and its kernel) and the plain versions; the bound
    # counts what this call's ids need (the window's lookups, each row read)
    live = int(((ids.long() - r0 >= 0) & (ids.long() - r0 < table.shape[0])).sum())
    runs = {"bag_sum": (lambda: EO.bag_sum(table, ids, row0=r0),
                        lambda: EREF.embedding_bag_ref(table, ids, r0), 1,
                        nbytes(ids, got) + live * table.shape[1] * table.element_size()),
            "bag_backward": (lambda: EO.bag_backward(ids_k, d_out, rows, row0=r0k),
                             lambda: EREF.bag_backward_ref(ids_k, d_out, rows, r0k), 2,
                             nbytes(ids_k, d_out) + rows * d_out.shape[1] * 4)}
    for name, (fn, plain, events, nb) in runs.items():
        dev_ms, dev = counted_device_ms(fn, events)
        out[name].update(ms=time_ms(fn), device_ms=dev_ms, device_note=dev.get("note"),
                         plain_ms=time_ms(plain, reps=5, warmup=1), bytes=nb,
                         bound_ms=nb / HBM_BYTES_S * 1e3, live_lookups=live)
    return out


def _scale_err(label, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.isfinite(got).all() or err > tol * max(scale, 1e-30):
        raise RuntimeError(f"phase 2n {label}: max|mesh - unsharded| {err} > {tol} x max|x| "
                           f"{scale} (shapes {got.shape} / {want.shape})")
    return err / max(scale, 1e-30)


def _recsys_unsharded(dev):
    """One unsharded run on the card per recsys arch (published width, seed
    0: the model, a serve_p99 batch, a retrieval_cand query; Wide&Deep
    also TRAIN_STEPS AdamW steps on a train_batch), to the host."""
    out = {}
    for arch in MESH_RECSYS:
        cfg = RREG.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = RM.init_params(cfg, gen, dev)
        res = {"score": RM.score(model, RREG.make_batch(cfg, "serve_p99", gen, dev)).cpu()
               .numpy(),
               "retrieval": RM.retrieval_scores(model, RREG.make_batch(
                   cfg, "retrieval_cand", gen, dev)).cpu().numpy()}
        if arch == "wide-deep":
            batch = RREG.make_batch(cfg, "train_batch", gen, dev)
            res["loss"], res["gnorm"], _ = STEPS.run_train(model, batch, TRAIN_STEPS)
            del batch
        out[arch] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _gnn_unsharded(dev):
    out = {}
    cfg = RREG.get_config("schnet")
    for cell in MESH_GNN:
        gen = torch.Generator(device=dev).manual_seed(0)
        model = STEPS.init_model(cfg, gen, dev, cell)
        batch = RREG.make_batch(cfg, cell, gen, dev)
        out[cell] = STEPS.run_train(model, batch, TRAIN_STEPS)[0]
        del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _long_cfg():
    return dataclasses.replace(RREG.get_config(LONG_ARCH), n_layers=TRAIN_LAYERS)


def _long_decode(fn, batch, dev, steps=LONG_STEPS):
    """`steps` greedy decode steps: -> (logits (steps, V) fp32 numpy,
    tokens, ms a step)."""
    nxt, pos, cache = batch["tokens"], batch["positions"], batch["cache"]
    logits, toks, times = [], [], []
    for _ in range(steps):
        _sync_dev(dev)
        t0 = time.perf_counter()
        lg, cache = fn({"tokens": nxt, "cache": cache, "positions": pos})
        _sync_dev(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        nxt, pos = lg.argmax(-1)[:, None], pos + 1
        logits.append(lg[0].float().cpu().numpy())
        toks.append(int(nxt[0, 0]))
    return np.stack(logits), toks, times


def _long_unsharded(dev):
    """long_500k unsharded on the card: starcoder2 at published width,
    depth 2, its one row of 524,288 cached positions (seed 0)."""
    cfg = _long_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = TT.init_params(cfg, gen, dev)
    batch = RREG.make_batch(cfg, "long_500k", gen, dev)
    out = _long_decode(lambda b: TT.decode_step(model, b["tokens"], b["cache"],
                                                b["positions"]), batch, dev)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _launches():
    return {"bag_sum": EO.bag_sum.launches, "bag_backward": EO.bag_backward.launches,
            "flash_bwd": FO.mha_flash_bwd.launches}


def _wide_cfg():
    return dataclasses.replace(RREG.get_config("starcoder2-15b"), n_layers=TRAIN_LAYERS)


def _wide_unsharded(dev):
    """(d)'s reference on the card: starcoder2-15b whole at depth 2, drawn
    as the ranks draw it (seed 0, then the prompt), prefill 1 x
    TP_LM_PREFILL and TP_LM_DECODE greedy decode steps.  -> (prefill
    logits (V,) fp32 numpy, decode logits (steps, V), tokens (the prefill's
    first), decode ms a step)."""
    cfg = _wide_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = TT.init_params(cfg, gen, dev)
    batch = RREG.make_batch(cfg, "train_4k", gen, dev, batch=1, seq=TP_LM_PREFILL)
    logits, cache = TT.prefill(model, batch["tokens"])
    first = logits.argmax(-1)[:, None]
    start = {"tokens": first, "cache": STEPS.grow_cache(cache, model, 8),
             "positions": torch.full((1,), TP_LM_PREFILL, device=dev)}
    lg, toks, times = _long_decode(lambda b: TT.decode_step(model, b["tokens"], b["cache"],
                                                            b["positions"]),
                                   start, dev, TP_LM_DECODE)
    out = (logits[0].float().cpu().numpy(), lg, [int(first[0, 0])] + toks, times)
    del model, batch, logits, cache, start
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _token_gate(label, got_logits, got_toks, want_logits, want_toks, tol=LONG_TOL):
    """Greedy steps against a reference's, as far as their tokens agree:
    each step's logits within `tol` of the reference row's max |logit|,
    and its token equal unless the reference's top two are within that
    tolerance (a near-tie).  -> the largest error."""
    errs = []
    for i, row in enumerate(want_logits):
        if list(got_toks[:i]) != list(want_toks[:i]):
            break
        errs.append(float(np.abs(np.asarray(got_logits[i]) - row).max() / np.abs(row).max()))
        if errs[-1] > tol:
            raise RuntimeError(f"phase 2n {label} step {i}: logits {errs[-1]} of the row max "
                               f"from the unsharded run (tol {tol})")
        if got_toks[i] != want_toks[i]:
            top = np.sort(row)[-2:]
            if top[1] - top[0] > tol * np.abs(row).max():
                raise RuntimeError(f"phase 2n {label} step {i}: token {got_toks[i]} vs "
                                   f"{want_toks[i]} without a near-tie")
    return max(errs)


def _peak(device):
    return torch.cuda.max_memory_allocated(device) / 1e9


def _warm_ms(bundle, device):
    """Host ms of one more call of a serving bundle (after its first),
    the card synchronised."""
    _sync_dev(device)
    t0 = time.perf_counter()
    bundle.fn(bundle.inputs)
    _sync_dev(device)
    return (time.perf_counter() - t0) * 1e3


def mesh2_rank(rank, world, backend, device, _):
    """A rank of phase 2n's dp = 2 world: (a) the recsys archs, (b) SchNet,
    then long_500k.  -> its record."""
    from repro_torch.sharding import ctx as CTX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshConfig(dp=2, tp=1).build()
    mesh.device = device
    b5, k7 = BagRecorder(RM.bag_sum), BagBwdRecorder(RM.bag_backward)
    k7.armed = True
    saved = (RM.bag_sum, RM.bag_backward)
    RM.bag_sum, RM.bag_backward = b5, k7
    out = {"rank": rank, "device": str(device), "backend": backend,
           "coords": dict(mesh.coords), "recsys": {}, "gnn": {}}
    try:
        before = _launches()
        for arch in MESH_RECSYS:
            cfg = RREG.get_config(arch)
            gen = torch.Generator(device=device).manual_seed(0)
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            b = STEPS.build(arch, "serve_p99", mesh, device, generator=gen)
            rec = {"init_s": time.perf_counter() - t0,
                   "table_rows": {n: [int(b.model.row0[n]),
                                      int(b.model.get_parameter(n).shape[0])]
                                  for n in b.model.row0}}
            rec["score"] = b.fn(b.inputs).cpu().numpy()
            rec["score_ms"] = _warm_ms(b, device)
            r = STEPS.build(arch, "retrieval_cand", mesh, device, model=b.model,
                            batch=RREG.make_batch(cfg, "retrieval_cand", gen, device))
            rec["retrieval"] = r.fn(r.inputs).cpu().numpy()
            rec["retrieval_ms"] = _warm_ms(r, device)
            rec["score_rows"], rec["retrieval_cut"] = int(rec["score"].shape[0]), r.dp_batch
            del r
            if arch == "wide-deep":
                t = STEPS.build(arch, "train_batch", mesh, device, model=b.model,
                                batch=RREG.make_batch(cfg, "train_batch", gen, device))
                hist, times = [], []
                for _ in range(TRAIN_STEPS):
                    _sync_dev(device)
                    t0 = time.perf_counter()
                    m = t.fn(t.inputs)
                    hist.append({k: float(v) for k, v in m.items()})
                    _sync_dev(device)
                    times.append((time.perf_counter() - t0) * 1e3)
                rec.update(loss=[h["loss"] for h in hist], gnorm=[h["gnorm"] for h in hist],
                           step_ms=times, train_rows=int(t.inputs["labels"].shape[0]))
                del t
            rec["peak_gb"] = _peak(device)
            out["recsys"][arch] = rec
            del b
            gc.collect()
            torch.cuda.empty_cache()
        out["recsys_launches"] = {k: v - before[k] for k, v in _launches().items()}
        RM.bag_sum, RM.bag_backward = saved
        out["windows"] = _window_checks(b5, k7)
        cfg = RREG.get_config("schnet")
        for cell in MESH_GNN:
            gen = torch.Generator(device=device).manual_seed(0)
            torch.cuda.reset_peak_memory_stats(device)
            b = STEPS.build("schnet", cell, mesh, device, generator=gen)
            hist, times = [], []
            for _ in range(TRAIN_STEPS):
                _sync_dev(device)
                t0 = time.perf_counter()
                m = b.fn(b.inputs)
                hist.append(float(m["loss"]))
                _sync_dev(device)
                times.append((time.perf_counter() - t0) * 1e3)
            out["gnn"][cell] = {"loss": hist, "step_ms": times, "peak_gb": _peak(device),
                                "edges": list(b.inputs["edge_src"].shape),
                                "data_mean": b.dp_batch}
            del b
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        b = STEPS.build(LONG_ARCH, "long_500k", mesh, device, generator=gen,
                        layers=TRAIN_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        build_s = time.perf_counter() - t0
        logits, toks, times = _long_decode(b.fn, b.inputs, device)
        out["long"] = {"logits": logits, "tokens": toks, "decode_ms": times,
                       "cache_block": list(b.inputs["cache"]["k"].shape), "build_s": build_s,
                       "peak_gb": _peak(device), "dp_batch": b.dp_batch}
        del b
    finally:
        RM.bag_sum, RM.bag_backward = saved
    return out


def _reduced_one_row(label, dev):
    """A reduced() case's batch-1 decode input: the whole model's prefill
    of the first prompt (tp = 1, outside any mesh) grown by 8 positions,
    and its first greedy token.  -> (cfg, the model on `dev`, that input,
    the prompt (1, 40), its prefill logits (1, V) fp32 numpy)."""
    cfg, whole, toks, _ = _reduced_case(label)
    model = whole.to(dev)
    prompt = toks[:1].to(dev)
    logits, cache = TT.prefill(model, prompt)
    cache = STEPS.grow_cache(cache, model, 8)
    return cfg, model, {"tokens": logits.argmax(-1)[:, None], "cache": cache,
                        "positions": torch.full((1,), toks.shape[1], device=dev)}, prompt, \
        logits.float().cpu().numpy()


def _one_row_steps(fn, batch, dev, steps=2):
    nxt, pos, cache, out = batch["tokens"], batch["positions"], batch["cache"], []
    for _ in range(steps):
        lg, cache = fn({"tokens": nxt, "cache": cache, "positions": pos})
        nxt, pos = lg.argmax(-1)[:, None], pos + 1
        out.append((lg.float().cpu().numpy(), nxt[:, 0].cpu().numpy()))
    return out


def kv_rank(rank, world, backend, device, _):
    """A rank of phase 2n's 4-rank world: (c) the reduced() cases at
    (1, 4) (the Dh cut, the cache over ``model``: prefill, 2 decode steps,
    3 train steps) and at (2, 2) (the cache over every axis) a batch-1
    decode from the whole model's cache, then a batch-1 prefill on the
    mesh (each rank its block of positions, the kv heads gathered) and
    its decode.  -> its record."""
    from repro_torch.sharding import ctx as CTX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "device": str(device), "backend": backend, "layouts": {}}
    for layout in KV_LAYOUTS:
        mesh = MeshConfig(dp=layout[0], tp=layout[1]).build()
        mesh.device = device
        res = {"coords": dict(mesh.coords), "cases": {}}
        for label in TP_LM_REDUCED:
            if layout == (1, 4):
                cfg, whole, toks, batch = _reduced_case(label)
                with CTX.axes(mesh):
                    res["cases"][label] = _lm_steps(whole, mesh, toks, batch, 2, 3, device)
                continue
            cfg, model, row, prompt, _ = _reduced_one_row(label, device)
            with CTX.axes(mesh):
                serve = STEPS.rank_model(cfg, mesh, "decode", device, source=model)
                inputs = STEPS.rank_inputs(cfg, mesh, "decode", row)
                dec, _ = STEPS.mesh_fn(serve, mesh, "decode", 1)
                case = {"decode": _one_row_steps(dec, inputs, device),
                        "block": list(inputs["cache"]["k"].shape)}
                # every data rank holds the row (`build` cuts a prefill's
                # rows over the data axis, as the reference does)
                logits, cache = TT.prefill(serve, prompt, dp_batch=False)
                case.update(prefill=logits.float().cpu().numpy(),
                            prefill_block=list(cache["k"].shape))
                mine = {"tokens": logits.argmax(-1)[:, None],
                        "cache": STEPS.grow_cache(cache, serve, 8, dp_batch=False),
                        "positions": row["positions"]}
                case["prefilled"] = _one_row_steps(dec, mine, device)
                res["cases"][label] = case
        out["layouts"][layout] = res
    return out


def wide_tp_rank(rank, world, backend, device, _):
    """A rank of phase 2n's (d): starcoder2-15b at tp = WIDE_TP, depth 2:
    prefill 1 x TP_LM_PREFILL, TP_LM_DECODE decode steps, TRAIN_STEPS AdamW
    steps (K6 on the rank's query heads against its gathered kv head).
    -> its record."""
    from repro_torch.sharding import ctx as CTX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshConfig(dp=1, tp=WIDE_TP).build()
    mesh.device = device
    rec = BwdRecorder(TL.mha_flash_bwd)
    TL.mha_flash_bwd = rec
    cfg = _wide_cfg()
    out = {"rank": rank, "device": str(device), "backend": backend}
    try:
        with CTX.axes(mesh):
            gen = torch.Generator(device=device).manual_seed(0)
            torch.cuda.reset_peak_memory_stats(device)
            before = (FO.mha_flash_bwd.launches, FO.mha_flash_bwd.tc_launches)
            model = STEPS.rank_model(cfg, mesh, "train", device, generator=gen)
            batch = RREG.make_batch(cfg, "train_4k", gen, device, batch=1, seq=TP_LM_PREFILL)
            out["param_gb"] = sum(p.numel() * p.element_size()
                                  for p in model.parameters()) / 1e9
            out["heads"] = [list(model.layers[0].wq.shape), list(model.layers[0].wk.shape)]
            fn, _ = STEPS.mesh_fn(model, mesh, "prefill", 1)
            toks = STEPS.rank_inputs(cfg, mesh, "prefill", {"tokens": batch["tokens"]})
            _sync_dev(device)
            t0 = time.perf_counter()
            logits, cache = fn(toks)
            _sync_dev(device)
            out["prefill_s"] = time.perf_counter() - t0
            out["prefill_cache_block"] = list(cache["k"].shape)
            cache = STEPS.grow_cache(cache, model, 8)
            dec, _ = STEPS.mesh_fn(model, mesh, "decode", 1)
            first = logits.argmax(-1)[:, None]
            start = {"tokens": first, "cache": cache,
                     "positions": torch.full((1,), TP_LM_PREFILL, device=device)}
            lg, toks, times = _long_decode(dec, start, device, TP_LM_DECODE)
            out.update(decode_ms=times, decode_cache_block=list(start["cache"]["k"].shape),
                       finite=bool(np.isfinite(lg).all() and torch.isfinite(logits).all()),
                       prefill_logits=logits[0].float().cpu().numpy(), decode_logits=lg,
                       tokens=[int(first[0, 0])] + toks)
            del logits, cache, start
            gc.collect()
            torch.cuda.empty_cache()
            step, _ = STEPS.mesh_fn(model, mesh, "train", 1)
            inputs = STEPS.rank_inputs(cfg, mesh, "train", batch)
            rec.arm("starcoder2-15b:tp8")
            losses, norms, times = [], [], []
            for _ in range(TRAIN_STEPS):
                _sync_dev(device)
                t0 = time.perf_counter()
                m = step(inputs)
                losses.append(float(m["loss"]))
                norms.append(float(m["gnorm"]))
                _sync_dev(device)
                times.append((time.perf_counter() - t0) * 1e3)
            rec.arm(None)
            out.update(loss=losses, gnorm=norms, step_ms=times, peak_gb=_peak(device),
                       k6_launches=FO.mha_flash_bwd.launches - before[0],
                       k6_tc_launches=FO.mha_flash_bwd.tc_launches - before[1])
            del model, batch, step, inputs
            gc.collect()
            torch.cuda.empty_cache()
        out["k6"] = _k6_rank_checks(rec.calls)
    finally:
        TL.mha_flash_bwd = rec.fn
    return out


def mesh_families_phase(smi, dev):
    """Phase 2n (the module docstring).  -> its report."""
    t0 = time.perf_counter()
    cfg = _long_cfg()
    long_gb = 2 * cfg.n_layers * 524_288 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 / 1e9
    wide = dataclasses.replace(RREG.get_config("starcoder2-15b"), n_layers=TRAIN_LAYERS)
    wide_gb = sum(p.numel() for p in TT.Transformer(wide, device="meta").parameters()) * 2 / 1e9
    log(f"recsys, SchNet and the kv-split LM layouts on a mesh (phase 2n): ranks sharing one "
        f"card over {collective_backend(2, 'cuda')} ({smi}); footprint: long_500k's cache "
        f"{long_gb:.2f} GB in bf16 ({long_gb / 2:.2f} a rank at dp = 2), starcoder2-15b at "
        f"depth 2 {wide_gb:.2f} GB of bf16 weights ({wide_gb / WIDE_TP:.2f} a rank at tp = "
        f"{WIDE_TP}, plus each rank's CUDA context); times are gloo's host staging on one "
        "card, not a multi-card speed")
    # the unsharded references on the card, each freed before the ranks start
    recsys_ref = _recsys_unsharded(dev)
    gnn_ref = _gnn_unsharded(dev)
    long_ref = _long_unsharded(dev)
    wide_ref = _wide_unsharded(dev)
    ref_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 1e9
    if resident > LM_RESIDENT_GB:
        raise RuntimeError(f"phase 2n: {resident:.2f} GB still allocated before the ranks")
    t1 = time.perf_counter()
    two = MESH_SPAWN(mesh2_rank, 2, "cuda", args=(None,))
    two_s = time.perf_counter() - t1
    report = {"nvidia_smi": smi, "reference_s": ref_s, "recsys": {}, "gnn": {}, "ranks2": []}
    # gate (a): recsys at dp = 2 against the unsharded run
    for arch in MESH_RECSYS:
        want = recsys_ref[arch]
        scores = np.concatenate([r["recsys"][arch]["score"] for r in two])
        e = {"score": _scale_err(f"{arch} serve_p99 scores", scores, want["score"], MESH_TOL)}
        for r in two:
            got = r["recsys"][arch]
            if got["retrieval_cut"]:
                raise RuntimeError(f"phase 2n {arch}: the one retrieval query was cut")
            e["retrieval"] = max(e.get("retrieval", 0.0), _scale_err(
                f"{arch} retrieval_cand scores", got["retrieval"], want["retrieval"], MESH_TOL))
            if "loss" in want:
                for k, tol in (("loss", MESH_TOL), ("gnorm", TRAIN_TOL)):
                    e[k] = max(e.get(k, 0.0), _scale_err(f"{arch} train {k}", got[k], want[k],
                                                         tol))
        report["recsys"][arch] = e
    for r in two:
        n = r["recsys_launches"]
        if n["bag_sum"] == 0 or n["bag_backward"] == 0:
            raise RuntimeError(f"phase 2n rank {r['rank']}: B5 launched {n['bag_sum']} and K7 "
                               f"{n['bag_backward']} times on the rank's window: both must run")
    log("  (a) recsys at dp = 2 == one unsharded run on the card (scores and Wide&Deep's "
        f"losses within {MESH_TOL}, its gradient norms within {TRAIN_TOL}, of max|x|): "
        + "; ".join(
            f"{a} " + ", ".join(f"{k} {v:.1e}" for k, v in e.items())
            for a, e in report["recsys"].items()))
    records = []
    for name, kernel in (("bag_sum", "embedding_bag"), ("bag_backward", "bag_backward")):
        w = two[0]["windows"][name]
        records.append({
            "name": f"{kernel}:window", "route": "cuda", "source": KERNELS[kernel]["source"],
            "replaces": KERNELS[kernel]["replaces"],
            "launches": sum(r["recsys_launches"][name] for r in two),
            "max_abs_err": max(r["windows"][name]["max_abs_err"] for r in two),
            "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "library_note": "no single PyTorch call skips the ids outside a row window",
            "device_ms": w["device_ms"], "device_note": w["device_note"],
            "shapes": w["shapes"], "row0": w["row0"], "bytes": w["bytes"],
            "tol": MESH_TOL, "nvidia_smi": smi})
        log(f"  time {kernel} on rank 0's window (row0 {w['row0']}, {w['shapes']}): kernel "
            f"{w['ms']:.4f} ms (device {w['device_ms'] if w['device_ms'] is None else round(w['device_ms'], 4)}), "
            f"plain {w['plain_ms']:.4f} ms, bound {w['bound_ms']:.4f} ms (bytes, "
            f"{w['bytes'] / 1e6:.1f} MB: {w['live_lookups']} lookups in the window)")
    for r in two:
        w = r["windows"]
        log(f"  (a) rank {r['rank']} ({r['device']}, {r['backend']}): launches on its windows "
            f"{r['recsys_launches']}; B5 at its largest call {w['bag_sum']['shapes']} row0 "
            f"{w['bag_sum']['row0']} max|kernel-plain| {w['bag_sum']['max_abs_err']:.2e} "
            f"(tol {MESH_TOL} x max(1, max|plain|); a second call bitwise equal), K7 at "
            f"{w['bag_backward']['shapes']} row0 {w['bag_backward']['row0']} "
            f"{w['bag_backward']['max_abs_err']:.2e} (tol {MESH_TOL} x max|plain| "
            f"{w['bag_backward']['scale']:.3g})")
        for arch, c in r["recsys"].items():
            log(f"    {arch}: init {c['init_s']:.2f} s, serve_p99 {c['score_rows']} rows "
                f"{c['score_ms']:.2f} ms, retrieval_cand {c['retrieval_ms']:.2f} ms (each a "
                f"second call, host clock), peak "
                f"{c['peak_gb']:.2f} GB, tables (row0, rows) {c['table_rows']}"
                + (f"; train_batch {c['train_rows']} rows a rank, step ms "
                   + ", ".join(f"{t:.1f}" for t in c["step_ms"]) if "step_ms" in c else ""))
    # gate (b): SchNet
    for cell in MESH_GNN:
        e = max(_scale_err(f"schnet {cell} losses", r["gnn"][cell]["loss"], gnn_ref[cell],
                           MESH_TOL) for r in two)
        report["gnn"][cell] = e
        log(f"  (b) schnet {cell} at dp = 2: losses {two[0]['gnn'][cell]['loss']} within "
            f"{e:.1e} of max|x| of the unsharded run's (tol {MESH_TOL}); " + "; ".join(
                f"rank {r['rank']}: edges {r['gnn'][cell]['edges']}, step ms "
                + ", ".join(f"{t:.1f}" for t in r["gnn"][cell]["step_ms"])
                + f", peak {r['gnn'][cell]['peak_gb']:.2f} GB" for r in two))
    # long_500k
    logits, toks, ref_ms = long_ref
    errs = []
    for r in two:
        got = r["long"]
        if got["dp_batch"]:
            raise RuntimeError("phase 2n long_500k: the one row was cut over the data axis")
        errs.append(_token_gate("long_500k", got["logits"], got["tokens"], logits, toks))
    report["long"] = {"max_rel_err": max(errs), "tokens": toks, "unsharded_ms": ref_ms}
    for r in two:
        g = r["long"]
        log(f"  long_500k rank {r['rank']}: cache block {g['cache_block']} (bf16), decode ms "
            + ", ".join(f"{t:.1f}" for t in g["decode_ms"]) + f" (unsharded on the card: "
            + ", ".join(f"{t:.1f}" for t in ref_ms) + f"), peak {g['peak_gb']:.2f} GB; tokens "
            f"{g['tokens']} vs {toks}; logits within {max(errs):.2e} of the row max (tol "
            f"{LONG_TOL})")
        report["ranks2"].append({k: v for k, v in r.items() if k not in ("long", "recsys")}
                                | {"long": {k: v for k, v in r["long"].items()
                                            if k != "logits"},
                                   "recsys": {a: {k: v for k, v in c.items()
                                                  if k not in ("score", "retrieval")}
                                              for a, c in r["recsys"].items()}})
    # (c) the reduced() cases: the Dh cut at (1, 4), batch 1 over every axis at (2, 2)
    t2 = time.perf_counter()
    four = MESH_SPAWN(kv_rank, 4, "cuda", args=(None,))
    four_s = time.perf_counter() - t2
    one = MeshConfig(mesh_shape=(1, 1)).build()
    errs = {}
    for label in TP_LM_REDUCED:
        cfg, whole, toks, batch = _reduced_case(label)
        want = _lm_steps_cpu(whole, one, toks, batch)
        _, _, row_in, _, row_logits = _reduced_one_row(label, torch.device("cpu"))
        row = _one_row_steps(lambda b: TT.decode_step(whole, b["tokens"], b["cache"],
                                                      b["positions"]), row_in,
                             torch.device("cpu"))
        e = {}
        for r in four:
            got = r["layouts"][(1, 4)]["cases"][label]
            e["prefill"] = max(e.get("prefill", 0.0), _np_close(
                f"phase 2n {label} (1, 4) prefill", got["prefill"], want["prefill"]))
            for i, ((gl, gt), (wl, wt)) in enumerate(zip(got["decode"], want["decode"])):
                e["decode"] = max(e.get("decode", 0.0), _np_close(
                    f"phase 2n {label} (1, 4) decode {i}", gl, wl))
                if not np.array_equal(gt, wt):
                    raise RuntimeError(f"phase 2n {label} (1, 4) decode {i}: tokens {gt} vs "
                                       f"the CPU's {wt}")
            for k in ("loss", "gnorm"):
                d = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got[k], want[k]))
                if d > TRAIN_TOL:
                    raise RuntimeError(f"phase 2n {label} (1, 4): {k} {got[k]} vs the CPU's "
                                       f"{want[k]}")
                e[k] = max(e.get(k, 0.0), d)
            got = r["layouts"][(2, 2)]["cases"][label]
            e["row_prefill"] = max(e.get("row_prefill", 0.0), _np_close(
                f"phase 2n {label} (2, 2) batch-1 prefill", got["prefill"], row_logits))
            for key in ("decode", "prefilled"):
                for i, ((gl, gt), (wl, wt)) in enumerate(zip(got[key], row)):
                    e["row"] = max(e.get("row", 0.0), _np_close(
                        f"phase 2n {label} (2, 2) batch-1 {key} decode {i}", gl, wl))
                    if not np.array_equal(gt, wt):
                        raise RuntimeError(f"phase 2n {label} (2, 2) {key} decode {i}: tokens "
                                           f"{gt} vs the CPU's {wt}")
        errs[label] = e
    report["reduced_vs_cpu"] = errs
    for r in four:
        cases = r["layouts"][(1, 4)]["cases"].values()
        log(f"  (c) rank {r['rank']} ({r['device']}, {r['backend']}) at (1, 4), the "
            f"{len(cases)} cases: prefill s " + ", ".join(f"{c['prefill_s']:.3f}" for c in cases)
            + "; decode ms (median of each case's 2) " + ", ".join(
                f"{statistics.median(c['decode_ms']):.1f}" for c in cases)
            + "; train ms (median of 3) " + ", ".join(
                f"{statistics.median(c['step_ms']):.1f}" for c in cases))
    first = four[0]["layouts"][(2, 2)]["cases"][TP_LM_REDUCED[0]]
    blocks, pre_blocks = first["block"], first["prefill_block"]
    log(f"  (c) {len(errs)} reduced() cases (fp32) on the card == tp = 1 on the CPU: at (1, 4) "
        f"prefill, 2 decode steps, 3 train steps (logits within {LM_TOL}, max "
        f"{max(max(v['prefill'], v['decode']) for v in errs.values()):.2e}; losses and norms "
        f"within {TRAIN_TOL}, max {max(max(v['loss'], v['gnorm']) for v in errs.values()):.2e}); "
        f"at (2, 2) a batch-1 prefill on the mesh (cache blocks {pre_blocks}, max "
        f"{max(v['row_prefill'] for v in errs.values()):.2e}) and 2 decode steps over blocks "
        f"{blocks}, from it and from the whole model's cache: max "
        f"{max(v['row'] for v in errs.values()):.2e}; greedy tokens equal; 4 ranks in "
        f"{four_s:.1f} s")
    # (d) starcoder2-15b at tp = 8
    t3 = time.perf_counter()
    eight = MESH_SPAWN(wide_tp_rank, WIDE_TP, "cuda", args=(None,))
    eight_s = time.perf_counter() - t3
    losses = [r["loss"] for r in eight]
    if any(l != losses[0] for l in losses):
        raise RuntimeError(f"phase 2n (d): the ranks report other losses {losses}")
    # the prefill's and decode steps' logits and greedy tokens against the
    # unsharded run on the card (long_500k's gate)
    w_pre, w_dec, w_toks, w_ms = wide_ref
    want = np.concatenate([w_pre[None], w_dec])
    wide_err = max(_token_gate(f"(d) rank {r['rank']}",
                               np.concatenate([r["prefill_logits"][None], r["decode_logits"]]),
                               r["tokens"], want, w_toks) for r in eight)
    report["tp8_vs_unsharded"] = {"max_rel_err": wide_err, "tokens": w_toks,
                                  "unsharded_decode_ms": w_ms, "tol": LONG_TOL}
    log(f"  (d) starcoder2-15b at tp = {WIDE_TP} == one unsharded run on the card: prefill and "
        f"{TP_LM_DECODE} decode steps' logits within {wide_err:.2e} of the row max (tol "
        f"{LONG_TOL}, bf16), greedy tokens {eight[0]['tokens']} vs {w_toks} (unsharded decode "
        "ms " + ", ".join(f"{t:.1f}" for t in w_ms) + ")")
    for r in eight:
        k6 = r["k6"].get("starcoder2-15b:tp8")
        if (not r["finite"] or not all(np.isfinite(r["loss"] + r["gnorm"]))
                or not r["loss"][-1] < r["loss"][0] or r["k6_launches"] == 0
                or r["k6_tc_launches"] != r["k6_launches"] or k6 is None or k6["route"] != "tc"):
            raise RuntimeError(f"phase 2n (d) rank {r['rank']}: finite {r['finite']}, losses "
                               f"{r['loss']}, K6 {r['k6_launches']} ({r['k6_tc_launches']} tc), "
                               f"checked {k6}")
        log(f"  (d) starcoder2-15b tp = {WIDE_TP} rank {r['rank']}: wq {r['heads'][0]}, wk "
            f"{r['heads'][1]} ({r['param_gb']:.3f} GB of weights); prefill 1 x {TP_LM_PREFILL} "
            f"{r['prefill_s']:.3f} s (cache block {r['prefill_cache_block']}), decode ms "
            + ", ".join(f"{t:.1f}" for t in r["decode_ms"]) + "; train losses "
            + ", ".join(f"{x:.4f}" for x in r["loss"]) + ", step ms "
            + ", ".join(f"{t:.1f}" for t in r["step_ms"]) + f", peak {r['peak_gb']:.2f} GB; K6 "
            f"launches {r['k6_launches']}, checked at q, k {k6['shapes'][:2]}: dq "
            f"{k6['rel_err'][0]:.2e} dk {k6['rel_err'][1]:.2e} dv {k6['rel_err'][2]:.2e} of "
            f"max|plain| (tol {k6['tol']}; {k6['route']} route, a second call bitwise equal)")
    report.update(ranks8=[{k: v for k, v in r.items()
                           if k not in ("prefill_logits", "decode_logits")} for r in eight],
                  ranks4=[{k: v for k, v in r.items() if k != "layouts"}
                                        for r in four],
                  wall_s={"reference": ref_s, "dp2": two_s, "four": four_s, "tp8": eight_s})
    log(f"  phase 2n {time.perf_counter() - t0:.1f} s (references on the card {ref_s:.1f} s, "
        f"dp = 2 ranks {two_s:.1f} s, 4 ranks {four_s:.1f} s, {WIDE_TP} ranks {eight_s:.1f} s, "
        "each with its ranks' start)")
    return report, records


# ---------------------------------------------------------------- phase 2o
# the data-axis parameter cuts (the module docstring's 2o): four ranks at
# (dp, tp) = (2, 2) sharing the card
CUT_LAYOUT = (2, 2)
CUT_SERVE_ARCH, CUT_SERVE_LAYERS, CUT_SERVE_SEQ, CUT_SERVE_DECODE = "kimi-k2-1t-a32b", 1, 1024, 4
CUT_TRAIN_ARCH, CUT_TRAIN_LAYERS, CUT_TRAIN_SEQ = "moonshot-v1-16b-a3b", 4, 2048
CUT_REDUCED = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
CUT_TOL, CUT_LOSS_TOL, CUT_RANK_GB = 2e-2, 1e-2, 72.0


def _cut_cfg(arch, layers):
    return dataclasses.replace(RREG.get_config(arch), n_layers=layers)


def _expert_ff_bytes(model):
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if ".moe.w_" in n)


def _cut_serve(mesh, device):
    """(a) on this rank: kimi-k2 at published width, depth 1, drawn in turn
    with the other ranks (seed 0; serve mode: experts over model, expert-ff
    and d_model over data), a prefill of its row of the 2 x CUT_SERVE_SEQ
    prompt and CUT_SERVE_DECODE greedy decode steps."""
    cfg = _cut_cfg(CUT_SERVE_ARCH, CUT_SERVE_LAYERS)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(device)
    model = STEPS.rank_model(cfg, mesh, "prefill", device, generator=gen)
    torch.cuda.synchronize(device)
    init_peak = _peak(device)
    batch = RREG.make_batch(cfg, "prefill_32k", gen, device, batch=2, seq=CUT_SERVE_SEQ)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    lp = model.layers[0]
    out = {"param_bytes": params, "expert_ff_bytes": _expert_ff_bytes(model),
           "w_up": list(lp.moe.w_up.shape), "wq": list(lp.wq.shape), "init_peak_gb": init_peak}
    torch.cuda.reset_peak_memory_stats(device)
    fn, _ = STEPS.mesh_fn(model, mesh, "prefill", 2)
    inputs = STEPS.rank_inputs(cfg, mesh, "prefill", batch)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits, cache = fn(inputs)
    torch.cuda.synchronize(device)
    out["prefill_s"] = time.perf_counter() - t0
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    # what stays on the card after the layer: the shards and the cache,
    # no gathered expert or attention weights
    out["resident_after_prefill_gb"] = (torch.cuda.memory_allocated(device) - params
                                        - cache_bytes) / 1e9
    out["prefill"] = logits.float().cpu().numpy()
    cache = STEPS.grow_cache(cache, model, 8)
    dec, _ = STEPS.mesh_fn(model, mesh, "decode", 2)
    pos = torch.full((inputs["tokens"].shape[0],), CUT_SERVE_SEQ, device=device)
    nxt, steps, times = logits.argmax(-1)[:, None], [], []
    out["first"] = nxt[:, 0].cpu().numpy()
    for _ in range(CUT_SERVE_DECODE):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        lg, cache = dec({"tokens": nxt, "cache": cache, "positions": pos})
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        nxt, pos = lg.argmax(-1)[:, None], pos + 1
        steps.append((lg.float().cpu().numpy(), nxt[:, 0].cpu().numpy()))
    out.update(decode=steps, decode_ms=[t * 1e3 for t in times], peak_gb=_peak(device))
    del model, logits, cache, lg, batch, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cut_train(mesh, device, rec):
    """(b) on this rank: moonshot at published width, depth
    CUT_TRAIN_LAYERS (seed 0; train mode: experts over model, expert-ff
    over data, moments with them), 3 AdamW steps on its row of 2 x
    CUT_TRAIN_SEQ tokens, K6 on the rank's heads."""
    cfg = _cut_cfg(CUT_TRAIN_ARCH, CUT_TRAIN_LAYERS)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(device)
    model = STEPS.rank_model(cfg, mesh, "train", device, generator=gen)
    batch = RREG.make_batch(cfg, "train_4k", gen, device, batch=2, seq=CUT_TRAIN_SEQ)
    step, opt = STEPS.mesh_fn(model, mesh, "train", 2)
    inputs = STEPS.rank_inputs(cfg, mesh, "train", batch)
    before = (FO.mha_flash_bwd.launches, FO.mha_flash_bwd.tc_launches)
    rec.arm(CUT_TRAIN_ARCH)
    losses, norms, times = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m = step(inputs)
        losses.append(float(m["loss"]))
        norms.append(float(m["gnorm"]))
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    rec.arm(None)
    out = {"loss": losses, "gnorm": norms, "step_ms": [t * 1e3 for t in times],
           "peak_gb": _peak(device), "optimizer": type(opt).__name__,
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "expert_ff_bytes": _expert_ff_bytes(model),
           "k6_launches": FO.mha_flash_bwd.launches - before[0],
           "k6_tc_launches": FO.mha_flash_bwd.tc_launches - before[1]}
    del model, batch, step, opt, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cut_ckpt_case():
    """The checkpoint case: moonshot at reduced() size (fp32, seed 0) and
    three 2 x 64 training batches (numpy draws, the same in every
    process)."""
    cfg, whole, _, batch = _reduced_case(CUT_TRAIN_ARCH)
    rng = np.random.default_rng(11)
    batches = [batch]
    for _ in range(2):
        t = rng.integers(1, cfg.vocab_size, (2, 65)).astype(np.int64)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return cfg, whole, [{k: np.asarray(v) for k, v in b.items()} for b in batches]


def _cut_ckpt_train(mesh, device, ckpt_dir, steps):
    """The checkpoint case on this rank: the port's loop to `steps` on its
    rows, a checkpoint each step in `ckpt_dir` (resuming from its latest
    and skipping the batches taken before it).  -> the history of the
    steps run here."""
    from repro_torch.checkpoint import checkpoint as CKPT
    from repro_torch.data.pipeline import rows_of
    from repro_torch.sharding import specs as SPECS
    from repro_torch.training import train_loop as TTL

    cfg, whole, batches = _cut_ckpt_case()
    model = STEPS.rank_model(cfg, mesh, "train", device, source=whole)
    n, d = mesh.shape["data"], mesh.coords["data"]
    done = CKPT.latest_step(ckpt_dir) or 0
    data = iter([{k: rows_of(v, d, n) for k, v in b.items()} for b in batches[done:]])
    _, _, hist = TTL.train(model, STEPS.lm_loss, data, TTL.TrainConfig(
        steps=steps, optimizer=cfg.optimizer, lr=1e-3, ckpt_dir=ckpt_dir, ckpt_every=1),
        layout=SPECS.train_layout(cfg, mesh, cfg.optimizer))
    return hist


def cut_rank(rank, world, backend, device, layout, part, ckpt_dir):
    """A rank of phase 2o on a (dp, tp) `layout`: `part` "serve" is (a);
    "train" is (b): moonshot at published width, the reduced() cases and
    the checkpoint case's first two steps; "resume" the checkpoint case's
    third step from the (2, 2) checkpoint."""
    from repro_torch.sharding import ctx as CTX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshConfig(dp=layout[0], tp=layout[1]).build()
    mesh.device = device
    out = {"rank": rank, "device": str(device), "backend": backend,
           "coords": dict(mesh.coords)}
    with CTX.axes(mesh):
        if part == "serve":
            out["serve"] = _cut_serve(mesh, device)
            return out
        if part == "resume":
            out["resumed"] = _cut_ckpt_train(mesh, device, ckpt_dir, 3)
            return out
        rec = BwdRecorder(TL.mha_flash_bwd)
        TL.mha_flash_bwd = rec
        try:
            out["train"] = _cut_train(mesh, device, rec)
            out["reduced"] = {}
            for label in CUT_REDUCED:
                cfg, whole, toks, batch = _reduced_case(label)
                out["reduced"][label] = _lm_steps(whole, mesh, toks, batch, 2, 3, device)
            out["ckpt"] = _cut_ckpt_train(mesh, device, ckpt_dir, 2)
        finally:
            TL.mha_flash_bwd = rec.fn
        out["k6"] = _k6_rank_checks(rec.calls)
    return out


def _cut_serve_unsharded(dev):
    """(a)'s reference: the same depth-1 kimi-k2 whole on the card (seed 0,
    then the prompt), its prefill and CUT_SERVE_DECODE greedy steps."""
    cfg = _cut_cfg(CUT_SERVE_ARCH, CUT_SERVE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    model = TT.init_params(cfg, gen, dev)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = RREG.make_batch(cfg, "prefill_32k", gen, dev, batch=2, seq=CUT_SERVE_SEQ)
    logits, cache = TT.prefill(model, batch["tokens"])
    nxt = logits.argmax(-1)[:, None]
    out = {"prefill": logits.float().cpu().numpy(), "first": nxt[:, 0].cpu().numpy(),
           "param_bytes": params}
    cache = STEPS.grow_cache(cache, model, 8)
    pos = torch.full((2,), CUT_SERVE_SEQ, device=dev)
    steps = []
    for _ in range(CUT_SERVE_DECODE):
        lg, cache = TT.decode_step(model, nxt, cache, pos)
        nxt, pos = lg.argmax(-1)[:, None], pos + 1
        steps.append((lg.float().cpu().numpy(), nxt[:, 0].cpu().numpy()))
    out.update(decode=steps, peak_gb=_peak(dev))
    del model, batch, logits, cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cut_train_unsharded(dev):
    """(b)'s reference: the same depth-4 moonshot whole on the card, 3
    AdamW steps on the whole 2 x CUT_TRAIN_SEQ batch."""
    cfg = _cut_cfg(CUT_TRAIN_ARCH, CUT_TRAIN_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    model = TT.init_params(cfg, gen, dev)
    batch = RREG.make_batch(cfg, "train_4k", gen, dev, batch=2, seq=CUT_TRAIN_SEQ)
    losses, norms, _ = STEPS.run_train(model, batch, TRAIN_STEPS)
    out = {"loss": losses, "gnorm": norms, "peak_gb": _peak(dev)}
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cut_close(label, rank, got, want):
    """(a)'s gate on one rank's row: logits within CUT_TOL of the row max
    of the unsharded run, greedy tokens equal.  -> the largest error."""
    d = rank["coords"]["data"]
    rows = [(got["prefill"], want["prefill"][d:d + 1])] + [
        (g[0], w[0][d:d + 1]) for g, w in zip(got["decode"], want["decode"])]
    errs = []
    for i, (g, w) in enumerate(rows):
        errs.append(float(np.abs(g - w).max() / np.abs(w).max()))
        if errs[-1] > CUT_TOL:
            raise RuntimeError(f"phase 2o {label} rank {rank['rank']} step {i}: logits "
                               f"{errs[-1]} of the row max from the unsharded run "
                               f"(tol {CUT_TOL})")
    toks = [got["first"]] + [g[1] for g in got["decode"]]
    want_toks = [want["first"][d:d + 1]] + [w[1][d:d + 1] for w in want["decode"]]
    if not all(np.array_equal(a, b) for a, b in zip(toks, want_toks)):
        raise RuntimeError(f"phase 2o {label} rank {rank['rank']}: greedy tokens {toks} vs "
                           f"the unsharded run's {want_toks}")
    return max(errs)


def data_cut_phase(smi, dev):
    """Phase 2o (the module docstring).  -> its report."""
    import shutil
    import tempfile

    from repro_torch.launch import dryrun as DRY
    from repro_torch.sharding import ctx as CTX
    from repro_torch.training import train_loop as TTL

    t0 = time.perf_counter()
    world = CUT_LAYOUT[0] * CUT_LAYOUT[1]
    report = {"nvidia_smi": smi, "layout": list(CUT_LAYOUT),
              "cuts": {"serve": {"arch": CUT_SERVE_ARCH, "n_layers": CUT_SERVE_LAYERS,
                                 "batch": 2, "seq": CUT_SERVE_SEQ},
                       "train": {"arch": CUT_TRAIN_ARCH, "n_layers": CUT_TRAIN_LAYERS,
                                 "batch": 2, "seq": CUT_TRAIN_SEQ},
                       "checkpoint": f"{CUT_TRAIN_ARCH} at reduced() (fp32)"}}
    log(f"data-axis parameter cuts (phase 2o): {world} ranks at (dp, tp) = {CUT_LAYOUT} "
        f"sharing one card over {collective_backend(world, 'cuda')} ({smi}); depth cut: "
        f"{CUT_SERVE_ARCH} {CUT_SERVE_LAYERS} layer, {CUT_TRAIN_ARCH} {CUT_TRAIN_LAYERS} "
        "layers (published widths)")
    # (a) kimi-k2 serve, then the unsharded run after the ranks exit
    serve = MESH_SPAWN(cut_rank, world, "cuda", args=(CUT_LAYOUT, "serve", None))
    t_a = time.perf_counter() - t0
    want = _cut_serve_unsharded(dev)
    errs = []
    for r in serve:
        a = r["serve"]
        errs.append(_cut_close(CUT_SERVE_ARCH, r, a, want))
        dp, tp = CUT_LAYOUT
        cfg = _cut_cfg(CUT_SERVE_ARCH, CUT_SERVE_LAYERS)
        whole_ff = 3 * cfg.moe.n_experts // tp * cfg.d_model * cfg.moe.d_ff * \
            torch.empty((), dtype=cfg.torch_dtype).element_size()
        if a["expert_ff_bytes"] * dp != whole_ff or a["wq"][0] * dp != cfg.d_model:
            raise RuntimeError(f"phase 2o (a) rank {r['rank']}: expert bytes "
                               f"{a['expert_ff_bytes']} (want {whole_ff // dp}), wq {a['wq']}")
        if max(a["peak_gb"], a["init_peak_gb"]) > CUT_RANK_GB or \
                a["resident_after_prefill_gb"] > 1.0:
            raise RuntimeError(f"phase 2o (a) rank {r['rank']}: peak {a['peak_gb']:.2f} GB, "
                               f"init {a['init_peak_gb']:.2f} GB, "
                               f"{a['resident_after_prefill_gb']:.2f} GB beside the shards and "
                               "the cache after the layer")
        log(f"  (a) rank {r['rank']} {r['coords']}: {a['param_bytes'] / 1e9:.3f} GB of weights "
            f"(expert-ff {a['expert_ff_bytes'] / 1e9:.3f} GB, w_up {a['w_up']}, wq {a['wq']}); "
            f"max_memory_allocated {a['peak_gb']:.2f} GB (init {a['init_peak_gb']:.2f} GB), "
            f"{a['resident_after_prefill_gb']:.3f} GB beside shards and cache after the "
            f"prefill; prefill 1 x {CUT_SERVE_SEQ} {a['prefill_s']:.2f} s, decode ms "
            + ", ".join(f"{t:.0f}" for t in a["decode_ms"]))
    log(f"  (a) check: {CUT_SERVE_ARCH} at (2, 2) vs whole on the card "
        f"({want['param_bytes'] / 1e9:.2f} GB, peak {want['peak_gb']:.2f} GB): logits within "
        f"{CUT_TOL} of the row max (max {max(errs):.2e}), greedy tokens equal")
    report["serve"] = {"ranks": [{k: v for k, v in r["serve"].items()
                                  if k not in ("prefill", "decode", "first")} | {
                                      "rank": r["rank"], "coords": r["coords"]} for r in serve],
                       "unsharded": {"param_bytes": want["param_bytes"],
                                     "peak_gb": want["peak_gb"]},
                       "max_err": max(errs), "wall_s": t_a}
    del want
    # (c) the dry run of the same cell at (2, 2), no card
    t1 = time.perf_counter()
    dry = DRY.trace_cell(CUT_SERVE_ARCH, "prefill_32k", CUT_LAYOUT, layers=CUT_SERVE_LAYERS,
                         batch_size=2, seq=CUT_SERVE_SEQ)
    held = {r["serve"]["param_bytes"] for r in serve}
    if held != {dry["memory"]["argument_parts"]["params"]}:
        raise RuntimeError(f"phase 2o (c): the dry run's parameter bytes "
                           f"{dry['memory']['argument_parts']} vs the ranks' {held}")
    log(f"  (c) dry run of {CUT_SERVE_ARCH} prefill 2 x {CUT_SERVE_SEQ}, depth "
        f"{CUT_SERVE_LAYERS}, at {CUT_LAYOUT} (fake {dry['device']} tensors): parameter bytes "
        f"{dry['memory']['argument_parts']['params']} == each rank's resident bytes in (a); "
        f"{dry['flops_per_device'] / 1e9:.1f} GFLOP, {dry['bytes_per_device'] / 1e9:.2f} GB, "
        f"collectives {dry['collectives']['total_bytes'] / 1e9:.2f} GB per rank, modelled "
        f"temp {dry['memory']['temp_size'] / 1e9:.2f} GB ({time.perf_counter() - t1:.1f} s)")
    report["dryrun"] = dict(dry)
    # (b) moonshot training, the reduced() cases and the checkpoint
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="cut_ckpt_", dir=str(ROOT / "chiprun_out"))
    t2 = time.perf_counter()
    train = MESH_SPAWN(cut_rank, world, "cuda", args=(CUT_LAYOUT, "train", ckpt))
    resumed = MESH_SPAWN(cut_rank, 2, "cuda", args=((1, 2), "resume", ckpt))
    t_b = time.perf_counter() - t2
    want = _cut_train_unsharded(dev)
    losses = [r["train"]["loss"] for r in train]
    if any(l != losses[0] for l in losses):
        raise RuntimeError(f"phase 2o (b): the ranks report other losses {losses}")
    for r in train:
        b = r["train"]
        d = max(abs(x - y) / abs(y) for x, y in zip(b["loss"], want["loss"]))
        if d > CUT_LOSS_TOL or b["optimizer"] != "AdamW":
            raise RuntimeError(f"phase 2o (b) rank {r['rank']}: losses {b['loss']} vs the "
                               f"unsharded {want['loss']} ({d:.2e} > {CUT_LOSS_TOL})")
        if b["k6_launches"] == 0 or b["k6_tc_launches"] != b["k6_launches"] \
                or b["peak_gb"] > CUT_RANK_GB:
            raise RuntimeError(f"phase 2o (b) rank {r['rank']}: K6 {b['k6_launches']} "
                               f"({b['k6_tc_launches']} tc), peak {b['peak_gb']:.2f} GB")
        k6 = r["k6"][CUT_TRAIN_ARCH]
        if k6["route"] != "tc":
            raise RuntimeError(f"phase 2o (b) rank {r['rank']}: K6 on the {k6['route']} route")
        log(f"  (b) rank {r['rank']} {r['coords']}: {CUT_TRAIN_ARCH} "
            f"{b['param_bytes'] / 1e9:.3f} GB of weights (expert-ff "
            f"{b['expert_ff_bytes'] / 1e9:.3f} GB), losses "
            + ", ".join(f"{x:.4f}" for x in b["loss"]) + " (unsharded "
            + ", ".join(f"{x:.4f}" for x in want["loss"]) + f"; {d:.2e} rel), step ms "
            + ", ".join(f"{t:.0f}" for t in b["step_ms"]) + f", peak {b['peak_gb']:.2f} GB; "
            f"K6 launches {b['k6_launches']} (tc), checked at q, k {k6['shapes'][:2]}: dq "
            f"{k6['rel_err'][0]:.2e} dk {k6['rel_err'][1]:.2e} dv {k6['rel_err'][2]:.2e} of "
            f"max|plain| (tol {k6['tol']}; a second call bitwise equal)")
    # the reduced() cases at (2, 2) on the card against one process on the CPU
    from repro_torch.serving.api import MeshConfig as _MC
    one = _MC(mesh_shape=(1, 1)).build()
    rerr = {}
    for label in CUT_REDUCED:
        cfg, whole, toks, batch = _reduced_case(label)
        ref = _lm_steps_cpu(whole, one, toks, batch)
        e = 0.0
        for r in train:
            got, dd = r["reduced"][label], r["coords"]["data"]
            e = max(e, _np_close(f"phase 2o {label} prefill", got["prefill"],
                                 ref["prefill"][dd:dd + 1]))
            for i, ((gl, gt), (wl, wt)) in enumerate(zip(got["decode"], ref["decode"])):
                e = max(e, _np_close(f"phase 2o {label} decode {i}", gl, wl[dd:dd + 1]))
                if not np.array_equal(gt, wt[dd:dd + 1]):
                    raise RuntimeError(f"phase 2o {label} decode {i}: tokens {gt} vs "
                                       f"{wt[dd:dd + 1]}")
            for k in ("loss", "gnorm"):
                dk = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got[k], ref[k]))
                if dk > TRAIN_TOL:
                    raise RuntimeError(f"phase 2o {label}: {k} {got[k]} vs the CPU's {ref[k]}")
                e = max(e, dk)
        rerr[label] = e
    log(f"  check: {len(CUT_REDUCED)} reduced() MoE cases (fp32) at {CUT_LAYOUT} on the card "
        f"== one process on the CPU: logits within rtol=atol={LM_TOL}, tokens equal, losses "
        f"and norms within {TRAIN_TOL} (max {max(rerr.values()):.2e})")
    # the checkpoint: two steps at (2, 2), the third at (1, 2) from it
    cfg, whole, batches = _cut_ckpt_case()
    with CTX.axes(one):
        _, _, cpu = TTL.train(whole, STEPS.lm_loss, iter(batches), TTL.TrainConfig(
            steps=3, optimizer=cfg.optimizer, lr=1e-3))
    got = train[0]["ckpt"] + resumed[0]["resumed"]
    for k in ("loss", "gnorm"):
        dk = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for a, b in zip(got, cpu))
        if len(got) != 3 or dk > TRAIN_TOL or any(r["resumed"] != resumed[0]["resumed"]
                                                 for r in resumed):
            raise RuntimeError(f"phase 2o checkpoint: {got} vs the CPU's {cpu}")
    shutil.rmtree(ckpt)
    log(f"  checkpoint: {CUT_TRAIN_ARCH} reduced() written at {CUT_LAYOUT} after step 2, "
        "restored at (1, 2) for step 3: losses " + ", ".join(f"{h['loss']:.5f}" for h in got)
        + " == the CPU's 3 steps within " + f"{TRAIN_TOL}")
    report["train"] = {"ranks": [{k: v for k, v in r.items() if k not in ("reduced",)}
                                 for r in train],
                       "unsharded": want, "reduced_err": rerr, "checkpoint": got,
                       "wall_s": t_b}
    log(f"  phase 2o {time.perf_counter() - t0:.1f} s ((a) ranks {t_a:.1f} s, (b) ranks "
        f"{t_b:.1f} s, each with its ranks' start)")
    return report


# ---------------------------------------------------------------- phase 2p
def hillclimb_phase(smi):
    """Phase 2p (the module docstring).  -> its report."""
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch import perf_iterations as PI

    t0 = time.perf_counter()
    log(f"the hillclimbs (phase 2p): four cells modelled at H100 SXM peaks on 256 "
        f"cards (never measured), three probes traced on fake {DRY.fake_device()} tensors "
        f"({smi})")
    if DRY.fake_device() != "cuda":
        raise RuntimeError("phase 2p: the probes must trace fake cuda tensors")
    with open(ROOT / "results" / "perf_torch" / "hillclimbs.json") as f:
        committed = json.load(f)
    out = PI.main(probe=True, out_dir=str(ROOT / "chiprun_out" / "perf_torch"))
    report = {"nvidia_smi": smi, "cells": out}
    if list(out) != list(committed):
        raise RuntimeError(f"phase 2p: cells {list(out)} vs the record's {list(committed)}")
    n_probes = 0
    for cell, rec in out.items():
        want_its = committed[cell]["iterations"]
        if len(rec["iterations"]) != len(want_its):
            raise RuntimeError(f"phase 2p {cell}: {len(rec['iterations'])} iterations vs "
                               f"the record's {len(want_its)}")
        for it, want in zip(rec["iterations"], want_its):
            if "terms" in it:
                bad = [k for k, v in it["terms"].items() if not (
                    v == want["terms"][k] if isinstance(v, str) else
                    math.isclose(v, want["terms"][k], rel_tol=1e-12))]
                if bad or it.get("confirmed") != want.get("confirmed"):
                    raise RuntimeError(f"phase 2p {cell} [{it['iter']}]: {bad} differ "
                                       "from the record")
                continue
            p, w = it["probe"], want["probe"]
            same = ("mesh_shape", "cuts", "arg_bytes", "flops_per_device",
                    "collective_counts", "collective_bytes")
            bad = [k for k in same if p[k] != w[k]]
            if p["device"] != "cuda" or bad or \
                    abs(p["bytes_per_device"] / w["bytes_per_device"] - 1) > 1e-3 or \
                    abs(p["temp_gb"] - w["temp_gb"]) > 0.01 * w["temp_gb"] + 0.01:
                raise RuntimeError(f"phase 2p {cell} probe on {p['device']}: {bad} differ; "
                                   f"{p} vs the record's {w}")
            n_probes += 1
            log(f"  {cell} probe at {tuple(p['mesh_shape'])} on fake {p['device']} tensors, "
                f"{p['trace_s']} s: argument bytes {p['arg_bytes']}, "
                f"{p['flops_per_device'] / 1e12:.1f} TFLOP, collectives "
                f"{p['collective_bytes'] / 1e9:.2f} GB ({p['collective_counts']}) as "
                f"recorded; bytes {p['bytes_per_device'] / 1e12:.4f} TB "
                f"({100 * (p['bytes_per_device'] / w['bytes_per_device'] - 1):+.4f}%), "
                f"modelled temp {p['temp_gb']} GB (record {w['temp_gb']})")
    if n_probes != 3:
        raise RuntimeError(f"phase 2p: {n_probes} probes, 3 expected")
    report["wall_s"] = time.perf_counter() - t0
    log(f"  check: three probes and every cell's terms as recorded; phase 2p "
        f"{report['wall_s']:.1f} s")
    return report


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
    designs = threading.Thread(target=BD.build)    # B5's first design, for its turns
    designs.start()
    build_s = PHASE_S["1 build"] = _build.build()
    designs.join()
    BD.library_path().stat()                       # raises where that build failed
    log(f"kernel build: {build_s:.1f} s (parallel nvcc, sm_90a)")
    log(f"device_ms marker kernel: {_marker_name()}")   # read while the profiler loses nothing
    for name in _build.SOURCES:
        text = _build.library_path(name).with_suffix(".log")
        for line in (text.read_text().splitlines() if text.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    report, records, closed = serving_phases(args, dev)

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

    # ---- phase 2l: tensor parallelism, two ranks on the card ----
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["tp"] = tp_phase(args, closed, smi)
    PHASE_S["2l"] = time.perf_counter() - t0

    # ---- phase 2m: the LM archs' steps at tp = 2 and dp = 2, two ranks on the card ----
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["tp_lm"] = lm_mesh_phase(smi)
    PHASE_S["2m"] = time.perf_counter() - t0

    # ---- phase 2n: recsys and SchNet on a mesh, the kv-split LM layouts ----
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["mesh_families"], mesh_records = mesh_families_phase(smi, dev)
    records = records + mesh_records
    report["kernels"] = records
    PHASE_S["2n"] = time.perf_counter() - t0

    # ---- phase 2o: the data-axis parameter cuts, four ranks on the card ----
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["data_cuts"] = data_cut_phase(smi, dev)
    PHASE_S["2o"] = time.perf_counter() - t0

    # ---- phase 2p: the hillclimbs, their probes on fake cuda tensors ----
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["hillclimb"] = hillclimb_phase(smi)
    PHASE_S["2p"] = time.perf_counter() - t0
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
