"""RcLLM system façade for the port: the offline build (both cache pools +
placement), the per-request plan / cached-KV lookup the serving path
needs, and online ranking (full / rcllm / cacheblend / epic).  The port
of `repro/core/rcllm.py`.  The offline caches' rows are also packed into
one pool on the model's device (`core.cache_rows`), and a request's
cached KV is its plan's block table into that pool.

Under tensor parallelism each rank builds its own system from the same
seed (`make_system(mesh=)`): the same catalog, placement and plans on
every rank, the model and the cached rows holding the rank's kv heads.
The semantic cache matches tokens on the whole embedding, which every
rank keeps on the host."""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core import assembly as ASM
from repro_torch.core import baselines as BASE
from repro_torch.core import engine as ENG
from repro_torch.core import item_cache as IC
from repro_torch.core import placement as PL
from repro_torch.core import scheduler as SCH
from repro_torch.core import semantic_cache as SC
from repro_torch.core.cache_rows import CacheRows
from repro_torch.data import synth as SY
from repro_torch.models.transformer import Transformer, init_params


@dataclass
class RcLLMSystem:
    cfg: LMConfig
    model: Transformer
    catalog: SY.Catalog
    instruction: np.ndarray
    token_embed: np.ndarray
    semantic: Optional[SC.SemanticCache]
    item_store: Optional[IC.ItemKVStore]
    placement: PL.Placement
    rows: Optional[CacheRows] = None        # both caches' rows, on the device

    # ----------------------------- offline -----------------------------
    @staticmethod
    def build(model: Transformer, cfg: LMConfig, catalog: SY.Catalog,
              review_corpus: List[np.ndarray], history_requests,
              k_instances: int = 4, n_instruction: int = 207,
              item_coverage: float = 1.0, lsh_bits: int = 12,
              seed: int = 0, token_embed: Optional[np.ndarray] = None) -> "RcLLMSystem":
        """`token_embed`: the whole embedding (fp32 numpy), which a model
        split over ranks does not hold; default: the model's."""
        instruction = SY.make_instruction(n_instruction, catalog.vocab_size)
        if token_embed is None:
            model.whole("the semantic cache's token embedding")
            token_embed = model.embed.detach().float().cpu().numpy()

        # placement from the historical request log (Algorithm 1)
        req_items = [r.candidate_items for r in history_requests]
        placement = PL.place(catalog.n_items, req_items, k_instances)

        # batched, length-bucketed offline KV materialization
        # the model's own kv heads: a shard's rows hold its heads only
        rows = CacheRows(cfg.n_layers, model.layers[0].wk.shape[1], cfg.resolved_head_dim)
        corpus_kv = ENG.precompute_kv_batch(model, cfg, review_corpus)
        semantic = SC.build_semantic_cache(
            review_corpus, token_embed, n_bits=lsh_bits, seed=seed)
        SC.materialize_kv(semantic, review_corpus,
                          lambda toks, _i=None: None,
                          kv_by_doc=lambda i: corpus_kv[i], rows=rows)

        item_docs = [np.concatenate([[SY.ITEM_SEP], t]).astype(np.int32)
                     for t in catalog.item_tokens]
        item_kv = ENG.precompute_kv_batch(model, cfg, item_docs)
        item_store = IC.build_item_store(
            item_docs, placement,
            kv_of_sequence=None, kv_list=item_kv,
            coverage=item_coverage, seed=seed, rows=rows)
        return RcLLMSystem(cfg=cfg, model=model, catalog=catalog,
                           instruction=instruction, token_embed=token_embed,
                           semantic=semantic, item_store=item_store,
                           placement=placement, rows=rows.to_device(model.device))

    # ----------------------------- online ------------------------------
    def plan_for(self, request: SY.Request, instance: int = 0
                 ) -> ASM.AssemblyPlan:
        tokens, kind, ids = request.prompt_segments(self.catalog,
                                                    self.instruction)
        return ASM.build_plan(
            tokens, kind, ids,
            marker_mask=request.history_marker_mask,
            item_store=self.item_store, semantic=self.semantic,
            token_embed=self.token_embed, instance=instance)

    def cached_kv(self, plan: ASM.AssemblyPlan, instance: int = 0):
        """A plan's cached KV on one instance, as (block_table, positions,
        have) into `self.rows` (see `assembly.plan_block_table`)."""
        return ASM.plan_block_table(plan, self.item_store, self.semantic,
                                    instance)

    def best_instance(self, request: SY.Request) -> int:
        """Affinity routing (idle cluster → pure cache affinity)."""
        return int(np.argmax(SCH.hit_vector(request.candidate_items,
                                        self.placement)))

    def rank(self, request: SY.Request, method: str = "rcllm",
             sel: Optional[ENG.SelectiveConfig] = None,
             instance: Optional[int] = None
             ) -> Tuple[np.ndarray, Optional[ENG.EngineStats]]:
        """Score one request's candidates by `method`: "full" (the
        Full-Recompute oracle), "rcllm" (selective prefill), "cacheblend"
        or "epic" (`core.baselines`, CacheBlend's budget the mean of
        `sel`'s two).  -> (the final position's logits at the candidate
        slots `SY.SLOT_BASE : SY.SLOT_BASE + n_candidates` (host fp32),
        stats; None for "full")."""
        sel = sel or ENG.SelectiveConfig()
        if instance is None:
            instance = self.best_instance(request)
        slots = slice(SY.SLOT_BASE, SY.SLOT_BASE + len(request.candidate_items))
        if method == "full":
            tokens, _, _ = request.prompt_segments(self.catalog, self.instruction)
            return ENG.full_prefill_logits(self.model, self.cfg, tokens)[slots], None
        plan = self.plan_for(request, instance)
        table, positions, have = self.cached_kv(plan, instance)
        if method == "rcllm":
            logits, stats = ENG.selective_prefill_logits(
                self.model, self.cfg, plan, table, positions, have, sel, self.rows)
        elif method == "cacheblend":
            logits, stats = BASE.cacheblend_prefill_logits(
                self.model, self.cfg, plan, table, have, self.rows,
                r=(sel.r_item + sel.r_rev) / 2)
        elif method == "epic":
            logits, stats = BASE.epic_prefill_logits(self.model, self.cfg, plan, table,
                                                     have, self.rows)
        else:
            raise ValueError(f"unknown ranking method {method!r}")
        return logits[slots], stats


def synthetic_world(profile_name: str = "amazon", n_items: int = 300,
                    n_requests_hist: int = 200, seed: int = 0):
    """The small catalog / review pool / history log every system here is
    built over (numpy, seeded exactly as the JAX package's
    `make_tiny_system`).  -> (profile, catalog, review pool, history,
    review corpus: one history per distinct user)."""
    prof = dataclasses.replace(SY.PROFILES[profile_name], n_items=n_items,
                               n_clusters=max(6, n_items // 50),
                               mean_item_tokens=24, mean_review_tokens=20)
    catalog = SY.make_catalog(prof, vocab_size=4096, seed=seed)
    pool = SY.make_review_pool(vocab_size=4096, n_phrases=120, seed=seed + 1)
    hist = SY.make_trace(catalog, pool, prof, n_requests=n_requests_hist,
                         qps=10.0, n_users=40, n_candidates=8,
                         reviews_per_user=2, seed=seed + 2)
    corpus = []
    seen = set()
    for r in hist:
        if r.user_id not in seen:
            corpus.append(r.history_tokens)
            seen.add(r.user_id)
    return prof, catalog, pool, hist, corpus


def make_system(cfg: LMConfig, device="cuda", profile_name: str = "amazon",
                n_items: int = 300, k_instances: int = 4,
                n_requests_hist: int = 200, seed: int = 0,
                item_coverage: float = 1.0,
                model: Optional[Transformer] = None, mesh=None):
    """An RcLLM system around `cfg` on `device`: random weights from a
    seeded `torch.Generator` on that device (or the given whole `model`),
    then the offline build.  With a `mesh` whose model axis has more than
    one rank, this rank's system: the weights cut to its shard
    (`sharding.specs`: drawn one whole parameter at a time, or cut out of
    `model`), and the offline build run on its heads, inside
    ``sharding.ctx.axes(mesh)``.  -> (system, review pool, profile,
    history)."""
    from repro_torch.sharding import ctx as CTX
    from repro_torch.sharding import specs as SPECS

    prof, catalog, pool, hist, corpus = synthetic_world(
        profile_name, n_items, n_requests_hist, seed)
    token_embed = None
    split = mesh is not None and mesh.shape["model"] > 1
    if split:
        SPECS.check_serving_divisibility(cfg, mesh)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        if split:
            model, token_embed = SPECS.init_sharded_params(cfg, mesh, gen, device)
        else:
            model = init_params(cfg, gen, device=device)
    elif split:
        token_embed = model.embed.detach().float().cpu().numpy()
        model = SPECS.shard_lm_params(model, cfg, mesh, device=device)
    with CTX.axes(mesh) if mesh is not None else contextlib.nullcontext():
        system = RcLLMSystem.build(model, cfg, catalog, corpus, hist,
                                   k_instances=k_instances, item_coverage=item_coverage,
                                   seed=seed, token_embed=token_embed)
    return system, pool, prof, hist


def tiny_config(n_layers: int = 4, d_model: int = 64, n_heads: int = 4,
                n_kv_heads: int = 2) -> LMConfig:
    """The JAX package's `make_tiny_system` model (fp32, head_dim 16,
    attention chunks of 64, no remat)."""
    return LMConfig(name="rcllm-tiny", n_layers=n_layers, d_model=d_model,
                    n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=16,
                    d_ff=128, vocab_size=4096, mlp_type="swiglu",
                    dtype="float32", attn_q_chunk=64, attn_kv_chunk=64, remat=False)


def make_tiny_system(profile_name: str = "amazon", n_items: int = 300,
                     k_instances: int = 4, n_requests_hist: int = 200,
                     seed: int = 0, n_layers: int = 4, d_model: int = 64,
                     item_coverage: float = 1.0, n_heads: int = 4,
                     n_kv_heads: int = 2, device="cuda",
                     model: Optional[Transformer] = None, mesh=None):
    """A small end-to-end RcLLM instance (the JAX package's
    `make_tiny_system` shapes).  Pass `model` to serve given weights —
    the parity tests pass the JAX init converted by
    `models.convert.params_from_numpy`."""
    cfg = tiny_config(n_layers, d_model, n_heads, n_kv_heads)
    return make_system(cfg, device=device, profile_name=profile_name,
                       n_items=n_items, k_instances=k_instances,
                       n_requests_hist=n_requests_hist, seed=seed,
                       item_coverage=item_coverage, model=model, mesh=mesh)
