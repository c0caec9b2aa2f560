"""Typed serving API of the port — the subset of the JAX package's
`serving/api.py` that the single-instance path needs under the wave and
chunked schedulers: `ServeConfig` with the block store's knobs
(`kv_reuse`, `StoreConfig`), greedy/temperature sampling, stop
sequences, and the sliced builders (engine -> backend -> batcher)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

ENGINES = ("torch",)
MODES = ("rcllm", "full")
SCHEDS = ("wave", "chunked")


@dataclass(frozen=True)
class StoreConfig:
    """How the shared block store holds its payloads and what happens to
    evicted blocks.

    ``kv_store_dtype='int8'`` quantizes user/item block payloads to
    symmetric per-(row, kv-head)-scaled int8 (the arena holds the
    dequantized bytes).  ``spill_mb`` bounds a host-RAM spill tier that
    device-tier evictions demote to instead of dropping; 0 drops.  The
    default ``StoreConfig()`` is disabled: fp32 payloads, drop-on-evict.
    The reference's ``prefetch_pages_per_tick`` budgets promotions the
    cluster router hints; it comes with the cluster (not ported)."""

    kv_store_dtype: str = "fp32"
    spill_mb: int = 0

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"invalid StoreConfig: {msg}")

        if self.kv_store_dtype not in ("fp32", "int8"):
            bad(f"kv_store_dtype={self.kv_store_dtype!r} not in ('fp32', 'int8')")
        if self.spill_mb < 0:
            bad(f"spill_mb={self.spill_mb} must be >= 0")

    @property
    def enabled(self) -> bool:
        """Does this config change the store at all?"""
        return self.kv_store_dtype != "fp32" or self.spill_mb > 0


@dataclass(frozen=True)
class ServeConfig:
    """Every serving knob the port has, validated once.  ``engine`` is
    the port's own name; the cluster and mesh knobs of the reference are
    not ported yet.  ``kv_reuse`` turns on the shared block store and
    ``store`` configures its tiers.  ``step_tokens=None`` resolves to
    ``max(4 * chunk_tokens, 512)`` (`resolved_step_tokens`), the chunked
    scheduler's default budget."""

    engine: str = "torch"
    mode: str = "rcllm"
    sched: str = "wave"
    kv_reuse: bool = False
    chunk_tokens: int = 128
    step_tokens: Optional[int] = None
    max_batch_tokens: int = 4096
    max_decode_batch: int = 64
    page_size: int = 16
    n_pages: int = 512
    decode_steps: int = 4
    r_item: float = 0.3
    r_rev: float = 0.3
    store: StoreConfig = field(default_factory=StoreConfig)

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"invalid ServeConfig: {msg}")

        for name, val, choices in (
            ("engine", self.engine, ENGINES),
            ("mode", self.mode, MODES),
            ("sched", self.sched, SCHEDS),
        ):
            if val not in choices:
                bad(f"{name}={val!r} not in {choices}")
        if self.kv_reuse and self.mode != "rcllm":
            bad(f"kv_reuse=True needs mode='rcllm' (the shared block store holds "
                f"beyond-prefix blocks), got mode={self.mode!r}")
        if self.sched == "chunked" and self.mode != "rcllm":
            bad("sched='chunked' drives the beyond-prefix selective prefill; "
                f"mode={self.mode!r} has no chunk-resumable path")
        if self.chunk_tokens < 1:
            bad(f"chunk_tokens={self.chunk_tokens} must be >= 1")
        if self.step_tokens is not None and self.step_tokens < 1:
            bad(f"step_tokens={self.step_tokens} must be >= 1 (or None)")
        if self.page_size < 1 or self.n_pages < 2:
            bad(f"page_size={self.page_size} must be >= 1 and "
                f"n_pages={self.n_pages} >= 2 (page 0 is the scratch page)")
        if self.decode_steps < 1:
            bad(f"decode_steps={self.decode_steps} must be >= 1")
        if not (0.0 <= self.r_item <= 1.0 and 0.0 <= self.r_rev <= 1.0):
            bad(f"r_item={self.r_item}/r_rev={self.r_rev} must be in [0, 1]")
        if not isinstance(self.store, StoreConfig):
            bad(f"store must be a StoreConfig, got {type(self.store).__name__}")
        if self.store.enabled and not self.kv_reuse:
            bad("store tiering configures the shared block store: set "
                "kv_reuse=on (the default store config is a no-op without it)")

    @property
    def resolved_step_tokens(self) -> int:
        if self.step_tokens is not None:
            return self.step_tokens
        return max(4 * self.chunk_tokens, 512)


# ------------------------------------------------------------- sampling
@dataclass(frozen=True)
class SamplingParams:
    """Per-sequence sampling.  ``temperature == 0`` is greedy argmax (the
    default, and the mode the parity tests pin); otherwise the token is
    drawn from softmax(logits / temperature), optionally top-k truncated,
    with a per-request numpy PRNG seeded from ``seed``."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature={self.temperature} must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"top_k={self.top_k} must be >= 0")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def sample_token(logits: np.ndarray, params: SamplingParams = GREEDY,
                 rng: Optional[np.random.Generator] = None) -> int:
    """One token from one row of logits under `params`."""
    logits = np.asarray(logits, np.float64)
    if params.greedy or rng is None:
        return int(np.argmax(logits))
    z = logits / params.temperature
    if params.top_k and params.top_k < len(z):
        kth = np.partition(z, -params.top_k)[-params.top_k]
        z = np.where(z >= kth, z, -np.inf)
    z = z - np.max(z)
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


def match_stop(generated: Sequence[int], stops: Sequence[Tuple[int, ...]]) -> bool:
    """Does the generated stream end with any stop sequence?"""
    for s in stops:
        n = len(s)
        if n and len(generated) >= n and tuple(generated[-n:]) == tuple(s):
            return True
    return False


# ------------------------------------------------------- sliced builders
def build_engine(model, lm_cfg, config: ServeConfig, pool=None, sel=None,
                 cache=None):
    """`BatchEngine` on the model's device from the config's pool and
    reuse slices; `cache` is the device pool of cached rows
    (`RcLLMSystem.rows`) that rcllm requests' block tables index."""
    from repro_torch.core import engine as ENG
    from repro_torch.serving.batch_engine import BatchEngine
    from repro_torch.serving.block_store import SharedBlockStore
    from repro_torch.serving.kv_pool import pool_for

    if pool is None:
        pool = pool_for(lm_cfg, page_size=config.page_size,
                        n_pages=config.n_pages, device=model.device)
    if sel is None:
        sel = ENG.SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev)
    store = None
    if config.kv_reuse:
        store = SharedBlockStore(
            pool, kv_store_dtype=config.store.kv_store_dtype,
            spill_mb=config.store.spill_mb)
    return BatchEngine(model, lm_cfg, pool=pool, sel=sel, cache=cache,
                       chunk_tokens=config.chunk_tokens, store=store)


def build_backend(engine, config: ServeConfig, plans=None, reuse=None):
    """`TorchEngineBackend` over a built engine (mode slice); `reuse` is
    read only by a store-backed engine."""
    from repro_torch.serving.batching import TorchEngineBackend

    return TorchEngineBackend(engine, mode=config.mode, plans=plans, reuse=reuse)


def build_batcher(backend, config: ServeConfig):
    """`ContinuousBatcher` over a backend (scheduler slice)."""
    from repro_torch.serving.batching import ContinuousBatcher

    return ContinuousBatcher(backend, max_batch_tokens=config.max_batch_tokens,
                             max_decode_batch=config.max_decode_batch,
                             sched=config.sched, chunk_tokens=config.chunk_tokens,
                             step_tokens=config.resolved_step_tokens)
