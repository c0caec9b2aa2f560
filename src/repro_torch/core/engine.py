"""RcLLM local execution engine (§III-C2b, §III-C3) — the port of the JAX
package's `core/engine.py`.

Layer 0 computes full attention for every token and scores tokens with
Eq. 3

    S_i = (1−λ)·‖A_i‖₁ + λ·Σ_{M∈{K,V}} ‖M_i^new − M_i^cached‖₁

Heavy hitters, instruction tokens, instance-specific markers, cache misses
and the trailing local window are recomputed exactly through layers
1..L−1; every other token's deeper-layer K/V comes from the assembled
cache blocks (pre-RoPE, rotated to the request position).

Attention inside the engine goes through the kernel wrappers: flash
attention (`kernels.flash_attention`) in the offline KV build and full
prefill, selective attention (`kernels.selective_attention`) in layers
1..L−1.  Layer 0 needs the materialised probabilities for Eq. 3, so it
runs plain torch attention, as the JAX package runs jnp there.  The
config's `attn_backend` picks the kernels or their plain PyTorch versions
above the wrappers (`attn_uses_kernels`), and `decode_kernel` the serving
decode's (`decode_uses_paged`); the wrappers themselves still launch on a
CUDA tensor and run the plain version on a CPU one.  The
cached KV stays on the model's device (`core.cache_rows`): a request
brings a block table into that pool, and the block-gather kernel
(`kernels.block_gather`, bound to the pools once per batch or request:
`cache_gather`) assembles the rows: copied for layer 0's Eq. 3
divergence, and rotated to the request positions for layers 1..L−1, all
of them in one launch per selective pass.  Only tables, positions, masks
and logits cross between host and device; plans and the Eq. 3 selection
stay numpy, as in the reference.

A request whose instruction rows are shared by the serving block store's
prefix tier carries them in the same block table: its entries from
`cache.n_rows` on address the serving arena's layer planes (`shared`,
`kv_pool.PagedKVPool.planes`), which the block-gather kernel reads as its
second pool.

Under tensor parallelism (a model split over the ranks of a mesh's model
axis, `models.transformer`) every function here runs on the rank's heads
unchanged, the kernels included, at the shard's shapes.  Eq. 3 is a
reduction over heads: layer 0's attention mass is averaged and its K/V
divergence summed over every rank's heads (`sharding.ctx`) before
`select_recompute`, so every rank selects from the same values and the
recompute mask is the same on every rank (`ctx.check` compares it when
the mesh checks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core.assembly import FROM_ITEM, FROM_SEMANTIC, AssemblyPlan
from repro_torch.core.cache_rows import ZERO_ROW, CacheRows
from repro_torch.kernels.block_gather.ops import PlainGather, PoolGather
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.flash_attention.ref import mha_flash_ref
from repro_torch.kernels.selective_attention.ops import (block_liveness,
                                                         selective_mha)
from repro_torch.kernels.selective_attention.ref import selective_mha_ref
from repro_torch.models import layers as L
from repro_torch.models.transformer import Block, Transformer
from repro_torch.models.transformer import forward as model_forward
from repro_torch.sharding import ctx as CTX

# Tile sizes of the selective kernel's block-liveness map: the engine's
# shape buckets are multiples of 64, as in the JAX package.
LIVE_Q_BLOCK = 64
LIVE_KV_BLOCK = 64


def attn_uses_kernels(cfg: LMConfig, device) -> bool:
    """Resolve `cfg.attn_backend` for a model on `device`: does the serving
    path run the hand-written kernels of the offline build, the cached-KV
    assembly and the selective layers (True), or their plain PyTorch
    versions (False)?  "auto" follows the device; "cuda" on a model that
    is not on a CUDA device raises.  `LMConfig` validated the value."""
    on_card = torch.device(device).type == "cuda"
    if cfg.attn_backend == "auto":
        return on_card
    if cfg.attn_backend == "cuda" and not on_card:
        raise ValueError(f"attn_backend='cuda' runs the kernels on the card: the model is "
                         f"on {device} (use 'plain' or 'auto')")
    return cfg.attn_backend == "cuda"


def decode_uses_paged(cfg: LMConfig, device) -> bool:
    """Resolve `cfg.decode_kernel` for the serving decode step of a model
    on `device`: does it read K/V through the paged-decode kernel (True)
    or through that kernel's plain version, which gathers the pages
    (False)?  "auto" follows the attention backend (`attn_uses_kernels`);
    "paged" and "gather" pin either path whatever the backend, so a
    decode-only difference cannot hide behind a prefill one.  "paged" on
    a model that is not on a CUDA device raises."""
    if cfg.decode_kernel == "gather":
        return False
    if cfg.decode_kernel == "paged":
        if torch.device(device).type != "cuda":
            raise ValueError(f"decode_kernel='paged' runs the kernel on the card: the model "
                             f"is on {device} (use 'gather' or 'auto')")
        return True
    return attn_uses_kernels(cfg, device)


@dataclass
class SelectiveConfig:
    r_item: float = 0.3               # recompute budget over item tokens
    r_rev: float = 0.3                # recompute budget over history tokens
    lam: float = 0.5                  # Eq. 3 λ (divergence weight)
    window: int = 32                  # trailing local window, always exact
    layer0_full: bool = True          # identify HH with full first layer


@dataclass
class EngineStats:
    n_tokens: int
    n_recomputed: int
    n_reused_item: int
    n_reused_semantic: int
    n_heavy_hitters: int
    layer0_full: bool
    # (n,) bool — which tokens went through layers 1..L-1 exactly; the
    # serving path uses it to scatter fresh KV over the paged pool.
    recompute_mask: Optional[np.ndarray] = None

    def recompute_fraction(self) -> float:
        return self.n_recomputed / max(self.n_tokens, 1)


def _pad_to(x: np.ndarray, n: int, fill=0):
    if len(x) >= n:
        return x[:n]
    return np.concatenate([x, np.full((n - len(x),) + x.shape[1:], fill,
                                      x.dtype)])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


# ---------------------------------------------------------------------------
# Shared building blocks
# ---------------------------------------------------------------------------

# Layer 0's pre-RoPE K/V depend on the token id alone (embedding ->
# RMSNorm -> projection), so a cached item token's layer-0 KV equals its
# fresh one and its Eq. 3 divergence is exactly 0 — if both sides compute
# it with bitwise the same arithmetic.  Eq. 3 normalises the divergence
# by its maximum, so rounding noise would otherwise be scaled up to O(1)
# and decide the recompute set.  Both the offline build and the online
# layer-0 pass therefore compute layer-0 K/V here, in products of one
# fixed shape (a matrix product's row does not depend on the other rows
# of a same-shaped product).
L0_ROWS = 64


def layer0_kv(model: Transformer, toks: torch.Tensor):
    """Pre-RoPE layer-0 (k, v) of the token ids `toks` (any shape) ->
    each toks.shape + (Hkv, Dh), bitwise the same wherever a token id
    appears."""
    cfg = model.cfg
    lp = model.layers[0]
    flat = toks.reshape(-1)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-n) % L0_ROWS))
    wk = lp.wk.reshape(cfg.d_model, -1)
    wv = lp.wv.reshape(cfg.d_model, -1)
    ks, vs = [], []
    for rows in flat.split(L0_ROWS):
        h = L.rms_norm(model.embed_tokens(rows), lp.attn_norm, cfg.norm_eps)
        ks.append(h @ wk)
        vs.append(h @ wv)
    shape = tuple(toks.shape) + tuple(lp.wk.shape[1:])
    return (torch.cat(ks)[:n].reshape(shape), torch.cat(vs)[:n].reshape(shape))


def full_attn(q, k, v, q_pos, k_pos, k_valid=None):
    """Plain single-request attention that also returns the probabilities
    (layer-0 Eq. 3 scoring): q (Sq, Hq, Dh) vs k/v (Sk, Hkv, Dh).
    -> (o (Sq, Hq, Dh), p (Hkv, G, Sq, Sk) fp32)."""
    Hq, Hkv = q.shape[1], k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qr = q.reshape(q.shape[0], Hkv, G, -1)
    s = torch.einsum("qhgd,khd->hgqk", qr.float(), k.float()) * scale
    mask = q_pos[:, None] >= k_pos[None, :]
    if k_valid is not None:
        mask = mask & k_valid[None, :]
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("hgqk,khd->qhgd", p.to(v.dtype), v)
    return o.reshape(q.shape[0], Hq, -1), p


def _layer_step(x, lp: Block, cfg: LMConfig, o):
    """Residual updates after attention output `o` (.., H, Dh); a shard's
    partial products are summed over the model axis."""
    x = x + CTX.all_reduce(torch.einsum("...he,hed->...d", o, lp.wo))
    return x + CTX.all_reduce(L.mlp_apply(L.rms_norm(x, lp.mlp_norm, cfg.norm_eps),
                                          lp.mlp, cfg.mlp_type))


# ---------------------------------------------------------------------------
# Offline KV build and full prefill (flash-attention kernel)
# ---------------------------------------------------------------------------

@torch.no_grad()
def batched_forward(model: Transformer, toks: torch.Tensor,
                    valid: torch.Tensor, kernels: bool):
    """Padded (N, S) forward pass.  -> (x, k_all, v_all): the final
    residual stream (N, S, D) plus the pre-RoPE per-layer caches
    (N, S, L, Hkv, Dh).  Invalid keys are masked out via `valid`.
    `kernels` False runs the flash kernel's plain version on any device."""
    cfg = model.cfg
    flash = mha_flash if kernels else mha_flash_ref
    S = toks.shape[1]
    pos = torch.arange(S, device=toks.device)
    x = model.embed_tokens(toks)
    ks, vs = [], []
    for l, lp in enumerate(model.layers):
        h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
        q = torch.einsum("nsd,dhe->nshe", h, lp.wq)
        if l == 0:
            k_raw, v = layer0_kv(model, toks)
        else:
            k_raw = torch.einsum("nsd,dhe->nshe", h, lp.wk)
            v = torch.einsum("nsd,dhe->nshe", h, lp.wv).contiguous()
        ks.append(k_raw)
        vs.append(v)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k_raw, pos, cfg.rope_theta)
        o = flash(q, k, v, kv_valid=valid, causal=True)
        x = _layer_step(x, lp, cfg, o)
    return x, torch.stack(ks, dim=2), torch.stack(vs, dim=2)


def precompute_kv_batch(model: Transformer, cfg: LMConfig, docs,
                        bucket: int = 64):
    """Batched offline KV materialization with length bucketing.
    -> list of (S_i, L, Hkv, Dh) pre-RoPE (k, v) fp32 numpy arrays."""
    kernels = attn_uses_kernels(cfg, model.device)
    order = np.argsort([len(d) for d in docs])
    out = [None] * len(docs)
    i = 0
    while i < len(order):
        max_len = ((len(docs[order[i]]) + bucket - 1) // bucket) * bucket
        group = [j for j in order[i:i + 64]
                 if len(docs[j]) <= max_len]
        batch = np.zeros((len(group), max_len), np.int32)
        for gi, j in enumerate(group):
            batch[gi, :len(docs[j])] = docs[j]
        toks = torch.from_numpy(batch).to(model.device)
        _, k, v = batched_forward(model, toks, toks != 0, kernels)
        k, v = _host(k), _host(v)
        for gi, j in enumerate(group):
            s = len(docs[j])
            out[j] = (k[gi, :s], v[gi, :s])
        i += len(group)
    return out


@torch.no_grad()
def batched_prefill(model: Transformer, toks: np.ndarray, last_idx: np.ndarray,
                    kernels: bool):
    """Padded multi-request full prefill.  toks: (N, S); last_idx: (N,)
    index of each request's final real token; `kernels` as
    `batched_forward` takes it.  -> (logits (N, V) host fp32, pre-RoPE k,
    v (N, S, L, Hkv, Dh) on the device)."""
    dev = model.device
    t = torch.from_numpy(np.asarray(toks, np.int64)).to(dev)
    last = torch.from_numpy(np.asarray(last_idx, np.int64)).to(dev)
    S = t.shape[1]
    valid = torch.arange(S, device=dev)[None, :] <= last[:, None]
    x, k_all, v_all = batched_forward(model, t, valid, kernels)
    x_last = x[torch.arange(t.shape[0], device=dev), last]
    xf = L.rms_norm(x_last, model.final_norm, model.cfg.norm_eps)
    return _host(model.logits(xf)), k_all, v_all


def full_prefill_logits(model: Transformer, cfg: LMConfig, tokens: np.ndarray,
                        bucket: int = 128) -> np.ndarray:
    """Full-Recompute oracle: exact final-position logits (padding is
    causally invisible to the final real token)."""
    n = len(tokens)
    n_pad = ((n + bucket - 1) // bucket) * bucket
    toks = np.pad(np.asarray(tokens, np.int64), (0, n_pad - n))
    logits = model_forward(model, torch.from_numpy(toks)[None].to(model.device),
                           kernels=attn_uses_kernels(cfg, model.device))
    return _host(logits[0, n - 1])


# ---------------------------------------------------------------------------
# Selective prefill
# ---------------------------------------------------------------------------

def _pad_table(table: np.ndarray, positions: np.ndarray, n_pad: int):
    """A block table and its target positions padded to `n_pad` rows:
    pad rows read the zero row (the host assembly's zero padding)."""
    tbl = np.full(n_pad, ZERO_ROW, np.int32)
    pos = np.arange(n_pad, dtype=np.int32)
    tbl[:len(table)] = table
    pos[:len(positions)] = positions
    return tbl, pos


def cache_gather(cache: CacheRows, rope_theta: float, shared, kernels: bool) -> PlainGather:
    """The block-gather kernel bound to the cached rows' layer planes and,
    with `shared`, to that arena's (`shared.planes()`) as its second
    pool: table entries from `cache.n_rows` on read slot (entry - n_rows)
    of the arena.  Called with (table, positions, layers, rotate=,
    keep_raw=): table/positions (N,) int32 on the pool's device ->
    (k, v[, k_raw]) each (N, Hkv, Dh) for one layer, (n_layers, N, Hkv,
    Dh) for a range, in the pool dtype; `rotate=False` is a bitwise copy
    of the rows.  `kernels` False binds the kernel's plain version
    instead (`PlainGather`), on any device."""
    k2, v2 = shared.planes() if shared is not None else (None, None)
    bind = PoolGather if kernels else PlainGather
    return bind(cache.k, cache.v, k2, v2, rope_theta=rope_theta)


def _device_table(cache: CacheRows, table: np.ndarray, n_pad: int) -> torch.Tensor:
    """A block table padded to `n_pad` rows with the zero row, on the
    pool's device: what layer 0's copy of the cached rows reads."""
    tbl = np.full(n_pad, ZERO_ROW, np.int32)
    tbl[:len(table)] = table
    return torch.from_numpy(tbl).to(cache.k.device)


@torch.no_grad()
def layer0(model: Transformer, toks: np.ndarray, valid: np.ndarray, ck0, cv0):
    """Layer-0 full pass (padded) with the Eq. 3 terms.  ck0/cv0: (n,
    Hkv, Dh) cached layer-0 rows (tensors on the model's device, or host
    arrays).  -> (x after layer 0 (n, D), attn_mass (n,), divergence
    (n,), fresh pre-RoPE k0, v0 (n, Hkv, Dh)), all on the model's device."""
    cfg = model.cfg
    dev = model.device
    toks_t = torch.from_numpy(np.asarray(toks, np.int64)).to(dev)
    valid_t = torch.from_numpy(np.asarray(valid)).to(dev)
    n = toks_t.shape[0]
    pos = torch.arange(n, device=dev)
    x = model.embed_tokens(toks_t)
    lp = model.layers[0]
    h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q = L.apply_rope(torch.einsum("sd,dhe->she", h, lp.wq)[None], pos,
                     cfg.rope_theta)[0]
    k_raw, v = layer0_kv(model, toks_t)
    k = L.apply_rope(k_raw[None], pos, cfg.rope_theta)[0]
    o, probs = full_attn(q, k, v, pos, pos, k_valid=valid_t)
    # A_i: attention mass received by key i from *valid* queries, over
    # every head of every rank
    attn_mass = CTX.mean_over_tp(
        (probs * valid_t[None, None, :, None]).mean(dim=(0, 1)).sum(dim=0))
    dk = (k_raw.float() - torch.as_tensor(ck0, device=dev)).abs().sum(dim=(1, 2))
    dv = (v.float() - torch.as_tensor(cv0, device=dev)).abs().sum(dim=(1, 2))
    x = _layer_step(x, lp, cfg, o)
    return x, attn_mass, CTX.all_reduce(dk + dv), k_raw, v


def select_recompute(plan: AssemblyPlan, have: np.ndarray,
                     attn_mass, div_raw, sel: SelectiveConfig
                     ) -> Tuple[np.ndarray, EngineStats]:
    """Eq. 3 scoring + heavy-hitter selection under per-class budgets.

    attn_mass/div_raw: layer-0 outputs (padded; only [:n] is read).
    -> (recompute mask (n,), EngineStats).
    """
    n = plan.n
    attn_mass = np.asarray(attn_mass)[:n]
    a_norm = attn_mass / max(attn_mass.max(), 1e-9)
    div = np.asarray(div_raw)[:n] * have.astype(np.float32)
    div = div / max(div.max(), 1e-9)
    s_score = (1.0 - sel.lam) * a_norm + sel.lam * div              # Eq. 3

    src = plan.source
    recompute = ~have.copy()                                 # misses
    # instructions: always recomputed — unless their exact KV is already
    # cached (`have`)
    recompute |= (plan.seg_kind == 0) & ~have
    recompute[max(0, n - sel.window):] = True                # local window
    n_hh = 0
    for kind, budget in ((2, sel.r_item), (1, sel.r_rev)):
        cls = np.where((plan.seg_kind == kind) & ~recompute)[0]
        if len(cls) == 0:
            continue
        k_top = int(np.ceil(budget * len(cls)))
        top = cls[np.argsort(-s_score[cls])[:k_top]]
        recompute[top] = True
        n_hh += len(top)

    stats = EngineStats(
        n_tokens=n, n_recomputed=int(recompute.sum()),
        n_reused_item=int(((src == FROM_ITEM) & ~recompute).sum()),
        n_reused_semantic=int(((src == FROM_SEMANTIC) & ~recompute).sum()),
        n_heavy_hitters=n_hh, layer0_full=sel.layer0_full,
        recompute_mask=recompute.copy())
    return recompute, stats


@torch.no_grad()
def selective_layers(model: Transformer, x: torch.Tensor, r_idx: np.ndarray,
                     r_valid: np.ndarray, gather: PlainGather, table: torch.Tensor,
                     positions: torch.Tensor, valid: np.ndarray,
                     final_slot: np.ndarray, kernels: bool):
    """Batched layers 1..L-1 over the recompute sets.

    x: (B, n, D); r_idx/r_valid: (B, R) host; gather: the block-gather
    kernel bound to the cached rows (`cache_gather`); table/positions:
    (B, n) int32 on the device, each key's cached row (or store-shared
    slot) and target position; valid: (B, n) host key validity;
    final_slot: (B,); `kernels` False runs the selective kernel's plain
    version on any device.  -> (logits (B, V), merged pre-RoPE k, v (B,
    n, L-1, Hkv, Dh)) on the device (views of layer-major tensors).

    One block-gather launch assembles every layer's cached keys, rotated
    to their request positions (exact realignment), with the pre-RoPE base
    and the values from the same launch, layer by layer contiguous; each
    layer then scatters its recomputed tokens' fresh K/V over its planes.
    Padded recompute rows (`r_valid` False) are masked out of the scatter
    — the reference's drop-mode scatter at index n.
    """
    cfg = model.cfg
    dev = x.device
    B, n, _ = x.shape
    r_pos_np = np.clip(np.asarray(r_idx, np.int64), 0, n - 1)
    r_pos = torch.from_numpy(r_pos_np).to(dev)                   # (B, R)
    # the selective kernel's mask operands, on the device once for all
    # layers and in the kernel's dtypes (int32 positions, uint8 validity,
    # int32 liveness), so no layer's call copies or converts them
    valid_u8 = np.asarray(valid, np.uint8)
    live = None
    if kernels:
        live = torch.from_numpy(block_liveness(
            r_pos_np, valid_u8, window=0, q_block=LIVE_Q_BLOCK,
            kv_block=LIVE_KV_BLOCK)).to(dev)
    r_pos32 = r_pos.to(torch.int32)
    valid_t = torch.from_numpy(valid_u8).to(dev)
    rv = torch.from_numpy(np.asarray(r_valid, bool)).to(dev)
    rows = torch.arange(B, device=dev)[:, None].expand_as(r_pos)[rv]
    widx = r_pos[rv]                                             # kept rows only
    tbl, kpos = table.reshape(-1), positions.reshape(-1)
    xr = torch.gather(x, 1, r_pos[..., None].expand(-1, -1, x.shape[-1]))
    # every layer's assembled keys (cached pre-RoPE keys rotated to the
    # request positions), their pre-RoPE base and the values: (L-1, B*n,
    # Hkv, Dh) each, one launch
    k_rot, v_all, k_raw = gather(tbl, kpos, range(1, cfg.n_layers), rotate=True,
                                 keep_raw=True)
    for l in range(1, cfg.n_layers):
        lp = model.layers[l]
        hr = L.rms_norm(xr, lp.attn_norm, cfg.norm_eps)
        qr = torch.einsum("brd,dhe->brhe", hr, lp.wq)
        kr_raw = torch.einsum("brd,dhe->brhe", hr, lp.wk)
        vr = torch.einsum("brd,dhe->brhe", hr, lp.wv)
        qr = L.apply_rope(qr, r_pos, cfg.rope_theta)
        kr = L.apply_rope(kr_raw, r_pos, cfg.rope_theta)
        k_l, v_l, k_m = (t[l - 1].view(B, n, *t.shape[2:]) for t in (k_rot, v_all, k_raw))
        k_l[rows, widx] = kr[rv].to(k_l.dtype)
        v_l[rows, widx] = vr[rv].to(v_l.dtype)
        # merged pre-RoPE cache: cached blocks + fresh recomputed keys
        k_m[rows, widx] = kr_raw[rv].to(k_m.dtype)
        if kernels:
            o = selective_mha(qr, r_pos32, k_l, v_l.to(kr.dtype), valid_t, live=live,
                              window=0, q_block=LIVE_Q_BLOCK, kv_block=LIVE_KV_BLOCK)
        else:
            o = selective_mha_ref(qr, r_pos32, k_l, v_l.to(kr.dtype), valid_t, window=0)
        xr = _layer_step(xr, lp, cfg, o)

    fs = torch.from_numpy(np.asarray(final_slot, np.int64)).to(dev)
    xf = L.rms_norm(xr[torch.arange(B, device=dev), fs], model.final_norm,
                    cfg.norm_eps)
    logits = model.logits(xf)                                   # (B, V)
    deep = lambda t: t.view(cfg.n_layers - 1, B, n, *t.shape[2:]).movedim(0, 2)
    return logits, deep(k_raw), deep(v_all)


def selective_layers_batch(model: Transformer, cfg: LMConfig, items,
                           cache: CacheRows, r_bucket: int = 64, shared=None,
                           gather: Optional[PlainGather] = None):
    """Bucketed batched selective-layer pass (phase 2 of the selective
    prefill): requests are grouped by (padded length, padded recompute
    budget) and ONE selective step runs per bucket.  PyTorch runs eagerly,
    so the batch axis is not padded to a power of two as under jit.  The
    wave prefill and the chunked finalize both land here.

    items: sequence of (plan, x (n_pad, D) device tensor, recompute (n,),
    block_table (n,), positions (n,)).  -> list of (logits (V,) host,
    k_rest, v_rest) per item in input order; k_rest/v_rest are the merged
    pre-RoPE layers 1..L-1, (n_pad, L-1, Hkv, Dh) on the device.
    `shared`: the arena whose slots tables may address (`cache_gather`);
    `gather`: `cache_gather(cache, cfg.rope_theta, shared, kernels)` when
    the caller has bound it already.  `cfg.attn_backend` picks kernels or
    plain versions (`attn_uses_kernels`).
    """
    dev = model.device
    kernels = attn_uses_kernels(cfg, dev)
    if gather is None:
        gather = cache_gather(cache, cfg.rope_theta, shared, kernels)
    results = [None] * len(items)
    by_shape: Dict[tuple, list] = {}
    for i, (plan, x, recompute, _, _) in enumerate(items):
        n_pad = x.shape[0]
        r_count = int(recompute.sum())
        r_pad = max(r_bucket, ((r_count + r_bucket - 1) // r_bucket)
                    * r_bucket)
        by_shape.setdefault((n_pad, r_pad), []).append(i)
    for (n_pad, r_pad), idxs in sorted(by_shape.items()):
        B = len(idxs)
        r_idx_p = np.zeros((B, r_pad), np.int32)
        r_valid = np.zeros((B, r_pad), bool)
        valid = np.zeros((B, n_pad), bool)
        final_slot = np.zeros(B, np.int64)
        tables = np.zeros((2, B, n_pad), np.int32)
        for bi, i in enumerate(idxs):
            plan, _, recompute, table, positions = items[i]
            r_idx = np.where(recompute)[0]
            r_idx_p[bi] = _pad_to(r_idx.astype(np.int32), r_pad,
                                  fill=plan.n - 1)
            r_valid[bi, :len(r_idx)] = True
            valid[bi, :plan.n] = True
            final_slot[bi] = len(r_idx) - 1
            tables[:, bi] = _pad_table(table, positions, n_pad)
        x = torch.stack([items[i][1] for i in idxs])
        tables_t = torch.from_numpy(tables).to(dev)
        logits, k_rest, v_rest = selective_layers(
            model, x, r_idx_p, r_valid, gather, tables_t[0], tables_t[1], valid,
            final_slot, kernels)
        logits = _host(logits)
        for bi, i in enumerate(idxs):
            results[i] = (logits[bi], k_rest[bi], v_rest[bi])
    return results


def plan_layer0(model: Transformer, cfg: LMConfig, plan: AssemblyPlan,
                table: np.ndarray, positions: np.ndarray, cache: CacheRows,
                bucket: int = 128, shared=None, gather: Optional[PlainGather] = None):
    """Layer 0 of one request over its prompt padded to a `bucket`
    multiple, against its cached layer-0 rows copied out of `cache` by the
    block-gather kernel (`table`/`positions` as `cache_gather` takes them;
    `gather`: that binding, when the caller has one).  -> `layer0`'s
    outputs."""
    n_pad = ((plan.n + bucket - 1) // bucket) * bucket
    toks = _pad_to(plan.tokens.astype(np.int32), n_pad)
    valid = np.zeros(n_pad, bool)
    valid[:plan.n] = True
    tbl = _device_table(cache, table, n_pad)
    if gather is None:
        gather = cache_gather(cache, cfg.rope_theta, shared,
                              attn_uses_kernels(cfg, model.device))
    ck0, cv0 = gather(tbl, None, 0, rotate=False)
    return layer0(model, toks, valid, ck0, cv0)


def run_selective_layers(model: Transformer, cfg: LMConfig, plan: AssemblyPlan,
                         x: torch.Tensor, recompute: np.ndarray, cache: CacheRows,
                         table: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Layers 1..L-1 of ONE request (the JAX package's
    `run_selective_layers`): a one-item `selective_layers_batch`.  x: (n_pad,
    D) after layer 0; recompute: (n,) mask; table/positions: (n,) each
    key's cached row and the position its key is rotated to (the request
    position realigns exactly; `core.baselines`' CacheBlend passes the
    blocks' original positions).  -> final-position logits (V,) host."""
    return selective_layers_batch(model, cfg, [(plan, x, recompute, table, positions)],
                                  cache)[0][0]


def selective_prefill_logits(model: Transformer, cfg: LMConfig, plan: AssemblyPlan,
                             table: np.ndarray, positions: np.ndarray,
                             have: np.ndarray, sel: SelectiveConfig,
                             cache: CacheRows) -> Tuple[np.ndarray, EngineStats]:
    """Beyond-prefix prefill of ONE request with selective recomputation
    (the JAX package's `selective_prefill_logits`): a one-item
    `selective_prefill_batch`.  -> (logits (V,) host, EngineStats)."""
    logits, stats, _, _ = selective_prefill_batch(
        model, cfg, [(plan, table, positions, have)], sel, cache)[0]
    return logits, stats


def selective_prefill_batch(
    model: Transformer, cfg: LMConfig, items: Sequence, sel: SelectiveConfig,
    cache: CacheRows, bucket: int = 128, r_bucket: int = 64, shared=None,
):
    """Batched beyond-prefix prefill over many requests at once.

    Phase 1 runs layer 0 + Eq. 3 scoring per request, against its cached
    layer-0 rows copied out of `cache` by the block-gather kernel; phase
    2 runs the selective layers per (padded length, padded recompute
    budget) bucket (`selective_layers_batch`).

    items: sequence of (plan, block_table, positions, have) tuples (see
    `assembly.plan_block_table`; entries past the cached rows address
    `shared`, see `cache_gather`).  -> list of (logits (V,) host,
    EngineStats, k_all (n, L, Hkv, Dh), v_all) per request, in input
    order; k_all/v_all are fp32 on the device.
    """
    if not items:
        return []
    gather = cache_gather(cache, cfg.rope_theta, shared,
                          attn_uses_kernels(cfg, model.device))
    sel_items, stats_of, k0_of, v0_of = [], [], [], []
    for plan, table, positions, have in items:
        x, attn_mass, div_raw, k0, v0 = plan_layer0(model, cfg, plan, table, positions,
                                                    cache, bucket, gather=gather)
        rec, stats = select_recompute(plan, have, _host(attn_mass),
                                      _host(div_raw), sel)
        CTX.check("recompute mask", rec)
        k0_of.append(k0)
        v0_of.append(v0)
        stats_of.append(stats)
        sel_items.append((plan, x, rec, table, positions))

    sel_out = selective_layers_batch(model, cfg, sel_items, cache,
                                     r_bucket=r_bucket, gather=gather)
    results = []
    for i, (logits, k_rest, v_rest) in enumerate(sel_out):
        n = items[i][0].n
        k_all = torch.cat([k0_of[i][:n, None].float(), k_rest[:n]], dim=1)
        v_all = torch.cat([v0_of[i][:n, None].float(), v_rest[:n]], dim=1)
        results.append((logits, stats_of[i], k_all, v_all))
    return results


# ---------------------------------------------------------------------------
# Chunk-resumable layer 0 (the unified-step serving path).
#
# The monolithic selective prefill runs layer 0 over the whole prompt at
# once; under load a long prompt then stalls every running request for its
# full n^2 scan.  The chunked pass scans the prompt in fixed-size query
# chunks against a key buffer of the monolithic length: chunk c computes
# q/k/v for its tokens, writes its rotated keys into the buffer and
# attends causally over everything scanned so far.  Unscanned keys are
# zeros but causally invisible, so each chunk's rows are the monolithic
# pass's rows up to the summation order of its products.  The one
# cross-token reduction, Eq. 3's attention mass (a sum over queries), is
# kept as per-query rows on the device and reduced once, in one fixed
# order, when the scan completes.
# ---------------------------------------------------------------------------

@torch.no_grad()
def layer0_chunk(model: Transformer, toks_c: np.ndarray, offset: int,
                 valid: torch.Tensor, ck0_c: torch.Tensor, cv0_c: torch.Tensor,
                 kbuf: torch.Tensor, vbuf: torch.Tensor):
    """One layer-0 chunk: queries [offset, offset+C) vs all scanned keys.

    toks_c: (C,) chunk token ids (0-padded past the prompt); valid:
    (nbuf,) key validity on the device; ck0_c/cv0_c: (C, Hkv, Dh) cached
    layer-0 rows for the Eq. 3 divergence; kbuf/vbuf: (nbuf, Hkv, Dh)
    rotated-key / value buffers, updated in place.  -> (x_c, m_c, div_c,
    k0_c, v0_c): m_c (C, nbuf) holds the per-query head-mean attention
    probabilities (the Eq. 3 mass rows), k0_c/v0_c the chunk's fresh
    pre-RoPE layer-0 K/V."""
    cfg = model.cfg
    dev = model.device
    C = len(toks_c)
    toks_t = torch.from_numpy(np.asarray(toks_c, np.int64)).to(dev)
    pos_c = torch.arange(offset, offset + C, device=dev)
    x = model.embed_tokens(toks_t)
    lp = model.layers[0]
    h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q = L.apply_rope(torch.einsum("sd,dhe->she", h, lp.wq)[None], pos_c,
                     cfg.rope_theta)[0]
    k_raw, v = layer0_kv(model, toks_t)
    kbuf[offset:offset + C] = L.apply_rope(k_raw[None], pos_c, cfg.rope_theta)[0]
    vbuf[offset:offset + C] = v
    k_pos = torch.arange(kbuf.shape[0], device=dev)
    o, probs = full_attn(q, kbuf, vbuf, pos_c, k_pos, k_valid=valid)
    qvalid = valid[offset:offset + C]
    m_c = (probs * qvalid[None, None, :, None]).mean(dim=(0, 1))
    dk = (k_raw.float() - ck0_c).abs().sum(dim=(1, 2))
    dv = (v.float() - cv0_c).abs().sum(dim=(1, 2))
    x = _layer_step(x, lp, cfg, o)
    return x, m_c, dk + dv, k_raw, v


class ChunkedPrefill:
    """Resumable selective prefill state for ONE request.

    Drives the prompt scan in `chunk_tokens`-sized steps (`run_chunk`),
    finalizes Eq. 3 recompute selection once the prompt is fully scanned,
    and hands the selective-layer pass to the same bucketed dispatch as
    the wave path (`sel_item` -> `selective_layers_batch`).  Every chunk's
    cached layer-0 rows come from the block-gather kernel; the per-chunk
    outputs stay on the device.  The serving engine
    (`serving.batch_engine.PrefillState`) wraps this with the pool
    bookkeeping; this class is compute + state only.  `shared`: the arena
    whose slots the table may address (`cache_gather`).
    """

    def __init__(self, model: Transformer, cfg: LMConfig, plan: AssemblyPlan,
                 table: np.ndarray, positions: np.ndarray, have: np.ndarray,
                 cache: CacheRows, sel: SelectiveConfig, chunk_tokens: int,
                 bucket: int = 128, shared=None):
        self.model = model
        self.cfg = cfg
        self.plan = plan
        self.table = table
        self.positions = positions
        self.have = have
        self.cache = cache
        self.shared = shared
        self.sel = sel
        self.chunk = int(chunk_tokens)
        n = plan.n
        self.n = n
        # the key buffers have the monolithic layer-0 length n_pad; the
        # scan covers n_pad in `chunk`-wide steps with a ragged tail
        self.n_pad = ((n + bucket - 1) // bucket) * bucket
        self.toks = _pad_to(plan.tokens.astype(np.int32), self.n_pad)
        dev = model.device
        self.valid = torch.arange(self.n_pad, device=dev) < n
        self._tbl = _device_table(cache, table, self.n_pad)
        self._kernels = attn_uses_kernels(cfg, model.device)
        self._gather = cache_gather(cache, cfg.rope_theta, shared, self._kernels)
        w = model.layers[0].wk
        self.kbuf = torch.zeros((self.n_pad,) + tuple(w.shape[1:]), dtype=w.dtype,
                                device=dev)
        self.vbuf = torch.zeros_like(self.kbuf)
        self.offset = 0
        self._xs: list = []
        self._ms: list = []
        self._divs: list = []
        self._k0s: list = []
        self._v0s: list = []
        self.recompute: Optional[np.ndarray] = None
        self.stats: Optional[EngineStats] = None

    @property
    def scan_done(self) -> bool:
        return self.offset >= self.n_pad

    def rebind(self, table: np.ndarray, shared) -> None:
        """Read the cached rows through `table` and `shared`'s arena from
        now on: a chunk-partial prefill migrated to another engine, whose
        store holds the injected prefix rows at other slots."""
        self.table, self.shared = table, shared
        self._tbl = _device_table(self.cache, table, self.n_pad)
        self._gather = cache_gather(self.cache, self.cfg.rope_theta, shared, self._kernels)

    def pending_tokens(self) -> int:
        """Chunk-grid tokens still to scan (padded: what a budget is
        charged for, since the dispatch width is the work)."""
        return self.n_pad - self.offset

    def next_chunk_tokens(self) -> int:
        """Dispatch width of the next chunk (ragged at the tail)."""
        return min(self.chunk, self.n_pad - self.offset)

    def finalize_charge(self) -> int:
        """Token charge of the selective finalize (the padded recompute
        budget), known as soon as the scan completes."""
        if self.recompute is None:
            raise RuntimeError("finalize_charge before scan completed")
        r_count = int(self.recompute.sum())
        return max(64, -(-r_count // 64) * 64)

    def run_chunk(self):
        """Scan the next chunk.  -> (positions, k0_rows, v0_rows): the real
        prompt positions covered (host) and their fresh pre-RoPE layer-0
        K/V (device), ready for pool insertion (empty on an all-pad tail
        chunk).  Completing the scan finalizes Eq. 3 selection."""
        if self.scan_done:
            raise RuntimeError("prompt fully scanned")
        off = self.offset
        C = self.next_chunk_tokens()
        ck0, cv0 = self._gather(self._tbl[off:off + C], None, 0, rotate=False)
        x_c, m_c, div_c, k0, v0 = layer0_chunk(
            self.model, self.toks[off:off + C], off, self.valid, ck0, cv0,
            self.kbuf, self.vbuf)
        self._xs.append(x_c)
        self._ms.append(m_c)
        self._divs.append(div_c)
        self._k0s.append(k0)
        self._v0s.append(v0)
        self.offset = off + C
        lo, hi = off, min(off + C, self.n)
        if self.scan_done:
            self._select()
        if hi <= lo:
            return np.zeros(0, np.int64), k0[:0], v0[:0]
        return np.arange(lo, hi), k0[:hi - lo], v0[:hi - lo]

    def _select(self) -> None:
        # one device reduction, then over every rank's heads
        attn_mass = CTX.mean_over_tp(torch.cat(self._ms).sum(dim=0))
        div = CTX.all_reduce(torch.cat(self._divs))
        self.recompute, self.stats = select_recompute(
            self.plan, self.have, _host(attn_mass), _host(div), self.sel)
        CTX.check("recompute mask", self.recompute)
        # the mass rows are O(n_pad^2) floats per request: free them once
        # the scan-wide reduction has consumed them
        self._ms = []
        self._divs = []

    def x_full(self) -> torch.Tensor:
        """Post-layer-0 residual stream (n_pad, D): the selective input."""
        return torch.cat(self._xs)

    def k0_full(self) -> torch.Tensor:
        """Fresh pre-RoPE layer-0 K (n, Hkv, Dh) over the real prompt."""
        return torch.cat(self._k0s)[:self.n]

    def v0_full(self) -> torch.Tensor:
        return torch.cat(self._v0s)[:self.n]

    def sel_item(self) -> tuple:
        """This request's `selective_layers_batch` entry."""
        if self.recompute is None:
            raise RuntimeError("selective pass before scan completed")
        return (self.plan, self.x_full(), self.recompute, self.table,
                self.positions)
