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
engine runs on the device its model lives on; host arrays (plans,
cached KV, masks) stay numpy, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core.assembly import FROM_ITEM, FROM_SEMANTIC, AssemblyPlan
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.selective_attention.ops import (block_liveness,
                                                         selective_mha)
from repro_torch.models import layers as L
from repro_torch.models.transformer import Block, Transformer
from repro_torch.models.transformer import forward as model_forward

# Tile sizes of the selective kernel's block-liveness map: the engine's
# shape buckets are multiples of 64, as in the JAX package.
LIVE_Q_BLOCK = 64
LIVE_KV_BLOCK = 64


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
    """Residual updates after attention output `o` (.., H, Dh)."""
    x = x + torch.einsum("...he,hed->...d", o, lp.wo)
    return x + L.mlp_apply(L.rms_norm(x, lp.mlp_norm, cfg.norm_eps), lp.mlp,
                           cfg.mlp_type)


# ---------------------------------------------------------------------------
# Offline KV build and full prefill (flash-attention kernel)
# ---------------------------------------------------------------------------

@torch.no_grad()
def batched_forward(model: Transformer, toks: torch.Tensor,
                    valid: torch.Tensor):
    """Padded (N, S) forward pass.  -> (x, k_all, v_all): the final
    residual stream (N, S, D) plus the pre-RoPE per-layer caches
    (N, S, L, Hkv, Dh).  Invalid keys are masked out via `valid`."""
    cfg = model.cfg
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
        o = mha_flash(q, k, v, kv_valid=valid, causal=True)
        x = _layer_step(x, lp, cfg, o)
    return x, torch.stack(ks, dim=2), torch.stack(vs, dim=2)


def precompute_kv_batch(model: Transformer, cfg: LMConfig, docs,
                        bucket: int = 64):
    """Batched offline KV materialization with length bucketing.
    -> list of (S_i, L, Hkv, Dh) pre-RoPE (k, v) fp32 numpy arrays."""
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
        _, k, v = batched_forward(model, toks, toks != 0)
        k, v = _host(k), _host(v)
        for gi, j in enumerate(group):
            s = len(docs[j])
            out[j] = (k[gi, :s], v[gi, :s])
        i += len(group)
    return out


@torch.no_grad()
def batched_prefill(model: Transformer, toks: np.ndarray, last_idx: np.ndarray):
    """Padded multi-request full prefill.  toks: (N, S); last_idx: (N,)
    index of each request's final real token.  -> (logits (N, V),
    pre-RoPE k, v (N, S, L, Hkv, Dh)) as host fp32."""
    dev = model.device
    t = torch.from_numpy(np.asarray(toks, np.int64)).to(dev)
    last = torch.from_numpy(np.asarray(last_idx, np.int64)).to(dev)
    S = t.shape[1]
    valid = torch.arange(S, device=dev)[None, :] <= last[:, None]
    x, k_all, v_all = batched_forward(model, t, valid)
    x_last = x[torch.arange(t.shape[0], device=dev), last]
    xf = L.rms_norm(x_last, model.final_norm, model.cfg.norm_eps)
    return _host(xf @ model.head()), _host(k_all), _host(v_all)


def full_prefill_logits(model: Transformer, cfg: LMConfig, tokens: np.ndarray,
                        bucket: int = 128) -> np.ndarray:
    """Full-Recompute oracle: exact final-position logits (padding is
    causally invisible to the final real token)."""
    n = len(tokens)
    n_pad = ((n + bucket - 1) // bucket) * bucket
    toks = np.pad(np.asarray(tokens, np.int64), (0, n_pad - n))
    logits = model_forward(model, torch.from_numpy(toks)[None].to(model.device))
    return _host(logits[0, n - 1])


# ---------------------------------------------------------------------------
# Selective prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def layer0(model: Transformer, toks: np.ndarray, valid: np.ndarray,
           ck0: np.ndarray, cv0: np.ndarray):
    """Layer-0 full pass (padded) with the Eq. 3 terms.  -> (x after
    layer 0 (n, D), attn_mass (n,), divergence (n,), fresh pre-RoPE
    k0, v0 (n, Hkv, Dh)), all on the model's device."""
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
    # A_i: attention mass received by key i from *valid* queries
    attn_mass = (probs * valid_t[None, None, :, None]).mean(dim=(0, 1)).sum(dim=0)
    dk = (k_raw.float() - torch.from_numpy(ck0).to(dev)).abs().sum(dim=(1, 2))
    dv = (v.float() - torch.from_numpy(cv0).to(dev)).abs().sum(dim=(1, 2))
    x = _layer_step(x, lp, cfg, o)
    return x, attn_mass, dk + dv, k_raw, v


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
                     r_valid: np.ndarray, ck: torch.Tensor, cv: torch.Tensor,
                     valid: np.ndarray, final_slot: np.ndarray,
                     collect_kv: bool = True):
    """Batched layers 1..L-1 over the recompute sets.

    x: (B, n, D); r_idx/r_valid: (B, R) host; ck/cv: (B, n, L, Hkv, Dh)
    fp32 on the device (the assembled pre-RoPE caches); valid: (B, n)
    host key validity; final_slot: (B,).  -> logits (B, V) [+ merged
    pre-RoPE (k, v): (B, n, L-1, Hkv, Dh)] on the device.

    Cached keys are rotated to their request positions (exact realignment);
    the recomputed tokens' fresh K/V are scattered over them.  Padded
    recompute rows (`r_valid` False) are masked out of the scatter — the
    reference's drop-mode scatter at index n.
    """
    cfg = model.cfg
    dev = x.device
    B, n, _ = x.shape
    pos = torch.arange(n, device=dev)
    r_pos_np = np.clip(np.asarray(r_idx, np.int64), 0, n - 1)
    r_pos = torch.from_numpy(r_pos_np).to(dev)                   # (B, R)
    live = block_liveness(r_pos_np, np.asarray(valid, np.int8), window=0,
                          q_block=LIVE_Q_BLOCK, kv_block=LIVE_KV_BLOCK)
    valid_t = torch.from_numpy(np.asarray(valid, np.int8)).to(dev)
    rv = torch.from_numpy(np.asarray(r_valid, bool)).to(dev)
    rows = torch.arange(B, device=dev)[:, None].expand_as(r_pos)[rv]
    widx = r_pos[rv]                                             # kept rows only
    xr = torch.gather(x, 1, r_pos[..., None].expand(-1, -1, x.shape[-1]))
    ks, vs = [], []
    for l in range(1, cfg.n_layers):
        lp = model.layers[l]
        hr = L.rms_norm(xr, lp.attn_norm, cfg.norm_eps)
        qr = torch.einsum("brd,dhe->brhe", hr, lp.wq)
        kr_raw = torch.einsum("brd,dhe->brhe", hr, lp.wk)
        vr = torch.einsum("brd,dhe->brhe", hr, lp.wv)
        qr = L.apply_rope(qr, r_pos, cfg.rope_theta)
        kr = L.apply_rope(kr_raw, r_pos, cfg.rope_theta)
        # assembled keys: cached pre-RoPE keys rotated to request positions
        k_l = L.apply_rope(ck[:, :, l], pos, cfg.rope_theta)
        v_l = cv[:, :, l].clone()
        k_l[rows, widx] = kr[rv].to(k_l.dtype)
        v_l[rows, widx] = vr[rv].to(v_l.dtype)
        if collect_kv:
            # merged pre-RoPE cache: cached blocks + fresh recomputed keys
            k_m = ck[:, :, l].clone()
            k_m[rows, widx] = kr_raw[rv].to(k_m.dtype)
            ks.append(k_m)
            vs.append(v_l)
        o = selective_mha(qr, r_pos, k_l, v_l.to(kr.dtype), valid_t, live=live,
                          window=0, q_block=LIVE_Q_BLOCK, kv_block=LIVE_KV_BLOCK)
        xr = _layer_step(xr, lp, cfg, o)

    fs = torch.from_numpy(np.asarray(final_slot, np.int64)).to(dev)
    xf = L.rms_norm(xr[torch.arange(B, device=dev), fs], model.final_norm,
                    cfg.norm_eps)
    logits = xf @ model.head()                                  # (B, V)
    if collect_kv:
        return logits, torch.stack(ks, dim=2), torch.stack(vs, dim=2)
    return logits


def selective_layers_batch(model: Transformer, cfg: LMConfig, items,
                           r_bucket: int = 64, return_kv: bool = True):
    """Bucketed batched selective-layer pass (phase 2 of the selective
    prefill): requests are grouped by (padded length, padded recompute
    budget) and ONE selective step runs per bucket.  PyTorch runs eagerly,
    so the batch axis is not padded to a power of two as under jit.

    items: sequence of (plan, x (n_pad, D) device tensor, recompute (n,),
    ckp, cvp) with ckp/cvp padded to n_pad.  -> list of (logits (V,),
    k_rest, v_rest) host arrays per item in input order (k_rest/v_rest
    are the merged pre-RoPE layers 1..L-1, (n_pad, L-1, Hkv, Dh); None
    unless ``return_kv``).
    """
    dev = model.device
    results = [None] * len(items)
    by_shape: Dict[tuple, list] = {}
    for i, (plan, x, recompute, ckp, cvp) in enumerate(items):
        n_pad = ckp.shape[0]
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
        for bi, i in enumerate(idxs):
            plan = items[i][0]
            r_idx = np.where(items[i][2])[0]
            r_idx_p[bi] = _pad_to(r_idx.astype(np.int32), r_pad,
                                  fill=plan.n - 1)
            r_valid[bi, :len(r_idx)] = True
            valid[bi, :plan.n] = True
            final_slot[bi] = len(r_idx) - 1
        x = torch.stack([items[i][1] for i in idxs])
        ck = torch.from_numpy(np.stack([items[i][3] for i in idxs])).to(dev)
        cv = torch.from_numpy(np.stack([items[i][4] for i in idxs])).to(dev)
        out = selective_layers(model, x, r_idx_p, r_valid, ck, cv, valid,
                               final_slot, collect_kv=return_kv)
        if return_kv:
            logits, k_rest, v_rest = (_host(t) for t in out)
        else:
            logits, k_rest, v_rest = _host(out), None, None
        for bi, i in enumerate(idxs):
            results[i] = (logits[bi],
                          k_rest[bi] if return_kv else None,
                          v_rest[bi] if return_kv else None)
    return results


def selective_prefill_batch(
    model: Transformer, cfg: LMConfig, items: Sequence, sel: SelectiveConfig,
    bucket: int = 128, r_bucket: int = 64, return_kv: bool = True,
):
    """Batched beyond-prefix prefill over many requests at once.

    Phase 1 runs layer 0 + Eq. 3 scoring per request; phase 2 runs the
    selective layers per (padded length, padded recompute budget) bucket
    (`selective_layers_batch`).

    items: sequence of (plan, cached_k, cached_v, have) tuples.
    -> list of (logits (V,), EngineStats, k_all (n, L, Hkv, Dh), v_all)
    per request, in input order (k_all/v_all None unless ``return_kv``).
    """
    if not items:
        return []
    sel_items, stats_of, k0_of, v0_of = [], [], [], []
    for plan, ck, cv, have in items:
        n_pad = ((plan.n + bucket - 1) // bucket) * bucket
        toks = _pad_to(plan.tokens.astype(np.int32), n_pad)
        valid = np.zeros(n_pad, bool)
        valid[:plan.n] = True
        ckp = _pad_to(ck.astype(np.float32), n_pad)
        cvp = _pad_to(cv.astype(np.float32), n_pad)
        x, attn_mass, div_raw, k0, v0 = layer0(
            model, toks, valid, np.ascontiguousarray(ckp[:, 0]),
            np.ascontiguousarray(cvp[:, 0]))
        rec, stats = select_recompute(plan, have, _host(attn_mass),
                                      _host(div_raw), sel)
        k0_of.append(_host(k0) if return_kv else None)
        v0_of.append(_host(v0) if return_kv else None)
        stats_of.append(stats)
        sel_items.append((plan, x, rec, ckp, cvp))

    sel_out = selective_layers_batch(model, cfg, sel_items,
                                     r_bucket=r_bucket, return_kv=return_kv)
    results = []
    for i, (logits, k_rest, v_rest) in enumerate(sel_out):
        n = items[i][0].n
        k_all = v_all = None
        if return_kv:
            k_all = np.concatenate([k0_of[i][:, None], k_rest], axis=1)[:n]
            v_all = np.concatenate([v0_of[i][:, None], v_rest], axis=1)[:n]
        results.append((logits, stats_of[i], k_all, v_all))
    return results
