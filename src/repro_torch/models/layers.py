"""Transformer building blocks for the port: RMSNorm, half-split RoPE,
chunked prefill attention and dense-cache decode attention (with a
sliding window), the dense MLPs and the sort-based top-k MoE, with the
JAX package's numerics (`repro/models/layers.py`): fp32 normalisation
with the `(1 + scale)` factor, fp32 rotation cast back to the input
dtype, fp32 attention scores under the finite mask constant, fp32 router,
and the same parameter layouts.

The reference runs the LM architectures' attention in jnp, not through a
Pallas kernel, so the forward is plain torch here.  Its training path
differentiates attention through a hand-written backward (`_flash_bwd`,
a custom VJP); the port's counterpart is `flash_attention`, an autograd
function whose backward is kernel K6 on the card
(`kernels/flash_attention/ops.py:mha_flash_bwd`)."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ops import mha_flash_bwd
from repro_torch.sharding import ctx as CTX

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).  Half-split
    rotation (x1 = first half, x2 = second half), computed in fp32."""
    d = x.shape[-1]
    positions = torch.as_tensor(positions, device=x.device)
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_realign(k: torch.Tensor, delta, theta: float) -> torch.Tensor:
    """Rotate cached keys by a position delta (RcLLM §III-C3 'Alignment'):
    R(p+d) = R(d) R(p).  k: (..., S, H, D); delta: scalar or (...,)."""
    s = k.shape[-3]
    delta = torch.as_tensor(delta, dtype=torch.float32, device=k.device)
    pos = torch.zeros((s,), dtype=torch.float32, device=k.device) + delta[..., None]
    return apply_rope(k, pos, theta)


# ---------------------------------------------------------------- attention
def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product (B, n, k) @ (B, k, m) with an fp32 result, as the
    reference's `preferred_element_type=float32`: fp32 inputs as they
    are; bf16 inputs on the card accumulate in fp32 and come out
    unrounded (and so does the dry run's trace of the card's program,
    `kernels.shape_only`); elsewhere they are widened first (exact)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda or K.shape_only(a):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _host(positions) -> np.ndarray:
    if isinstance(positions, np.ndarray):
        return positions.astype(np.int64, copy=False)
    return np.asarray(torch.as_tensor(positions).cpu(), dtype=np.int64)


def _keys_seen(kpos: np.ndarray, first: int, last: int, causal: bool,
               window: Optional[int]) -> np.ndarray:
    """Which keys a query row can see, for rows at positions from `first`
    to `last`: called with (min, max) of a chunk's positions it gives the
    keys SOME row sees, with (max, min) the keys EVERY row sees."""
    seen = np.ones(kpos.shape, dtype=bool)
    if causal:
        seen &= kpos <= last
    if window is not None:
        seen &= kpos > first - window
        if not causal:
            seen &= kpos < last + window
    return seen


def _runs(flags: np.ndarray):
    """[(start, end)] of the runs of True in a 1-D bool array."""
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flags.astype(np.int8), [0]])))
    return list(zip(edges[::2].tolist(), edges[1::2].tolist()))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_positions, kv_positions,
                      kv_valid: Optional[torch.Tensor] = None,
                      sliding_window: Optional[int] = None, q_chunk: int = 512,
                      kv_chunk: int = 1024, return_lse: bool = False):
    """Attention of q (B, Sq, Hq, D) over k, v (B, Skv, Hkv, D) at the given
    absolute positions, one q chunk at a time: the counterpart of the
    reference's `_attn_impl` (`repro/models/layers.py:76`).

    Masks as the reference's: a key is live where `kv_valid` (B, Skv)
    allows it and, if causal, `qpos >= kpos` and `qpos - kpos < window`
    (not causal: `|qpos - kpos| < window`).  Each q chunk meets only the
    hull of the keys any of its rows can see (the causal and window band),
    never an (Sq, Skv) score tensor.  Numerics as the reference's: fp32
    scores times 1/sqrt(D), masked to the finite NEG_INF, probabilities
    exp(s - max) cast to V's dtype before an fp32-accumulated PV, the
    denominator clamped at 1e-30, the output in q's dtype.  The reference
    tiles Skv in kv chunks and keeps a running max; masked keys add
    exactly 0 to both, so a single pass over the band differs only in the
    order of sums.  The one place the padding shows: a row with no live
    key at all, which the reference gives the mean of V over every key of
    its kv-chunk-padded length (pad rows zero); so does this function.
    GQA by index: rows (query, group) of one kv head share its K/V.

    With `return_lse` also the rows' fp32 log-sum-exp (B, Sq, Hq), as the
    reference's `_attn_impl(return_lse=True)`: max + log(max(sum, 1e-30))
    of the scaled scores; a row with no live key gets NEG_INF, as the
    reference's -1e30 + log(padded length) rounds to in fp32."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    qpos_h, kpos_h = _host(q_positions), _host(kv_positions)
    qpos = torch.as_tensor(qpos_h, device=dev)
    kpos = torch.as_tensor(kpos_h, device=dev)
    qt = q.reshape(B, Sq, Hkv, G, D).transpose(1, 2).reshape(B * Hkv, Sq * G, D)
    kt = k.transpose(1, 2).reshape(B * Hkv, Skv, D)
    vt = v.transpose(1, 2).reshape(B * Hkv, Skv, D)
    n_padded = -(-Skv // kv_chunk) * kv_chunk
    dead = vt.float().sum(1)[:, None] / n_padded                 # (B*Hkv, 1, D)
    valid = None if kv_valid is None else kv_valid.to(dev, torch.bool)
    out = torch.empty_like(qt)
    lse = torch.empty(qt.shape[:2], dtype=torch.float32, device=dev) if return_lse else None
    for i0 in range(0, Sq, q_chunk):
        i1 = min(Sq, i0 + q_chunk)
        rows = slice(i0 * G, i1 * G)
        qmin, qmax = qpos_h[i0:i1].min(), qpos_h[i0:i1].max()
        band = np.flatnonzero(_keys_seen(kpos_h, qmin, qmax, causal, sliding_window))
        if band.size == 0:
            out[:, rows] = dead.to(out.dtype)
            if lse is not None:
                lse[:, rows] = NEG_INF
            continue
        lo, hi = int(band[0]), int(band[-1]) + 1
        s = matmul_f32(qt[:, rows], kt[:, lo:hi].transpose(1, 2)).mul_(scale)
        s5 = s.view(B, Hkv, i1 - i0, G, hi - lo)
        # the positional mask, applied to the columns that some row of the
        # chunk cannot see (in the causal band: the diagonal block and the
        # window's edge)
        seen_by_all = _keys_seen(kpos_h[lo:hi], qmax, qmin, causal, sliding_window)
        for c0, c1 in _runs(~seen_by_all):
            d = qpos[i0:i1, None] - kpos[None, lo + c0:lo + c1]
            mask = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
            if sliding_window is not None:
                mask &= (d if causal else d.abs()) < sliding_window
            s5[..., c0:c1].masked_fill_(~mask[None, None, :, None, :], NEG_INF)
        if valid is not None:
            s5.masked_fill_(~valid[:, None, None, None, lo:hi], NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = s.sub_(m).exp_()
        l = p.sum(-1, keepdim=True).clamp_min_(1e-30)
        o = matmul_f32(p.to(v.dtype), vt[:, lo:hi]).div_(l)
        out[:, rows] = torch.where(m <= 0.5 * NEG_INF, dead, o).to(out.dtype)
        if lse is not None:
            lse[:, rows] = torch.where(m <= 0.5 * NEG_INF, NEG_INF, m + torch.log(l))[..., 0]
        del s, p, o
    out = out.view(B, Hkv, Sq, G, D).transpose(1, 2).reshape(B, Sq, Hq, D)
    if lse is None:
        return out
    return out, lse.view(B, Hkv, Sq, G).transpose(1, 2).reshape(B, Sq, Hq)


class _FlashAttention(torch.autograd.Function):
    """The reference's `_flash` custom VJP: forward `chunked_attention`
    (plain torch, no gradient graph, saving q, k, v, out and the fp32
    log-sum-exp), backward `mha_flash_bwd` (kernel K6 on the card, the
    tile-for-tile plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, host, causal, window, q_chunk,
                kv_chunk):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = chunked_attention(q, k, v, causal=causal, q_positions=host[0],
                                     kv_positions=host[1], sliding_window=window,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk, return_lse=True)
        out, lse = out.contiguous(), lse.contiguous()
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.cfg = (causal, window, q_chunk, kv_chunk, host)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qpos, kpos = ctx.saved_tensors
        causal, window, q_chunk, kv_chunk, host = ctx.cfg
        # the dry run's shape-only call counts its live pairs on the host
        extra = {"host_positions": host} if K.shape_only(q) else {}
        dq, dk, dv = mha_flash_bwd(q, k, v, out, lse, dout.contiguous(), qpos, kpos,
                                   causal=causal, window=window, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, **extra)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    q_positions, kv_positions, sliding_window: Optional[int] = None,
                    q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Differentiable attention of the training path (the reference's
    `chunked_attention` without `kv_valid`, which routes through `_flash`):
    the value of `chunked_attention`, the gradient of `_flash_bwd`.
    Positions go to the backward as int32 tensors on q's device (and as
    host arrays, which the forward's chunk plan reads)."""
    dev = q.device
    host = (_host(q_positions), _host(kv_positions))
    qpos = torch.as_tensor(host[0], device=dev).to(torch.int32).contiguous()
    kpos = torch.as_tensor(host[1], device=dev).to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, qpos, kpos, host, causal, sliding_window, q_chunk,
                                 kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, *,
                     sliding_window: Optional[int] = None) -> torch.Tensor:
    """One new token per row against a dense cache: the counterpart of the
    reference's `decode_attention` (`repro/models/layers.py:371`).

    q (B, 1, Hq, D); k_cache, v_cache (B, S, Hkv, D); positions (B,) the
    rows' lengths: key i is live iff i < positions, and with a window
    also i >= positions - window.  fp32 scores, softmax in fp32,
    probabilities cast to V's dtype before an fp32-accumulated PV.

    The cache is read in place, each of K and V once: the queries go in
    as a block-diagonal (Hq, Hkv*D) matrix, so one batched product over
    the cache's (S, Hkv*D) rows gives every head's scores (the
    off-diagonal zeros add exactly nothing); a per-head product over the
    (B, S, Hkv, D) layout would first copy the cache into head-major
    order."""
    s, _ = _decode_scores(q, k_cache, positions, 0, sliding_window)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return _decode_pv(p, v_cache).to(q.dtype)


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor, positions: torch.Tensor,
                   offset: int, sliding_window: Optional[int]):
    """`decode_attention`'s masked fp32 scores (B, Hq, S) of the keys at
    global positions offset .. offset + S - 1, and their liveness (B, S)."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qb = q.new_zeros((B, Hkv, G, Hkv, D))
    qb.diagonal(dim1=1, dim2=3).copy_(q.reshape(B, Hkv, G, D).permute(0, 2, 3, 1))
    s = matmul_f32(qb.view(B, Hq, Hkv * D), k_cache.reshape(B, S, Hkv * D).transpose(1, 2))
    s.mul_(1.0 / (D ** 0.5))                                      # (B, Hq, S)
    idx = torch.arange(S, device=q.device)[None, :]
    if offset:
        idx = idx + offset
    lens = positions.to(q.device)[:, None]
    valid = idx < lens
    if sliding_window is not None:
        valid &= idx >= lens - sliding_window
    s.masked_fill_(~valid[:, None, :], NEG_INF)
    return s, valid


def _decode_pv(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """Weights p (B, Hq, S) in V's dtype times the cache's V, fp32:
    -> (B, 1, Hq, D)."""
    B, S, Hkv, D = v_cache.shape
    Hq = p.shape[1]
    G = Hq // Hkv
    o = matmul_f32(p, v_cache.reshape(B, S, Hkv * D))                    # (B, Hq, Hkv*D)
    o = o.view(B, Hkv, G, Hkv, D).diagonal(dim1=1, dim2=3)              # (B, G, D, Hkv)
    return o.permute(0, 3, 1, 2).reshape(B, 1, Hq, D)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             positions: torch.Tensor, *, offset: int = 0,
                             sliding_window: Optional[int] = None):
    """`decode_attention` over one block of a cache whose sequence is split
    across ranks (flash-decoding): k_cache, v_cache (B, Sb, Hkv, D) hold
    global positions offset .. offset + Sb - 1, and the mask and window
    read those positions.  -> (m (B, Hq), the block's max fp32 score; s
    (B, Hq), the sum of exp(score - m) over its live keys; o (B, Hq, D),
    fp32, those weights, cast to V's dtype, times V, unnormalised), which
    `sharding.ctx.merge_attention` combines.  A block with no live key
    gives s = 0 and o = 0 (its m is the mask constant).  Against
    `decode_attention` the order of sums differs and the weights are
    rounded to V's dtype before, not after, normalising: in fp32 the two
    agree to ~1e-6 relative, in bf16 to a bf16 rounding of the weights."""
    s, valid = _decode_scores(q, k_cache, positions, offset, sliding_window)
    m = s.amax(-1)
    p = torch.where(valid[:, None, :], torch.exp(s - m[..., None]), torch.zeros_like(s))
    o = _decode_pv(p.to(v_cache.dtype), v_cache)[:, 0]
    return m, p.sum(-1), o


# ---------------------------------------------------------------- MLPs
def activation(h: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The MLP's nonlinearity: on the gate for swiglu / geglu, on the
    hidden for relu2 / gelu (tanh GELU, as the reference's)."""
    if mlp_type == "swiglu":
        return F.silu(h)
    if mlp_type in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    if mlp_type == "relu2":
        return torch.square(F.relu(h))
    raise ValueError(mlp_type)


def mlp_apply(x: torch.Tensor, params: Mapping[str, torch.Tensor],
              mlp_type: str) -> torch.Tensor:
    if mlp_type in ("swiglu", "geglu"):
        g = activation(x @ params["w_gate"], mlp_type)
        return (g * (x @ params["w_up"])) @ params["w_down"]
    return activation(x @ params["w_up"], mlp_type) @ params["w_down"]


def _normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device).mul_(std)


def mlp_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             mlp_type: str, dtype, device=None) -> dict:
    std_in = d_model ** -0.5
    std_out = d_ff ** -0.5
    p = {"w_up": _normal((d_model, d_ff), std_in, dtype, device, generator),
         "w_down": _normal((d_ff, d_model), std_out, dtype, device, generator)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _normal((d_model, d_ff), std_in, dtype, device, generator)
    return p


# ---------------------------------------------------------------- MoE
def moe_route(x: torch.Tensor, router: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, dp_batch: bool = True) -> Dict[str, torch.Tensor]:
    """The reference's sort-based routing of x (T, D) (`moe_apply`,
    `repro/models/layers.py:503`).  Router logits and softmax in fp32;
    the top k by (probability descending, expert id ascending), as
    `lax.top_k` breaks ties; gates renormalised over the k.  Each expert
    takes at most C = max(1, int(capacity_factor * T * K / E)) routes:
    the flat (token, k) routes stably sorted by expert, and a route is
    kept iff its place in its expert's segment is < C (a dropped route
    is the later one in that order).  -> gate_vals, expert_idx (T, K);
    keep_tk, dest_tk (T, K): each route's kept flag and flat slot e*C+c;
    slot_tok, slot_valid (E, C): each slot's token and whether a route
    fills it; aux, the Switch load-balancing term; C; base (E,), the
    routes the earlier data ranks send to each expert (zeros without data
    parallelism): a local slot c of expert e is the batch's slot base + c.

    Under data parallelism (`dp_batch`: x is this rank's contiguous share
    of a batch cut over the data axis) the function is the reference's on
    the whole batch: C counts every rank's tokens, a route's place in its
    expert is offset by the routes the earlier data ranks send there (an
    exclusive prefix sum of the per-expert counts), and the aux term's
    density and mean probability are means over every token.  The slots
    (E, C) are then this rank's routes at their places within the rank's
    share, so an expert's kept slots across the ranks are the
    reference's."""
    T = x.shape[0]
    E, K = n_experts, top_k
    dev = x.device
    dp = CTX.dp_size() if dp_batch else 1
    probs = torch.softmax(x.float() @ router.float(), dim=-1)          # (T, E)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top[:, :K], idx[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    experts = torch.arange(E, device=dev)
    density = (expert_idx[:, :1] == experts).float().mean(0)           # no host sync
    mean_prob = probs.mean(0)
    if dp > 1:
        density = CTX.mean_over_dp(density)
        mean_prob = CTX.mean_over_dp(mean_prob)
    aux = E * torch.sum(density * mean_prob)

    C = max(1, int(capacity_factor * T * dp * K / E))
    n = T * K
    sorted_e, order = torch.sort(expert_idx.reshape(n), stable=True)
    seg_start = torch.searchsorted(sorted_e, experts)
    pos = torch.arange(n, device=dev) - seg_start[sorted_e]
    base = torch.zeros(E, dtype=torch.long, device=dev)
    if dp > 1:
        counts = torch.searchsorted(sorted_e, experts, right=True) - seg_start
        base = CTX.exclusive_cumsum_dp(counts)
    keep = pos + base[sorted_e] < C
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=dev)
    slots = torch.arange(C, device=dev)[None, :]
    slot_idx = seg_start[:, None] + slots                                  # (E, C)
    clipped = slot_idx.clamp(max=n - 1)
    slot_valid = (slot_idx < n) & (sorted_e[clipped] == experts[:, None])
    if dp > 1:
        slot_valid &= base[:, None] + slots < C
    dest = sorted_e * C + pos.clamp(0, C - 1)
    return {"gate_vals": gate_vals, "expert_idx": expert_idx, "aux": aux, "C": C,
            "base": base, "keep_tk": keep[inv_order].reshape(T, K),
            "dest_tk": dest[inv_order].reshape(T, K),
            "slot_tok": order[clipped] // K, "slot_valid": slot_valid}


# bytes of one weight's gathered experts that `moe_apply` holds at a time
# (a chunk of experts; kimi-k2's w_up at 16-way EP is 11.3 GB / 16 whole)
GATHER_CHUNK_BYTES = 256 << 20


def _expert_ffn(expert_in: torch.Tensor, params: Mapping[str, torch.Tensor],
                mlp_type: str, gather: bool,
                experts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The experts' products on their slots: expert_in (E, C, D) ->
    (E, C, D).  With `gather` the weights are the rank's expert-ff blocks
    over the data axes, gathered whole a chunk of experts at a time
    (`GATHER_CHUNK_BYTES`), each chunk dropped before the next.  With
    `experts` (the indices of the experts that have slots, `_used_experts`)
    only those are computed, the other experts' rows are zeros."""
    E = expert_in.shape[0]
    names = ("w_gate", "w_up", "w_down") if mlp_type in ("swiglu", "geglu") else \
        ("w_up", "w_down")
    step = E
    if gather:
        whole = params["w_up"][0].numel() * params["w_up"].element_size() * CTX.dp_size()
        step = max(1, min(E, GATHER_CHUNK_BYTES // max(1, whole)))
    outs = []
    n = E if experts is None else experts.numel()
    for e0 in range(0, n, step):
        if experts is None:
            w = {k: params[k][e0:e0 + step] for k in names}
            xe = expert_in[e0:e0 + step]
        else:
            w = {k: params[k][experts[e0:e0 + step]] for k in names}
            xe = expert_in[experts[e0:e0 + step]]
        if gather:
            w = {k: CTX.gather_data(t, 1 if k == "w_down" else 2) for k, t in w.items()}
        if mlp_type in ("swiglu", "geglu"):
            h = activation(torch.bmm(xe, w["w_gate"]), mlp_type) * torch.bmm(xe, w["w_up"])
        else:
            h = activation(torch.bmm(xe, w["w_up"]), mlp_type)
        outs.append(torch.bmm(h, w["w_down"]))
        del w, h
    if experts is not None:
        out = torch.zeros_like(expert_in)
        if outs:
            out[experts] = torch.cat(outs)
        return out
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _used_experts(slot_valid: torch.Tensor) -> torch.Tensor:
    """Serving with gathered experts: the rank's experts that some data
    rank fills a slot of (their union over the data axes, so that the
    data ranks gather the same ones), read on the host (one sync a
    layer).  A decode step's few tokens reach a few of the experts, and
    only those are gathered."""
    used = slot_valid.any(-1).to(torch.int32)
    CTX.reduce_(used, "data", dist.ReduceOp.MAX)
    return torch.nonzero(used).flatten()


def _expert_ffn_in(mesh, *args) -> torch.Tensor:
    """`_expert_ffn` inside `mesh` (a recomputation in the backward runs on
    autograd's thread, where the caller's mesh is not current)."""
    if mesh is None:
        return _expert_ffn(*args)
    with CTX.axes(mesh):
        return _expert_ffn(*args)


def moe_apply(x: torch.Tensor, params: Mapping[str, torch.Tensor], *, n_experts: int,
              top_k: int, capacity_factor: float, mlp_type: str,
              dp_batch: bool = True, ff_cut: bool = False,
              remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (T, D) and the aux term, by the reference's gather-only
    dispatch: `moe_route`, the (E, C, D) expert inputs gathered by slot,
    the experts as batched products, and the K routes combined by
    gate-weighted gathers from the (E*C, D) outputs (a dropped route adds
    0).  No (T, E, C) one-hot is built.

    Expert parallelism: a rank holding E / tp of the experts (the model
    axis cuts w_gate / w_up / w_down's leading dim) routes its tokens with
    the whole router, runs only its experts' slots, combines the routes
    that went to them, and the ranks' outputs are summed over the model
    axis; x and the gates enter that region through `copy_to_tp`, so the
    router's gradient is the whole model's.

    `ff_cut`: the expert weights are the rank's blocks of the expert-ff
    dimension over the data axes, gathered where they are used
    (`_expert_ffn`).  Under autograd without `remat` (whose layer
    recomputation already drops them) the products are recomputed in the
    backward, so the gathered weights are not kept for it.  Serving
    gathers only the experts that some data rank routes a token to
    (`_used_experts`); the dry run's trace, which cannot read the routing,
    gathers every one."""
    T, D = x.shape
    r = moe_route(x, params["router"], n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor, dp_batch=dp_batch)
    E_loc = params["w_up"].shape[0]
    e0 = 0 if E_loc == n_experts else E_loc * CTX.current().coords["model"]
    x = CTX.copy_to_tp(x)
    gates = CTX.copy_to_tp(r["gate_vals"])
    C = r["C"]
    slot_tok, slot_valid = r["slot_tok"][e0:e0 + E_loc], r["slot_valid"][e0:e0 + E_loc]
    expert_in = torch.where(slot_valid[..., None], x[slot_tok.clamp(0, T - 1)], 0)
    gather = ff_cut and CTX.dp_size() > 1
    if gather and not remat and torch.is_grad_enabled():
        flat_out = checkpoint(_expert_ffn_in, CTX.current(), expert_in, dict(params), mlp_type,
                              gather, use_reentrant=False)
    else:
        serving = gather and not torch.is_grad_enabled() and not K.shape_only(x)
        flat_out = _expert_ffn(expert_in, params, mlp_type, gather,
                               _used_experts(slot_valid) if serving else None)
    flat_out = flat_out.reshape(-1, D)                                  # (E_loc*C, D)
    del expert_in
    y = None
    for j in range(top_k):
        keep = r["keep_tk"][:, j]
        dest = r["dest_tk"][:, j] - e0 * C
        if E_loc != n_experts:
            e = r["expert_idx"][:, j]
            keep = keep & (e >= e0) & (e < e0 + E_loc)
        yj = torch.where(keep[:, None], flat_out[dest.clamp(0, flat_out.shape[0] - 1)], 0)
        yj = yj * gates[:, j, None].to(yj.dtype)
        y = yj if y is None else y + yj
    return CTX.all_reduce(y.to(x.dtype)), r["aux"]
