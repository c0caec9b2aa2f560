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
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import mha_flash_bwd

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
    unrounded; elsewhere they are widened first (exact)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _host(positions) -> np.ndarray:
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
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window, q_chunk, kv_chunk):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = chunked_attention(q, k, v, causal=causal, q_positions=q_positions,
                                     kv_positions=kv_positions, sliding_window=window,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk, return_lse=True)
        out, lse = out.contiguous(), lse.contiguous()
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.cfg = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qpos, kpos = ctx.saved_tensors
        causal, window, q_chunk, kv_chunk = ctx.cfg
        dq, dk, dv = mha_flash_bwd(q, k, v, out, lse, dout.contiguous(), qpos, kpos,
                                   causal=causal, window=window, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    q_positions, kv_positions, sliding_window: Optional[int] = None,
                    q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Differentiable attention of the training path (the reference's
    `chunked_attention` without `kv_valid`, which routes through `_flash`):
    the value of `chunked_attention`, the gradient of `_flash_bwd`.
    Positions go to the backward as int32 tensors on q's device."""
    dev = q.device
    qpos = torch.as_tensor(q_positions, device=dev).to(torch.int32).contiguous()
    kpos = torch.as_tensor(kv_positions, device=dev).to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, qpos, kpos, causal, sliding_window, q_chunk,
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
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qb = q.new_zeros((B, Hkv, G, Hkv, D))
    qb.diagonal(dim1=1, dim2=3).copy_(q.reshape(B, Hkv, G, D).permute(0, 2, 3, 1))
    s = matmul_f32(qb.view(B, Hq, Hkv * D), k_cache.reshape(B, S, Hkv * D).transpose(1, 2))
    s.mul_(1.0 / (D ** 0.5))                                      # (B, Hq, S)
    idx = torch.arange(S, device=q.device)[None, :]
    lens = positions.to(q.device)[:, None]
    valid = idx < lens
    if sliding_window is not None:
        valid &= idx >= lens - sliding_window
    s.masked_fill_(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = matmul_f32(p, v_cache.reshape(B, S, Hkv * D))                    # (B, Hq, Hkv*D)
    o = o.view(B, Hkv, G, Hkv, D).diagonal(dim1=1, dim2=3)              # (B, G, D, Hkv)
    return o.permute(0, 3, 1, 2).reshape(B, 1, Hq, D).to(q.dtype)


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
              capacity_factor: float) -> Dict[str, torch.Tensor]:
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
    fills it; aux, the Switch load-balancing term; C."""
    T = x.shape[0]
    E, K = n_experts, top_k
    dev = x.device
    probs = torch.softmax(x.float() @ router.float(), dim=-1)          # (T, E)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top[:, :K], idx[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    experts = torch.arange(E, device=dev)
    density = (expert_idx[:, :1] == experts).float().mean(0)           # no host sync
    aux = E * torch.sum(density * probs.mean(0))

    C = max(1, int(capacity_factor * T * K / E))
    n = T * K
    sorted_e, order = torch.sort(expert_idx.reshape(n), stable=True)
    seg_start = torch.searchsorted(sorted_e, experts)
    pos = torch.arange(n, device=dev) - seg_start[sorted_e]
    keep = pos < C
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=dev)
    slot_idx = seg_start[:, None] + torch.arange(C, device=dev)[None, :]   # (E, C)
    clipped = slot_idx.clamp(max=n - 1)
    slot_valid = (slot_idx < n) & (sorted_e[clipped] == experts[:, None])
    dest = sorted_e * C + pos.clamp(0, C - 1)
    return {"gate_vals": gate_vals, "expert_idx": expert_idx, "aux": aux, "C": C,
            "keep_tk": keep[inv_order].reshape(T, K),
            "dest_tk": dest[inv_order].reshape(T, K),
            "slot_tok": order[clipped] // K, "slot_valid": slot_valid}


def moe_apply(x: torch.Tensor, params: Mapping[str, torch.Tensor], *, n_experts: int,
              top_k: int, capacity_factor: float,
              mlp_type: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (T, D) and the aux term, by the reference's gather-only
    dispatch: `moe_route`, the (E, C, D) expert inputs gathered by slot,
    the experts as batched products, and the K routes combined by
    gate-weighted gathers from the (E*C, D) outputs (a dropped route adds
    0).  No (T, E, C) one-hot is built."""
    T, D = x.shape
    r = moe_route(x, params["router"], n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor)
    expert_in = torch.where(r["slot_valid"][..., None], x[r["slot_tok"].clamp(0, T - 1)], 0)
    if mlp_type in ("swiglu", "geglu"):
        h = activation(torch.bmm(expert_in, params["w_gate"]), mlp_type) * \
            torch.bmm(expert_in, params["w_up"])
    else:
        h = activation(torch.bmm(expert_in, params["w_up"]), mlp_type)
    flat_out = torch.bmm(h, params["w_down"]).reshape(-1, D)            # (E*C, D)
    del expert_in, h
    y = None
    for j in range(top_k):
        yj = torch.where(r["keep_tk"][:, j, None],
                         flat_out[r["dest_tk"][:, j].clamp(0, flat_out.shape[0] - 1)], 0)
        yj = yj * r["gate_vals"][:, j, None].to(yj.dtype)
        y = yj if y is None else y + yj
    return y.to(x.dtype), r["aux"]


def moe_init(generator: Optional[torch.Generator], d_model: int, cfg_moe, mlp_type: str,
             dtype, device=None) -> dict:
    """The reference's `moe_init` scales: router (D, E) fp32 and w_up /
    w_gate (E, D, F) at D^-1/2, w_down (E, F, D) at F^-1/2."""
    E, Fe = cfg_moe.n_experts, cfg_moe.d_ff
    std_in, std_out = d_model ** -0.5, Fe ** -0.5
    p = {"router": _normal((d_model, E), std_in, torch.float32, device, generator),
         "w_up": _normal((E, d_model, Fe), std_in, dtype, device, generator),
         "w_down": _normal((E, Fe, d_model), std_out, dtype, device, generator)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _normal((E, d_model, Fe), std_in, dtype, device, generator)
    return p
