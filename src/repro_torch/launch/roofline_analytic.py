"""Analytic roofline terms for the LM cells on H100s.

The reference's closed forms (`repro/launch/roofline_analytic.py`), with
its `n_chips` and `data_par` (default: one card, `n_chips=1`,
`data_par=1`): the same chunked attention (tiles not causally skipped),
the same MoE dispatch, the same byte and collective-byte counts per
device.  What changes is the price (`launch.roofline`: 989 TFLOP/s dense
bf16, 3.35 TB/s HBM3 and 900 GB/s NVLink of one H100 SXM5).  One card
runs no collective, so with `n_chips=1` there is no collective term and
the result is the one-card dict.  These are analytic bounds, never
measured.

Conventions:
  train factors: matmul fwd=2·m·n·k; bwd=2×fwd; remat re-fwd=+1×fwd → 4×.
  attention tile flops are NOT causally skipped (the baseline masks, it
  does not skip).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LMConfig
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS

DTYPE = 2  # bf16


def _per_layer_matmul_flops(cfg: LMConfig, tokens: int) -> float:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    attn = 2 * tokens * d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    if cfg.moe is not None:
        ffn = n_mats * 2 * tokens * cfg.moe.top_k * d * cfg.moe.d_ff
        ffn += 2 * tokens * d * cfg.moe.n_experts          # router
    else:
        ffn = n_mats * 2 * tokens * d * cfg.d_ff
    return attn + ffn


def _attn_score_flops(cfg: LMConfig, batch: int, s_q: int, s_kv: int) -> float:
    dh = cfg.resolved_head_dim
    return 2 * 2 * batch * cfg.n_heads * s_q * s_kv * dh   # QK^T + PV


def lm_analytic(cfg: LMConfig, step: str, dims: Dict[str, int], n_chips: int = 1,
                data_par: int = 1) -> Dict[str, float]:
    """FLOPs, bytes and (over more than one card) collective bytes per
    device of one `step` ("train", "prefill" or "decode") at `dims`
    ({"batch", "seq"}) on `n_chips` cards, `data_par` of them data
    parallel (the weights sharded over all of them, activations over the
    data-parallel ones), and their times at the H100's peaks."""
    b, s = dims["batch"], dims["seq"]
    L = cfg.n_layers

    if step == "train":
        tokens = b * s
        mm = L * _per_layer_matmul_flops(cfg, tokens)
        att = L * _attn_score_flops(cfg, b, s, s)
        head = 2 * tokens * cfg.d_model * cfg.vocab_size
        flops = (4.0 * (mm + att) + 3.0 * head) / n_chips   # fwd+2bwd+remat / no-remat head
        p_total = cfg.param_count()
        p_local = p_total * DTYPE / n_chips          # fully sharded weights
        act_layer = tokens * cfg.d_model * DTYPE / data_par
        opt_bytes = (2 if cfg.optimizer == "adafactor" else 8) * p_total / n_chips
        # params read 3× (fwd/bwd/remat) + grads written + opt r/w +
        # residual stack write+read + per-layer activation traffic (~6 big
        # tensors r/w per layer in the fused pipeline)
        nbytes = (3 * p_local + 2 * p_local + 2 * opt_bytes
                  + 2 * L * act_layer + 6 * L * act_layer)
        # DP grad all-reduce (2x the local shard) + TP all-reduce of
        # (B_loc, S, D) twice a layer forward and twice backward
        coll = 2.0 * p_local + 4 * L * act_layer * 2.0
        if cfg.moe is not None:
            coll += 4.0 * cfg.moe.top_k * tokens * cfg.d_model * DTYPE / n_chips
    elif step == "prefill":
        tokens = b * s
        mm = L * _per_layer_matmul_flops(cfg, tokens)
        att = L * _attn_score_flops(cfg, b, s, s)
        head = 2 * b * cfg.d_model * cfg.vocab_size   # last position only
        flops = (mm + att + head) / n_chips
        p_local = cfg.param_count() * DTYPE / n_chips
        act_layer = tokens * cfg.d_model * DTYPE / data_par
        kv_bytes = 2 * L * tokens * cfg.n_kv_heads * cfg.resolved_head_dim * DTYPE / n_chips
        nbytes = p_local + 6 * L * act_layer + kv_bytes
        coll = 2 * L * act_layer                       # TP all-reduce, forward only
        if cfg.moe is not None:
            coll += 2.0 * cfg.moe.top_k * tokens * cfg.d_model * DTYPE / n_chips
    else:                                             # decode: one token per sequence
        mm = L * _per_layer_matmul_flops(cfg, b)
        att = L * _attn_score_flops(cfg, b, 1, s)
        head = 2 * b * cfg.d_model * cfg.vocab_size
        flops = (mm + att + head) / n_chips
        # memory-bound: every local param and the local KV slice read once
        p_local = cfg.param_count() * DTYPE / n_chips
        kv_bytes = 2 * L * b * s * cfg.n_kv_heads * cfg.resolved_head_dim * DTYPE / n_chips
        nbytes = p_local + kv_bytes
        coll = 2 * L * (b * cfg.d_model * DTYPE / max(data_par, 1))   # TP combine a layer
        if cfg.moe is not None:
            coll += 2.0 * cfg.moe.top_k * b * cfg.d_model * DTYPE / n_chips

    ct, mt = flops / PEAK_FLOPS, nbytes / HBM_BW
    out = {"compute_s": ct, "memory_s": mt,
           "flops_per_device": flops, "bytes_per_device": nbytes}
    terms = {"compute": ct, "memory": mt}
    if n_chips > 1:
        out["collective_s"] = terms["collective"] = coll / NVLINK_BW
        out["collective_bytes_per_device"] = coll
    top = max(terms.values())
    out["bottleneck"] = max(terms, key=terms.get)
    out["roofline_fraction"] = ct / top if top > 0 else 0.0
    return out
