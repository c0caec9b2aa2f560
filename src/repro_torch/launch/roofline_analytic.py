"""Analytic roofline terms for the LM cells on one H100.

The reference's closed forms (`repro/launch/roofline_analytic.py`) at its
default knobs on one card (`n_chips=1`, `data_par=1`): the same chunked
attention (tiles not causally skipped), the same MoE dispatch, the same
byte counts.  What changes is the price (`launch.roofline`: 989 TFLOP/s
dense bf16 and 3.35 TB/s HBM3 of one H100 SXM5).  One card runs no
collective, so there is no collective term.  These are analytic bounds,
never measured.

Conventions:
  train factors: matmul fwd=2·m·n·k; bwd=2×fwd; remat re-fwd=+1×fwd → 4×.
  attention tile flops are NOT causally skipped (the baseline masks, it
  does not skip).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LMConfig
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

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


def lm_analytic(cfg: LMConfig, step: str, dims: Dict[str, int]) -> Dict[str, float]:
    """FLOPs and bytes of one `step` ("train", "prefill" or "decode") at
    `dims` ({"batch", "seq"}) on one card, and their times at the H100's
    peaks."""
    b, s = dims["batch"], dims["seq"]
    L = cfg.n_layers
    params = cfg.param_count() * DTYPE

    if step == "train":
        tokens = b * s
        mm = L * _per_layer_matmul_flops(cfg, tokens)
        att = L * _attn_score_flops(cfg, b, s, s)
        head = 2 * tokens * cfg.d_model * cfg.vocab_size
        flops = 4.0 * (mm + att) + 3.0 * head       # fwd+2bwd+remat / no-remat head
        act_layer = tokens * cfg.d_model * DTYPE
        opt_bytes = (2 if cfg.optimizer == "adafactor" else 8) * cfg.param_count()
        # params read 3× (fwd/bwd/remat) + grads written + opt r/w +
        # residual stack write+read + per-layer activation traffic (~6 big
        # tensors r/w per layer in the fused pipeline)
        nbytes = (3 * params + 2 * params + 2 * opt_bytes
                  + 2 * L * act_layer + 6 * L * act_layer)
    elif step == "prefill":
        tokens = b * s
        mm = L * _per_layer_matmul_flops(cfg, tokens)
        att = L * _attn_score_flops(cfg, b, s, s)
        head = 2 * b * cfg.d_model * cfg.vocab_size   # last position only
        flops = mm + att + head
        act_layer = tokens * cfg.d_model * DTYPE
        kv_bytes = 2 * L * tokens * cfg.n_kv_heads * cfg.resolved_head_dim * DTYPE
        nbytes = params + 6 * L * act_layer + kv_bytes
    else:                                             # decode: one token per sequence
        mm = L * _per_layer_matmul_flops(cfg, b)
        att = L * _attn_score_flops(cfg, b, 1, s)
        head = 2 * b * cfg.d_model * cfg.vocab_size
        flops = mm + att + head
        # memory-bound: every param and the whole KV cache read once
        kv_bytes = 2 * L * b * s * cfg.n_kv_heads * cfg.resolved_head_dim * DTYPE
        nbytes = params + kv_bytes

    ct, mt = flops / PEAK_FLOPS, nbytes / HBM_BW
    return {"compute_s": ct, "memory_s": mt,
            "flops_per_device": flops, "bytes_per_device": nbytes,
            "bottleneck": "compute" if ct >= mt else "memory",
            "roofline_fraction": ct / max(ct, mt) if max(ct, mt) > 0 else 0.0}
