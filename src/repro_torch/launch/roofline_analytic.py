"""Analytic roofline terms for the LM cells on H100s.

The reference's closed forms (`repro/launch/roofline_analytic.py`), with
its `n_chips` and `data_par` (default: one card, `n_chips=1`,
`data_par=1`) and its five hillclimb knobs (`lm_analytic`'s docstring;
their caller is `launch.perf_iterations`): the same attention tile
count, the same MoE dispatch, the same byte and collective-byte counts
per device.  What changes is the price (`launch.roofline`: 989 TFLOP/s
dense bf16, 3.35 TB/s HBM3 and 900 GB/s NVLink of one H100 SXM5).  One
card runs no collective, so with `n_chips=1` there is no collective term
and the result is the one-card dict.  These are analytic bounds, never
measured.

Conventions:
  train factors: matmul fwd=2·m·n·k; bwd=2×fwd; remat re-fwd=+1×fwd → 4×.
  attention-score FLOPs count every tile of the causal square unless
  `causal_block_pairing` is set: the reference's baseline computes the
  masked tiles.  The port's own attention is already banded, so its
  work is the knob's side of the count.
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
                data_par: int = 1, causal_block_pairing: bool = False,
                seq_parallel: bool = False, overlap_collectives: bool = False,
                selective_recompute: float = 1.0,
                selective_decode_read: float = 1.0) -> Dict[str, float]:
    """FLOPs, bytes and (over more than one card) collective bytes per
    device of one `step` ("train", "prefill" or "decode") at `dims`
    ({"batch", "seq"}) on `n_chips` cards, `data_par` of them data
    parallel (the weights sharded over all of them, activations over the
    data-parallel ones), and their times at the H100's peaks.

    The reference's hillclimb knobs, in the same closed forms:

    * `causal_block_pairing`: attention-score FLOPs x 0.55, the live
      (q, kv) tiles of a causal square (the lower triangle and the
      diagonal) out of all of them.  The reference's baseline masks the
      tiles above the diagonal but computes them; the port's never did
      (`models.layers.chunked_attention` takes each q chunk's causal band
      of keys, K6 loops over the live tiles only), so this knob prices
      the reference's tile count, not a change to the port;
    * `seq_parallel`: sequence-parallel block boundaries: the two
      all-reduces of each block become a reduce-scatter and an all-gather
      of sequence-sharded activations, half the tensor-parallel wire
      bytes (train and prefill);
    * `overlap_collectives`: the collectives hidden behind compute:
      ``overlapped_s`` is the largest term instead of their sum;
    * `selective_recompute`: RcLLM prefill: the share r of the tokens
      that layers 1..L-1 recompute (layer 0 runs for all; their attention
      reads every key);
    * `selective_decode_read`: RcLLM decode: the share of the cached
      sequence a step reads (the window and the heavy hitters).

    ``serial_s`` is the sum of the terms, ``overlapped_s`` the step time
    under `overlap_collectives` (else the sum again)."""
    b, s = dims["batch"], dims["seq"]
    L = cfg.n_layers

    if step == "train":
        tokens = b * s
        mm = L * _per_layer_matmul_flops(cfg, tokens)
        att = L * _attn_score_flops(cfg, b, s, s)
        if causal_block_pairing:
            att *= 0.55                     # live tiles ~ (nq * nk / 2 + diagonal)
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
        tp = 4 * L * act_layer * 2.0
        if seq_parallel:
            tp *= 0.5
        coll = 2.0 * p_local + tp
        if cfg.moe is not None:
            coll += 4.0 * cfg.moe.top_k * tokens * cfg.d_model * DTYPE / n_chips
    elif step == "prefill":
        tokens = b * s
        r = selective_recompute
        # layer 0 for every token, layers 1..L-1 for the recompute set,
        # whose attention reads every key (r * S^2 scores)
        mm = (_per_layer_matmul_flops(cfg, tokens)
              + (L - 1) * _per_layer_matmul_flops(cfg, int(r * tokens)))
        att = (_attn_score_flops(cfg, b, s, s)
               + (L - 1) * _attn_score_flops(cfg, b, int(r * s), s))
        if causal_block_pairing:
            att *= 0.55
        head = 2 * b * cfg.d_model * cfg.vocab_size   # last position only
        flops = (mm + att + head) / n_chips
        p_local = cfg.param_count() * DTYPE / n_chips
        act_layer = tokens * cfg.d_model * DTYPE / data_par
        kv_bytes = 2 * L * tokens * cfg.n_kv_heads * cfg.resolved_head_dim * DTYPE / n_chips
        nbytes = p_local + 6 * L * act_layer * (1 + r * (L - 1)) / L + kv_bytes
        coll = 2 * L * act_layer                       # TP all-reduce, forward only
        if seq_parallel:
            coll *= 0.5
        if cfg.moe is not None:
            coll += 2.0 * cfg.moe.top_k * tokens * cfg.d_model * DTYPE / n_chips
    else:                                             # decode: one token per sequence
        rd = selective_decode_read                    # (window + heavy hitters) / S
        mm = L * _per_layer_matmul_flops(cfg, b)
        att = L * _attn_score_flops(cfg, b, 1, int(rd * s))
        head = 2 * b * cfg.d_model * cfg.vocab_size
        flops = (mm + att + head) / n_chips
        # memory-bound: every local param and the local KV slice read once
        p_local = cfg.param_count() * DTYPE / n_chips
        kv_bytes = (2 * L * b * s * cfg.n_kv_heads * cfg.resolved_head_dim * DTYPE
                    / n_chips) * rd
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
    out["serial_s"] = ct + mt + terms.get("collective", 0.0)
    out["overlapped_s"] = top if overlap_collectives else out["serial_s"]
    return out
