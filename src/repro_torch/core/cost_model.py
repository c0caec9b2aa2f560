"""Analytic serving cost model — the port of the JAX package's
`core/cost_model.py`, with the H100's constants as the default.

The cluster bills what it does not measure on one card through these
closed forms: a cross-shard item pull (`fetch_time_s`) and a KV migration
between two workers go over a modelled interconnect, since the K workers
of a one-card cluster share one device.  TTFT for a request = queue
wait + max(KV fetch, layer-0 pass) [the §III-C3 overlap] + selective
prefill compute + LM head.  An MoE config counts its top-k experts
(`LMConfig.active_param_count`), as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import LMConfig


@dataclass(frozen=True)
class Hardware:
    """One serving instance's rates.  No default: every instance names
    where its numbers come from (`H100_SXM`)."""

    peak_flops: float
    mfu: float
    hbm_bw: float
    host_to_device_bw: float
    network_bw: float
    network_rtt: float
    chips_per_instance: int = 1


# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 column: 989 TFLOP/s
# dense BF16 tensor-core throughput, 3.35 TB/s HBM3, PCIe Gen5 x16 at
# 64 GB/s per direction (128 GB/s both ways) between host and card.
# Modelling assumptions, not measurements: the paper's 100 Gbps
# inter-instance network (12.5 GB/s) with a 200 us round trip, and a
# prefill MFU of 0.45.
H100_SXM = Hardware(peak_flops=989e12, mfu=0.45, hbm_bw=3.35e12,
                    host_to_device_bw=64e9, network_bw=12.5e9,
                    network_rtt=200e-6)


def kv_bytes_per_token(cfg: LMConfig, dtype_bytes: int = 2) -> int:
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim * dtype_bytes


def prefill_flops(cfg: LMConfig, n_total: int, n_recompute: int,
                  layer0_full: bool = True) -> float:
    """FLOPs for selective prefill: dense work only for recomputed tokens,
    attention for recomputed queries over all keys, plus one full layer-0
    pass for heavy-hitter identification."""
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    attn_proj = 2 * d * dh * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    if cfg.moe is not None:
        ffn = 3 * 2 * d * cfg.moe.d_ff * cfg.moe.top_k
    else:
        n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        ffn = n_mats * 2 * d * cfg.d_ff
    dense_per_tok_layer = attn_proj + ffn
    attn_per_q_layer = 2 * 2 * cfg.n_heads * dh * n_total   # QK^T + PV

    layers_sel = cfg.n_layers - (1 if layer0_full else 0)
    fl = n_recompute * layers_sel * (dense_per_tok_layer + attn_per_q_layer)
    if layer0_full:
        fl += n_total * (dense_per_tok_layer + attn_per_q_layer)
    fl += 2 * d * cfg.vocab_size                            # LM head, 1 token
    return float(fl)


def prefill_time_s(cfg: LMConfig, hw: Hardware, n_total: int,
                   n_recompute: int, layer0_full: bool = True) -> float:
    fl = prefill_flops(cfg, n_total, n_recompute, layer0_full)
    return fl / (hw.peak_flops * hw.chips_per_instance * hw.mfu)


def fetch_time_s(cfg: LMConfig, hw: Hardware, n_local_tokens: int,
                 n_remote_tokens: int) -> float:
    """Cache-block staging: local = host-DRAM -> device DMA; remote adds a
    network hop."""
    b = kv_bytes_per_token(cfg)
    t_local = n_local_tokens * b / hw.host_to_device_bw
    t_remote = 0.0
    if n_remote_tokens > 0:
        t_remote = hw.network_rtt + n_remote_tokens * b / hw.network_bw \
            + n_remote_tokens * b / hw.host_to_device_bw
    return t_local + t_remote


def ttft_s(cfg: LMConfig, hw: Hardware, n_total: int, n_recompute: int,
           n_local_tokens: int, n_remote_tokens: int,
           layer0_full: bool = True) -> float:
    """§III-C3 pipeline: the layer-0 pass overlaps the PCIe/network staging."""
    t_fetch = fetch_time_s(cfg, hw, n_local_tokens, n_remote_tokens)
    t_layer0 = prefill_time_s(cfg, hw, n_total, 0, layer0_full=True) \
        if layer0_full else 0.0
    t_rest = prefill_time_s(cfg, hw, n_total, n_recompute,
                            layer0_full=False) * (cfg.n_layers - 1) / cfg.n_layers
    return max(t_fetch, t_layer0) + t_rest


def full_prefill_ttft_s(cfg: LMConfig, hw: Hardware, n_total: int) -> float:
    return prefill_time_s(cfg, hw, n_total, n_total, layer0_full=False)


def prefix_cache_ttft_s(cfg: LMConfig, hw: Hardware, n_total: int,
                        n_prefix_hit: int) -> float:
    """Industrial prefix caching: only the shared leading segment is free."""
    return prefill_time_s(cfg, hw, n_total, n_total - n_prefix_hit,
                          layer0_full=False)


def decode_step_time_s(cfg: LMConfig, hw: Hardware, batch_size: int,
                       mean_context: int = 1024) -> float:
    """One continuous-batching decode iteration (one token per request):
    the larger of the memory time (bf16 weights once per iteration plus
    each request's KV) and the batch's matmul time."""
    wb = cfg.active_param_count() * 2                               # bf16 weights
    kv = batch_size * mean_context * kv_bytes_per_token(cfg)
    t_mem = (wb + kv) / (hw.hbm_bw * hw.chips_per_instance)
    flops = batch_size * 2 * cfg.active_param_count()
    t_fl = flops / (hw.peak_flops * hw.chips_per_instance * hw.mfu)
    return float(max(t_mem, t_fl))
