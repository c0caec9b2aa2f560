"""H100 constants for the port's roofline terms, and `model_flops`.

Analytic bounds, never measured: the constants are NVIDIA's published
peaks for one H100 SXM5 (the "NVIDIA H100 Tensor Core GPU" datasheet,
H100 SXM column, the figures `core/cost_model.py:H100_SXM` cites):

* 989 TFLOP/s dense BF16 tensor-core throughput (the datasheet's 1,979
  is with sparsity);
* 3.35 TB/s HBM3 bandwidth;
* 900 GB/s NVLink (fourth generation) bandwidth per card, for the
  multi-card terms; the one-card closed forms of `roofline_analytic` run
  no collective and do not read it.

A card that runs below its 700 W power limit runs below these peaks.
The reference prices the same terms at a TPU's rates
(`repro/launch/roofline.py`).

`roofline_terms` is the reference's rule on a dry-run record
(`launch.dryrun`): compute = FLOPs / PEAK_FLOPS, memory = bytes / HBM_BW,
collective = collective bytes / NVLINK_BW, all per device, and the
bottleneck the largest.  The reference reads its collective bytes from
XLA's optimised HLO; the port counts its own collectives as it issues
them (`sharding.ctx.count_collectives`), each op's output bytes times
the reference's wire multiplier (`COLL_OPS`).
"""
from __future__ import annotations

from repro_torch.core.cost_model import H100_SXM

PEAK_FLOPS = H100_SXM.peak_flops     # 989e12: dense bf16 per card
HBM_BW = H100_SXM.hbm_bw             # 3.35e12 bytes/s
NVLINK_BW = 900e9                    # bytes/s per card, NVLink 4

# wire-traffic multiplier per collective (ring algorithms, per device), the
# reference's: an all-reduce is a reduce-scatter and an all-gather
COLL_OPS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def roofline_terms(rec: dict) -> dict:
    """rec: a dry-run record with flops_per_device / bytes_per_device /
    collectives.  -> the three terms in seconds at the H100's peaks, the
    bottleneck and the compute term's share of the dominant one
    (modelled, never measured)."""
    ct = rec["flops_per_device"] / PEAK_FLOPS
    mt = rec["bytes_per_device"] / HBM_BW
    xt = rec["collectives"]["total_bytes"] / NVLINK_BW
    terms = {"compute_s": ct, "memory_s": mt, "collective_s": xt}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    denom = max(ct, mt, xt)
    terms["roofline_fraction_of_dominant"] = ct / denom if denom > 0 else 0.0
    return terms


def model_flops(arch: str, shape_dims: dict, step: str) -> float:
    """MODEL_FLOPS = 6 N D (dense train; N the active parameters of an
    MoE), 2 N D for the forward-only steps (prefill; decode takes one
    token per sequence): the "useful compute" yardstick of an MFU.  NaN
    for a non-LM arch."""
    from repro_torch.configs import registry as R

    cfg = R.ARCHS[arch]
    if R.family_of(arch) != "lm":
        return float("nan")
    n = cfg.active_param_count()
    if step == "train":
        return 6.0 * n * shape_dims["batch"] * shape_dims["seq"]
    if step == "prefill":
        return 2.0 * n * shape_dims["batch"] * shape_dims["seq"]
    return 2.0 * n * shape_dims["batch"]
