"""The port's analytic roofline (`launch.roofline`,
`launch.roofline_analytic`) against the reference's closed forms: for the
five assigned LM archs and the served Qwen3-8B x train / prefill / decode,
`lm_analytic`'s FLOPs and bytes equal the reference's at its default
knobs on one card (`n_chips=1`, `data_par=1`), and its compute and memory
times are the reference's scaled by the ratio of the two packages'
constants (the H100's 989 TFLOP/s dense bf16 and 3.35 TB/s HBM3 against
the reference's TPU figures), within 1e-12 relative.  One card runs no
collective, so the port has no collective term.  `model_flops` equals
the reference's."""
import math

import pytest

from repro.configs import registry as JR
from repro.launch import roofline as JRF
from repro.launch import roofline_analytic as JRA
from repro_torch.configs import registry as TR
from repro_torch.core.cost_model import H100_SXM
from repro_torch.launch import roofline as TRF
from repro_torch.launch import roofline_analytic as TRA

ASSIGNED_LM = ("nemotron-4-15b", "starcoder2-15b", "gemma-7b", "kimi-k2-1t-a32b",
               "moonshot-v1-16b-a3b")
STEPS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
SERVED_LM = ("rcllm-qwen3-8b",)
COUNTS = ("flops_per_device", "bytes_per_device")
REL = 1e-12


def test_h100_constants_are_the_cited_figures():
    assert TRF.PEAK_FLOPS == H100_SXM.peak_flops == 989e12
    assert TRF.HBM_BW == H100_SXM.hbm_bw == 3.35e12
    assert TRF.NVLINK_BW == 900e9


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("arch", ASSIGNED_LM + SERVED_LM)
def test_lm_analytic_equals_the_reference(arch, step):
    dims = TR.LM_SHAPES[STEPS[step]].dims
    assert dims == JR.LM_SHAPES[STEPS[step]].dims
    got = TRA.lm_analytic(TR.ARCHS[arch], step, dims)
    want = JRA.lm_analytic(JR.ARCHS[arch], step, dims, n_chips=1, data_par=1)
    assert set(got) == {"compute_s", "memory_s", "bottleneck", "roofline_fraction",
                        "serial_s", "overlapped_s", *COUNTS}
    for key in COUNTS:
        assert got[key] == want[key], key
    scale = {"compute_s": JRF.PEAK_FLOPS / TRF.PEAK_FLOPS,
             "memory_s": JRF.HBM_BW / TRF.HBM_BW}
    for key, r in scale.items():
        assert math.isclose(got[key], want[key] * r, rel_tol=REL), key
    terms = {k: got[k + "_s"] for k in ("compute", "memory")}
    assert got["bottleneck"] == max(terms, key=terms.get)
    assert math.isclose(got["roofline_fraction"], terms["compute"] / max(terms.values()),
                        rel_tol=REL)
    assert got["serial_s"] == got["overlapped_s"] == terms["compute"] + terms["memory"]


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("arch", ASSIGNED_LM + ("rcllm-qwen3-8b", "wide-deep"))
def test_model_flops_equals_the_reference(arch, step):
    dims = TR.LM_SHAPES[STEPS[step]].dims
    got, want = TRF.model_flops(arch, dims, step), JRF.model_flops(arch, dims, step)
    assert (math.isnan(got) and math.isnan(want)) or got == want
